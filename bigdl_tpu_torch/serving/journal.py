"""Crash-recovery request journal for the serving engine (a copy of
bigdl_tpu/serving/journal.py; the files are the JAX package's, so either
package replays what the other wrote).

Every accepted request is appended to a JSONL journal, completions
append a tombstone, and a fresh engine replays the unfinished tail into
`engine.recovered_requests`.

Format: one JSON object per line, followed by a tab and the crc32 of the
JSON bytes (hex, 8 chars):
  {"op": "submit", "rid": 7, "prompt": [...], "max_new_tokens": 64, ...}\t1a2b3c4d
  {"op": "done", "rid": 7}\t5e6f7a8b

The crc suffix detects INTERIOR corruption (bit rot inside a record that
may even still parse as JSON) per-record — before it, only the
torn-trailing-line crash case was detectable. Compact JSON never
contains a raw tab, so the split is unambiguous; checksum-less lines
from pre-crc journals parse exactly as before (backward compatible).

A request is pending iff its last submit has no matching done. Replayed
requests get NEW rids (each old entry is superseded by a tombstone once
its replacement is recorded), and streaming consumers are not
resurrected — a replayed request completes as a plain buffered request
the caller reads from `engine.recovered_requests`.

On engine attach the journal is COMPACTED first (scan → rewrite holding
only the pending submits, through the atomic tmp+fsync+rename protocol)
— tombstoned pairs and corrupt lines stop accumulating across restarts,
and the rewrite happens strictly before the append handle opens, so the
live-inode hazard of mid-flight compaction never arises.
"""

from __future__ import annotations

import json
import os
import re
import threading
import warnings
import zlib
from typing import Optional

_CRC_RE = re.compile(r"^[0-9a-f]{8}$")


def crc_line(body: str) -> str:
    """`<body>\\t<crc32 hex>` — the journal's wire discipline, shared
    with the request log (obs/tracing.RequestLog) so the two line
    formats cannot drift."""
    return f"{body}\t{_crc_of(body)}"


def split_crc_line(line: str):
    """Inverse of :func:`crc_line`: (body, verdict) where verdict is
    True (crc present and matches), False (present, mismatch — bit
    rot), or None (no crc suffix: a legacy or torn line; the body is
    the whole line)."""
    body, sep, tail = line.rpartition("\t")
    if sep and _CRC_RE.fullmatch(tail):
        return body, _crc_of(body) == tail
    return line, None


def _crc_of(body: str) -> str:
    return f"{zlib.crc32(body.encode('utf-8')) & 0xFFFFFFFF:08x}"


_crc_line = crc_line

# sampling/stop/deadline fields that survive a restart (stream
# deliberately not). Deadlines are measured from the REPLAYED submit's
# own clock — the previous process's wall-clock budget is unknowable
# after a crash, and a fresh window errs on serving, not dropping.
_REPLAY_FIELDS = (
    "max_new_tokens", "do_sample", "temperature", "top_k", "top_p",
    "repetition_penalty", "eos_token_id", "queue_deadline_s", "deadline_s",
    # the named LoRA adapter (serving/adapters.py): a replayed tenant
    # request must decode with ITS fine-tune, not the shared base — the
    # registry re-resolves the name at the successor's admission
    "adapter",
)


class RequestJournal:
    """Append-only JSONL journal; thread-safe (submit can come from any
    request thread while the engine thread records completions)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def _append(self, obj: dict) -> None:
        line = _crc_line(json.dumps(obj, separators=(",", ":")))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()

    def record_submit(self, req) -> None:
        entry = {"op": "submit", "rid": req.rid, "prompt": list(req.prompt)}
        for f in _REPLAY_FIELDS:
            v = getattr(req, f)
            if v is not None:
                entry[f] = v
        self._append(entry)

    def record_done(self, rid: int) -> None:
        self._append({"op": "done", "rid": rid})

    def close(self) -> None:
        with self._lock:
            self._f.close()

    @staticmethod
    def scan(path: str, stats: Optional[dict] = None) -> tuple[list[dict], int]:
        """Parse a journal file -> (submit entries with no done marker,
        in submission order; highest rid seen). A truncated TRAILING line
        (the crash-mid-append case this journal must expect) is skipped
        with a warning; undecodable interior lines and per-line crc32
        mismatches ANYWHERE are skipped with a louder warning (they mean
        corruption beyond a torn tail). Either way recovery proceeds — a
        damaged line must never block replay of the intact entries
        around it.

        `stats`, when given, receives `corrupt_lines` — the count of
        interior-undecodable + crc-mismatched lines (NOT the expected
        torn tail); the engine exports it as
        `bigdl_tpu_journal_corrupt_lines_total`."""
        if stats is not None:
            stats.setdefault("corrupt_lines", 0)
        if not os.path.exists(path):
            return [], -1

        def corrupt(n: int = 1) -> None:
            if stats is not None:
                stats["corrupt_lines"] += n

        submits: dict[int, dict] = {}
        max_rid = -1
        # one-line lookbehind instead of readlines(): a long-lived
        # journal can be large and recovery must stream it. An
        # undecodable line is only a torn tail if NOTHING follows it.
        torn: Optional[tuple[int, str]] = None
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                if torn is not None:
                    corrupt()
                    warnings.warn(
                        f"{path}: skipping undecodable journal line "
                        f"{torn[0] + 1} (interior corruption): "
                        f"{torn[1][:60]!r}",
                        stacklevel=2,
                    )
                    torn = None
                # crc-suffixed line (compact JSON never holds a raw tab,
                # so the split is unambiguous). A torn tail can never
                # masquerade here: truncation eats the crc digits first,
                # so a full 8-hex suffix means the line was written
                # whole — a mismatch is bit rot, torn-position or not.
                body, ok = split_crc_line(line)
                if ok is False:
                    corrupt()
                    warnings.warn(
                        f"{path}: skipping journal line {i + 1} with "
                        f"crc32 mismatch (interior corruption): "
                        f"{body[:60]!r}",
                        stacklevel=2,
                    )
                    continue
                if ok:
                    line = body
                try:
                    obj = json.loads(line)
                except json.JSONDecodeError:
                    torn = (i, line)
                    continue
                rid = obj.get("rid")
                if not isinstance(rid, int):
                    continue  # malformed entry must not block recovery
                max_rid = max(max_rid, rid)
                if obj.get("op") == "submit" and isinstance(
                    obj.get("prompt"), list
                ):
                    submits[rid] = obj
                elif obj.get("op") == "done":
                    submits.pop(rid, None)
        if torn is not None:
            warnings.warn(
                f"{path}: skipping truncated trailing journal "
                f"line (crash mid-append): {torn[1][:60]!r}",
                stacklevel=2,
            )
        return list(submits.values()), max_rid

    @staticmethod
    def pending(path: str) -> list[dict]:
        return RequestJournal.scan(path)[0]

    @staticmethod
    def compact(path: str, entries: Optional[list] = None) -> None:
        """Atomic rewrite keeping only pending submits (tombstoned pairs
        and corrupt lines dropped; every surviving line crc-suffixed),
        through the tmp+fsync+rename protocol. Startup or offline
        maintenance ONLY — the os.replace swaps the inode out from under
        any live engine's open append handle. Pass `entries` (a prior
        scan's pending list) to skip the rescan the engine already did."""
        if not os.path.exists(path):
            return
        if entries is None:
            entries = RequestJournal.pending(path)
        from bigdl_tpu_torch.utils.durability import atomic_write

        def write(f) -> None:
            for e in entries:
                body = json.dumps(e, separators=(",", ":"))
                f.write((_crc_line(body) + "\n").encode("utf-8"))

        atomic_write(path, write)


def replay(engine, entries: list[dict]) -> list:
    """Re-submit unfinished journaled entries into `engine` (fresh
    rids, no streams), superseding each old entry with a tombstone the
    moment its replacement submit is recorded. No truncate-first window:
    a crash mid-replay leaves every not-yet-resubmitted entry pending
    for the NEXT recovery. The crash window between a replacement's
    submit record and the old tombstone yields at-least-once semantics
    (a later recovery may replay that request twice), never loss.
    Requires the engine's rid counter to be seeded past every journaled
    rid (the engine does this at journal attach) so old-rid tombstones
    cannot collide with fresh submissions."""
    j = getattr(engine, "_journal", None)
    out = []
    for e in entries:
        kwargs = {f: e[f] for f in _REPLAY_FIELDS if f in e}
        out.append(engine.submit(e["prompt"], **kwargs))
        if j is not None:
            j.record_done(e["rid"])  # superseded by the new record
    return out
