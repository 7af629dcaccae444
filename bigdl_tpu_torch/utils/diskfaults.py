"""Deterministic storage fault injection for on-disk artifacts (a copy
of bigdl_tpu/utils/diskfaults.py).

The disk twin of `serving/faults.py`: the detection and recovery paths
of the artifact-durability layer (utils/durability.py, convert/low_bit,
serving/adapters, serving/journal) run on the CPU under *injected*
storage faults. The injector shares FaultInjector's arm/disarm/fire
discipline — counted, optionally probabilistic from a seeded RNG,
replayable exactly.

Injection points (fired by `durability.atomic_write`):

==============  ===========================================================
point           effect when armed
==============  ===========================================================
``torn_rename``  the save crashes (``DiskFaultError``) after the tmp file
                 is fully written + fsynced but BEFORE the rename — the
                 SIGKILL-mid-save window. The tmp sibling is left on disk
                 (a killed process cleans nothing up); the prior artifact
                 must remain bit-identical and loadable.
``drop_file``    the rename never happens and the tmp is deleted — the
                 artifact silently never appears (lost write / dropped
                 dirent), driving the missing-file detection path.
``bit_flip``     one byte of the committed file is XOR-flipped after the
                 rename (storage rot). payload: ``offset=int`` pins the
                 position; default draws from the injector's seeded RNG.
``truncate``     the committed file is truncated after the rename (torn
                 storage). payload: ``keep=float`` fraction kept
                 (default 0.5) or ``keep_bytes=int``.
==============  ===========================================================

The post-commit corruptions (`bit_flip`/`truncate`) are also exposed as
plain helpers (:func:`flip_byte`, :func:`truncate_file`) so tests can
corrupt existing artifacts — e.g. journal lines — at exact offsets.
"""

from __future__ import annotations

import os
from typing import Optional

from bigdl_tpu_torch.serving.faults import FaultInjector

DISK_POINTS = ("bit_flip", "truncate", "torn_rename", "drop_file")


class DiskFaultError(RuntimeError):
    """Raised by an injected storage crash point (never by real code)."""


class DiskFaultInjector(FaultInjector):
    """Seedable storage-fault hook table (see module docstring)."""

    points = DISK_POINTS


class NullDiskFaultInjector(DiskFaultInjector):
    """Default for every save path: inert, arming forbidden (the shared
    module-level instance must stay a no-op)."""

    def arm(self, *a, **k):  # pragma: no cover - guard rail
        raise RuntimeError(
            "this is the shared no-op disk injector; construct your own "
            "DiskFaultInjector and pass it via faults="
        )

    def fire(self, point: str) -> Optional[dict]:
        return None


NULL_DISK_INJECTOR = NullDiskFaultInjector()


# ---------------------------------------------------------------------------
# corruption primitives (used by the injector AND directly by tests)
# ---------------------------------------------------------------------------

def flip_byte(path: str, offset: Optional[int] = None, *, bit: int = 0,
              rng=None) -> int:
    """XOR-flip one bit of one byte of `path` in place; returns the
    offset actually flipped. offset=None draws uniformly from `rng`
    (random.Random) — pass a seeded one for replayable corruption."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path}: empty file, nothing to flip")
    if offset is None:
        if rng is None:
            raise ValueError("flip_byte needs offset= or a seeded rng=")
        offset = rng.randrange(size)
    if not 0 <= offset < size:
        raise ValueError(f"offset {offset} outside file of {size} bytes")
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([b ^ (1 << (bit & 7))]))
    return offset


def truncate_file(path: str, keep: float = 0.5,
                  keep_bytes: Optional[int] = None) -> int:
    """Truncate `path` in place to `keep_bytes` (or a `keep` fraction of
    its current size); returns the new size."""
    size = os.path.getsize(path)
    new = keep_bytes if keep_bytes is not None else int(size * keep)
    new = max(0, min(new, size))
    with open(path, "r+b") as f:
        f.truncate(new)
    return new


def apply_post_commit(path: str, inj: DiskFaultInjector) -> None:
    """Fire the storage-rot points (`bit_flip`, `truncate`) against a
    just-committed file. Called by durability.atomic_write after the
    rename; corruption after the commit point models media decay, which
    the *load*-side verification must catch."""
    p = inj.fire("bit_flip")
    if p is not None:
        flip_byte(path, p.get("offset"), bit=p.get("bit", 0), rng=inj._rng)
    p = inj.fire("truncate")
    if p is not None:
        truncate_file(path, keep=p.get("keep", 0.5),
                      keep_bytes=p.get("keep_bytes"))
