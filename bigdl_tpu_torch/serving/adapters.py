"""Multi-tenant LoRA adapter serving (port of bigdl_tpu/serving/adapters.py).

The base model stays quantized and shared; a request may name a LoRA
adapter, which the engine applies unquantized on top of the base's fused
dequant matmul (`ops/linear.py`: the LoRA GEMV in decode steps, the LoRA
GEMM in prefills, or the plain epilogue where the width is past JAX's
eligibility rule), never merged into the base.

- **Artifact I/O**: `save_adapter` / `load_adapter` write and read one
  .npz per adapter with a per-tensor integrity manifest
  (`utils/durability.py`), committed atomically. The bytes and the meta
  are the JAX package's: either package loads what the other saved.
- **`AdapterRegistry`**: named adapters resident in host RAM under a byte
  budget, LRU on every hit, refcounted (each request holding an adapter
  carries one reference; eviction touches only refcount-0, unpinned
  entries), reloaded by name after an eviction. The operator calls
  behind the HTTP layer's `/adapters` endpoints: `load`, `unload` (refused
  while a request holds the adapter), `pin`, and `peek` (no side effects).
- **`AdapterPager`**: device residency of resident adapters' (A, B)
  leaves in pages of the engine's KV `PagePool` (`kvpaged.AdapterPageStore`):
  page-in at admission, LRU page-out of holder-free adapters under page
  pressure, one device budget for KV and adapters.
- **`rank_bucket`**: a batch's adapters pad their rank up a power-of-two
  ladder; zero rows of A and columns of B add exactly 0.

Fault points (`serving/faults.py`): ``adapter_load_corrupt`` fails the
registry's next load as a corrupt artifact, ``adapter_page_in_stall`` the
pager's next page-in; either quarantines the one request naming the
tenant. With a tracer the registry records ``adapter_load``,
``adapter_unload`` and ``adapter_evict`` instants on the engine track.

One change from JAX: the pager keys a page-in by the registry entry, not
only its name. An operator's unload and reload of a name (a new artifact
under the old name) gives a new entry, so the next admission pages the
new weights in; JAX's pager would serve the old pages. The old pages go
back to the pool then, or at the next page-out.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
import zipfile
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.serving.faults import NULL_INJECTOR
from bigdl_tpu_torch.utils import durability
from bigdl_tpu_torch.utils.durability import IntegrityError

FORMAT_VERSION = 1

# registry default: adapters above this rank are refused at load
DEFAULT_MAX_RANK = 64


def rank_bucket(rank: int) -> int:
    """Smallest power of two >= rank, at least 4 (ranks 1-4 share one)."""
    b = 4
    while b < rank:
        b *= 2
    return b


def _tree(lora) -> tuple[dict, object]:
    """(layers {target: {"a", "b"}}, scale) of a dict tree or a
    `train.qlora.LoRA`."""
    if isinstance(lora, dict):
        return lora["layers"], lora["scale"]
    return lora.layers, lora.scale


def _nbytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(np.asarray(a).nbytes)


def lora_nbytes(lora) -> int:
    """Host bytes of a LoRA tree's weight leaves: the size the registry
    budgets, evicts on and reports."""
    layers, _ = _tree(lora)
    return sum(_nbytes(pair[leaf]) for pair in layers.values() for leaf in ("a", "b"))


class AdapterError(ValueError):
    """Structured adapter failure; `kind` is one of ``missing``,
    ``corrupt``, ``rank_mismatch`` (shape or rank against the serving
    model, or over the registry's cap), ``busy`` (unload under
    references) and ``budget`` (no room after evicting every evictable
    entry)."""

    def __init__(self, name: str, kind: str, detail: str = ""):
        self.name = name
        self.kind = kind
        self.detail = detail
        super().__init__(f"adapter {name!r}: {kind}" + (f" — {detail}" if detail else ""))


# ---------------------------------------------------------------------------
# artifact I/O
# ---------------------------------------------------------------------------

def save_adapter(path: str, lora, *, faults=None) -> None:
    """Write a LoRA tree ({'layers': {target: {'a', 'b'}}, 'scale'}, or a
    `train.qlora.LoRA`) as one verifiable .npz: per-tensor digests in the
    meta member, atomic commit (`faults`: a DiskFaultInjector for it)."""
    layers, scale = _tree(lora)
    arrays: dict = {}
    dtypes: dict = {}
    rank = None
    for t in sorted(layers):
        pair = layers[t]
        a, b = pair["a"], pair["b"]
        if a.ndim != 3 or b.ndim != 3 or a.shape[1] != b.shape[2]:
            raise AdapterError(
                os.path.basename(path), "rank_mismatch",
                f"target {t}: a {tuple(a.shape)} / b {tuple(b.shape)} are not "
                "[L, r, in] / [L, out, r] with one shared rank")
        if rank is None:
            rank = a.shape[1]
        elif a.shape[1] != rank:
            raise AdapterError(os.path.basename(path), "rank_mismatch",
                               f"target {t} rank {a.shape[1]} != {rank} (one rank "
                               "per adapter)")
        for leaf in ("a", "b"):
            enc, dt = durability.encode_array(pair[leaf])
            arrays[f"layers/{t}/{leaf}"] = enc
            dtypes[f"layers/{t}/{leaf}"] = dt
    if isinstance(scale, torch.Tensor):
        scale = scale.detach().float().cpu().item()
    scale = float(np.asarray(scale, np.float32))

    def write(f) -> None:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as zf:
            tensors = {k: durability.add_npz_member(zf, k, arrays[k]) for k in sorted(arrays)}
            meta = {
                "format_version": FORMAT_VERSION,
                "rank": int(rank or 0),
                "scale": scale,
                "targets": sorted(layers),
                "dtypes": dtypes,
                "integrity": durability.integrity_section(tensors),
            }
            durability.add_npz_member(zf, "meta", np.asarray(json.dumps(meta)))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    durability.atomic_write(path, write, faults=faults)


def load_adapter(path: str, verify: str = "fast") -> tuple[dict, dict]:
    """Read and verify one adapter artifact -> (lora tree with CPU tensors
    of the stored dtypes, meta). verify: off|fast|full. Raises
    FileNotFoundError for an absent file and IntegrityError for a damaged
    one; the registry wraps both into AdapterError."""
    durability.check_verify_mode(verify)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path, allow_pickle=False) as npz:
            meta = json.loads(str(npz["meta"]))
    except Exception as e:  # any unreadable file is one structured error
        durability.VERIFY_FAILURES.inc()
        raise IntegrityError(path, detail=f"unreadable adapter: {type(e).__name__}: {e}") from e
    if meta.get("format_version") != FORMAT_VERSION:
        durability.VERIFY_FAILURES.inc()
        raise IntegrityError(path, detail=f"unsupported adapter format_version "
                                          f"{meta.get('format_version')!r} (rotted meta?)")
    targets = meta.get("targets") or []
    dtypes = meta.get("dtypes") or {}
    expected = [f"layers/{t}/{leaf}" for t in targets for leaf in ("a", "b")]
    integrity = (meta.get("integrity") or {}).get("tensors")
    arrays, corrupted, missing, extra = durability.verify_npz_members(
        path, integrity, verify, expected, ignore={"meta"})
    if verify == "full":
        for k in expected:
            if k not in arrays:
                continue
            detail = durability.scan_non_finite(arrays[k], dtypes.get(k, ""))
            if detail is not None:
                corrupted[k] = f"non_finite: {detail}"
                arrays.pop(k)
    if corrupted or missing or extra:
        durability.VERIFY_FAILURES.inc()
        raise IntegrityError(path, corrupted=corrupted, missing=missing, extra=extra)
    layers = {t: {leaf: durability.decode_array(arrays[f"layers/{t}/{leaf}"],
                                                dtypes.get(f"layers/{t}/{leaf}", "float32"))
                  for leaf in ("a", "b")}
              for t in targets}
    return {"layers": layers, "scale": float(meta.get("scale", 1.0))}, meta


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class AdapterEntry:
    """One resident adapter: host (CPU) weights and the rank-padded trees
    the engine's prefills feed to the model, cached per (bucket, device).
    The registry owns `refcount`; each holder carries one."""

    __slots__ = ("name", "path", "layers", "scale", "rank", "alpha", "targets",
                 "nbytes", "pinned", "refcount", "_trees")

    def __init__(self, name: str, path: Optional[str], lora: dict, meta: dict,
                 pinned: bool = False):
        self.name = name
        self.path = path
        self.layers = lora["layers"]
        self.scale = float(lora["scale"])
        self.rank = int(meta.get("rank", 0))
        self.alpha = self.scale * max(self.rank, 1)
        self.targets = tuple(sorted(self.layers))
        self.nbytes = lora_nbytes(lora)
        self.pinned = pinned
        self.refcount = 0
        self._trees: dict = {}

    def tree(self, bucket: Optional[int] = None, device=None) -> dict:
        """The single-request tree at `bucket` rank (default: this
        adapter's own bucket) on `device` (the card unless told), A
        zero-padded on rank rows and B on rank columns, the scale f32."""
        rb = rank_bucket(self.rank) if bucket is None else bucket
        dev = torch.device("cuda" if device is None else device)
        key = (rb, str(dev))
        if key not in self._trees:
            pad = rb - self.rank
            layers = {t: {"a": F.pad(pair["a"].to(dev), (0, 0, 0, pad)),
                          "b": F.pad(pair["b"].to(dev), (0, pad))}
                      for t, pair in self.layers.items()}
            self._trees[key] = {"layers": layers, "scale": torch.tensor(
                self.scale, dtype=torch.float32, device=dev)}
        return self._trees[key]

    def describe(self) -> dict:
        return {"name": self.name, "rank": self.rank, "alpha": self.alpha,
                "targets": list(self.targets), "nbytes": self.nbytes,
                "pinned": self.pinned, "refcount": self.refcount}


class AdapterRegistry:
    """Named LoRA adapters resident in host RAM under `budget_bytes`.

    Thread-safe (an RLock): operators load, unload and pin while the
    engine acquires and releases per request. LRU order is an OrderedDict
    (`move_to_end` on every hit); eviction takes the least recently used
    entry that no request references and no operator pinned. An evicted
    name keeps its path, so the next request naming it reloads it."""

    def __init__(self, dir: Optional[str] = None, budget_bytes: Optional[int] = None,
                 verify: str = "fast", max_rank: int = DEFAULT_MAX_RANK,
                 faults=None, tracer=None, clock: Callable[[], float] = time.time):
        self.dir = dir
        self.budget_bytes = budget_bytes
        self.verify = durability.check_verify_mode(verify)
        self.max_rank = max_rank
        self._faults = faults if faults is not None else NULL_INJECTOR
        self.tracer = tracer
        self._clock = clock
        self._lock = threading.RLock()
        # name -> entry, least recently used first
        self._entries: "collections.OrderedDict[str, AdapterEntry]" = collections.OrderedDict()
        self._paths: dict[str, str] = {}  # every name ever loaded
        self.loads = 0  # artifact reads, reloads after eviction included
        self.hits = 0  # get() served from residency
        self.evictions = 0  # budget-pressure drops
        self.load_failures = 0  # missing, corrupt or mismatched artifacts

    def bind(self, tracer=None, clock=None, faults=None) -> "AdapterRegistry":
        """Late wiring for a server that makes its tracer, clock and fault
        injector after the registry. An injector the registry was made
        with is kept: the server's fills only the inert default."""
        if tracer is not None:
            self.tracer = tracer
        if clock is not None:
            self._clock = clock
        if faults is not None and self._faults is NULL_INJECTOR:
            self._faults = faults
        return self

    # -- internals (call with the lock held) --------------------------------

    def _instant(self, event: str, **args) -> None:
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.instant(event, ts=self._clock(), tid=0, cat="adapter", **args)

    def _resolve_path(self, name: str, path: Optional[str]) -> str:
        if path is not None:
            return path
        if name in self._paths:
            return self._paths[name]
        if self.dir is not None:
            for cand in (os.path.join(self.dir, f"{name}.npz"), os.path.join(self.dir, name)):
                if os.path.exists(cand):
                    return cand
        raise AdapterError(name, "missing", "not resident and no artifact path known"
                           + (f" under {self.dir}" if self.dir else
                              " (no adapter dir configured)"))

    def _resident_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    def _evict_for(self, name: str, nbytes: int) -> None:
        """Free budget room for `nbytes`, LRU first, refcount-0 and
        unpinned entries only."""
        if self.budget_bytes is None:
            return
        while self._resident_bytes() + nbytes > self.budget_bytes:
            victim = next((e for e in self._entries.values()
                           if e.refcount == 0 and not e.pinned), None)
            if victim is None:
                raise AdapterError(name, "budget",
                                   f"{nbytes} bytes over budget {self.budget_bytes} and "
                                   "every resident adapter is referenced or pinned")
            del self._entries[victim.name]
            self.evictions += 1
            self._instant("adapter_evict", name=victim.name, nbytes=victim.nbytes)

    def _load_locked(self, name: str, path: Optional[str], pin: bool) -> AdapterEntry:
        resolved = self._resolve_path(name, path)
        t0 = self._clock()
        if self._faults.fire("adapter_load_corrupt") is not None:
            self.load_failures += 1
            raise AdapterError(name, "corrupt", f"injected corrupt artifact ({resolved}; "
                               "fault point adapter_load_corrupt)")
        try:
            lora, meta = load_adapter(resolved, verify=self.verify)
        except FileNotFoundError as e:
            self.load_failures += 1
            raise AdapterError(name, "missing", str(e)) from e
        except IntegrityError as e:
            self.load_failures += 1
            raise AdapterError(name, "corrupt", str(e)) from e
        entry = AdapterEntry(name, resolved, lora, meta, pinned=pin)
        if entry.rank < 1 or entry.rank > self.max_rank:
            self.load_failures += 1
            raise AdapterError(name, "rank_mismatch", f"rank {entry.rank} outside "
                               f"[1, {self.max_rank}] (registry max_rank)")
        self._evict_for(name, entry.nbytes)
        self._entries[name] = entry  # most recently used
        self._paths[name] = resolved
        self.loads += 1
        self._instant("adapter_load", name=name, rank=entry.rank, nbytes=entry.nbytes,
                      seconds=round(self._clock() - t0, 6))
        return entry

    # -- operator surface ----------------------------------------------------

    def load(self, name: str, path: Optional[str] = None, pin: bool = False) -> dict:
        """Load (or reload) an adapter into residency; returns its
        description. A failed reload keeps the healthy resident entry."""
        with self._lock:
            old = self._entries.get(name)
            if old is not None and old.refcount > 0:
                raise AdapterError(name, "busy", f"{old.refcount} in-flight request(s) "
                                   "hold it; unload requires refcount 0")
            if old is not None:
                del self._entries[name]
            try:
                entry = self._load_locked(name, path, pin)
            except Exception:
                if old is not None:
                    self._entries[name] = old  # restore, most recently used
                raise
            return entry.describe()

    def unload(self, name: str) -> dict:
        """Drop an adapter from residency (its path stays known, so a later
        request reloads it). Refused ("busy") while a request holds it."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise AdapterError(name, "missing", "not resident")
            if entry.refcount > 0:
                raise AdapterError(name, "busy",
                                   f"{entry.refcount} in-flight request(s) hold it")
            del self._entries[name]
            self._instant("adapter_unload", name=name)
            return entry.describe()

    def pin(self, name: str, pinned: bool = True) -> dict:
        with self._lock:
            entry = self._entries.get(name)
            if entry is None:
                raise AdapterError(name, "missing", "not resident")
            entry.pinned = pinned
            return entry.describe()

    # -- engine surface ------------------------------------------------------

    def get(self, name: str) -> AdapterEntry:
        """The entry for `name`, LRU-refreshed; reloads an evicted (or, with
        `dir`, a never-loaded) adapter."""
        with self._lock:
            entry = self._entries.get(name)
            if entry is not None:
                self._entries.move_to_end(name)
                self.hits += 1
                return entry
            return self._load_locked(name, None, pin=False)

    def acquire(self, name: str) -> AdapterEntry:
        """get() plus one reference, held until release()."""
        with self._lock:
            entry = self.get(name)
            entry.refcount += 1
            return entry

    def release(self, entry: AdapterEntry) -> None:
        with self._lock:
            entry.refcount -= 1
            if entry.refcount < 0:  # a double release, caught at its site
                raise AssertionError(f"adapter {entry.name!r} refcount went negative")

    def reject(self, entry: AdapterEntry, held: bool = True) -> None:
        """Release (when held) and drop an entry the caller found unusable
        against its model; counted as a load failure."""
        with self._lock:
            if held:
                self.release(entry)
            self.load_failures += 1
            if self._entries.get(entry.name) is entry and entry.refcount == 0:
                del self._entries[entry.name]
                self._instant("adapter_evict", name=entry.name, nbytes=entry.nbytes,
                              rejected=True)

    def peek(self, name: str) -> Optional[AdapterEntry]:
        """The resident entry for `name`, with no side effects: no LRU
        refresh, no hit count, no reload (validation must not skew the
        counters traffic is measured by)."""
        with self._lock:
            return self._entries.get(name)

    # -- observability -------------------------------------------------------

    def resident(self) -> list:
        with self._lock:
            return [e.describe() for e in self._entries.values()]

    def stats(self) -> dict:
        with self._lock:
            return {"loads": self.loads, "hits": self.hits, "evictions": self.evictions,
                    "load_failures": self.load_failures, "resident": len(self._entries),
                    "resident_bytes": self._resident_bytes(),
                    "budget_bytes": self.budget_bytes}


# ---------------------------------------------------------------------------
# unified paging: adapter weights in the KV page pool
# ---------------------------------------------------------------------------

class _PagedAdapter:
    """One device-resident adapter: its pages (each carrying the pager's
    one PagePool reference), the leaf shapes that rebuild (A, B) from the
    flat page frame, and the rids holding it resident."""

    __slots__ = ("name", "entry", "pages", "shapes", "n_elems", "holders")

    def __init__(self, name, entry, pages, shapes, n_elems):
        self.name = name
        self.entry = entry  # the registry entry whose weights the pages hold
        self.pages = pages
        self.shapes = shapes
        self.n_elems = n_elems
        self.holders: set = set()


class AdapterPager:
    """Device residency of resident adapters' (A, B) leaves, in pages of
    the engine's KV `PagePool`. Engine thread only.

    - page-in (`ensure`): the entry's host leaves at its own rank, flat,
      into pages from the engine's allocator (free list, then radix
      eviction, then other adapters' page-out); a pool that stays dry is
      no error: the engine gathers that adapter from host RAM instead;
    - page-out (`evict_one`): the least recently used holder-free adapter
      gives its pages back; its host copy in the registry survives;
    - the scale stays host-side; only the bf16 leaves are paged, so a
      gather from pages equals one from host RAM bit for bit."""

    def __init__(self, store, pool, alloc: Callable[[], Optional[int]], faults=None):
        self.store = store
        self._pool = pool
        self._alloc = alloc
        self._faults = faults if faults is not None else NULL_INJECTOR
        # name -> _PagedAdapter, least recently used first
        self._res: "collections.OrderedDict[str, _PagedAdapter]" = collections.OrderedDict()
        self.page_ins = 0  # pages written device-ward
        self.page_outs = 0  # pages given back to the free list

    @property
    def pages_resident(self) -> int:
        return sum(len(r.pages) for r in self._res.values())

    def held_pages(self):
        for rec in self._res.values():
            yield from rec.pages

    def ensure(self, entry: AdapterEntry, rid: int) -> bool:
        """Make `entry` device-resident and add `rid`'s hold. False: the
        pool stayed dry (the caller gathers from host RAM). Raises
        AdapterError(kind="page_in_stall") when that fault point fires:
        the caller quarantines the one request, never the batch."""
        rec = self._res.get(entry.name)
        if rec is not None and rec.entry is not entry and not rec.holders:
            # the name was unloaded and reloaded: its pages hold the old weights
            self._drop(rec)
            rec = None
        if rec is not None:
            self._res.move_to_end(entry.name)
            rec.holders.add(rid)
            return True
        if self._faults.fire("adapter_page_in_stall") is not None:
            raise AdapterError(entry.name, "page_in_stall", "injected device page-in stall "
                               "(fault point adapter_page_in_stall)")
        flats, shapes = [], []
        for t in entry.targets:
            for leaf in ("a", "b"):
                arr = entry.layers[t][leaf]
                shapes.append((t, leaf, tuple(arr.shape)))
                flats.append(arr.reshape(-1).to(torch.bfloat16))  # the store's type
        flat = torch.cat(flats) if flats else torch.zeros((0,), dtype=torch.bfloat16)
        pages: list = []
        for _ in range(self.store.n_for(flat.numel())):
            pg = self._alloc()
            if pg is None:  # dry after eviction: give the pages back
                for p in pages:
                    self._pool.decref(p)
                return False
            pages.append(pg)
        try:
            self.store.write(pages, flat)
        except BaseException:
            # nothing holds the fresh pages yet: return them before raising
            for p in pages:
                self._pool.decref(p)
            raise
        self.page_ins += len(pages)
        rec = _PagedAdapter(entry.name, entry, pages, shapes, flat.numel())
        rec.holders.add(rid)
        self._res[entry.name] = rec
        return True

    def leaves(self, name: str) -> Optional[dict]:
        """{target: {'a', 'b'}} bf16 device views of a resident adapter
        (LRU-refreshed), or None."""
        rec = self._res.get(name)
        if rec is None:
            return None
        self._res.move_to_end(name)
        flat = self.store.read(rec.pages, rec.n_elems)
        out: dict = {}
        off = 0
        for t, leaf, shape in rec.shapes:
            n = int(np.prod(shape))
            out.setdefault(t, {})[leaf] = flat[off:off + n].view(shape)
            off += n
        return out

    def drop_holder(self, rid: int) -> None:
        """Release `rid`'s holds; the adapter stays resident (warm reuse)
        until page pressure evicts it."""
        for rec in self._res.values():
            rec.holders.discard(rid)

    def evict_one(self) -> bool:
        """Page out the least recently used holder-free adapter; False
        when every resident adapter is held."""
        victim = next((r for r in self._res.values() if not r.holders), None)
        if victim is None:
            return False
        self._drop(victim)
        return True

    def _drop(self, rec: _PagedAdapter) -> None:
        for pg in rec.pages:
            self._pool.decref(pg)
        self.page_outs += len(rec.pages)
        del self._res[rec.name]

    def reset(self, pool) -> None:
        """After the engine rebuilt its pool: forget residency (the old
        pool's pages are gone) and take the new pool."""
        self._pool = pool
        self._res.clear()
