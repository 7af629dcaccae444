"""Artifact durability for the port's npz artifacts: a copy of the npz
parts of bigdl_tpu/utils/durability.py, plus the dtype carry of
bigdl_tpu/train/checkpoint.py (`_encode` / `_decode`, here
`encode_array` / `decode_array`).

- **Integrity manifest**: per-tensor digests (crc32, sha256) of each
  serialized `.npy` zip member, with its byte size, shape and storage
  dtype, recorded at save time; loads verify in modes ``off | fast |
  full`` and raise a structured :class:`IntegrityError` naming every
  corrupted, missing or extra tensor. The same tree saved by either
  package gives the same member bytes, so the same manifest.
- **Atomic writes**: :func:`atomic_write` streams into a ``tmp-<pid>``
  sibling, fsyncs, renames over the target and fsyncs the directory; a
  kill at any instant leaves the old file or the complete new one. Its
  `faults=` (a `utils/diskfaults.DiskFaultInjector`) injects the storage
  faults the load side must detect.
- **Dtypes numpy lacks**: bf16 and fp8 leaves cross an npz as their
  unsigned-integer bit view, with the dtype's name kept in the
  artifact's meta. The port decodes them with `torch` views (it has no
  ml_dtypes).

- **Numerical validation and reports**: `validate_numerics` (NaN/inf in
  float tensors, per-qtype scale ranges) behind ``verify="full"``, and
  the per-tensor `VerifyReport` of `convert.low_bit.verify_low_bit`.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import io
import os
import threading
import zipfile
import zlib
from typing import Callable, Optional

import numpy as np
import torch

VERIFY_MODES = ("off", "fast", "full")


def check_verify_mode(mode: str) -> str:
    if mode not in VERIFY_MODES:
        raise ValueError(f"verify mode {mode!r} not in {VERIFY_MODES}")
    return mode


class _Counter:
    """Process-wide thread-safe counter."""

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n


# every IntegrityError raised by a loader bumps this
VERIFY_FAILURES = _Counter()


class IntegrityError(ValueError):
    """An artifact failed integrity verification, naming every offending
    tensor: ``corrupted`` {name: reason}, ``missing`` (listed in the
    manifest, absent from the file), ``extra`` (present, not listed) and
    an artifact-level ``detail``."""

    def __init__(self, path: str, *, corrupted: Optional[dict] = None,
                 missing=(), extra=(), detail: Optional[str] = None):
        self.path = path
        self.corrupted = dict(corrupted or {})
        self.missing = sorted(missing)
        self.extra = sorted(extra)
        self.detail = detail
        parts = []
        if detail:
            parts.append(detail)
        if self.corrupted:
            parts.append("corrupted: " + "; ".join(
                f"{k} ({v})" for k, v in sorted(self.corrupted.items())))
        if self.missing:
            parts.append(f"missing: {', '.join(self.missing)}")
        if self.extra:
            parts.append(f"extra: {', '.join(self.extra)}")
        super().__init__(f"{path}: integrity check failed — " + " | ".join(parts))


# ---------------------------------------------------------------------------
# dtypes numpy lacks
# ---------------------------------------------------------------------------

# stored as the same-width unsigned view (bigdl_tpu/convert/low_bit.py)
_VIEW_DTYPES = {"bfloat16": (np.uint16, torch.int16),
                "float8_e4m3fn": (np.uint8, torch.uint8),
                "float8_e5m2": (np.uint8, torch.uint8)}


def encode_array(arr) -> tuple[np.ndarray, str]:
    """A torch tensor or numpy array as (stored numpy array, dtype name):
    bf16 and fp8 as their unsigned bit view, every other dtype as is."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        name = str(t.dtype).split(".")[-1]
        if name in _VIEW_DTYPES:
            store, same_width = _VIEW_DTYPES[name]
            return t.view(same_width).numpy().view(store), name
        return t.numpy(), name
    a = np.asarray(arr)
    return a, a.dtype.name


def decode_array(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The inverse of `encode_array`: a CPU tensor of the logical dtype."""
    # np.ascontiguousarray makes a 0-d array 1-d: keep the stored shape
    if dtype_name in _VIEW_DTYPES:
        _, same_width = _VIEW_DTYPES[dtype_name]
        bits = torch.from_numpy(np.ascontiguousarray(a).view(
            np.int16 if same_width == torch.int16 else np.uint8))
        return bits.view(getattr(torch, dtype_name)).reshape(a.shape)
    return torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape)


# ---------------------------------------------------------------------------
# digests
# ---------------------------------------------------------------------------

def crc32_hex(data) -> str:
    return f"{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def add_npz_member(zf: "zipfile.ZipFile", key: str, a) -> dict:
    """Serialize one array into an open (uncompressed) npz zip and return
    its integrity entry; the digests cover the serialized `.npy` member
    bytes, exactly what the zip stores, so `fast` verification compares
    the zip directory's crc32 with the manifest at no extra read."""
    b = np.asanyarray(a)
    buf = io.BytesIO()
    np.lib.format.write_array(buf, b, allow_pickle=False)
    raw = buf.getvalue()
    zf.writestr(key + ".npy", raw)
    return {
        "crc32": crc32_hex(raw),
        "sha256": hashlib.sha256(raw).hexdigest(),
        "nbytes": len(raw),
        "shape": list(b.shape),
        "dtype": b.dtype.name,
    }


def write_npz(f, arrays: dict) -> dict:
    """Write `arrays` as an uncompressed .npz (np.load-compatible) to the
    open file `f`, one member at a time; returns the `tensors` map."""
    tensors = {}
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as zf:
        for k in sorted(arrays):
            tensors[k] = add_npz_member(zf, k, arrays[k])
    return tensors


def integrity_section(tensors: dict) -> dict:
    """The `integrity` section saved into an artifact's metadata."""
    return {"version": 1, "scheme": "npy-member", "tensors": tensors}


def verify_npz_members(path: str, integrity: Optional[dict], mode: str,
                       expected, ignore=frozenset()):
    """Read and verify every expected member of an .npz. Returns (arrays,
    corrupted, missing, extra); raises IntegrityError only when the file
    is no readable zip. Every mode checks structure and the zip layer's
    own payload crc during the read; ``fast`` adds the zip directory's
    crc32 and size against the manifest and the decoded shape and dtype;
    ``full`` adds a sha256 over the member bytes. `integrity` is the saved
    {name: entry} map (None: digest checks skip); `ignore` names members
    exempt from the expected/extra accounting."""
    expected = set(expected)
    try:
        zf = zipfile.ZipFile(path)
    except Exception as e:  # any unreadable archive is one structured error
        VERIFY_FAILURES.inc()
        raise IntegrityError(
            path, detail=f"unreadable archive: {type(e).__name__}: {e}") from e
    corrupted: dict = {}
    arrays: dict = {}
    with zf:
        infos = {}
        for i in zf.infolist():
            nm = i.filename
            infos[nm[:-4] if nm.endswith(".npy") else nm] = i
        missing = sorted(expected - infos.keys())
        extra = sorted(infos.keys() - expected - set(ignore))
        for key in sorted(expected & infos.keys()):
            info = infos[key]
            entry = integrity.get(key) if integrity else None
            if mode != "off" and integrity is not None:
                if entry is None:
                    corrupted[key] = "not in integrity manifest"
                    continue
                if info.file_size != entry["nbytes"]:
                    corrupted[key] = f"{info.file_size} bytes != recorded {entry['nbytes']}"
                    continue
                if f"{info.CRC & 0xFFFFFFFF:08x}" != entry["crc32"]:
                    corrupted[key] = "crc32 mismatch (zip directory vs manifest)"
                    continue
            try:
                # zipfile checks the payload against the member crc here
                raw = zf.read(info)
            except Exception as e:  # a rotted member is reported, not raised
                corrupted[key] = f"unreadable ({type(e).__name__}: {e})"
                continue
            if mode == "full" and entry is not None:
                if hashlib.sha256(raw).hexdigest() != entry["sha256"]:
                    corrupted[key] = "sha256 mismatch"
                    continue
            try:
                a = np.lib.format.read_array(io.BytesIO(raw), allow_pickle=False)
            except Exception as e:  # a rotted header is reported, not raised
                corrupted[key] = f"undecodable npy ({type(e).__name__}: {e})"
                continue
            if mode != "off" and entry is not None:
                if list(a.shape) != list(entry["shape"]):
                    corrupted[key] = f"shape {list(a.shape)} != recorded {entry['shape']}"
                    continue
                if a.dtype.name != entry["dtype"]:
                    corrupted[key] = f"dtype {a.dtype.name} != recorded {entry['dtype']}"
                    continue
            arrays[key] = a
    return arrays, corrupted, missing, extra


# ---------------------------------------------------------------------------
# numerical validation
# ---------------------------------------------------------------------------

# storage dtypes worth a non-finite scan (manifest `dtype` names)
FLOAT_DTYPES = ("float16", "float32", "float64", "bfloat16",
                "float8_e4m3fn", "float8_e5m2")


@dataclasses.dataclass
class Finding:
    tensor: str
    issue: str  # "non_finite" | "scale_range"
    detail: str


# per-qtype plausibility ceiling for |scale|: block scales are a block's
# absmax over the format's largest code, so for the formats this package
# quantizes a magnitude in the tens of thousands means scrambled fp16
# bytes, not a big model. Unlisted qtypes get a conservative default.
_SCALE_MAX_DEFAULT = 1e6
_SCALE_MAX = {q: 1e4 for q in (
    "sym_int4", "asym_int4", "sym_int5", "asym_int5", "sym_int8",
    "nf4", "nf3", "fp4", "fp6", "fp8_e4m3", "fp8_e5m2",
    "q2_k", "q3_k", "q4_k", "q5_k", "q6_k",
)}


def scale_bound(qtype: Optional[str]) -> float:
    return _SCALE_MAX.get(qtype, _SCALE_MAX_DEFAULT)


def _stored_to_f32(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array as float32 on the CPU (bf16/fp8 bit views decoded)."""
    return decode_array(a, dtype_name).float()


def scan_non_finite(a: np.ndarray, dtype_name: str) -> Optional[str]:
    """NaN/inf scan of one stored array (bf16/fp8 bit views decoded).
    Returns a detail like '3 NaN / 0 inf of 4096 values', or None when
    clean or not a float storage dtype."""
    if dtype_name not in FLOAT_DTYPES:
        return None
    x = _stored_to_f32(a, dtype_name)
    n_nan = int(torch.isnan(x).sum())
    n_inf = int(torch.isinf(x).sum())
    if n_nan or n_inf:
        return f"{n_nan} NaN / {n_inf} inf of {x.numel()} values"
    return None


def validate_numerics(arrays: dict, manifest: dict) -> list:
    """NaN/inf scan of float tensors (dense leaves, scales, mins) plus
    scale-range sanity per qtype. `manifest` is the low-bit manifest
    (path -> {kind, dtype[, qtype]}), `arrays` the stored numpy arrays
    keyed the same way. Returns a list of Findings (empty: healthy)."""
    findings: list[Finding] = []
    for key in sorted(arrays):
        info = manifest.get(key)
        if info is None or info.get("kind") != "array":
            continue
        dt = info["dtype"]
        if dt not in FLOAT_DTYPES:
            continue
        detail = scan_non_finite(arrays[key], dt)
        if detail is not None:
            findings.append(Finding(key, "non_finite", detail))
            continue
        if key.endswith("@scales"):
            parent = key[: -len("@scales")]
            qtype = (manifest.get(parent) or {}).get("qtype")
            x = _stored_to_f32(arrays[key], dt)
            amax = float(x.abs().max()) if x.numel() else 0.0
            bound = scale_bound(qtype)
            if amax > bound:
                findings.append(Finding(
                    key, "scale_range",
                    f"|scale| max {amax:.3g} exceeds {bound:.0e} for qtype {qtype}"))
    return findings


# ---------------------------------------------------------------------------
# per-tensor verification report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TensorReport:
    name: str
    status: str  # "ok" | "corrupt" | "missing" | "extra" | "numerics"
    detail: str = ""


@dataclasses.dataclass
class VerifyReport:
    path: str
    kind: str  # "low_bit" | "train"
    rows: list
    detail: Optional[str] = None  # artifact-level failure

    @property
    def ok(self) -> bool:
        return self.detail is None and all(r.status == "ok" for r in self.rows)

    def format(self) -> str:
        lines = [f"{self.path} [{self.kind}]"]
        if self.detail:
            lines.append(f"  ARTIFACT {self.detail}")
        width = max((len(r.name) for r in self.rows), default=0)
        n_bad = 0
        for r in sorted(self.rows, key=lambda r: (r.status == "ok", r.name)):
            if r.status == "ok":
                continue
            n_bad += 1
            lines.append(f"  {r.status.upper():8s} {r.name:<{width}s}  {r.detail}")
        lines.append(f"  {len(self.rows) - n_bad}/{len(self.rows)} tensors ok"
                     + ("" if self.ok else f", {n_bad} findings"))
        return "\n".join(lines)


def rows_from_error(err: IntegrityError) -> list:
    rows = [TensorReport(k, "corrupt", v) for k, v in err.corrupted.items()]
    rows += [TensorReport(k, "missing", "listed in manifest, absent from file")
             for k in err.missing]
    rows += [TensorReport(k, "extra", "present in file, absent from manifest")
             for k in err.extra]
    return rows


# ---------------------------------------------------------------------------
# atomic write protocol
# ---------------------------------------------------------------------------

def clean_stale_tmps(path: str) -> list:
    """Remove `path`.tmp-* siblings left by earlier killed saves."""
    removed = []
    for tmp in glob.glob(glob.escape(path) + ".tmp-*"):
        try:
            os.unlink(tmp)
            removed.append(tmp)
        except OSError:  # a racing cleanup already took it
            pass
    return removed


def _fsync_dir(path: str) -> None:
    """fsync the containing directory so the rename itself is durable."""
    d = os.path.dirname(os.path.abspath(path))
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:  # filesystems that refuse to open a directory
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path: str, writer: Callable, *, faults=None) -> None:
    """Crash-safe file replacement: `writer(f)` streams the payload into a
    ``tmp-<pid>`` sibling, which is flushed, fsynced and renamed over
    `path`, then the directory is fsynced.

    `faults` (utils/diskfaults.DiskFaultInjector) drives the injected
    failure modes: ``torn_rename`` raises DiskFaultError before the rename
    with the tmp left behind (a simulated kill, deliberately not cleaned
    up), ``drop_file`` discards the write, ``bit_flip``/``truncate``
    corrupt the committed file after the rename (storage rot)."""
    from bigdl_tpu_torch.utils.diskfaults import (NULL_DISK_INJECTOR, DiskFaultError,
                                                  apply_post_commit)

    inj = faults if faults is not None else NULL_DISK_INJECTOR
    clean_stale_tmps(path)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        if inj.fire("torn_rename") is not None:
            # a kill between fsync and rename: the tmp stays on disk as a
            # real SIGKILL would leave it
            raise DiskFaultError(f"torn_rename injected before {path}")
        if inj.fire("drop_file") is not None:
            os.unlink(tmp)
            return
        os.replace(tmp, path)
    except DiskFaultError:
        raise
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    _fsync_dir(path)
    apply_post_commit(path, inj)
