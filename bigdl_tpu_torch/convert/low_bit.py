"""save_low_bit / load_low_bit / verify_low_bit: the JAX package's
low-bit artifact (bigdl_tpu/convert/low_bit.py), read and written by the
port. An artifact means the same weights in both packages: either writes
it, either reads it.

    bigdl_tpu_config.json   {format_version, qtype, model_config,
                             manifest, weights_file, integrity}
    weights.npz             flat arrays; bf16/fp8 stored as integer views
                            (weights-<token>.npz after an overwrite)

The keys are `convert/from_jax.py`'s: `params_to_numpy` flattens the
port's model for the save, `params_from_numpy` rebuilds it on the load,
in the fused or the unfused layout. Both files go through the atomic
write (utils/durability.py): the config's rename is the one commit
point, and superseded weight archives are swept only after it landed.
Loads verify per-tensor digests (`verify="off" | "fast" | "full"`, the
last with NaN/inf and scale-range checks) and raise an IntegrityError
naming every bad tensor; `salvage=True` returns the valid subset and the
report instead.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import warnings
from typing import Optional

from bigdl_tpu_torch.convert.from_jax import params_from_numpy, params_to_numpy
from bigdl_tpu_torch.models.config import ModelConfig
from bigdl_tpu_torch.quant import ARRAY_FIELDS, QTensor
from bigdl_tpu_torch.utils import durability, resolve_device
from bigdl_tpu_torch.utils.durability import IntegrityError, decode_array

# v2: nibble packing half-split; v3: q4_k/q6_k planar; v4: the remaining
# low-bit formats in their fused-GEMV layouts (the JAX module's history)
FORMAT_VERSION = 4

# qtypes whose storage layout changed at each version bump: older
# artifacts load only if they hold none of the later-moved types
_MOVED_AT = {
    3: ("q4_k", "q6_k"),
    4: ("q2_k", "q3_k", "q5_k", "sym_int5", "fp6", "nf3"),
}

# current and superseded weight archives and their stale tmps, anchored
# so that unrelated files (weights.npz.bak) are never swept
_WEIGHTS_RE = re.compile(r"^weights(-[0-9a-f]{8})?\.npz(\.tmp-\d+)?$")
_CONFIG = "bigdl_tpu_config.json"


def save_low_bit(path: str, config: ModelConfig, model, qtype: str, *, faults=None) -> None:
    """Write `model` (a `models.llama.LlamaModel`) as the JAX package's
    artifact, with one commit point: the config's rename. A fresh save
    writes `weights.npz`; an overwrite writes `weights-<token>.npz` beside
    the archive the live config names, commits the config that names the
    new one, then sweeps the superseded archives. `faults` threads a
    `utils/diskfaults.DiskFaultInjector` through both atomic writes (a
    lost write on either file is then detected at load, never answered by
    deleting the only archive the surviving config names)."""
    os.makedirs(path, exist_ok=True)
    arrays, manifest = params_to_numpy(model)
    overwrite = os.path.exists(os.path.join(path, _CONFIG))
    wname = f"weights-{os.urandom(4).hex()}.npz" if overwrite else "weights.npz"
    tensors: dict[str, dict] = {}
    durability.atomic_write(os.path.join(path, wname),
                            lambda f: tensors.update(durability.write_npz(f, arrays)),
                            faults=faults)
    meta = {
        "format_version": FORMAT_VERSION,
        "qtype": qtype,
        "model_config": dataclasses.asdict(config),
        "manifest": manifest,
        "weights_file": wname,
        "integrity": durability.integrity_section(tensors),
    }
    durability.atomic_write(os.path.join(path, _CONFIG),
                            lambda f: f.write(json.dumps(meta, indent=1).encode()),
                            faults=faults)
    # sweep only after seeing the commit land: the config on disk names
    # the new archive and the archive exists
    try:
        with open(os.path.join(path, _CONFIG)) as f:
            committed = json.load(f).get("weights_file") == wname
    except (OSError, ValueError):
        committed = False
    if committed and os.path.exists(os.path.join(path, wname)):
        for name in os.listdir(path):
            if name != wname and _WEIGHTS_RE.match(name):
                try:
                    os.unlink(os.path.join(path, name))
                except OSError:
                    pass


def _check_version(meta: dict) -> None:
    ver = meta["format_version"]
    if ver != FORMAT_VERSION:
        moved = [q for v, qs in _MOVED_AT.items() if v > ver for q in qs]
        ok = ver in (2, 3) and not any(
            info.get("qtype") in moved for info in meta["manifest"].values())
        if not ok:
            raise ValueError(f"unsupported format_version {ver}")


def _read_arrays(path: str, meta: dict, verify: str):
    """Read and verify every stored array: (arrays, corrupted, missing,
    extra). Raises IntegrityError only when the weights archive is gone
    or no readable zip; digests are compared by mode, structure always."""
    manifest = meta["manifest"]
    integrity = (meta.get("integrity") or {}).get("tensors")
    wname = meta.get("weights_file", "weights.npz")
    wpath = os.path.join(path, wname)
    expected = {k for k, v in manifest.items() if v["kind"] == "array"}
    if not os.path.exists(wpath):
        durability.VERIFY_FAILURES.inc()
        raise IntegrityError(path, missing=expected, detail=f"{wname} does not exist")
    if integrity is None and verify == "full":
        warnings.warn(f"{path}: no integrity manifest (an artifact from before "
                      "digests); digest verification skipped — re-save to add digests")
    return durability.verify_npz_members(wpath, integrity, verify, expected)


def _read_meta(path: str) -> dict:
    with open(os.path.join(path, _CONFIG)) as f:
        meta = json.load(f)
    missing = [k for k in ("format_version", "qtype", "model_config", "manifest") if k not in meta]
    if missing:
        durability.VERIFY_FAILURES.inc()
        raise IntegrityError(path, detail="damaged config record (missing keys: "
                                          f"{', '.join(missing)})")
    _check_version(meta)
    return meta


def load_low_bit(path: str, *, verify: str = "fast", salvage: bool = False, device=None):
    """Returns (config, model, qtype), the model a `LlamaModel` on `device`
    (the card unless told otherwise) in the artifact's layout; with
    salvage=True (config, model, qtype, report), where report is the
    un-raised IntegrityError (None when the artifact is clean) and, when
    it is not None, `model` is the valid subset as the JAX loader's tree
    ({"layers": {...}, "embed": ...}, QTensors where every field verified)
    with `report.quarantined_params` naming the rest.

    verify: "off" skips the digests (structure and the zip's own checks
    still apply), "fast" checks sizes, shapes and crc32, "full" adds
    sha256 and the numerical validation."""
    durability.check_verify_mode(verify)
    dev = resolve_device(device)
    meta = _read_meta(path)
    config = ModelConfig(**meta["model_config"])
    manifest = meta["manifest"]
    arrays, corrupted, missing, extra = _read_arrays(path, meta, verify)
    if verify == "full":
        for fnd in durability.validate_numerics(arrays, manifest):
            corrupted.setdefault(fnd.tensor, f"{fnd.issue}: {fnd.detail}")
            arrays.pop(fnd.tensor, None)
    report = None
    if corrupted or missing or extra:
        durability.VERIFY_FAILURES.inc()
        report = IntegrityError(path, corrupted=corrupted, missing=missing, extra=extra)
        if not salvage:
            raise report
        warnings.warn(f"salvage load: {report}")
    decoded = {k: decode_array(a, manifest[k]["dtype"]) for k, a in arrays.items()}
    qtypes = {k: v["qtype"] for k, v in manifest.items() if v["kind"] == "qtensor"}
    if report is None:
        model = params_from_numpy(decoded, qtypes, config, device=dev, dtype=None)
        return (config, model, meta["qtype"], None) if salvage else (config, model, meta["qtype"])
    tree, quarantined = _valid_subset(decoded, manifest, dev)
    report.quarantined_params = sorted(quarantined)
    return config, tree, meta["qtype"], report


def _valid_subset(decoded: dict, manifest: dict, dev) -> tuple[dict, list]:
    """The JAX loader's partial tree: every logical tensor whose stored
    arrays all verified, on `dev`; the others' paths quarantined."""
    tree: dict = {}
    quarantined: list[str] = []

    def put(key, value):
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    for key, info in manifest.items():
        if info["kind"] == "qtensor":
            fkeys = [f"{key}@{f}" for f in ARRAY_FIELDS if f"{key}@{f}" in manifest]
            if all(k in decoded for k in fkeys):
                put(key, QTensor(qtype=info["qtype"], **{
                    k.split("@")[1]: decoded[k].to(dev) for k in fkeys}))
            else:
                quarantined.append(key)
        elif "@" not in key:
            if key in decoded:
                put(key, decoded[key].to(dev))
            else:
                quarantined.append(key)
    return tree, quarantined


def verify_low_bit(path: str) -> durability.VerifyReport:
    """Full per-tensor verification without building the model: digests
    in "full" mode plus the numerical validation. Tensor findings land in
    the report's rows; nothing raises for them."""
    try:
        with open(os.path.join(path, _CONFIG)) as f:
            meta = json.load(f)
        _check_version(meta)
        manifest = meta["manifest"]
        if not isinstance(manifest, dict):
            raise KeyError("manifest")
    except (OSError, ValueError, KeyError, TypeError) as e:
        return durability.VerifyReport(path, "low_bit", rows=[],
                                       detail=f"unreadable config: {type(e).__name__}: {e}")
    try:
        arrays, corrupted, missing, extra = _read_arrays(path, meta, "full")
    except IntegrityError as e:
        return durability.VerifyReport(path, "low_bit", rows=durability.rows_from_error(e),
                                       detail=e.detail)
    rows = durability.rows_from_error(IntegrityError(
        path, corrupted=corrupted, missing=missing, extra=extra))
    flagged = set(corrupted) | set(missing) | set(extra)
    for fnd in durability.validate_numerics(arrays, manifest):
        rows.append(durability.TensorReport(fnd.tensor, "numerics", f"{fnd.issue}: {fnd.detail}"))
        flagged.add(fnd.tensor)
    rows += [durability.TensorReport(k, "ok") for k in sorted(arrays) if k not in flagged]
    return durability.VerifyReport(path, "low_bit", rows=rows)
