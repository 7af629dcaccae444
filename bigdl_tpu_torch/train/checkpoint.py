"""Atomic train-state checkpoint and resume (port of
bigdl_tpu/train/checkpoint.py).

The checkpoint is the training state itself: the trainable tensors (the
adapters of QLoRA, or every parameter of a full fine-tune), the
optimizer's state, the step, the `torch.Generator` state (LISA's layer
draws, sampling), and for a mid-ReLoRA resume the merged base, which
changes at every merge-and-reset.

Format: ONE .npz (every tensor a member, bf16/fp8 as bit views through
`utils.durability.encode_array`, and a JSON meta member), written through
`durability.atomic_write` — a kill at any instant leaves the old or the
new checkpoint, never a torn one. The meta carries per-member crc32 and
sha256 digests, checked by `load_train_state(verify=...)`. The layout is
the port's own: JAX's flattens an optax pytree, the port a torch
optimizer's `state_dict()`, so the two packages do not read each other's
checkpoints.

As JAX's loader unflattens onto "like" templates, `load_train_state`
loads into live objects the caller already built (the modules, the
optimizer, the generator), after checking every tensor's shape and dtype
against them; nothing is changed unless the whole checkpoint matches.
`save_train_state_rotating` / `load_latest_train_state` keep the last k
checkpoints and resume from the newest loadable one, skipping corrupt
ones with a warning.
"""

from __future__ import annotations

import json
import os
import re
import warnings
import zipfile
from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.utils import durability
from bigdl_tpu_torch.utils.durability import IntegrityError

FORMAT_VERSION = 1


def _module_members(prefix: str, module: torch.nn.Module) -> dict:
    return {f"{prefix}:{k}": v for k, v in module.state_dict().items()}


def _optim_members(optimizer: torch.optim.Optimizer) -> tuple[dict, dict]:
    """(tensor members, JSON record) of a torch optimizer's state_dict:
    tensors become members, every other value stays in the record."""
    sd = optimizer.state_dict()
    members, state = {}, {}
    for idx, entry in sd["state"].items():
        rec = {}
        for name, val in entry.items():
            if isinstance(val, torch.Tensor):
                key = f"optim:{idx}:{name}"
                members[key] = val
                rec[name] = {"member": key}
            else:
                rec[name] = {"value": val}
        state[str(idx)] = rec
    return members, {"state": state, "param_groups": sd["param_groups"]}


def save_train_state(path: str, *, trainable: torch.nn.Module,
                     optimizer: torch.optim.Optimizer, step: int,
                     rng: Optional[torch.Generator] = None,
                     base: Optional[torch.nn.Module] = None,
                     resets: int = 0) -> None:
    """Atomically write the training state to `path` (one file). Pass
    `base` when it changes during training (ReLoRA's merges); a frozen
    base reloads from its own artifact."""
    tensors = _module_members("trainable", trainable)
    opt_members, optim = _optim_members(optimizer)
    tensors.update(opt_members)
    if base is not None:
        tensors.update(_module_members("base", base))
    if rng is not None:
        tensors["rng"] = rng.get_state()
    arrays, dtypes = {}, {}
    for k, t in tensors.items():
        arrays[k], dtypes[k] = durability.encode_array(t)

    def write(f) -> None:
        with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED) as zf:
            digests = {k: durability.add_npz_member(zf, k, arrays[k]) for k in sorted(arrays)}
            meta = {"format_version": FORMAT_VERSION, "step": int(step),
                    "resets": int(resets), "dtypes": dtypes, "optim": optim,
                    "has_base": base is not None, "has_rng": rng is not None,
                    "integrity": durability.integrity_section(digests)}
            durability.add_npz_member(zf, "meta", np.asarray(json.dumps(meta)))

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    durability.atomic_write(path, write)


def _read_meta(path: str) -> dict:
    try:
        with np.load(path, allow_pickle=False) as npz:
            meta = json.loads(str(npz["meta"]))
    except FileNotFoundError:
        raise
    except Exception as e:  # any unreadable file is one structured error
        durability.VERIFY_FAILURES.inc()
        raise IntegrityError(path, detail=f"unreadable checkpoint: {type(e).__name__}: {e}") from e
    bad = [k for k in ("format_version", "step", "resets", "dtypes", "optim",
                       "has_base", "has_rng") if k not in meta]
    if bad or meta["format_version"] != FORMAT_VERSION:
        durability.VERIFY_FAILURES.inc()
        raise IntegrityError(path, detail=f"damaged meta record (missing {bad} or "
                                          f"format_version {meta.get('format_version')!r})")
    return meta


def _check_like(what: str, got: torch.Tensor, like: torch.Tensor) -> None:
    if tuple(got.shape) != tuple(like.shape) or got.dtype != like.dtype:
        raise ValueError(f"{what}: checkpoint {tuple(got.shape)} {got.dtype} != live "
                         f"{tuple(like.shape)} {like.dtype} — a resumed run would not "
                         "reproduce the original one")


def load_train_state(path: str, *, trainable: torch.nn.Module,
                     optimizer: torch.optim.Optimizer,
                     rng: Optional[torch.Generator] = None,
                     base: Optional[torch.nn.Module] = None,
                     verify: str = "fast") -> dict:
    """Load the checkpoint at `path` into the live `trainable`,
    `optimizer`, `rng` and (for a checkpoint that carries one) `base`;
    returns {"step", "resets"}. verify: "off" | "fast" (crc32) | "full"
    (sha256 and a non-finite scan). Corruption raises IntegrityError
    naming each bad member; a checkpoint whose tensors do not match the
    live objects' shapes and dtypes raises ValueError, and nothing is
    loaded."""
    durability.check_verify_mode(verify)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    meta = _read_meta(path)
    if meta["has_base"] and base is None:
        raise ValueError("the checkpoint carries a merged base (ReLoRA): pass base=")
    arrays, corrupted, missing, extra = durability.verify_npz_members(
        path, meta.get("integrity", {}).get("tensors"), verify, meta["dtypes"],
        ignore={"meta"})
    if verify == "full":
        for k in list(arrays):
            detail = durability.scan_non_finite(arrays[k], meta["dtypes"][k])
            if detail is not None:
                corrupted[k] = f"non_finite: {detail}"
                arrays.pop(k)
    if corrupted or missing or extra:
        durability.VERIFY_FAILURES.inc()
        raise IntegrityError(path, corrupted=corrupted, missing=missing, extra=extra)
    tensors = {k: durability.decode_array(a, meta["dtypes"][k]) for k, a in arrays.items()}

    modules = [("trainable", trainable)] + ([("base", base)] if meta["has_base"] else [])
    loads = []
    for prefix, module in modules:
        live = module.state_dict()
        sd = {k.split(":", 1)[1]: t for k, t in tensors.items() if k.startswith(prefix + ":")}
        if sd.keys() != live.keys():
            raise ValueError(f"{prefix}: checkpoint keys differ from the live module's: "
                             f"{sorted(sd.keys() ^ live.keys())[:5]}")
        for k, t in sd.items():
            _check_like(f"{prefix}.{k}", t, live[k])
        loads.append((module, sd))
    live_opt = optimizer.state_dict()
    saved = meta["optim"]
    if len(saved["param_groups"]) != len(live_opt["param_groups"]) or any(
            s["params"] != g["params"] for s, g in zip(saved["param_groups"],
                                                       live_opt["param_groups"])):
        raise ValueError("optimizer: the checkpoint's parameter groups differ from the live one's")
    state = {}
    for idx, rec in saved["state"].items():
        state[int(idx)] = {n: tensors[v["member"]] if "member" in v else v["value"]
                           for n, v in rec.items()}
    groups = [{k: (tuple(v) if isinstance(g.get(k), tuple) else v) for k, v in s.items()}
              for s, g in zip(saved["param_groups"], live_opt["param_groups"])]

    for module, sd in loads:
        module.load_state_dict(sd, strict=True)
    optimizer.load_state_dict({"state": state, "param_groups": groups})
    # torch casts a float state tensor to its parameter's dtype on load;
    # keep each as saved (GaLore's f32 projector beside a bf16 weight)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for idx, entry in state.items():
        for name, val in entry.items():
            if isinstance(val, torch.Tensor) and name != "step":
                optimizer.state[params[idx]][name] = val.to(params[idx].device)
    if rng is not None and meta["has_rng"]:
        rng.set_state(tensors["rng"])
    return {"step": meta["step"], "resets": meta["resets"]}


# ---------------------------------------------------------------------------
# rotation: keep the last k, resume from the newest loadable one
# ---------------------------------------------------------------------------

_CKPT_RE = re.compile(r"^ckpt-(\d{8})\.npz$")
_CKPT_TMP_RE = re.compile(r"^ckpt-\d{8}\.npz\.tmp-\d+$")


def list_train_checkpoints(ckpt_dir: str) -> list:
    """Rotated checkpoint paths in `ckpt_dir`, newest (highest step) first."""
    if not os.path.isdir(ckpt_dir):
        return []
    found = [(int(m.group(1)), os.path.join(ckpt_dir, n))
             for n in os.listdir(ckpt_dir) if (m := _CKPT_RE.match(n))]
    return [p for _, p in sorted(found, reverse=True)]


def save_train_state_rotating(ckpt_dir: str, *, step: int, keep_last: int = 3,
                              **state) -> str:
    """Save `ckpt-<step:08d>.npz` into `ckpt_dir`, then remove all but the
    newest `keep_last` checkpoints and the temporaries of killed saves
    (after the new one is committed, so a kill keeps `keep_last` whole
    ones). Returns the new path."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    if not 0 <= step < 10 ** 8:
        raise ValueError(f"step {step} outside the 8-digit rotation range")
    path = os.path.join(ckpt_dir, f"ckpt-{step:08d}.npz")
    save_train_state(path, step=step, **state)
    stale = [os.path.join(ckpt_dir, n) for n in os.listdir(ckpt_dir) if _CKPT_TMP_RE.match(n)]
    for old in list_train_checkpoints(ckpt_dir)[keep_last:] + stale:
        try:
            os.unlink(old)
        except OSError:  # a racing cleanup already took it
            pass
    return path


def load_latest_train_state(ckpt_dir: str, **live) -> Optional[dict]:
    """Load the newest loadable rotated checkpoint into the live objects
    (`load_train_state`'s keywords): corrupt candidates are skipped with
    a warning; a mismatch with the live objects still raises (an older
    checkpoint would mismatch the same way). Returns {"step", "resets",
    "path"}, or None when no checkpoint loads."""
    for path in list_train_checkpoints(ckpt_dir):
        try:
            out = load_train_state(path, **live)
        except (IntegrityError, FileNotFoundError) as e:
            warnings.warn(f"skipping corrupt train checkpoint {path}: {e}")
            continue
        out["path"] = path
        return out
    return None
