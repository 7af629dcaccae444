#!/usr/bin/env python3
"""chip_smoke phase 19 (self-speculative and prompt-lookup decoding) alone
on one CUDA card, or its adapter engine (d) taken apart.

    python3 scripts/decode_phase.py            # the builds, phase 16 (a)'s model, phase 19
    python3 scripts/decode_phase.py --adapters

The first form builds every kernel library, makes phase 16 (a)'s model
(llama3-8b at full width, 8 layers, sym_int4, weights from seed 0) and runs
`chip_smoke.decode_phases` on it; it exits 1 when a check failed.

--adapters serves phase 19 (d)'s traffic (phase 7's 8 prefix-sharing
requests, engine (f)'s four adapters, 32 new tokens) through the plain
adapter engine and the speculative one (the model as its own draft,
draft_k 4), each once more with the LoRA kernels swapped for their
plain versions, and prints for every request of each run its tokens'
largest teacher-forced gap (a one-shot forward of prompt + output on the
verify's route, with the request's adapter and penalty, through the LoRA
kernels and through their plain versions), how many tokens lie beyond
phase 3's bound, where the largest lies, and the bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def adapters(torch, cs, cfg, tm, dev) -> None:
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.serving import InferenceEngine
    from bigdl_tpu_torch.serving.adapters import AdapterRegistry

    root = ROOT / "build" / "adapters" / "decode_phase"
    cs.make_adapters(torch, dev, cfg, root)
    shared, _ = cs.serving_traffic(cfg.vocab_size)
    specs = [dict(sp, max_new_tokens=cs.SPEC_ADAPTER_NEW, adapter=a)
             for sp, a in zip(shared[:cs.SPEC_SERVE_REQS], cs.ADAPTER_OF)]

    def run(**kw):
        eng = InferenceEngine(tm, n_slots=cs.SLOTS, max_len=cs.MAX_LEN, page_size=cs.PAGE,
                              paged=True, adapters=AdapterRegistry(dir=str(root)), **kw)
        reqs = [eng.submit(**sp) for sp in specs]
        eng.run_until_idle()
        return [r.out_tokens for r in reqs]

    def plain_lora():
        return mock.patch.object(kernels, "qmatmul_lora", kernels.qmatmul_lora_plain)

    def gaps(toks, plain):
        reg = AdapterRegistry(dir=str(root))
        out = []
        for i, sp in enumerate(specs):
            entry = reg.acquire(sp["adapter"]) if sp["adapter"] else None
            with plain_lora() if plain else mock.patch.object(kernels, "qmatmul_lora",
                                                              kernels.qmatmul_lora):
                tf = cs.teacher_forced(torch, cfg, tm.params, sp["prompt"], toks[i], per_row=True,
                                       lora=entry and entry.tree(device=dev),
                                       penalty=sp.get("repetition_penalty", 1.0))
            if entry is not None:
                reg.release(entry)
            g, bound, _ = cs.tf_rule(torch, tf, toks[i])
            out.append((i, sp["adapter"], round(g.max().item(), 4), int((g > bound).sum()),
                        int(g.argmax()), round(bound, 4)))
        return out

    runs = {"plain engine": run(), "speculative engine":
            run(speculative=True, draft_params=tm.params, draft_k=cs.SPEC_K)}
    with plain_lora():
        runs["plain engine, plain LoRA"] = run()
        runs["speculative engine, plain LoRA"] = run(speculative=True, draft_params=tm.params,
                                                     draft_k=cs.SPEC_K)
    print("per request: (request, adapter, largest gap, tokens beyond the bound, where the "
          "largest lies, bound)", flush=True)
    for label, toks in runs.items():
        for plain in (False, True):
            print(f"{label}; teacher-forced through the LoRA {'plain versions' if plain else 'kernels'}: "
                  f"{gaps(toks, plain)}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--adapters", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from bigdl_tpu_torch import PRESETS, TorchModel, optimize_model
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops.kernels import _build

    t0 = time.time()
    libs = _build.build_all()
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    cfg = dataclasses.replace(PRESETS["llama3-8b"], num_hidden_layers=cs.HALF_LAYERS)
    dev = torch.device("cuda")
    tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, seed=0), cfg, "sym_int4"), "sym_int4")
    if args.adapters:
        adapters(torch, cs, cfg, tm, dev)
    else:
        cs.begin_phase(19)
        cs.decode_phases(torch, dev, f"{torch.cuda.get_device_name(0)} ({smi})", tm)
        cs.begin_phase(None)
    print(f"total {time.time() - t0:.1f} s; failed checks {cs.FAILED}", flush=True)
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
