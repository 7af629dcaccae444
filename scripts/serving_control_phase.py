#!/usr/bin/env python3
"""chip_smoke phase 22 (the serving engine's control plane) alone on one
CUDA card.

    python3 scripts/serving_control_phase.py

Builds every kernel library, prints the card's name and power limit,
builds phase 7's model (llama3-8b at full width and depth, sym_int4,
seed 0) and runs `chip_smoke.serving_control_phases` over phase 7's
traffic: chunked prefill against a monolithic engine, the decode stall of
a long prompt, overload control and the drain, the journal's crash and
replay with the fault points, and tracing, the request log and the
metrics exposition. It exits 1 when a check failed.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("serving_control_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from bigdl_tpu_torch import PRESETS, TorchModel, optimize_model
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    libs = _build.build_all()
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    cfg = PRESETS["llama3-8b"]
    t1 = time.time()
    tm = TorchModel(cfg, optimize_model(llama.init_params(cfg, seed=0), cfg, "sym_int4"),
                    "sym_int4")
    torch.cuda.synchronize()
    print(f"llama3-8b {cfg.num_hidden_layers} layers sym_int4 built in {time.time() - t1:.1f} s",
          flush=True)
    shared, indep = cs.serving_traffic(cfg.vocab_size)
    cs.begin_phase(22)
    cs.serving_control_phases(torch, torch.device("cuda"),
                              f"{torch.cuda.get_device_name(0)} ({smi})", tm, shared + indep)
    cs.begin_phase(None)
    print(f"total {time.time() - t0:.1f} s; failed checks {cs.FAILED}", flush=True)
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
