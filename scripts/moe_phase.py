#!/usr/bin/env python3
"""chip_smoke phase 20 (mixture of experts, ALiBi and logn) alone on one
CUDA card.

    python3 scripts/moe_phase.py

Builds every kernel library, prints the card's name and power limit, and
runs `chip_smoke.moe_phases`: mixtral-8x7b at full width and 8 of its
32 layers through `generate` and the paged engine, 2-layer qwen2-moe,
baichuan-13b (ALiBi) and Qwen-7B (logn) against the plain versions. It
exits 1 when a check failed.
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
        print("moe_phase: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from bigdl_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    libs = _build.build_all()
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    cs.begin_phase(20)
    cs.moe_phases(torch, torch.device("cuda"), f"{torch.cuda.get_device_name(0)} ({smi})")
    cs.begin_phase(None)
    print(f"total {time.time() - t0:.1f} s; failed checks {cs.FAILED}", flush=True)
    return 1 if cs.FAILED else 0


if __name__ == "__main__":
    sys.exit(main())
