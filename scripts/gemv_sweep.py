#!/usr/bin/env python3
"""The decode GEMV's tiles on one CUDA card: device ms of each tile at
llama3-8b's path shapes, each tile's output checked once.

    python3 scripts/gemv_sweep.py [--root DIR] [--qtype Q] [--m 1,4,8,32] [--policy | --misrounding]

Builds only `csrc/qmatmul.cu` for the qtype of the checkout at DIR
(default: the one this script lies in). Without --policy, times every
(warps, wr, kc) tile the GEMV takes at each shape and M by profiled
device time (operands cycled past the 50 MB L2), prints the policy's
tile (`ops/kernels/qtile.py` gemv_tile) beside the fastest ones, flags a
tile whose output is not within 2 bf16 ULPs of the plain version, and
sums a decode step (32 x the four layer projections + the lm head) over
the policy's tiles and over the fastest. With --policy, times only
`kernels.qmatmul` (the policy's tile) at M = 4 and 8: the form to time a
role-cut copy of the kernel (a checkout under build/exp/ with one role
cut out of csrc/qmatmul.cu), whose checks fail but whose times print.
With --misrounding, counts at wo, w_down and w_gateup the bf16 outputs of
the GEMV (M = 8), and of the GEMM, dx and the LoRA GEMM (M = 1024, R = 8;
chip_smoke.py `misrounding_counts`), and of their plain versions (f32
sums in torch.matmul) that differ from the exactly rounded value (f64
sums), and for the GEMV those where the two differ; it also builds
`csrc/qbackward.cu`.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import math
import sys
from pathlib import Path

SHAPES = {"wqkv": (6144, 4096), "wo": (4096, 4096), "w_gateup": (28672, 4096),
          "w_down": (4096, 14336), "lm_head": (128256, 4096)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--qtype", default="sym_int4")
    ap.add_argument("--m", default="1,4,8,32")
    ap.add_argument("--policy", action="store_true")
    ap.add_argument("--misrounding", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gemv_sweep: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from bigdl_tpu_torch.ops import kernels
    from bigdl_tpu_torch.ops.kernels import _build, qtile
    from bigdl_tpu_torch.ops.kernels.qmatmul import kernel_fields

    qtype = args.qtype
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for stem in ("qmatmul", "qbackward") if args.misrounding else ("qmatmul",):
        lib = _build._library_path(stem, qtype)
        if not lib.exists():
            err = _build._compile(stem, qtype, lib)
            if err:
                print(err, file=sys.stderr)
                return 1
        _build._libs[(stem, qtype)] = ctypes.CDLL(str(lib))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.misrounding:
        g = torch.Generator(device=dev).manual_seed(3)
        lines = []
        for name in ("wo", "w_down", "w_gateup"):
            O, K = SHAPES[name]
            w = cs.qweight_of(torch, dev, qtype, O, K, 5)
            wd = w.dequantize(torch.bfloat16).double()
            x = torch.randn(8, K, device=dev, generator=g).to(torch.bfloat16)
            exact = (x.double() @ wd.t()).float().to(torch.bfloat16)
            y, p = kernels.qmatmul(x, w), kernels.qmatmul_plain(x, w)
            lines.append(f"gemv {name} M=8: kernel {int((y != exact).sum())}, plain {int((p != exact).sum())}, "
                         f"kernel vs plain {int((y != p).sum())} of {y.numel()}")
            del w, wd
        shapes = {k: SHAPES[k] for k in cs.MISROUND_SHAPES}
        for (form, name), (k, p, n) in cs.misrounding_counts(torch, dev, qtype, shapes).items():
            lines.append(f"{form} {name} M={cs.MISROUND_M}: kernel {k}, plain {p} of {n}")
        print(f"{root.name} {qtype} outputs off the exactly rounded value: " + "; ".join(lines), flush=True)
        return 0
    g = torch.Generator(device=dev).manual_seed(0)
    ms_list = (4, 8) if args.policy else tuple(int(m) for m in args.m.split(","))
    tot = {}
    for name, (O, K) in SHAPES.items():
        w = cs.qweight_of(torch, dev, qtype, O, K, 1)
        wb = cs.weight_bytes(w)
        copies = max(1, math.ceil(cs.L2_COPIES_BYTES / wb))
        ws = [(w,)] + [(cs.qweight_of(torch, dev, qtype, O, K, 10 + c),) for c in range(1, copies)]
        n = 32 if name != "lm_head" else 1
        for M in ms_list:
            x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
            if args.policy:
                ms = cs.device_ms(torch, lambda w_: kernels.qmatmul(x, w_), ws, 20)
                tot.setdefault(M, [0.0, 0.0])[0] += n * ms
                print(f"{root.name} {name} M={M} {ms:.5f} ms ({wb / ms / 1e9:.3f} TB/s)", flush=True)
                continue
            ref = kernels.qmatmul_plain(x, w).float()
            pick = qtile.gemv_tile(M, O, K, qtype)
            res = []
            for warps in qtile.gemv_warps(qtype, M):
                for wr in (v for v in qtile.GEMV_WR if v <= warps):
                    for kc in qtile.GEMV_KC:
                        smem = qtile.gemv_smem(M, K, qtype, kc, 0, warps)
                        if smem > qtile.SMEM_LIMIT:
                            continue
                        out = torch.empty(M, O, dtype=torch.bfloat16, device=dev)

                        def fn(w_, wr=wr, kc=kc, warps=warps, smem=smem, out=out):
                            f = kernel_fields(w_, K, x.device, "gemv_sweep")
                            kernels.GEMV(x, *f, out, M, K, O, wr, kc, warps, qtile.gemv_stages(qtype), smem,
                                         device=dev, qtype=qtype)
                        fn(w)
                        ok = (out.float() - ref).abs().max().item() <= ref.abs().max().item() * 2 ** -7
                        res.append((cs.device_ms(torch, fn, ws, 20), warps, wr, kc, ok))
            res.sort()
            cur = next(r for r in res if (r[1], r[2], r[3]) == (pick.warps, pick.wr, pick.kc))
            tot.setdefault(M, [0.0, 0.0])
            tot[M][0] += n * cur[0]
            tot[M][1] += n * res[0][0]
            bad = [r[1:4] for r in res if not r[4]]
            print(f"{qtype} {name} M={M} bound {cs.bound_ms(M * K * 2 + wb + M * O * 2, 2.0 * M * O * K)[0]:.5f} "
                  f"policy warps={pick.warps} wr={pick.wr} kc={pick.kc} {cur[0]:.5f} ms; fastest "
                  + ", ".join(f"warps={b} wr={a} kc={c} {m:.5f}" for m, b, a, c, _ in res[:6])
                  + (f"; WRONG {bad}" if bad else ""), flush=True)
        del ws
    for M, (p, b) in tot.items():
        print(f"{root.name} decode step M={M}: policy {p:.4f} ms" + ("" if args.policy else f", fastest tiles {b:.4f} ms"),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
