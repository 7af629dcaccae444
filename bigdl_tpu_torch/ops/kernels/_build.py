"""Build and bind the port's CUDA kernels.

Every `csrc/*.cu` builds with nvcc into its own plain-C shared library
(no PyTorch headers, so a build takes seconds), loaded with `ctypes`.
The build runs once per process, at the first launch of any kernel: all
sources compile in parallel, one nvcc each, into `build/kernels/` at the
root of the checkout (listed in .gitignore). A library is named by a
digest of its sources and of the flags, so an unchanged tree reuses the
libraries a previous process built.

`Kernel` is one C entry point: its wrapper calls it with tensor pointers
(Python ints), it checks the cudaGetLastError() code the C function
returns, and it counts its launches in a plain integer, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is missing."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _library_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, all at once; returns
    {source stem: library path}. The ptxas report (registers, shared
    memory, spills per kernel) is kept beside each library as .log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: _library_path(src.stem)
               for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for stem, lib in targets.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for stem, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        targets[stem].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, targets[stem])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, building all on first use."""
    with _lock:
        if stem not in _libs:
            paths = build_all()
            for s, p in paths.items():
                _libs[s] = ctypes.CDLL(str(p))
        return _libs[stem]


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    `signature` spells the C parameters before the trailing stream: p a
    pointer (pass a tensor), i an int, f a float. `replaces` names the
    Pallas kernel (file:line) this kernel ports; `source` is its CUDA
    source, relative to the repository root."""

    def __init__(self, name: str, stem: str, signature: str, replaces: str):
        self.name = name
        self.stem = stem
        self.signature = signature
        self.replaces = replaces
        self.source = f"bigdl_tpu_torch/csrc/{stem}.cu"
        self.launches = 0
        self._fn = None

    def _bind(self):
        lib = library(self.stem)
        fn = getattr(lib, self.name)
        fn.argtypes = [_CTYPES[c] for c in self.signature] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.bigdl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        self._fn = fn
        self._err = lib.bigdl_cuda_error_string

    def __call__(self, *args, device: torch.device) -> None:
        """Launch on `device`'s current stream; the stream goes last."""
        if self._fn is None:
            self._bind()
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{err} ({self._err(err).decode()})")
        self.launches += 1
