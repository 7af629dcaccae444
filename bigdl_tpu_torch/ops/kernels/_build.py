"""Build and bind the port's CUDA kernels.

Every `csrc/*.cu` builds with nvcc into its own plain-C shared library
(no PyTorch headers, so a build takes seconds), loaded with `ctypes`.
The dequant sources (`FORMAT_SOURCES`) build once per weight format,
with `-DBIGDL_QFMT=QF_<qtype>` selecting the format's traits in
`csrc/qdecode.cuh`, into one library per (source, qtype). The build runs
once per process, at the first launch of any kernel: all libraries
compile in parallel, one nvcc each (as many at a time as the host has
cores), into `build/kernels/` at the root of the checkout (listed in
.gitignore). A library is named by a digest of its sources and of the
flags, so an unchanged tree reuses the libraries a previous process built.

`Kernel` is one C entry point: its wrapper calls it with tensor pointers
(Python ints), it checks the cudaGetLastError() code the C function
returns, and it counts its launches in a plain integer (and, for a
per-format kernel, per qtype), so a run can show that its main path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import torch

from bigdl_tpu_torch.quant.qtypes import qtype_registry

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every quantized weight format, and the sources built once for each
QTYPES = tuple(n for n, spec in qtype_registry().items() if not spec.is_dense)
FORMAT_SOURCES = ("qmatmul", "qbackward")

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device `index` (the persistent
    and split kernels size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is missing."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _variants(stem: str) -> tuple:
    return QTYPES if stem in FORMAT_SOURCES else (None,)


def _flags(variant: Optional[str]) -> tuple:
    return NVCC_FLAGS + ((f"-DBIGDL_QFMT=QF_{variant}",) if variant else ())


def _library_path(stem: str, variant: Optional[str]) -> Path:
    h = hashlib.sha256(" ".join(_flags(variant)).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{stem}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    name = stem if variant is None else f"{stem}_{variant}"
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile(stem: str, variant: Optional[str], lib: Path) -> Optional[str]:
    """nvcc one library; the ptxas report (registers, shared memory,
    spills per kernel) is kept beside it as .log. Returns the failure."""
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc(), *_flags(variant), "-o", str(tmp), str(CSRC / f"{stem}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lib.with_suffix(".log").write_text(proc.stdout)
    if proc.returncode != 0:
        return f"{lib.name} (exit {proc.returncode}):\n{proc.stdout}"
    os.replace(tmp, lib)
    return None


def build_all() -> dict[tuple, Path]:
    """Compile every library that is missing, in parallel; returns
    {(source stem, qtype or None): library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {(src.stem, v): _library_path(src.stem, v)
               for src in sorted(CSRC.glob("*.cu")) for v in _variants(src.stem)}
    todo = [(stem, v, lib) for (stem, v), lib in targets.items() if not lib.exists()]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        failed = [f for f in pool.map(lambda t: _compile(*t), todo) if f]
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


def library(stem: str, variant: Optional[str] = None) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu` (for one qtype, if it builds
    per format), building all on first use."""
    with _lock:
        if (stem, variant) not in _libs:
            for key, path in build_all().items():
                _libs[key] = ctypes.CDLL(str(path))
        return _libs[(stem, variant)]


_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    `signature` spells the C parameters before the trailing stream: p a
    pointer (pass a tensor, or None for a null pointer), i an int, f a
    float. `replaces` names the Pallas kernel (file:line) this kernel
    ports; `source` is its CUDA source, relative to the repository root.
    A `per_format` kernel is launched with the weight's qtype and counts
    its launches per qtype too (`by_format`)."""

    def __init__(self, name: str, stem: str, signature: str, replaces: str,
                 per_format: bool = False):
        self.name = name
        self.stem = stem
        self.signature = signature
        self.replaces = replaces
        self.per_format = per_format
        self.source = f"bigdl_tpu_torch/csrc/{stem}.cu"
        self.launches = 0
        self.by_format: dict[str, int] = {}
        self._fns: dict = {}

    def reset(self) -> None:
        self.launches = 0
        self.by_format = {}

    def _bind(self, variant):
        lib = library(self.stem, variant)
        fn = getattr(lib, self.name)
        fn.argtypes = [_CTYPES[c] for c in self.signature] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.bigdl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.bigdl_cuda_error_string.restype = ctypes.c_char_p
        self._fns[variant] = (fn, lib.bigdl_cuda_error_string)

    def __call__(self, *args, device: torch.device, qtype: Optional[str] = None) -> None:
        """Launch on `device`'s current stream; the stream goes last."""
        if self.per_format != (qtype is not None):
            raise ValueError(f"{self.name}: qtype={qtype!r} for a kernel with "
                             f"per_format={self.per_format}")
        if qtype not in self._fns:
            self._bind(qtype)
        fn, err_str = self._fns[qtype]
        args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: launch failed with CUDA error "
                               f"{err} ({err_str(err).decode()})")
        self.launches += 1
        if qtype is not None:
            self.by_format[qtype] = self.by_format.get(qtype, 0) + 1
