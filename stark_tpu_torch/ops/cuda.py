"""Build, bind and count the port's hand-written CUDA kernels (csrc/).

Route: ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ctypes.  The build happens at
the first launch (never at import: the CPU tests import every module), into
``stark_tpu_torch/_build/`` (utils/build.py).  Each C entry launches on the
stream it is given and returns ``cudaGetLastError()``; :meth:`Kernel.launch`
raises on a non-zero code.  Kernels allocate nothing: wrappers pass
``torch.empty`` outputs.

Every entry point is a :class:`Kernel` in :data:`KERNELS`, with a launch
count that its wrapper raises by one per launch and nowhere else, so a run
can show which kernels the main path went through.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil

import torch

from stark_tpu_torch.utils.build import PACKAGE_DIR, build_library

CSRC = os.path.join(PACKAGE_DIR, "csrc")
SOURCES = ("ntt.cu", "fold.cu")
HEADERS = ("field.cuh",)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

ptr = ctypes.c_void_p
i32 = ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    path = build_library(
        "stark_cuda",
        [os.path.join(CSRC, s) for s in SOURCES],
        [os.path.join(CSRC, h) for h in HEADERS],
        [_nvcc(), *NVCC_FLAGS],
    )
    lib = ctypes.CDLL(path)
    lib.stark_cuda_error_string.argtypes = [i32]
    lib.stark_cuda_error_string.restype = ctypes.c_char_p
    for k in KERNELS.values():
        fn = getattr(lib, k.symbol)
        fn.argtypes = [*k.argtypes, ptr]  # every entry ends with the stream
        fn.restype = i32
    return lib


class Kernel:
    """One C entry point of the library: binding, provenance, launch count.

    ``symbol`` is the host entry; the ``__global__`` function it launches is
    ``symbol + "_kernel"`` with C linkage (:attr:`kernel_symbol`), the name a
    profile shows for it."""

    def __init__(self, name: str, symbol: str, argtypes, *, source: str,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.kernel_symbol = symbol + "_kernel"
        self.argtypes = list(argtypes)
        self.source = source
        self.replaces = replaces
        self.launches = 0
        KERNELS[name] = self

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise if the launch fails."""
        lib = library()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, self.symbol)(*args, stream)
        if rc != 0:
            msg = lib.stark_cuda_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} ({msg})")
        self.launches += 1


KERNELS: dict[str, Kernel] = {}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def check_operand(t: torch.Tensor, name: str) -> None:
    """Kernel operands: contiguous int32 tensors on a CUDA device."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
