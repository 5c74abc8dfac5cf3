"""Build, bind and count the port's hand-written CUDA kernels (csrc/).

Route: one ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a``
(``--threads 0``: the sources side by side) into one shared library with a
plain C interface, loaded with ctypes.  The build happens at the first launch (never at import: the CPU tests import every module), into
``stark_tpu_torch/_build/`` (utils/build.py).  Each C entry launches on the
stream it is given and returns ``cudaGetLastError()``; :meth:`Kernel.launch`
raises on a non-zero code.  Kernels allocate nothing: wrappers pass
``torch.empty`` outputs.

Every entry point is a :class:`Kernel` in :data:`KERNELS`, with a launch
count that its wrapper raises by one per launch and nowhere else, so a run
can show which kernels the main path went through.  A :class:`Graph` holds
launches captured once as a CUDA graph and replays them; each replay adds
the launches it holds to their kernels' counts (and the collectives it
holds to its mesh's, :func:`taken_back`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import os
import shutil
import time

import torch

from stark_tpu_torch.utils.build import PACKAGE_DIR, build_library

CSRC = os.path.join(PACKAGE_DIR, "csrc")
SOURCES = ("ntt.cu", "fold.cu", "hash.cu", "gather.cu", "witness.cu")
HEADERS = ("field.cuh", "hash.cuh")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--threads", "0", "-shared", "-Xcompiler", "-fPIC",
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
        if k.generated:
            continue
        fn = getattr(lib, k.symbol)
        fn.argtypes = [*k.argtypes, ptr]  # every entry ends with the stream
        fn.restype = i32
    return lib


class Kernel:
    """One C entry point of the library: binding, provenance, launch count.

    ``symbol`` is the host entry; the ``__global__`` function it launches is
    ``symbol + "_kernel"`` (:attr:`kernel_symbol`), with C linkage, so that
    a profile shows that name (K13's and K11's are templates: a profile
    shows the name with its template arguments).  A ``generated`` kernel
    (K11) lives in a library of its own, one per AIR (ops/compose.py),
    which its wrapper passes to :meth:`launch`."""

    def __init__(self, name: str, symbol: str, argtypes, *, source: str,
                 replaces: str, generated: bool = False):
        self.name = name
        self.generated = generated
        self.symbol = symbol
        self.kernel_symbol = symbol + "_kernel"
        self.argtypes = list(argtypes)
        self.source = source
        self.replaces = replaces
        self.launches = 0
        KERNELS[name] = self

    def launch(self, device: torch.device, *args, lib: ctypes.CDLL | None = None) -> None:
        """Launch on ``device``'s current stream, from ``lib`` (default: the
        port's library); raise if the launch fails."""
        lib = lib or library()
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


class _Launches:
    """The kernels' launch counts as a ledger (:func:`taken_back`)."""

    def mark(self) -> dict[str, int]:
        return launch_counts()

    def take_back(self, before: dict[str, int]) -> dict[str, int]:
        held = {k: n - before.get(k, 0) for k, n in launch_counts().items()
                if n != before.get(k, 0)}
        for k, n in held.items():
            KERNELS[k].launches -= n
        return held

    def add(self, held: dict[str, int]) -> None:
        for k, n in held.items():
            KERNELS[k].launches += n


#: The launch counts' ledger: a capture takes its launches back from it.
LAUNCHES = _Launches()


@contextlib.contextmanager
def taken_back(ledgers):
    """Within the block, what the code adds to each ledger is recorded and,
    at its end, taken back out: the block yields a list that then holds
    (ledger, what it added) pairs, for :func:`add_back`.  A ledger has
    ``mark()``, ``take_back(mark)`` -> what was added since, and
    ``add(held)``: :data:`LAUNCHES`, and parallel/mesh.Mesh's collective
    counts.  A capture runs nothing, so what its body counted is taken back
    and each replay adds it again."""
    marks = [(ledger, ledger.mark()) for ledger in ledgers]
    held: list = []
    try:
        yield held
    finally:
        held.extend((ledger, ledger.take_back(mark)) for ledger, mark in marks)


def add_back(held: list) -> None:
    """Add to each ledger what :func:`taken_back` took out of it."""
    for ledger, got in held:
        ledger.add(got)


class Graph:
    """The kernel launches of ``body()``, captured once on ``device`` as a
    CUDA graph (``torch.cuda.graph``, in ``mode``: ``global`` by default;
    ``thread_local`` where other threads of the process make CUDA calls of
    their own during the capture, as NCCL's watchdog does) and replayed on
    the current stream: the port's form of one jit (stark_tpu/batch.py:
    _batch_mega_fn).  Every kernel the body launches must have launched
    before (a module's first launch under lazy loading cannot be
    captured), and the body may neither read from the card nor allocate
    pinned memory.  Tensors it allocates come from the graph's own memory
    pool and keep their addresses for as long as the graph lives; what the
    body returns (:attr:`result`) is what the caller keeps of them.  A
    failed capture or replay raises.

    Nothing runs at capture, so what the body counts is taken back
    (:func:`taken_back`) from the launch counts (held in :attr:`launches`)
    and from ``ledgers`` (a mesh's collectives, held in :attr:`held`);
    each :meth:`replay` adds it again.  :attr:`seconds`: the capture's host
    time; :attr:`pool_bytes`: the device memory the graph's pool reserved;
    :meth:`close` releases it."""

    def __init__(self, body, device: torch.device, ledgers=(), mode: str = "global"):
        # What torch.cuda.graph does on entry, done first here so that the
        # memory reserved before the capture is read after it.
        torch.cuda.synchronize(device)
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with taken_back((LAUNCHES, *ledgers)) as self.held, torch.cuda.device(device), \
                torch.cuda.graph(self.graph, capture_error_mode=mode):
            self.result = body()
        self.launches = self.held[0][1]
        self.seconds = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved

    def replay(self) -> None:
        self.graph.replay()
        add_back(self.held)

    def close(self) -> None:
        """Release the graph (``CUDAGraph.reset``) and what it returned; it
        replays no more.  NCCL's teardown waits for every graph that holds
        its operations (parallel/pstark.py)."""
        self.graph.reset()
        self.result = None


def check_operand(t: torch.Tensor, name: str,
                  dtype: torch.dtype = torch.int32) -> None:
    """Kernel operands: contiguous tensors of ``dtype`` on a CUDA device."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors (kernels that size their grid
    to the card)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def device_or_raise(device, what: str) -> torch.device:
    """``device`` as a torch.device with its index (``cuda`` is the current
    card, as the tensors made there report it); raises if it names CUDA
    and no card is visible (entry points never carry on on the CPU
    unasked)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device (pass device='cpu' for the "
                           "plain torch path)")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
