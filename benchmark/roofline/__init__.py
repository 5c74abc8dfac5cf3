"""A kernel's least time for one proof: the bytes it must move over the
card's published memory bandwidth (each input byte read once, each output
byte written once; what a kernel may compute on the fly, such as twiddle
or point tables, is not counted).

One module a kernel of the measured program: ``KERNELS``, the fragments of
the names under which its launches appear in a profile, and ``work(shape)``
-> ``{"bytes": ...}`` for one proof at the cell's ``shape`` (harness.shape:
T, N, c, B, rounds, tests, frame).  A module whose stage is split
over several launches or kernels by the program (a tree's levels between
K7 and K8) covers them together, since the split is the program's to
change.

Every bound is by bytes alone.  The hash is a byte-oriented design whose
operations an implementation may pack four or more to a 32-bit
instruction, and the field's products may be formed in several ways, so no
count of integer instructions is work that every implementation must do;
a byte count is.  No share can then pass 100 % for any implementation that
reads its inputs and writes its outputs.
"""

from __future__ import annotations

from pathlib import Path

#: NVIDIA H100 SXM5 80 GB (HBM3): 3.35 TB/s of memory bandwidth (NVIDIA H100
#: Tensor Core GPU datasheet).  torch.cuda.get_device_name() reads this part
#: as "NVIDIA H100 80GB HBM3".
HBM_BYTES_PER_S = 3.35e12


def kernels() -> dict:
    """{name: module} of every kernel's file in this folder."""
    from benchmark import harness as H

    here = Path(__file__).resolve().parent
    return {p.stem: H.load_module(p, f"benchmark_roofline_{p.stem}")
            for p in sorted(here.glob("*.py")) if not p.stem.startswith("_")}


def matches(mod, kernel_name: str) -> bool:
    return any(frag in kernel_name for frag in mod.KERNELS)


def least_seconds(mod, shape: dict) -> float:
    return mod.work(shape)["bytes"] / HBM_BYTES_PER_S
