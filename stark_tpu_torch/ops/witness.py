"""Device witnesses: kernel K12 (csrc/witness.cu), two entries, and the
plain version of each.

Counterparts of the JAX package's jit-fused expansions that let a prove
start from trace columns made on the device (stark_tpu/models/fibonacci.py:
_fib_block_fn, stark_tpu/models/examples.py:_mds_expand_fn).  The host
makes a length's basis once (models/fibonacci.py) or the seeds
(models/examples.py); these functions expand them:

    fib_expand   (3 nb + 2 B,) basis F_{kB-2} | F_{kB-1} | F_{kB} | u0 | u1
                 and a start pair (a, b) -> (1, length), the run a_0 = a,
                 a_1 = b: out[k B + j] = s1[k] u1[j] + s0[k] u0[j] mod p
                 with s1[k] = a F_{kB-1} + b F_{kB}, s0[k] = a F_{kB-2} + b
                 F_{kB-1};
    mds_expand   (nb, 8) block-start states -> (8, length): block b's
                 states k = 0 .. block-1 under s' = (M s)^2 + rc mod p fill
                 columns b block + k.

Every value is an exact integer mod p: the kernels and the plain versions
(int64 torch ops) agree bit for bit.  On a CPU tensor the plain version
runs; on a CUDA tensor the kernel launches or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops.fieldops import P

_SRC = "stark_tpu_torch/csrc/witness.cu"
_I64 = ctypes.c_longlong
_U32 = ctypes.c_uint
FIB_EXPAND = cuda.Kernel(
    "fib_expand", "stark_fib_expand_basis",
    [cuda.ptr] * 2 + [cuda.i32] * 2 + [_I64, _U32, _U32, cuda.i32],
    source=_SRC, replaces="stark_tpu/models/fibonacci.py:58",
)
MDS_EXPAND = cuda.Kernel(
    "mds_expand", "stark_mds_expand", [cuda.ptr] * 3 + [cuda.i32] * 2 + [_I64],
    source=_SRC, replaces="stark_tpu/models/examples.py:173",
)

MDS_WIDTH = 8


def _fib_split(basis: torch.Tensor, nb: int, length: int) -> int:
    """The block width B of a packed Fibonacci basis (a power of two),
    checked against ``length``."""
    b = (int(basis.shape[0]) - 3 * nb) // 2
    if basis.dim() != 1 or nb < 1 or b < 1 or b & (b - 1) or 3 * nb + 2 * b != basis.shape[0]:
        raise ValueError(f"basis must be F_{{kB-2}} | F_{{kB-1}} | F_{{kB}} (nb = {nb}) | "
                         f"u0 | u1 (a power of two), got {tuple(basis.shape)}")
    if not (nb - 1) * b < length <= nb * b:
        raise ValueError(f"length {length} is not cut from {nb} blocks of {b}")
    return b


def fib_expand_plain(basis: torch.Tensor, nb: int, length: int, start) -> torch.Tensor:
    b = _fib_split(basis, nb, length)
    x, y = (int(v) % P for v in start)
    f = basis.long()
    fm2, fm1, f0 = f[:nb], f[nb : 2 * nb], f[2 * nb : 3 * nb]
    u0, u1 = f[3 * nb : 3 * nb + b], f[3 * nb + b :]
    s0 = (x * fm2 + y * fm1) % P                     # a_{kB-1}
    s1 = (x * fm1 + y * f0) % P                      # a_{kB}
    out = (s1[:, None] * u1[None, :] % P + s0[:, None] * u0[None, :] % P) % P
    return out.reshape(1, -1)[:, :length].to(torch.int32)


def fib_expand(basis: torch.Tensor, nb: int, length: int, start) -> torch.Tensor:
    """(3 nb + 2 B,) int32 basis and the start pair (a, b) -> (1, length)
    int32 trace columns of the run from it, with nb B >= length > (nb - 1)
    B: one launch, and nothing waits for the card."""
    b = _fib_split(basis, nb, length)
    if basis.device.type == "cpu":
        return fib_expand_plain(basis, nb, length, start)
    cuda.check_operand(basis, "basis")
    x, y = (int(v) % P for v in start)
    out = torch.empty((1, length), dtype=torch.int32, device=basis.device)
    FIB_EXPAND.launch(basis.device, basis.data_ptr(), out.data_ptr(), nb,
                      b.bit_length() - 1, length, x, y, cuda.sm_count(basis.device))
    return out


def _mds_check(consts: torch.Tensor, seeds: torch.Tensor, block: int, length: int):
    nb = int(seeds.shape[0])
    if tuple(consts.shape) != (MDS_WIDTH * MDS_WIDTH + MDS_WIDTH,):
        raise ValueError(f"consts must be M (8 x 8) | rc (8), got {tuple(consts.shape)}")
    if seeds.dim() != 2 or seeds.shape[1] != MDS_WIDTH or nb < 1:
        raise ValueError(f"seeds must be (nb, 8), got {tuple(seeds.shape)}")
    if block < 1 or not (nb - 1) * block < length <= nb * block:
        raise ValueError(f"length {length} is not cut from {nb} blocks of {block}")


def mds_expand_plain(consts: torch.Tensor, seeds: torch.Tensor, block: int,
                     length: int) -> torch.Tensor:
    _mds_check(consts, seeds, block, length)
    w = MDS_WIDTH
    m, rc = consts[: w * w].long().reshape(w, w), consts[w * w :].long()
    s = seeds.long()
    states = []
    for _ in range(block):
        states.append(s)
        acc = torch.zeros_like(s)
        for j in range(w):
            acc = (acc + s[:, j : j + 1] * m[:, j][None, :]) % P
        s = (acc * acc % P + rc[None, :]) % P
    rows = torch.stack(states, dim=1).reshape(-1, w)  # row b block + k
    return rows[:length].T.contiguous().to(torch.int32)


def mds_expand(consts: torch.Tensor, seeds: torch.Tensor, block: int,
               length: int) -> torch.Tensor:
    """(72,) int32 M | rc and (nb, 8) int32 block-start states -> (8,
    length) int32 trace columns, nb block >= length > (nb - 1) block."""
    _mds_check(consts, seeds, block, length)
    if seeds.device.type == "cpu":
        return mds_expand_plain(consts, seeds, block, length)
    cuda.check_operand(consts, "consts")
    cuda.check_operand(seeds, "seeds")
    if consts.device != seeds.device:
        raise ValueError(f"consts on {consts.device}, seeds on {seeds.device}")
    out = torch.empty((MDS_WIDTH, length), dtype=torch.int32, device=seeds.device)
    MDS_EXPAND.launch(seeds.device, consts.data_ptr(), seeds.data_ptr(),
                      out.data_ptr(), int(seeds.shape[0]), block, length)
    return out
