"""The LDE's zero pad and coset scale: K14 (ops/ntt.pad_scale, csrc/ntt.cu
stark_lde_pad_scale) and K1 of an LDE (ops/ntt_fused.ntt_pass1_lde, csrc/
ntt.cu stark_ntt_pass1_lde: the pad and scale in pass 1's first round),
against stark_tpu.

On the CPU the wrappers run their plain versions, which are held bit for
bit against stark_tpu's own pad and scale (``jnp.pad`` then
``_coset_scale_fwd``; ``_coset_scale_inv`` for the inverse offset) and,
through ``lde`` / ``coset_eval`` / ``coset_interp``, against stark_tpu's
functions of those names, at small sizes and at the B·c rows of a batch; a
model of K1's first-round addressing (which elements it loads, which power
of s each gets) against K14's plain pad and scale and pass 1; a prove or a
batch makes one LDE pass over its B·c rows and calls K14 nowhere.  On a
card (marker ``gpu``): each kernel against its plain version, K14 on both
routes, K1 of an LDE strict and lazy.  Tolerance zero throughout.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkProver
from stark_tpu_torch.models import FibonacciAir, fibonacci_trace_mod_p
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import ntt as TN
from stark_tpu_torch.ops import ntt_fused as NTF
from stark_tpu_torch.ops.fieldops import P, host_powers, shoup_precompute
from torch_port_support import cuda_device, rand_field, to_numpy, to_torch  # noqa: F401

# (rows, t, n): the LDE's (T -> N) at blowups 1, 2, 4 and 8, and B·c rows of
# the batched paths (8 proofs of MdsSquareAir's 8 registers: 64 rows).
PAD_CASES = [(1, 1, 4), (3, 2, 8), (1, 4, 4), (5, 16, 64), (1, 64, 256),
             (8, 64, 256), (24, 16, 128), (64, 32, 128), (2, 1024, 4096)]
OFFSETS = [3, 5, P - 1]


@pytest.fixture(scope="module")
def jN():
    from stark_tpu.ops import ntt

    return ntt


def _coeffs(rows, t, seed):
    return rand_field(np.random.default_rng(seed), (rows, t))


@pytest.mark.parametrize("rows,t,n", PAD_CASES)
def test_pad_scale_matches_stark_tpu(jN, rows, t, n):
    x = _coeffs(rows, t, rows * t + n)
    want = jN._coset_scale_fwd(np.pad(x, ((0, 0), (0, n - t))), n, 3)
    np.testing.assert_array_equal(to_numpy(TN.pad_scale(to_torch(x), n, 3)),
                                  np.asarray(want))


@pytest.mark.parametrize("offset", OFFSETS)
def test_inverse_scale_matches_stark_tpu(jN, offset):
    # coset_interp's case: t = n and the inverse of the offset.
    x = _coeffs(8, 64, offset % 1000)
    inv = pow(offset, P - 2, P)
    np.testing.assert_array_equal(to_numpy(TN.pad_scale(to_torch(x), 64, inv)),
                                  np.asarray(jN._coset_scale_inv(x, 64, offset)))


@pytest.mark.parametrize("b,c,t", [(1, 1, 16), (2, 1, 64), (3, 8, 16), (8, 1, 64)])
@pytest.mark.parametrize("blowup", [4, 8])
def test_lde_matches_stark_tpu_at_batch_rows(jN, b, c, t, blowup):
    x = _coeffs(b * c, t, b * c * t + blowup)
    got = TN.lde(to_torch(x).reshape(b, c, t), blowup, 3)
    assert got.shape == (b, c, t * blowup)
    np.testing.assert_array_equal(to_numpy(got).reshape(b * c, -1),
                                  np.asarray(jN.lde(x, blowup, 3)))


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("rows,n", [(1, 16), (8, 64), (3, 256)])
def test_coset_eval_and_interp_match_stark_tpu(jN, offset, rows, n):
    x = _coeffs(rows, n, rows + n + offset % 1000)
    t = to_torch(x)
    np.testing.assert_array_equal(to_numpy(TN.coset_eval(t, offset)),
                                  np.asarray(jN.coset_eval(x, offset)))
    np.testing.assert_array_equal(to_numpy(TN.coset_interp(t, offset)),
                                  np.asarray(jN.coset_interp(x, offset)))


def test_scale_table_is_the_powers_and_companions_built_once():
    dev = torch.device("cpu")
    table = TN.scale_table(64, 3, dev)
    assert table.shape == (2, 64) and table.dtype == torch.int32
    w = host_powers(3, 64)
    np.testing.assert_array_equal(table[0].numpy().view(np.uint32), w)
    np.testing.assert_array_equal(table[1].numpy().view(np.uint32), shoup_precompute(w))
    assert TN.scale_table(64, 3, dev) is table


def test_pad_scale_rejects_bad_shapes():
    x = torch.zeros((2, 8), dtype=torch.int32)
    for bad in (lambda: TN.pad_scale(x[0], 16, 3),       # not (rows, t)
                lambda: TN.pad_scale(x, 4, 3),           # t > n
                lambda: TN.pad_scale(x, 24, 3),          # n not a power of two
                lambda: TN.pad_scale(x[:, :6], 24, 3)):  # t not a power of two
        with pytest.raises(ValueError):
            bad()


def test_cpu_tensors_take_the_plain_version():
    cuda.reset_launches()
    x = to_torch(_coeffs(2, 16, 1))
    assert torch.equal(TN.pad_scale(x, 64, 3), TN.pad_scale_plain(x, 64, 3))
    assert cuda.launch_counts()["lde_pad_scale"] == 0


@pytest.mark.parametrize("batch", [1, 3])
def test_one_lde_pass_a_prove_or_batch(monkeypatch, batch):
    # The B·c rows of a prove or a batch go through one LDE pass 1 (its
    # first round the pad and scale), and K14 runs nowhere.
    calls, pads = [], []
    pass1 = NTF.ntt_pass1_lde
    monkeypatch.setattr(NTF, "ntt_pass1_lde", lambda c, plan, s, lazy=False: calls.append(
        (tuple(c.shape), plan.n)) or pass1(c, plan, s, lazy))
    monkeypatch.setattr(TN, "pad_scale_by", lambda *a: pads.append(a))
    cfg = StarkConfig(trace_length=64, blowup=4, num_colinearity_tests=4)
    trace = fibonacci_trace_mod_p(64)
    if batch == 1:
        StarkProver(FibonacciAir(), cfg, device="cpu").prove(trace)
    else:
        BatchStarkProver(FibonacciAir(), cfg, batch, device="cpu").prove_batch([trace] * batch)
    c = FibonacciAir.num_registers
    assert calls == [((batch * c, 64), 256)] and pads == []


def first_round_loads(b: int, t: int, n: int) -> dict:
    """K1 of an LDE's first round as csrc/ntt.cu runs it (ntt_round with
    kLde, col_ntt's offsets), unit by unit of every block: {(entry, i1,
    i2): (e, row, col)} for every element it loads from the coefficients
    (e the coefficient's index, row and col the scale tables' entries it
    multiplies by), and the elements it sets to zero."""
    plan = NTF.get_plan(n, False, torch.device("cpu"))
    lg_r, cols = plan.lg1, plan.n2
    lg_tc, _ = NTF._launch_shape(lg_r, cols, b)
    q = NTF.round_stages(lg_r)[0]
    b_lo = lg_r - q
    loads, zeros = {}, set()
    for entry in range(b):
        for bx in range(cols >> lg_tc):
            c0 = bx << lg_tc
            for u in range(1 << (lg_r - q + lg_tc)):
                c, g = u & ((1 << lg_tc) - 1), u >> lg_tc
                lo, hi = g & ((1 << b_lo) - 1), g >> b_lo
                row0 = (hi << (b_lo + q)) | lo
                src = row0 * cols + c
                for m in range(1 << q):
                    e = src + m * (cols << b_lo)
                    where = (entry, (c0 + e) // cols, (c0 + e) % cols)
                    assert where not in loads and where not in zeros
                    if e < t - c0:
                        loads[where] = (c0 + e, row0 + (m << b_lo), c0 + c)
                    else:
                        zeros.add(where)
    assert len(loads) + len(zeros) == b * n
    return loads


# (B, T, N): T < n2, T = n2, T > n2, blowups 1, 2, 4 and 16, T of 1 and 2.
FIRST_ROUND_CASES = [(b, t, t * blowup) for b in (1, 3)
                     for t, blowup in ((4, 16), (8, 4), (16, 1), (16, 2), (64, 4), (64, 16),
                                       (256, 1), (256, 4), (1, 4), (2, 2), (32, 2))]


@pytest.mark.parametrize("b, t, n", FIRST_ROUND_CASES)
def test_lde_first_round_addressing(b, t, n):
    # Which (i1, i2) the first round loads (only e = i1 n2 + i2 < T, each
    # once) and which power of s each gets (s^(n2 row) s^col from the two
    # tables, row and col the element's own): through pass 1, K14's plain
    # pad and scale then K1's plain version.
    s = 3
    plan = NTF.get_plan(n, False, torch.device("cpu"))
    coeffs = to_torch(_coeffs(b, t, b * t + n))
    table = NTF.lde_scale(n, s, torch.device("cpu")).numpy().view(np.uint32)
    rows, cols = table[: plan.n1, 0].astype(np.uint64), table[plan.n1:, 0].astype(np.uint64)
    x = np.zeros((b, plan.n1, plan.n2), dtype=np.uint64)
    c64 = to_numpy(coeffs).astype(np.uint64)
    for (entry, i1, i2), (e, row, col) in first_round_loads(b, t, n).items():
        assert (row, col) == (i1, i2) and e == i1 * plan.n2 + i2 < t
        x[entry, i1, i2] = c64[entry, e] * rows[row] % P * cols[col] % P
    assert np.array_equal(rows, host_powers(pow(s, plan.n2, P), plan.n1))
    assert np.array_equal(cols, host_powers(s, plan.n2))
    want = TN.pad_scale_plain(coeffs, n, s).reshape(b, plan.n1, plan.n2)
    np.testing.assert_array_equal(x, to_numpy(want).astype(np.uint64))
    np.testing.assert_array_equal(NTF.lde_input_plain(coeffs, plan, s).numpy(), x)
    for lazy in (False, True):
        assert torch.equal(NTF.ntt_pass1_lde(coeffs, plan, s, lazy),
                           NTF.pass1_plain(want, plan, lazy))


def test_lde_pass1_rejects_bad_operands():
    plan = NTF.get_plan(64, False, torch.device("cpu"))
    x = torch.zeros((2, 16), dtype=torch.int32)
    for bad in (lambda: NTF.ntt_pass1_lde(x[0], plan, 3),            # not (B, T)
                lambda: NTF.ntt_pass1_lde(x[:, :6], plan, 3),        # T not a power of two
                lambda: NTF.ntt_pass1_lde(torch.zeros((1, 128), dtype=torch.int32), plan, 3),
                lambda: NTF.ntt_pass1_lde(x, NTF.get_plan(64, True, torch.device("cpu")), 3)):
        with pytest.raises(ValueError):
            bad()
    cuda.reset_launches()
    NTF.ntt_pass1_lde(x, plan, 3)
    assert cuda.launch_counts()["ntt_pass1_lde"] == 0  # a CPU tensor: the plain version


@pytest.mark.gpu
@pytest.mark.parametrize("rows,t,n", PAD_CASES + [(1, 1 << 20, 1 << 22),
                                                  (8, 1 << 16, 1 << 18),
                                                  (8, 1 << 14, 1 << 16)])
@pytest.mark.parametrize("offset", [3, pow(3, P - 2, P)])
def test_kernel_matches_plain_on_card(cuda_device, rows, t, n, offset):
    x = to_torch(_coeffs(rows, t, rows + t), cuda_device)
    before = cuda.launch_counts()["lde_pad_scale"]
    got = TN.pad_scale(x, n, offset)
    assert cuda.launch_counts()["lde_pad_scale"] == before + 1
    assert torch.equal(got, TN.pad_scale_plain(x, n, offset))
    # A view that starts off a 16-byte boundary is copied first.
    if t >= 4:
        flat = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].reshape(rows, t)
        assert torch.equal(TN.pad_scale(flat, n, offset), got)


# K1 of an LDE on a card: (B, T, N) of the three paths (Fibonacci T=2^20, MDS
# T=2^16's 8 rows, batch8's 8 rows), then T < n2, blowups 1, 2, 8, 16 and
# 32, T of 1 and 2 (K14's edge route), T = 2^22 with blowup 1 (the most
# elements a batch entry holds).
LDE_CARD_CASES = [(1, 1 << 20, 1 << 22), (8, 1 << 16, 1 << 18), (8, 1 << 14, 1 << 16),
                  (3, 4, 64), (2, 16, 1024), (1, 1, 4), (3, 2, 8), (3, 1, 32),
                  (2, 1 << 10, 1 << 10), (3, 1 << 12, 1 << 13), (1, 1 << 12, 1 << 15),
                  (5, 1 << 11, 1 << 15), (2, 1 << 9, 1 << 14), (1, 1 << 22, 1 << 22),
                  (64, 1 << 14, 1 << 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, n", LDE_CARD_CASES)
@pytest.mark.parametrize("lazy", [False, True])
def test_lde_pass1_matches_plain_on_card(cuda_device, b, t, n, lazy):
    c = to_torch(_coeffs(b, t, b + t + n), cuda_device)
    plan = NTF.get_plan(n, False, cuda_device)
    want = NTF.pass1_lde_plain(c, plan, 3, lazy)
    name = "ntt_pass1_lde_lazy" if lazy else "ntt_pass1_lde"
    before = cuda.launch_counts()[name]
    for _ in range(2):
        assert torch.equal(NTF.ntt_pass1_lde(c, plan, 3, lazy), want)
    assert cuda.launch_counts()[name] == before + 2
    # the whole LDE against K14's plain pad and scale, then the NTT's
    assert torch.equal(TN.lde(c, n // t, 3, lazy), TN.ntt(TN.pad_scale_plain(c, n, 3), lazy))
