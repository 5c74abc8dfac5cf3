"""K14, the LDE's zero pad and coset scale (ops/ntt.pad_scale, csrc/ntt.cu
stark_lde_pad_scale), against stark_tpu.

On the CPU the wrapper runs its plain version, which is held bit for bit
against stark_tpu's own pad and scale (``jnp.pad`` then
``_coset_scale_fwd``; ``_coset_scale_inv`` for the inverse offset) and,
through ``lde`` / ``coset_eval`` / ``coset_interp``, against stark_tpu's
functions of those names, at small sizes and at the B·c rows of a batch;
a prove or a batch calls it once.  On a card (marker ``gpu``): the kernel
against its plain version on both routes.  Tolerance zero throughout.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch import BatchStarkProver, StarkConfig, StarkProver
from stark_tpu_torch.models import FibonacciAir, fibonacci_trace_mod_p
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import ntt as TN
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
def test_one_pad_scale_a_prove_or_batch(monkeypatch, batch):
    # The B·c rows of a prove or a batch go through K14 in one call.
    calls = []
    pad_scale = TN.pad_scale
    monkeypatch.setattr(TN, "pad_scale",
                        lambda c, n, s: calls.append(tuple(c.shape)) or pad_scale(c, n, s))
    cfg = StarkConfig(trace_length=64, blowup=4, num_colinearity_tests=4)
    trace = fibonacci_trace_mod_p(64)
    if batch == 1:
        StarkProver(FibonacciAir(), cfg, device="cpu").prove(trace)
    else:
        BatchStarkProver(FibonacciAir(), cfg, batch, device="cpu").prove_batch([trace] * batch)
    assert calls == [(batch, 64)]


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
