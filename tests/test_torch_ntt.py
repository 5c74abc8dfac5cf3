"""The port's NTT against stark_tpu: the plain torch paths on the CPU
(bit-equal, tolerance zero), the four-step plan tables against the Pallas
engine's, and — on a card only — kernels K1-K3 against their plain
versions.

On a CPU tensor ops/ntt routes through the plain versions of the three
four-step kernels, so these tests hold the kernels' decomposition (plan
tables, twiddles, transposes) against stark_tpu as well as the Stockham.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import ntt as TN
from stark_tpu_torch.ops import ntt_fused as NTF
from torch_port_support import cuda_device, rand_field, to_numpy, to_torch  # noqa: F401

SIZES = [1 << 4, 1 << 10, 1 << 16]


@pytest.fixture(scope="module")
def jN():
    from stark_tpu.ops import ntt

    return ntt


def _input(n, batch, seed):
    shape = (batch, n) if batch > 1 else (n,)
    return rand_field(np.random.default_rng(seed), shape)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", SIZES)
def test_ntt_intt_match_stark_tpu(jN, n, batch):
    x = _input(n, batch, n + batch)
    np.testing.assert_array_equal(to_numpy(TN.ntt(to_torch(x))), np.asarray(jN.ntt(x)))
    np.testing.assert_array_equal(to_numpy(TN.intt(to_torch(x))), np.asarray(jN.intt(x)))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n", SIZES)
def test_coset_and_lde_match_stark_tpu(jN, n, batch):
    x = _input(n, batch, 7 * n + batch)
    t = to_torch(x)
    np.testing.assert_array_equal(
        to_numpy(TN.coset_eval(t, 3)), np.asarray(jN.coset_eval(x, 3))
    )
    np.testing.assert_array_equal(
        to_numpy(TN.coset_interp(t, 3)), np.asarray(jN.coset_interp(x, 3))
    )
    if n <= 1 << 10:
        np.testing.assert_array_equal(
            to_numpy(TN.lde(t, 4, 3)), np.asarray(jN.lde(x, 4, 3))
        )


@pytest.mark.parametrize("n", SIZES)
def test_stockham_matches_stark_tpu(jN, n):
    x = _input(n, 3, 11 * n)
    for inverse, want in ((False, jN.ntt(x)), (True, jN.intt(x))):
        got = NTF.ntt_plain(to_torch(x), inverse)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("n,inverse", [(1 << 16, False), (1 << 16, True), (1 << 17, False)])
def test_four_step_matches_pallas_kernel(n, inverse):
    # The TPU kernel itself, in interpret mode (as tests/test_ntt_fused.py
    # runs it).
    from stark_tpu.ops.ntt_fused import fused_ntt

    x = _input(n, 1, 13 * n + inverse)
    want = np.asarray(fused_ntt(x, inverse=inverse, interpret=True))
    got = NTF.fused_ntt(to_torch(x), inverse)
    np.testing.assert_array_equal(to_numpy(got), want)


@pytest.mark.parametrize("n", [1 << 14, 1 << 16, 1 << 17])
@pytest.mark.parametrize("inverse", [False, True])
def test_plan_tables_match_pallas_plan(n, inverse):
    from stark_tpu.ops.ntt_fused import _get_plan

    jp = _get_plan(n, inverse)
    tp = NTF.get_plan(n, inverse, torch.device("cpu"))
    assert (tp.n1, tp.n2) == (jp.n1, jp.n2)
    # The port's natural-row wm is the JAX table with its rows un-permuted.
    np.testing.assert_array_equal(to_numpy(tp.wm)[jp.perm1], jp.wm)
    # Stage s of the dense (rows, stages) DIF tables holds tw[j << s] at
    # rows [m/2^(s+1), m/2^s) — the compact tables carry the same values.
    for (tw, tws), (dense, dense_s), m in (
        ((tp.tw1, tp.tw1_shoup), jp.stages1, jp.n1),
        ((tp.tw2, tp.tw2_shoup), jp.stages2, jp.n2),
    ):
        tw = tw.numpy().view(np.uint32)
        tws = tws.numpy().view(np.uint32)
        for s in range(m.bit_length() - 1):
            half = m >> (s + 1)
            j = np.arange(half)
            np.testing.assert_array_equal(dense[half : 2 * half, s], tw[j << s])
            np.testing.assert_array_equal(dense_s[half : 2 * half, s], tws[j << s])


def test_host_engine_matches_stark_tpu(jN):
    for n in (1, 2, 8, 64):
        x = _input(n, 1, n)
        np.testing.assert_array_equal(
            TN.host_coset_interp(x, 5), jN.host_coset_interp(x, 5)
        )
        np.testing.assert_array_equal(
            TN.host_coset_eval(x, 5), jN.host_coset_eval(x, 5)
        )


def test_cpu_tensors_take_the_plain_versions():
    cuda.reset_launches()
    x = to_torch(_input(1 << 10, 2, 3))
    np.testing.assert_array_equal(
        to_numpy(NTF.fused_ntt(x)), to_numpy(NTF.ntt_plain(x))
    )
    assert all(c == 0 for c in cuda.launch_counts().values())


def test_wrappers_reject_bad_operands():
    with pytest.raises(ValueError):
        NTF.fused_ntt(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        NTF.fused_ntt(torch.zeros(64, dtype=torch.int64))
    plan = NTF.get_plan(64, False, torch.device("cpu"))
    with pytest.raises(ValueError):
        NTF.ntt_pass1(torch.zeros((1, 4, 16), dtype=torch.int32), plan)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 6, 1 << 10, 1 << 16, 1 << 17, 1 << 20, 1 << 22])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("inverse", [False, True])
def test_kernels_match_plain_on_card(cuda_device, n, batch, inverse):
    x = to_torch(_input(n, batch, n + batch), cuda_device)
    before = cuda.launch_counts()
    got = NTF.fused_ntt(x, inverse)
    for name in ("ntt_pass1", "ntt_transpose", "ntt_pass2"):
        assert cuda.launch_counts()[name] == before[name] + 1
    assert torch.equal(got, NTF.ntt_plain(x, inverse))
    plan = NTF.get_plan(n, inverse, cuda_device)
    x3 = x.reshape(-1, plan.n1, plan.n2)
    y3 = NTF.ntt_pass1(x3, plan)
    assert torch.equal(y3, NTF.pass1_plain(x3, plan))
    yt = NTF.ntt_transpose(y3)
    assert torch.equal(yt, NTF.transpose_plain(y3))
    assert torch.equal(NTF.ntt_pass2(yt, plan), NTF.pass2_plain(yt, plan))
