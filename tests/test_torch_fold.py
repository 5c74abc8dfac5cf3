"""The port's FRI fold (kernel K4's plain version on the CPU) against the
TPU kernel in interpret mode and stark_tpu's Fri.fold_codeword, bit-equal,
with raw challenges above 2^63 among the cases; on a card, the kernel
against its plain version."""

import numpy as np
import pytest
import torch

from stark_tpu_torch.fri import Fri as TFri
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fold as TFOLD
from stark_tpu_torch.ops.fieldops import P, primitive_nth_root
from torch_port_support import cuda_device, rand_field, to_numpy, to_torch  # noqa: F401

N = 4096
ALPHAS = [0, 1, P - 1, P, 12345678901234567, (1 << 63) + 5, (1 << 64) - 1]


def _fris():
    from stark_tpu.fri import Fri as JFri

    kw = dict(
        omega=primitive_nth_root(N),
        offset=3,
        domain_length=N,
        expansion_factor=4,
        num_colinearity_tests=4,
    )
    return JFri(**kw), TFri(**kw)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("round_idx", [0, 3])
def test_fold_matches_stark_tpu(alpha, round_idx):
    import jax.numpy as jnp

    from stark_tpu.fri import _INV2, _INV2_SHOUP
    from stark_tpu.ops import fieldops as JF
    from stark_tpu.ops import pallas_kernels as PK

    jfri, tfri = _fris()
    n = N >> round_idx
    cw = rand_field(np.random.default_rng(alpha % 1000 + round_idx), n)
    got = to_numpy(tfri.fold_codeword(to_torch(cw), alpha, round_idx))
    want = np.asarray(jfri.fold_codeword(jnp.asarray(cw), alpha, round_idx))
    np.testing.assert_array_equal(got, want)

    # The Pallas kernel itself (interpret mode), on the same ladder.
    inv_x = jfri._plan.inv_x_mont(round_idx)
    np.testing.assert_array_equal(
        to_numpy(tfri._plan.inv_x_mont(round_idx, "cpu")), np.asarray(inv_x)
    )
    a_red = alpha % P
    scalars = jnp.asarray(
        [a_red, int(JF.shoup_precompute(a_red)), _INV2, _INV2_SHOUP],
        dtype=jnp.uint32,
    )
    pallas = PK.fold_pallas(
        jnp.asarray(cw[: n // 2]), jnp.asarray(cw[n // 2 :]), inv_x, scalars,
        interpret=True,
    )
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_fold_constants_match_stark_tpu():
    from stark_tpu.fri import _INV2, _INV2_SHOUP

    assert (TFOLD.INV2, TFOLD.INV2_SHOUP) == (_INV2, _INV2_SHOUP)


def test_fold_rejects_bad_operands():
    cw = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        TFOLD.fold(cw, torch.zeros(3, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        TFOLD.fold(torch.zeros(7, dtype=torch.int32), torch.zeros(3, dtype=torch.int32), 5)


@pytest.mark.gpu
@pytest.mark.parametrize("half", [1, 128, 1 << 12, 1 << 21])
@pytest.mark.parametrize("alpha", [7, (1 << 64) - 1])
def test_fold_kernel_matches_plain_on_card(cuda_device, half, alpha):
    rng = np.random.default_rng(half)
    cw = to_torch(rand_field(rng, 2 * half), cuda_device)
    inv_x = to_torch(rand_field(rng, half), cuda_device)
    before = cuda.launch_counts()["fri_fold"]
    got = TFOLD.fold(cw, inv_x, alpha)
    assert cuda.launch_counts()["fri_fold"] == before + 1
    assert torch.equal(got, TFOLD.fold_plain(cw, inv_x, alpha))
