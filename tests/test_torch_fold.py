"""The port's FRI fold (kernel K4's plain version on the CPU) against the
TPU kernel in interpret mode and stark_tpu's Fri.fold_codeword, bit-equal,
with raw challenges above 2^63 among the cases; the fold with alpha in
device memory (fold_dyn_plain, B codewords each with its own alpha) against
stark_tpu.fri._fold_kernel_dynamic; one round of the device commit chain
(K4-dyn's plain version: each row's root absorbed into its sponge, the
challenge drawn, the row folded) against stark_tpu's
device_sponge_root_alpha + _fold_kernel_dynamic and the sponge and fold
outputs of its fused rounds, fri._commit_round_fn and
batch._batch_round_fn; on a card, each kernel against its plain version.
"""

import numpy as np
import pytest
import torch

from stark_tpu_torch.fri import Fri as TFri
from stark_tpu_torch.merkle import Forest as TForest
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import fold as TFOLD
from stark_tpu_torch.ops import hash_batch as THB
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


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("round_idx", [0, 3, 6])
def test_fold_dyn_matches_stark_tpu(b, round_idx):
    # (B, n) codewords, a different reduced alpha on each row (0 and p - 1
    # among them), on the same ladder stark_tpu builds.
    import jax.numpy as jnp

    from stark_tpu.fri import _INV2, _INV2_SHOUP, _fold_kernel_dynamic

    jfri, tfri = _fris()
    n = N >> round_idx
    rng = np.random.default_rng(b * 16 + round_idx)
    cw = rand_field(rng, (b, n))
    alpha = rng.integers(0, P, size=b).astype(np.uint32)
    alpha[0] = 0
    alpha[-1] = P - 1 if b > 1 else alpha[-1]
    inv_x = tfri._plan.inv_x_mont(round_idx, "cpu")
    got = to_numpy(TFOLD.fold_dyn_plain(to_torch(cw), inv_x, to_torch(alpha)))
    want = _fold_kernel_dynamic(
        jnp.asarray(cw[:, : n // 2]), jnp.asarray(cw[:, n // 2 :]),
        jfri._plan.inv_x_mont(round_idx), jnp.asarray(alpha)[:, None],
        jnp.uint32(_INV2), jnp.uint32(_INV2_SHOUP))
    np.testing.assert_array_equal(got, np.asarray(want))
    # Row by row, K4's fold with the same alpha gives the same values.
    for row in range(b):
        np.testing.assert_array_equal(
            got[row], to_numpy(TFOLD.fold(to_torch(cw[row]), inv_x, int(alpha[row]))))


def _sponge(prefix: np.ndarray, device="cpu") -> THB.Sponge:
    """A port sponge of B = prefix.shape[0] lanes after ``prefix``."""
    sp = THB.Sponge(prefix.shape[0], device)
    sp.absorb(torch.from_numpy(prefix.copy()).to(device))
    return sp


def _round_inputs(rng, b: int, half: int, q: int):
    """Codewords (B, 2 half), a ladder, a prefix of 64 + q bytes a lane and
    a root a lane, from ``rng``."""
    return (rand_field(rng, (b, 2 * half)), rand_field(rng, half),
            rng.integers(0, 256, size=(b, 64 + q), dtype=np.uint8),
            rng.integers(0, 256, size=(b, 32), dtype=np.uint8))


def _fold_dyn_round(cw, inv_x, sp: THB.Sponge, roots):
    """K4-dyn through its wrapper: (folded, alpha, copy) as numpy."""
    b = cw.shape[0]
    dev = sp.state.device
    copy = torch.empty((b, 32), dtype=torch.uint8, device=dev)
    alpha = torch.empty(b, dtype=torch.int32, device=dev)
    folded = TFOLD.fold_dyn(to_torch(cw, dev), to_torch(inv_x, dev), sp,
                            torch.from_numpy(np.ascontiguousarray(roots)).to(dev), copy, alpha)
    return to_numpy(folded), alpha.cpu().numpy().astype(np.uint32), copy.cpu().numpy()


@pytest.mark.parametrize("q", [0])
def test_fold_dyn_round_matches_sponge_root_alpha_then_fold(q):
    # B = 1: stark_tpu's wide-round chain, device_sponge_root_alpha then
    # _fold_kernel_dynamic, on the same sponge, root, codeword and ladder.
    import jax.numpy as jnp

    from stark_tpu.fri import _INV2, _INV2_SHOUP, _fold_kernel_dynamic
    from stark_tpu.ops import hash_batch as jHB

    rng = np.random.default_rng(40 + q)
    half = 512
    cw, inv_x, prefix, root = _round_inputs(rng, 1, half, q)
    sp = _sponge(prefix)
    got, alpha, copy = _fold_dyn_round(cw, inv_x, sp, root)
    j_state, j_pending = jHB.sponge_from_bytes(jnp.asarray(prefix[0]))
    j_alpha, j_state, j_pending = jHB.device_sponge_root_alpha(
        j_state, j_pending, jnp.asarray(root[0]))
    want = _fold_kernel_dynamic(
        jnp.asarray(cw[0, :half]), jnp.asarray(cw[0, half:]), jnp.asarray(inv_x),
        j_alpha, jnp.uint32(_INV2), jnp.uint32(_INV2_SHOUP))
    np.testing.assert_array_equal(got[0], np.asarray(want))
    np.testing.assert_array_equal(alpha, [int(j_alpha)])
    np.testing.assert_array_equal(sp.state.numpy()[0], np.asarray(j_state))
    assert sp.q == q == j_pending.shape[0]
    np.testing.assert_array_equal(sp.pending.numpy()[0, :q], np.asarray(j_pending))
    np.testing.assert_array_equal(copy, root)


def _check_fused_round(sp, cw, inv_x, j_outs, roots):
    """The port's round on the roots of the port's forest of ``cw``, held
    against a fused JAX round's (root(s), sp_state, sp_pending, alpha,
    folded), its sponge stacked byte-major ((32, B) or (32,))."""
    j_roots, j_state, j_pending, j_alpha, j_folded = (np.asarray(x) for x in j_outs)
    b, q = cw.shape[0], sp.q
    np.testing.assert_array_equal(roots.numpy(), j_roots.reshape(b, 32))
    got, alpha, copy = _fold_dyn_round(cw, inv_x, sp, roots.numpy())
    np.testing.assert_array_equal(got, j_folded.reshape(b, -1))
    np.testing.assert_array_equal(alpha, j_alpha.reshape(b))
    np.testing.assert_array_equal(sp.state.numpy(), j_state.reshape(32, b).T)
    assert sp.q == q == j_pending.shape[0]
    np.testing.assert_array_equal(sp.pending.numpy()[:, :q], j_pending.reshape(q, b).T)
    np.testing.assert_array_equal(sp.pending.numpy()[:, q:], 0)
    np.testing.assert_array_equal(copy, roots.numpy())


# Each fused round is one XLA compile of its tree hash on the CPU (7-12 s
# each): the cases take every W, B and q of the set {2^8, 2^10} x {1, 3,
# 8} x {0, 21} once, not their product.
@pytest.mark.parametrize("w,q", [(1 << 8, 21)])
def test_fold_dyn_round_matches_commit_round_fn(w, q):
    # One proof: stark_tpu's whole fused round (leaf hash, tree, root
    # absorb, challenge, fold in one dispatch) against the port's forest
    # of the codeword and K4-dyn's plain version on its root.
    import jax.numpy as jnp

    from stark_tpu.fri import _INV2, _INV2_SHOUP, _commit_round_fn
    from stark_tpu.ops import hash_batch as jHB

    rng = np.random.default_rng(w + q)
    cw, inv_x, prefix, _ = _round_inputs(rng, 1, w // 2, q)
    sp = _sponge(prefix)
    j_state, j_pending = jHB.sponge_from_bytes(jnp.asarray(prefix[0]))
    out = _commit_round_fn(w, q)(jnp.asarray(cw[0]), j_state, j_pending, jnp.asarray(inv_x),
                                 jnp.uint32(_INV2), jnp.uint32(_INV2_SHOUP))
    roots = TForest.from_values(to_torch(cw)).roots_dev()
    _check_fused_round(sp, cw, inv_x, out[2:7], roots)


@pytest.mark.parametrize("b,w,q", [(3, 1 << 10, 0), (8, 1 << 8, 21)])
def test_fold_dyn_round_matches_batch_round_fn(b, w, q):
    # B proofs: stark_tpu's fused batched round against the port's forest
    # and K4-dyn's plain version, lane by lane.
    import jax.numpy as jnp

    from stark_tpu.batch import _batch_round_fn
    from stark_tpu.fri import _INV2, _INV2_SHOUP
    from stark_tpu.ops import hash_batch as jHB

    rng = np.random.default_rng(b * w + q)
    cw, inv_x, prefix, _ = _round_inputs(rng, b, w // 2, q)
    sp = _sponge(prefix)
    j_state, j_pending = jHB.sponge_from_bytes(jnp.asarray(prefix.T))
    out = _batch_round_fn(b, w, q)(jnp.asarray(cw), j_state, j_pending, jnp.asarray(inv_x),
                                   jnp.uint32(_INV2), jnp.uint32(_INV2_SHOUP))
    roots = TForest.from_values(to_torch(cw)).roots_dev()
    _check_fused_round(sp, cw, inv_x, out[2:7], roots)


def test_fold_dyn_swaps_the_sponge_buffers_into_k9s_state():
    # Rounds of K4-dyn leave in the sponge's buffers, swapped after each,
    # the state, tail and challenges that K9 reaches on the same roots.
    rng = np.random.default_rng(77)
    b, half, q = 3, 64, 8
    cw, inv_x, prefix, _ = _round_inputs(rng, b, half, q)
    fused, k9 = _sponge(prefix), _sponge(prefix)
    for r in range(3):
        root = rng.integers(0, 256, size=(b, 32), dtype=np.uint8)
        current, spare = (fused.state, fused.pending), (fused.next_state, fused.next_pending)
        got, alpha, _ = _fold_dyn_round(cw, inv_x, fused, root)
        want = torch.empty(b, dtype=torch.int32)
        k9.absorb(torch.from_numpy(root), alpha=want)
        assert (fused.state, fused.pending) == spare
        assert (fused.next_state, fused.next_pending) == current
        assert (fused.q, fused.fresh) == (k9.q, k9.fresh) == (q, False)
        assert torch.equal(fused.state, k9.state)
        assert torch.equal(fused.pending, k9.pending)
        np.testing.assert_array_equal(alpha, want.numpy())
        np.testing.assert_array_equal(
            got, to_numpy(TFOLD.fold_dyn_plain(to_torch(cw), to_torch(inv_x), want)))


def test_fri_commit_from_an_empty_transcript(monkeypatch):
    # A fresh transcript: the chain's first K9 starts the sponge (fresh,
    # no bytes), K4-dyn draws every round's challenge but the last from it;
    # the proof stream, the transcript and the codewords equal the host
    # path's (a host challenge and K4 a round).
    from stark_tpu_torch.stream import ProofStream
    from stark_tpu_torch.transcript import FiatShamir

    n = 1024
    codeword = to_torch(rand_field(np.random.default_rng(5), n))
    fri = TFri(omega=primitive_nth_root(n), offset=3, domain_length=n,
               expansion_factor=4, num_colinearity_tests=4)
    calls = []
    absorb = THB.sponge_absorb_plain
    monkeypatch.setattr(THB, "sponge_absorb_plain",
                        lambda *a, **k: calls.append((a[3].shape[1], a[4])) or absorb(*a, **k))
    outs = {}
    for chain in (True, False):
        monkeypatch.setattr(TFri, "device_chain", chain)
        stream, fs = ProofStream(), FiatShamir()
        codewords, _ = fri.commit(codeword, stream, fs)
        outs[chain] = (stream.serialize(), bytes(fs.transcript), codewords)
    rounds = fri.num_rounds()
    # the prefix (0 bytes, fresh), a root a round in K4-dyn's plain version,
    # the last round's root in K9's
    assert calls == [(0, True)] + [(32, False)] * rounds
    assert outs[True][:2] == outs[False][:2]
    assert all(torch.equal(x, y) for x, y in zip(outs[True][2], outs[False][2]))


def test_fold_dyn_rejects_bad_operands():
    cw = torch.zeros((2, 8), dtype=torch.int32)
    inv_x = torch.zeros(4, dtype=torch.int32)
    roots, copy = torch.zeros((2, 32), dtype=torch.uint8), torch.zeros((2, 32), dtype=torch.uint8)
    alpha = torch.zeros(2, dtype=torch.int32)
    sp = THB.Sponge(2, "cpu")
    with pytest.raises(ValueError):  # a sponge of other lanes
        TFOLD.fold_dyn(cw, inv_x, THB.Sponge(3, "cpu"), roots, copy, alpha)
    with pytest.raises(ValueError):
        TFOLD.fold_dyn(cw, inv_x, sp, torch.zeros((2, 32), dtype=torch.int32), copy, alpha)
    with pytest.raises(ValueError):
        TFOLD.fold_dyn(cw, inv_x, sp, roots, copy, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        TFOLD.fold_dyn(cw, inv_x, sp, roots, torch.zeros((3, 32), dtype=torch.uint8), alpha)
    with pytest.raises(ValueError):
        TFOLD.fold_dyn(cw, torch.zeros(3, dtype=torch.int32), sp, roots, copy, alpha)
    with pytest.raises(ValueError):
        TFOLD.fold_dyn(torch.zeros(8, dtype=torch.int32), inv_x, sp, roots, copy, alpha)
    with pytest.raises(ValueError):
        TFOLD.fold_dyn(cw, inv_x, sp, roots, copy, alpha,
                       out=torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        TFOLD.fold_dyn(cw.to("meta"), inv_x.to("meta"), THB.Sponge(2, "meta"),
                       roots.to("meta"), copy.to("meta"), alpha.to("meta"))
    assert (sp.q, sp.fresh) == (0, True)  # nothing absorbed


FOLD_DYN_CARD_SHAPES = sorted(
    {(1, 1 << lg) for lg in range(21, 6, -1)}
    | {(b, 1 << lg) for b in (1, 3, 8, 32) for lg in range(15, 6, -1)}
    | {(1, 1), (1, 3), (3, 7)})


@pytest.mark.gpu
@pytest.mark.parametrize("q", [0, 16])
@pytest.mark.parametrize("b,half", FOLD_DYN_CARD_SHAPES)
def test_fold_dyn_kernel_matches_plain_on_card(cuda_device, b, half, q):
    # Folded rows, challenges, root copies and the sponges after the root
    # (two rounds: the second reads the buffers the first wrote), the
    # kernel against its plain version on the CPU.
    rng = np.random.default_rng(half + b + q)
    cw, inv_x, prefix, _ = _round_inputs(rng, b, half, q)
    card, plain = _sponge(prefix, cuda_device), _sponge(prefix)
    for _ in range(2):
        root = rng.integers(0, 256, size=(b, 32), dtype=np.uint8)
        before = cuda.launch_counts()["fri_fold_dyn"]
        got = _fold_dyn_round(cw, inv_x, card, root)
        assert cuda.launch_counts()["fri_fold_dyn"] == before + 1
        want = _fold_dyn_round(cw, inv_x, plain, root)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert torch.equal(card.state.cpu(), plain.state)
        assert torch.equal(card.pending.cpu(), plain.pending)
