"""The port's NTT against stark_tpu: the plain torch paths on the CPU
(bit-equal, tolerance zero), strict and lazy, the four-step plan tables
against the Pallas engine's, the column kernels' register rounds against
the stage-by-stage column transforms, and — on a card only — kernels K1-K3 and the
lazy K1/K2 against their plain versions.

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


@pytest.mark.parametrize("n,inverse", [(1 << 16, False), (1 << 16, True)])
def test_lazy_matches_strict_and_pallas_lazy_kernel(n, inverse):
    # The TPU kernel's lazy body in interpret mode; the port's lazy plain
    # versions follow the same [0, 2p) butterflies and assert their ranges.
    from stark_tpu.ops.ntt_fused import fused_ntt

    x = _input(n, 1, 17 * n + inverse)
    want = np.asarray(fused_ntt(x, inverse=inverse, interpret=True, lazy=True))
    t = to_torch(x)
    np.testing.assert_array_equal(to_numpy(NTF.fused_ntt(t, inverse, lazy=True)), want)
    np.testing.assert_array_equal(to_numpy(NTF.fused_ntt(t, inverse)), want)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [4, 64, 4096])
def test_lazy_plain_matches_strict_plain(n, inverse, batch):
    x = to_torch(_input(n, batch, 19 * n + inverse))
    strict = NTF.fused_ntt(x, inverse)
    assert torch.equal(NTF.fused_ntt(x, inverse, lazy=True), strict)
    assert torch.equal(NTF.ntt_plain(x, inverse), strict)
    # Each pass on its own, on the same operands.
    plan = NTF.get_plan(n, inverse, torch.device("cpu"))
    x3 = x.reshape(-1, plan.n1, plan.n2)
    y3 = NTF.pass1_plain(x3, plan)
    assert torch.equal(NTF.pass1_plain(x3, plan, lazy=True), y3)
    yt = NTF.transpose_plain(y3)
    assert torch.equal(NTF.pass2_plain(yt, plan, lazy=True), NTF.pass2_plain(yt, plan))
    # The public transforms carry the flag.
    assert torch.equal(TN.lde(x, 4, 3, lazy=True), TN.lde(x, 4, 3))
    assert torch.equal(TN.coset_interp(x, 3, lazy=True), TN.coset_interp(x, 3))


@pytest.mark.parametrize("lg_r", range(1, 14))
def test_round_stages(lg_r):
    rounds = NTF.round_stages(lg_r)
    assert sum(rounds) == lg_r and len(rounds) == -(-lg_r // NTF.MAX_ROUND)
    assert rounds == sorted(rounds, reverse=True) and rounds[0] - rounds[-1] <= 1
    assert 1 <= rounds[-1] and rounds[0] <= NTF.MAX_ROUND


def _column_tables(lg_r):
    from stark_tpu_torch.ops import fieldops as F

    root = F.primitive_nth_root(1 << lg_r)
    return NTF._shoup_pair(F.powers(root, max(1, (1 << lg_r) // 2), device="cpu"))


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("lg_r", range(1, 12))
def test_column_rounds_match_stage_by_stage(lg_r, batch):
    # The kernels' register rounds (element-to-thread mapping, twiddle
    # indices, the bit-reversed store) against the Stockham columns and,
    # value for value in [0, 2p), against the radix-2 lazy stage loop.
    tw, tws = _column_tables(lg_r)
    x3 = to_torch(rand_field(np.random.default_rng(100 * lg_r + batch),
                             (batch, 1 << lg_r, 5)))
    x3[0, :, 0] = NTF.P - 1
    strict = NTF._col_ntt_rounds(x3, tw, tws, lazy=False)
    assert torch.equal(strict, NTF._col_ntt(x3, False))
    lazy = NTF._col_ntt_rounds(x3, tw, tws, lazy=True)
    assert torch.equal(lazy, NTF._col_ntt_lazy(x3, tw, tws))
    assert torch.equal(torch.where(lazy >= NTF.P, lazy - NTF.P, lazy), strict)


@pytest.mark.parametrize("lg", range(2, 14))
def test_every_split_matches_stark_tpu(jN, lg):
    # Even and odd splits (lg1 = lg // 2, lg2 = lg - lg1) through both
    # passes' rounds, strict and lazy.
    x = _input(1 << lg, 2, 23 * lg)
    t = to_torch(x)
    for inverse, want in ((False, jN.ntt(x)), (True, jN.intt(x))):
        for lazy in (False, True):
            got = NTF.fused_ntt(t, inverse, lazy=lazy)
            np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("lg", [2, 6, 12, 16, 17, 20, 22, 24, 26])
def test_launch_shape_fits_a_block(lg, batch):
    for lg_r, cols in ((lg // 2, 1 << (lg - lg // 2)), (lg - lg // 2, 1 << (lg // 2))):
        lg_tc, threads = NTF._launch_shape(lg_r, cols, batch)
        assert cols % (1 << lg_tc) == 0
        assert 32 <= threads <= 1024 and threads % 32 == 0
        # twiddle pairs + the tile with its padding (csrc/ntt.cu)
        assert NTF._block_bytes(lg_r, lg_tc) <= 227 * 1024


def test_lazy_plain_asserts_its_ranges():
    # Operands outside [0, p) break the [0, 2p) invariant the lazy kernels
    # rely on; the plain version must notice, not wrap silently.
    plan = NTF.get_plan(64, False, torch.device("cpu"))
    bad = torch.full((1, plan.n1, plan.n2), -5, dtype=torch.int32)
    with pytest.raises(AssertionError):
        NTF.pass2_plain(bad.transpose(1, 2).contiguous(), plan, lazy=True)


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


# ---------------------------------------------------------------------------
# Pass 2 and the transpose alone against the JAX package's kernels.
# ---------------------------------------------------------------------------

PASS2_LGS = [2, 3, 4, 5, 7, 10, 13]
# (rows, cols): both routes of K3 (16-byte accesses need multiples of 4) and
# shapes that are not multiples of its 32 x 128 tile.
TRANSPOSES = [(2, 2), (2, 4), (4, 2), (4, 4), (96, 40), (97, 40), (96, 41),
              (33, 129), (36, 132), (32, 128), (28, 124), (4, 2048), (2048, 4),
              (8, 260), (1, 7), (100, 100), (512, 512), (1024, 512)]


def _jax_pass2(yt, root, lazy):
    """stark_tpu's pass-2 kernel (``_pass2_body`` under ``pl.pallas_call``,
    interpret mode, launched as ``_fused_ntt_jit`` launches it) down the
    columns of the (rows, cols) uint32 array ``yt``, ``root`` the primitive
    rows-th root, with its bit-reversed rows put back in natural order."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from stark_tpu.ops import ntt_fused as JF

    rows, cols = yt.shape
    lg = rows.bit_length() - 1
    t2 = min(JF._T_PASS2, cols)
    stw, stws = JF.FusedNTTPlan._dif_stage_tables(root, rows)
    vec = pl.BlockSpec((rows, t2), lambda j: (0, j), memory_space=pltpu.VMEM)
    tab = pl.BlockSpec((rows, lg), lambda j: (0, 0), memory_space=pltpu.VMEM)
    z = pl.pallas_call(
        functools.partial(JF._pass2_body, lazy=lazy),
        grid=(cols // t2,),
        in_specs=[vec, tab, tab],
        out_specs=vec,
        out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.uint32),
        scratch_shapes=[pltpu.VMEM((rows, t2), jnp.uint32)],
        interpret=True,
    )(jnp.asarray(yt), jnp.asarray(stw), jnp.asarray(stws))
    return np.asarray(z)[JF._bitrev_perm(rows)]


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("lg", PASS2_LGS)
def test_pass2_plain_matches_pallas_pass2(lg, batch, lazy):
    # n = 2^lg: pass 2 runs down columns of 2^(lg - lg // 2) rows, 2^(lg // 2)
    # of them: 2 columns (n = 4, 8: a row is no 16-byte run), 4, 8 (the
    # narrowest tile the launch rule keeps) and more.
    from stark_tpu_torch.ops import fieldops as F

    inverse = lg % 2 == 1
    plan = NTF.get_plan(1 << lg, inverse, torch.device("cpu"))
    yt = rand_field(np.random.default_rng(1000 * lg + 10 * batch + lazy),
                    (batch, plan.n2, plan.n1))
    got = to_numpy(NTF.pass2_plain(to_torch(yt), plan, lazy))
    root = pow(NTF._root(1 << lg, inverse), plan.n1, F.P)
    for b in range(batch):
        np.testing.assert_array_equal(got[b], _jax_pass2(yt[b], root, lazy))


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("rows,cols", TRANSPOSES)
def test_transpose_plain_matches_pallas_transpose(rows, cols, batch):
    from stark_tpu.ops.ntt_fused import _pallas_transpose

    y3 = rand_field(np.random.default_rng(rows * 7919 + cols + batch),
                    (batch, rows, cols))
    got = to_numpy(NTF.transpose_plain(to_torch(y3)))
    assert got.shape == (batch, cols, rows)
    for b in range(batch):
        np.testing.assert_array_equal(
            got[b], np.asarray(_pallas_transpose(y3[b], interpret=True)))


def _smoke_pass_shapes():
    """(lg_r, cols, batch) of every column pass chip_smoke.py launches."""
    import chip_smoke as CS

    sizes = {(n.bit_length() - 1, b) for n in CS.NTT_SIZES for b in (1, 3)}
    sizes |= {(n.bit_length() - 1, b) for b, n, _ in CS.PASS_SHAPES}
    sizes |= {(lg, b) for lg in CS.PASS_LGS for b in (1, 3, CS.WIDE_BATCH)}
    sizes |= {(lg, 1) for lg in CS.PASS_LGS_LONG}
    shapes = set()
    for lg, b in sizes:
        shapes.add((lg // 2, 1 << (lg - lg // 2), b))
        shapes.add((lg - lg // 2, 1 << (lg // 2), b))
    return sorted(shapes)


def test_launch_rules_hold_at_every_smoke_shape():
    # The kernels' own preconditions (csrc/ntt.cu launch_col_ntt and
    # stark_ntt_transpose) at every shape chip_smoke.py drives.
    import chip_smoke as CS

    for lg_r, cols, batch in _smoke_pass_shapes():
        lg_tc, threads = NTF._launch_shape(lg_r, cols, batch)
        tc = 1 << lg_tc
        assert 1 <= lg_r <= 13 and lg_r + lg_tc <= 20
        assert cols % tc == 0                        # tiles divide the columns
        assert NTF._block_bytes(lg_r, lg_tc) <= NTF.SMEM_BYTES
        assert 32 <= threads <= 1024 and threads % 32 == 0
        assert tc == cols or 4 * tc >= 32            # a tile's row: 32 bytes or the array's
    shapes = list(CS.TRANSPOSE_SHAPES)
    shapes += [(b, 1 << lg_r, cols) for lg_r, cols, b in _smoke_pass_shapes()]
    routes = set()
    for b, r, c in shapes:
        vector = NTF._transpose_vector(r, c)
        routes.add(vector)
        # 16-byte runs in both directions exactly where the vector route runs
        assert vector == (r % 4 == 0 and c % 4 == 0)
        # a block per tile: the grid's second and third dimensions
        assert -(-r // 32) <= 65535 and b <= 65535
    assert routes == {True, False}


def _bank_multiplicity(lg_r, lg_tc):
    """The most words of one bank that a warp touches in one access to the
    tile, per round, with csrc/ntt.cu's element-to-thread mapping and
    padding."""
    rounds = NTF.round_stages(lg_r)
    pad_shift = rounds[-1] + lg_tc if len(rounds) > 1 and lg_tc < 5 else 31
    worst, s0 = [], 0
    for q in rounds:
        b_lo = lg_r - s0 - q
        units = 1 << (lg_r - q + lg_tc)
        most = 0
        for warp in range(0, units, 32):
            for m in range(1 << q):
                banks = {}
                for u in range(warp, min(warp + 32, units)):
                    c, g = u & ((1 << lg_tc) - 1), u >> lg_tc
                    lo, hi = g & ((1 << b_lo) - 1), g >> b_lo
                    e = (((hi << (b_lo + q)) | (m << b_lo) | lo) << lg_tc) + c
                    word = e + ((e >> pad_shift) << lg_tc)
                    banks.setdefault(word % 32, set()).add(word)
                most = max(most, max(len(words) for words in banks.values()))
        worst.append(most)
        s0 += q
    return worst


@pytest.mark.parametrize("lg_r", [8, 9, 10, 11, 12])
@pytest.mark.parametrize("lg_tc", [2, 3, 4, 5])
def test_tile_padding_leaves_no_bank_conflict(lg_r, lg_tc):
    # The argument of csrc/ntt.cu's head note, checked by enumeration: in
    # every round a warp's 32 accesses fall in 32 different banks.
    assert _bank_multiplicity(lg_r, lg_tc) == [1] * len(NTF.round_stages(lg_r))


def test_tile_padding_keeps_unit_addresses_linear():
    # csrc/ntt.cu addresses element m of a unit as base + m * pitch: true
    # when the padded index of (e0 + m * step) is that of e0 plus m times
    # that of step, for every unit of every round.
    for lg_r in range(1, 13):
        for lg_tc in range(0, 6):
            rounds = NTF.round_stages(lg_r)
            pad_shift = rounds[-1] + lg_tc if len(rounds) > 1 and lg_tc < 5 else 31
            word = lambda e: e + ((e >> pad_shift) << lg_tc)  # noqa: E731
            s0 = 0
            for q in rounds:
                b_lo = lg_r - s0 - q
                step = 1 << (b_lo + lg_tc)
                for u in range(1 << (lg_r - q + lg_tc)):
                    c, g = u & ((1 << lg_tc) - 1), u >> lg_tc
                    lo, hi = g & ((1 << b_lo) - 1), g >> b_lo
                    e0 = ((((hi << (b_lo + q)) | lo)) << lg_tc) + c
                    for m in (1, (1 << q) - 1):
                        assert word(e0 + m * step) == word(e0) + m * word(step)
                s0 += q


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


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 6, 1 << 10, 1 << 16, 1 << 17, 1 << 20, 1 << 22])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("inverse", [False, True])
def test_lazy_kernels_match_plain_on_card(cuda_device, n, batch, inverse):
    x = to_torch(_input(n, batch, n + batch), cuda_device)
    before = cuda.launch_counts()
    got = NTF.fused_ntt(x, inverse, lazy=True)
    after = cuda.launch_counts()
    for name in ("ntt_pass1_lazy", "ntt_transpose", "ntt_pass2_lazy"):
        assert after[name] == before[name] + 1
    for name in ("ntt_pass1", "ntt_pass2"):
        assert after[name] == before[name]
    assert torch.equal(got, NTF.fused_ntt(x, inverse))
    assert torch.equal(got, NTF.ntt_plain(x, inverse))
    plan = NTF.get_plan(n, inverse, cuda_device)
    x3 = x.reshape(-1, plan.n1, plan.n2)
    y3 = NTF.ntt_pass1(x3, plan, lazy=True)
    assert torch.equal(y3, NTF.pass1_plain(x3, plan, lazy=True))
    yt = NTF.ntt_transpose(y3)
    assert torch.equal(NTF.ntt_pass2(yt, plan, lazy=True),
                       NTF.pass2_plain(yt, plan, lazy=True))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("lg", range(2, 23))
def test_pass_kernels_at_every_column_length_on_card(cuda_device, lg, batch):
    # n = 2^lg gives pass 1 columns of 2^(lg // 2) rows and pass 2 columns
    # of 2^(lg - lg // 2): every grouping of stages into rounds from 1 to
    # 11, strict and lazy, each pass against its plain version.
    plan = NTF.get_plan(1 << lg, lg % 3 == 0, cuda_device)
    x3 = to_torch(rand_field(np.random.default_rng(lg * 10 + batch),
                             (batch, plan.n1, plan.n2)), cuda_device)
    want = NTF.pass1_plain(x3, plan)
    yt = NTF.transpose_plain(want)
    want2 = NTF.pass2_plain(yt, plan)
    for lazy in (False, True):
        assert torch.equal(NTF.ntt_pass1(x3, plan, lazy), want)
        assert torch.equal(NTF.ntt_pass2(yt, plan, lazy), want2)


@pytest.mark.gpu
@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize(
    "lg,batch",
    [(lg, b) for lg in PASS2_LGS + [16, 18, 20, 22] for b in (1, 3, 8)] + [(23, 1)])
def test_pass2_kernel_twice_on_card(cuda_device, lg, batch, lazy):
    plan = NTF.get_plan(1 << lg, lg % 2 == 1, cuda_device)
    yt = to_torch(rand_field(np.random.default_rng(1000 * lg + 10 * batch + lazy),
                             (batch, plan.n2, plan.n1)), cuda_device)
    want = NTF.pass2_plain(yt, plan, lazy)
    name = "ntt_pass2_lazy" if lazy else "ntt_pass2"
    before = cuda.launch_counts()[name]
    for _ in range(2):
        assert torch.equal(NTF.ntt_pass2(yt, plan, lazy), want)
    assert cuda.launch_counts()[name] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("rows,cols", TRANSPOSES + [(2048, 2048), (1024, 4096)])
def test_transpose_kernel_twice_on_card(cuda_device, rows, cols, batch):
    y3 = to_torch(rand_field(np.random.default_rng(rows * 7919 + cols + batch),
                             (batch, rows, cols)), cuda_device)
    want = NTF.transpose_plain(y3)
    before = cuda.launch_counts()["ntt_transpose"]
    for _ in range(2):
        assert torch.equal(NTF.ntt_transpose(y3), want)
    assert cuda.launch_counts()["ntt_transpose"] == before + 2
    # a view that starts 4 bytes into its allocation is copied, not refused
    flat = torch.cat([y3.reshape(-1)[:1], y3.reshape(-1)])
    assert torch.equal(NTF.ntt_transpose(flat[1:].reshape(batch, rows, cols)), want)
