"""The sharded STARK prover: byte-identical proofs at any rank count.

Counterpart of stark_tpu/parallel/pstark.py, one process per device
(parallel/mesh.py).  What runs where:

* trace interpolation and LDE -> parallel/pntt.py (the four-step NTT,
                                 three all-to-alls a transform)
* trace and codeword trees    -> parallel/pmerkle.py (local subtrees, one
                                 all-gather of 32 B a share and tree, the
                                 top built on every rank)
* composition                 -> K11 on each rank's share of the LDE and
                                 of the domain tables, the rows read with a
                                 halo behind them and no wrap; the frame
                                 reads past the share come from the next
                                 rank (one exchange: stark_tpu's
                                 collective-permute of jnp.roll)
* FRI fold                    -> the (i, i + n/2) pairs (fri.rs:69-88): one
                                 exchange gives each rank its output share's
                                 two halves, K4-dyn (device chain) or K4
                                 (host path) folds them with its slice of
                                 the inverse-x ladder
* constraint challenges       -> K15 on every rank from the replicated
                                 trace roots (the forests' tops)
* query indices               -> K10 on every rank from its sponge, the
                                 same on every rank: no broadcast
* query phase                 -> K13 on every rank over the card's indices,
                                 each request read by the rank that serves
                                 it and zeros elsewhere, then one sum over
                                 the ranks into the prove's one buffer
                                 (pmerkle.ShardedRulePlan): one read a
                                 prove on every rank.  With host indices
                                 (``fused_round`` False: three reads) K13
                                 over the indices a rank serves, one
                                 all-gather (pmerkle.ShardedGather)
* transcript, challenges, IO  -> the replicated host control plane: every
                                 rank replays the same transcripts and
                                 emits the same bytes

A FRI codeword halves every round; once a rank's share would hold fewer
than ``ShardedFri.min_share`` points, the codeword is gathered whole to
every rank and the rounds left run as the single-device chain does (a
layout change, the same values).  The last codeword is always whole.

On a card with NCCL (or a mesh of one) the single-fetch prove's device
work, from the slot's columns to the buffer read, collectives included, is
one CUDA graph a slot on every rank, as the single prove's is
(stark.StarkProver._dispatch; stark_tpu's mesh mega dispatch).  Gloo
meshes, the CPU, the three-read path and the host commit path run eagerly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from stark_tpu_torch.fri import Fri, Upstream
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import compose as CO
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops import fold as FOLD
from stark_tpu_torch.ops import gather as G
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.parallel import pmerkle, pntt
from stark_tpu_torch.parallel.mesh import Mesh, Shard, replicated, swap_blocks
from stark_tpu_torch.stark import StarkConfig, StarkProver, StarkVerifier
from stark_tpu_torch.stream import FieldElements, MerkleRoot


class ShardedFri(Fri):
    """FRI whose trees, folds and query gather run over a mesh; the same
    protocol and bytes as :class:`~stark_tpu_torch.fri.Fri`, on the same
    paths: by default the single-fetch prove (stark_tpu/parallel/
    pstark.py:64-87): the device chain over the mesh (:meth:`_chain`, K4-dyn
    on the exchanged halves, K9 the last root) goes on from the STARK
    layer's sponge, K10 samples the indices on every rank from that rank's
    sponge (the same on every rank: every root it absorbs is replicated),
    and the query gather is this rank's share of the rule plan (K13) and one
    sum over the ranks (pmerkle.ShardedRulePlan), into the one buffer read
    once.  ``fused_round`` False or not ``_chainable``: the chain's fetch,
    then the query gather with host indices (pmerkle.ShardedGather); the
    host commit path (``device_chain`` False: K4, one proof at a time)."""

    #: A round's codeword stays cut while a rank's share holds at least this
    #: many points.  Below it a cut round's two collectives cost more than
    #: the work they split: on four H100s over NCCL, Fibonacci T=2^21,
    #: cutting down to pmerkle.MIN_LOCAL points took the FRI commit from
    #: 9.3-9.6 to 13.6-14.9 ms (PERF.md).  Tests set pmerkle.MIN_LOCAL to
    #: cut small codewords.
    min_share = 1 << 12

    def __init__(self, *args, mesh: Mesh, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh
        self._ladders: dict = {}

    def _gather_plan(self) -> pmerkle.ShardedGather:
        return pmerkle.ShardedGather(self.mesh)

    def rule_plan(self) -> pmerkle.ShardedRulePlan:
        return pmerkle.ShardedRulePlan(self.mesh)

    def _round_cut(self, r: int) -> tuple[bool, bool]:
        """Round r's codeword stays cut while a rank's share holds
        ``min_share`` points, but for the last round's; its forest is cut
        where the codeword is and the share holds pmerkle.MIN_LOCAL leaves
        (pmerkle.sharded_forest's floor)."""
        m = (self.domain_length >> r) // self.mesh.size
        cut = r < self.num_rounds() - 1 and m >= self.min_share
        return cut, cut and m >= pmerkle.MIN_LOCAL

    def _ladder(self, r: int, start: int, count: int) -> torch.Tensor:
        """Round r's inverse-x ladder (fri.FriPlan.inv_x_mont) at points
        start .. start + count - 1: a rank's slice."""
        dev = self.mesh.device
        key = (r, dev, start, count)
        got = self._ladders.get(key)
        if got is None:
            _, w, o = self._plan._params[r]
            iw = F.host_inv(w)
            ladder = F.powers(iw, count, scale=F.host_inv(o) * pow(iw, start, P), device=dev)
            got = self._ladders[key] = (ladder * F.R1 % P).to(torch.int32)
        return got

    def _halves(self, cw: Shard, r: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, 2m) rows [a | b] of this rank's output share (m points) and
        its ladder: a = cw[i], b = cw[i + n/2] for i in the share.  For a
        cut codeword one exchange: the first half's holders send to the
        ranks whose a they hold, the second half's to those whose b."""
        x = cw.local
        if not cw.split:
            return x, self._plan.inv_x_mont(r, x.device)
        mesh = self.mesh
        d_count, d = mesh.size, mesh.rank
        b, m = int(x.shape[0]), cw.m // 2
        if d_count > 1:
            half = d_count // 2
            dest = 2 * (d % half)
            send = [b * m if e in (dest, dest + 1) else 0 for e in range(d_count)]
            recv = [b * m if s in (d // 2, half + d // 2) else 0 for s in range(d_count)]
            got = mesh.exchange(swap_blocks(x, 1, b, 2, m).reshape(-1), send, recv)
            x = swap_blocks(got.reshape(2, b, m), 1, 2, b, m).reshape(b, 2 * m)
        return x, self._ladder(r, d * m, m)

    def _chain(self, codewords: Shard, sponge, packed: G.Packed):
        """The device chain over the mesh, writing ``packed``'s last, roots
        and alphas as the single-device chain does (fri.Fri._chain): per
        round the forest (a ShardedForest while cut), K4-dyn on this rank's
        exchanged halves, K9 the last root; a codeword is gathered whole
        where :meth:`_round_cut` says.  Returns (codewords, forests): per
        round the (B, n) codeword as a Shard and its forest."""
        mesh, rounds = self.mesh, self.num_rounds()
        b = codewords.shape[0]
        last, roots, alphas = self._chain_views(packed, b)
        cws, forests = [], []
        cw = codewords
        for r in range(rounds):
            cut, tree_cut = self._round_cut(r)
            if cw.split and not cut:
                cw = replicated(mesh, cw.whole())
            forest = pmerkle.sharded_forest(Shard(mesh, cw.local[:, None, :], cw.n, cw.split))
            got = (cw.split, isinstance(forest, pmerkle.ShardedForest))
            if got != (cut, tree_cut):
                raise ValueError(f"round {r}: codeword and forest cut {got}, the layout "
                                 f"says {(cut, tree_cut)}")
            cws.append(cw)
            forests.append(forest)
            if r == rounds - 1:
                sponge.absorb(forest.roots_dev(), copy=roots[r])
                break
            halves, ladder = self._halves(cw, r)
            out = last if r == rounds - 2 and not cw.split else None
            nxt = FOLD.fold_dyn(halves, ladder, sponge, forest.roots_dev(),
                                copy=roots[r], alpha=alphas[r], out=out)
            cw = Shard(mesh, nxt, cw.n // 2, cw.split)
        if cws[-1].local.data_ptr() != last.data_ptr():
            last.copy_(cws[-1].local)
            cws[-1] = replicated(mesh, last)
        return cws, forests

    def _commit(self, codewords: Shard, proof_streams: list, fiat_shamirs: list,
                upstream: Upstream | None = None):
        """The commit over the mesh: per round the (B, n) codeword as a
        Shard and its forest's stack (a ShardedForest while cut).  The
        device chain is the single device's (commit_batch over
        :meth:`_chain`: one read, ``upstream``'s sections riding it); the
        host path reads a root a round."""
        mesh = self.mesh
        if self.num_rounds() == 0:
            cws, stacks = super()._commit(codewords.whole(), proof_streams, fiat_shamirs,
                                          upstream)
            return [replicated(mesh, cw) for cw in cws], stacks
        if self.device_chain:
            return super()._commit(codewords, proof_streams, fiat_shamirs, upstream)
        b, n = codewords.shape
        if self.domain_length != n or not len(proof_streams) == len(fiat_shamirs) == b:
            raise ValueError(f"{b} codewords of {self.domain_length} need as many streams "
                             f"and transcripts, got {codewords.shape}")
        if upstream is not None:
            raise ValueError("the host commit path takes no device transcript")
        if b != 1:
            raise ValueError("the host commit path proves one codeword at a time")
        rounds = self.num_rounds()
        cws, stacks = [], []
        cw = codewords
        for r in range(rounds):
            if cw.split and not self._round_cut(r)[0]:
                cw = replicated(mesh, cw.whole())
            forest = pmerkle.sharded_forest(Shard(mesh, cw.local[:, None, :], cw.n, cw.split))
            cws.append(cw)
            stacks.append(forest.stack)
            root = Hash(G.to_host(forest.roots_dev().reshape(-1).view(torch.int32)).tobytes())
            proof_streams[0].push(MerkleRoot(root))
            fiat_shamirs[0].absorb(root.data)
            if r == rounds - 1:
                break
            halves, ladder = self._halves(cw, r)
            alpha = fiat_shamirs[0].challenge(self.field)  # pure; unreduced u64
            cw = Shard(mesh, FOLD.fold(halves[0], ladder, alpha.value)[None], cw.n // 2,
                       cw.split)
        proof_streams[0].push(FieldElements(
            tuple(int(v) for v in G.to_host(cws[-1].local.reshape(-1)))))
        return cws, stacks


def graphs_allowed(device_type: str, backend: str | None) -> bool:
    """Whether a mesh's single-fetch body runs as one CUDA graph a slot: on
    a card whose mesh has an NCCL group (a CUDA graph holds NCCL's
    collectives) or none (a mesh of one: its collectives are copies).
    Never for gloo, which carries the exchanges through the host outside
    any stream, CUDA tensors or not, nor on the CPU."""
    return device_type == "cuda" and backend in (None, "nccl")


class DistributedStarkProver(StarkProver):
    """StarkProver over a 1-D mesh (parallel/mesh.py), on the mesh's
    device; every rank calls :meth:`prove` with the same witness and gets
    the same proof, byte-identical to the single-device prove.  ``overlap``:
    the sharded NTT's chunks (pntt.py).  A rank's share of the N coset
    points must hold the frame's reach (max offset x blowup points), which
    the composition reads from the next share.

    Where :func:`graphs_allowed` says so, the single-fetch prove's body is
    one CUDA graph a slot on every rank, its collectives captured with its
    kernels (stark_tpu's mesh mega dispatch, stark_tpu/parallel/pstark.py:
    100-111): captured at the slot's second prove, replayed from its
    third (:meth:`_capture`), the backend read from the mesh's group.
    NCCL's teardown (``destroy_process_group``) waits for every graph that
    holds its point-to-point operations: :meth:`close` the prover first."""

    def __init__(self, air, cfg: StarkConfig, mesh: Mesh, lazy_ntt: bool = False,
                 overlap: int = 1):
        self.mesh = mesh
        self._graphs = graphs_allowed(mesh.device.type, None if mesh.group is None
                                      else dist.get_backend(mesh.group))
        self.overlap = overlap
        reach, share = air.max_offset * cfg.blowup, cfg.blowup * cfg.trace_length // mesh.size
        if reach > share:
            raise ValueError(f"a share of {share} points on {mesh.size} ranks is narrower than "
                             f"the frame's reach of {reach} points: use fewer ranks")
        super().__init__(air, cfg, device=mesh.device, lazy_ntt=lazy_ntt)
        d = self.dom
        self.fri = ShardedFri(
            omega=d.Omega, offset=d.offset, domain_length=d.N,
            expansion_factor=cfg.blowup // d.h,
            num_colinearity_tests=cfg.num_colinearity_tests, mesh=mesh,
        )
        if mesh.device.type == "cuda" and mesh.size > 1:
            # D ranks start at once: rank 0 builds the libraries, the others
            # load them after a barrier.
            mesh.first(lambda: (cuda.library(), CO.library(self.program.source)))

    def _capture(self, slot) -> cuda.Graph:
        """The slot's body as one CUDA graph on this rank: the collectives it
        counts (Mesh.counts, Mesh.log) are taken back with its launches and
        added at each replay.  With a process group the capture is
        thread-local (NCCL's watchdog thread makes CUDA calls of its own
        meanwhile), and every rank learns whether every rank's capture
        succeeded (Mesh.agree) before any replays: a failed capture raises
        on every rank, where the others would wait in their first replay."""
        mesh = self.mesh
        mode = "global" if mesh.group is None else "thread_local"
        try:
            graph = cuda.Graph(lambda: self._body(slot), self.device, (mesh,), mode)
        except Exception:
            mesh.agree(False)
            raise
        if not mesh.agree(True):
            raise RuntimeError(f"rank {mesh.rank}: the CUDA graph capture failed on "
                               "another rank of the mesh")
        return graph

    def _points(self) -> tuple[int, int]:
        lo, hi = self.mesh.bounds(self.dom.N)
        return lo, hi - lo

    def _lde_trace(self, cols: torch.Tensor) -> Shard:
        """(B, c, T) witness (whole on every rank) -> this rank's share of the
        (B, c, N) trace LDE: its share of the columns through the sharded
        iNTT and LDE; where T is too short to cut (D^2 | T, T >= 16), the
        single-device LDE and its share."""
        mesh, d = self.mesh, self.dom
        b, c, t = cols.shape
        lo, hi = mesh.bounds(d.N)
        if t % (mesh.size * mesh.size) or t < 16:
            return Shard(mesh, super()._lde_trace(cols)[..., lo:hi].contiguous(), d.N)
        tlo, thi = mesh.bounds(t)
        share = cols[..., tlo:thi].reshape(b * c, thi - tlo)
        coeffs = pntt.sharded_intt(share, mesh, self.overlap, self.lazy_ntt)
        lde = pntt.sharded_lde(coeffs, self.cfg.blowup, d.offset, mesh, self.overlap,
                               self.lazy_ntt)
        return Shard(mesh, lde.reshape(b, c, hi - lo), d.N)

    def _trace_tree(self, trace_lde: Shard):
        return pmerkle.sharded_forest(trace_lde)

    def _trace_sources(self, plan: pmerkle.ShardedRulePlan, b: int) -> tuple[int, int]:
        """The trace LDE as this rank's share, and its forest cut as
        pmerkle.sharded_forest cuts it (whole below pmerkle.MIN_LOCAL leaves
        a share)."""
        d, c = self.dom, self.air.num_registers
        return (plan.values_source((b, c, d.N), d.N, c, split=True),
                plan.stack_source(b * d.N, d.N.bit_length() - 1,
                                  split=d.N // self.mesh.size >= pmerkle.MIN_LOCAL))

    def _composition(self, trace_lde: Shard, alphas=None, betas=None, *,
                     weights: torch.Tensor | None = None, values=None) -> Shard:
        """K11 on this rank's share and its halo: the frame's reach past the
        share (max offset x blowup points of each row) comes from the next
        rank, the last rank's from rank 0 (one exchange).  The weights are
        host ints (``alphas``, ``betas``) or K15's words on the card
        (``weights``); ``values`` the proofs' boundary values."""
        mesh, d = self.mesh, self.dom
        x = trace_lde.local
        b, c, m = x.shape
        reach = self.air.max_offset * self.cfg.blowup
        to, frm = (mesh.rank - 1) % mesh.size, (mesh.rank + 1) % mesh.size
        words = b * c * reach
        halo = mesh.exchange(x[..., :reach].reshape(-1),
                             [words if e == to else 0 for e in range(mesh.size)],
                             [words if s == frm else 0 for s in range(mesh.size)])
        lde = torch.cat([x, halo.reshape(b, c, reach)], dim=-1)
        out = CO.compose(self.program, lde if b > 1 else lde[0], self.tables, alphas,
                         betas, self.cfg.blowup, points=m, weights=weights, values=values)
        return Shard(mesh, out.reshape(b, m), d.N)


class DistributedStarkVerifier(StarkVerifier):
    """Verification is query-local host work: the base verifier, with the
    mesh kept for the API's symmetry (stark_tpu's alias)."""

    def __init__(self, air, cfg: StarkConfig, mesh: Mesh | None = None):
        super().__init__(air, cfg)
        self.mesh = mesh
