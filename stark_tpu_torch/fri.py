"""FRI low-degree test: commit / fold / query / prove / verify.

Protocol contract: reference src/fri.rs:29-525, reproduced transcript- and
proof-byte-exactly.  Counterpart of stark_tpu/fri.py as it runs by
default: the single-fetch prove (stark_tpu's _prove_chained: the launches
``Fri.chain_launches``, the host's side ``Fri.chained_replay``), where the
device chain (``Fri.device_chain``: trees, roots, the Fiat-Shamir
challenges and the folds, kernel K4-dyn one launch a round for the root's
absorb, the challenge and the fold; the last root's absorb kernel K9) goes
on from the STARK layer's sponge, the query indices are sampled on the card
(K10) and every query read follows them there (K13's rule slots), one fetch
at the end, then the host replays the transcript and the sampling and
checks the card's values; B proofs at once as one.  With ``fused_round =
False`` (or where the prove is not ``_chainable``) the chain's fetch is one
read and the query phase with host indices another (``commit_batch``,
``prove_batch``).
``device_chain = False`` runs the host path: a root read, a host challenge
and a fold with that challenge (K4) per round.

* **fold** (fri.rs:57-91): each round's inverse ladder 1/x_i =
  offset^-1 * omega^-i is precomputed once (log-doubling, on the device),
  in Montgomery form; the fold is one elementwise kernel.
* **commit** (fri.rs:105-156): per-round leaf hashing and the Merkle
  levels run on the device (ops/hash_batch); trees (forests of B trees)
  are kept for the query phase — the reference rebuilds identical trees
  (fri.rs:288-298).
* **query** (fri.rs:215-248): every round's values and paths, and the
  caller's trace openings, are one gather (kernel K13, ops/gather.py) and
  one fetch per prove, copied into the proof's wire layout
  (stream.ProofLayout).
* **host control plane**: the transcript's replay, index sampling
  (fri.rs:168-213) and proof-stream writes are sequential byte-exact
  Python over the native engine.

Bit-exactness quirks preserved: challenges stay unreduced u64 until they
enter modular ops; the index-sampling seed is Hash::from_u64 of the RAW
challenge value (fri.rs:272).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from stark_tpu_torch import native
from stark_tpu_torch.field import FieldElement, FiniteField
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.merkle import Forest, MerkleTree
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops import fold as FOLD
from stark_tpu_torch.ops import gather as G
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.ops import ntt as NTT
from stark_tpu_torch.ops.fieldops import P
from stark_tpu_torch.stream import (
    PATH,
    ROOT,
    VALUES,
    FieldElements,
    MerklePath,
    MerkleRoot,
    ProofLayout,
    ProofStream,
)
from stark_tpu_torch.utils.profiling import NULL_TIMER, reason, span


#: Candidates the device sampler (K10) hashes for ``number`` indices: M = 2
#: number + this (stark_tpu/fri.py:132).  Where a proof's M candidates give
#: fewer than ``number`` distinct reduced indices, the host's indices go
#: through the same gather on the card (a second read).
_SAMPLE_SLACK = 32
#: The largest reduced size (the last codeword's length) the single-fetch
#: prove samples on the card: K10's seen-mask, one bit an index in shared
#: memory (stark_tpu/fri.py:136).
_SAMPLE_MAX_REDUCED = HB.SAMPLE_MAX_REDUCED


@dataclass
class Upstream:
    """The STARK layer's share of a device chain (stark_tpu/fri.py:
    transcript_dev_prefix, prefix_replay): the sponge its constraint
    challenges (K15) left, which the FRI chain goes on from; the one buffer
    (``packed``) they wrote their trace roots and challenge bytes into,
    which the chain fills and reads; and ``replay``, the host's replay of
    those, called with the fetched sections before the chain's own."""

    sponge: HB.Sponge
    packed: G.Packed
    replay: Callable[[dict], None]


@dataclass
class QueryData:
    """API-parity struct (reference fri.rs:23-27, declared there but never
    constructed; the proof artifact is the ProofStream)."""

    indices: list
    values: list
    paths: list


@dataclass
class FriProof:
    """API-parity struct (reference fri.rs:17-21, declared there but never
    constructed; the proof artifact is the ProofStream)."""

    commitments: list
    queries: list
    final_polynomial: object | None = None


class FriPlan:
    """Per-(domain, omega, offset) precomputation: the inverse-x ladder of
    each round, in Montgomery form (offset and omega square per round,
    fri.rs:146-147).  Built lazily on first use and kept: only the
    prover's folds need them."""

    def __init__(self, domain_length: int, omega: int, offset: int, num_rounds: int):
        self._params = []
        w, o = omega % P, offset % P
        for _ in range(max(num_rounds - 1, 0)):
            self._params.append((domain_length // 2, w, o))
            w = (w * w) % P
            o = (o * o) % P
            domain_length //= 2
        self._cache: dict = {}

    def inv_x_mont(self, r: int, device) -> torch.Tensor:
        """(half,) int32 tensor of (offset*omega^i)^{-1} * 2^32 mod p for
        round r."""
        key = (r, torch.device(device))
        got = self._cache.get(key)
        if got is None:
            half, w, o = self._params[r]
            ladder = F.powers(F.host_inv(w), half, scale=F.host_inv(o), device=device)
            got = (ladder * F.R1 % P).to(torch.int32)
            self._cache[key] = got
        return got


class Fri:
    """Contract: fri.rs:29-55 (parameter invariants included)."""

    def __init__(
        self,
        omega,
        offset,
        domain_length: int,
        expansion_factor: int,
        num_colinearity_tests: int,
        field: FiniteField | None = None,
    ):
        assert domain_length & (domain_length - 1) == 0, (
            "Domain length must be power of 2"
        )
        assert expansion_factor & (expansion_factor - 1) == 0, (
            "Expansion factor must be power of 2"
        )
        assert expansion_factor >= 4, "Expansion factor must be at least 4"
        self.omega = omega.value if isinstance(omega, FieldElement) else int(omega)
        self.offset = offset.value if isinstance(offset, FieldElement) else int(offset)
        self.domain_length = domain_length
        self.field = field or (
            omega.field if isinstance(omega, FieldElement) else FiniteField()
        )
        self.expansion_factor = expansion_factor
        self.num_colinearity_tests = num_colinearity_tests
        self._plan = FriPlan(domain_length, self.omega, self.offset, self.num_rounds())
        #: Single-fetch proves whose device sampler fell short and whose
        #: query gather ran again with the host's indices.
        self.shortfalls = 0

    def num_rounds(self) -> int:
        """fri.rs:93-103: halve while len > expansion AND 4*tests < len."""
        codeword_length = self.domain_length
        rounds = 0
        while (
            codeword_length > self.expansion_factor
            and 4 * self.num_colinearity_tests < codeword_length
        ):
            codeword_length //= 2
            rounds += 1
        return rounds

    # -- fold (fri.rs:57-91) ---------------------------------------------------

    def fold_codeword(self, codeword: torch.Tensor, alpha: int, round_idx: int):
        """codeword: (n,) int32 tensor; alpha raw (possibly unreduced)."""
        inv_x = self._plan.inv_x_mont(round_idx, codeword.device)
        return FOLD.fold(codeword, inv_x, alpha)

    # -- commit (fri.rs:105-156) -------------------------------------------------

    #: The device-chained commit (stark_tpu/fri.py:Fri.commit, :575-700, its
    #: default): trees, roots, challenges and folds stay on the card, one
    #: fetch at the end, then the host replays the transcript.  False: the
    #: host path, a root read and a host challenge per round, the fold K4
    #: with a host alpha (one proof at a time).
    device_chain = True

    #: With the device chain, the single-fetch prove (stark_tpu/fri.py:507,
    #: :739-1035, its default): the STARK layer's constraint challenges
    #: (K15) feed the chain, the query indices are sampled on the card (K10)
    #: and the query gather reads them there (K13's rule slots), and one
    #: read brings back the whole prove (:meth:`chain_launches`), where
    #: :meth:`_chainable`; else the challenges' bytes ride the chain's
    #: fetch and the query phase is a second read.  False: three reads (the
    #: trace roots, the chain's fetch, the query gather), the challenges
    #: and the sampling on the host.  The sharded FRI runs both
    #: (parallel/pstark.py).
    fused_round = True

    def _chainable(self) -> bool:
        """Whether the single-fetch prove applies (stark_tpu/fri.py:725-737):
        the device chain with fused rounds, two rounds or more (else no
        query reads a round's trees), and a last codeword that the device
        sampler's seen-mask holds and that has ``tests`` distinct indices."""
        rounds = self.num_rounds()
        if not (self.device_chain and self.fused_round and rounds >= 2):
            return False
        reduced = self.domain_length >> (rounds - 1)
        return reduced <= _SAMPLE_MAX_REDUCED and self.num_colinearity_tests <= reduced

    def packed_sections(self, b: int, prefix: dict | None = None,
                        gather_words: int | None = None) -> dict:
        """The sections of the one buffer that a device chain of B proofs
        fills and the host reads once (words each): the last codewords
        (first: the last fold writes them at the buffer's aligned start),
        every round's roots, ``prefix`` (the STARK layer's: its trace roots
        and challenge bytes), the alphas; with ``gather_words``, the
        single-fetch prove's sampled indices, their counts and the query
        gather's words."""
        rounds = self.num_rounds()
        sizes = {"last": b * (self.domain_length >> max(rounds - 1, 0)),
                 "roots": 8 * rounds * b, **(prefix or {}),
                 "alphas": max(rounds - 1, 0) * b}
        if gather_words is not None:
            sizes.update(indices=b * self.num_colinearity_tests, counts=b,
                         gather=gather_words)
        return sizes

    def commit(self, initial_codeword, proof_stream: ProofStream, fiat_shamir):
        """Returns (codewords, trees): the recorded codewords exactly as
        fri.rs:140+151-153 records them, plus their Merkle trees.  Leaf
        vectors are padded to a power of two with zero hashes
        (fri.rs:123-125) — a no-op here: codeword lengths are powers of 2."""
        if self.device_chain and self.num_rounds() > 0:
            codewords, forests = self.commit_batch(
                initial_codeword[None, :], [proof_stream], [fiat_shamir])
            return ([cw[0] for cw in codewords],
                    [MerkleTree(_stack=f.stack) for f in forests])
        codeword = initial_codeword
        codewords: list = []
        trees: list = []
        last_tree = None
        rounds = self.num_rounds()
        for r in range(rounds):
            tree = MerkleTree.from_leaf_values(codeword)
            root = tree.root
            proof_stream.push(MerkleRoot(root))
            fiat_shamir.absorb(root.data)
            if r == rounds - 1:
                last_tree = tree
                break
            alpha = fiat_shamir.challenge(self.field)  # pure; unreduced u64
            codewords.append(codeword)
            trees.append(tree)
            codeword = self.fold_codeword(codeword, alpha.value, r)
        last = codeword.cpu().numpy()
        proof_stream.push(FieldElements(tuple(int(v) for v in last)))
        codewords.append(codeword)
        trees.append(last_tree)
        return codewords, trees

    def commit_batch(self, codewords: torch.Tensor, proof_streams: list,
                     fiat_shamirs: list, upstream: Upstream | None = None):
        """The device chain for B proofs at once (stark_tpu/fri.py:575-700,
        stark_tpu/batch.py:976-1062): ``codewords`` (B, n) on the card,
        one transcript and stream each.  The sponge (K9, B lanes) is seeded
        with each transcript so far, or is ``upstream``'s (K15's, the
        transcripts then empty); a round builds the B trees as one forest
        (K5, K7, K8), and K4-dyn absorbs the roots straight from the
        forest's stack, writes each alpha mod p to device memory and folds
        with it, one launch (the last round's roots go to K9): nothing in
        the loop reads from the card.  One fetch then brings back the last
        codewords, every root and every alpha (and ``upstream``'s
        sections); the host replays ``upstream``'s, pushes the roots,
        replays each transcript, and raises if an alpha it draws differs
        from the card's.  Returns (codewords, forests): per round the (B,
        n_r) codewords and their :class:`~stark_tpu_torch.merkle.Forest`."""
        rounds = self.num_rounds()
        b, n = codewords.shape
        if rounds < 1 or self.domain_length != n:
            raise ValueError(f"a device chain needs a round and codewords of "
                             f"{self.domain_length}, got {rounds}, {tuple(codewords.shape)}")
        if not len(proof_streams) == len(fiat_shamirs) == b:
            raise ValueError(f"{b} codewords need {b} streams and transcripts")
        sponge, packed = self._chain_start(codewords.device, b, fiat_shamirs, upstream)
        cws, forests = self._chain(codewords, sponge, packed)
        host = packed.host(G.to_host(packed.buf))
        if upstream is not None:
            upstream.replay(host)
        roots, last = self._chain_replay(host, b, fiat_shamirs)
        for stream, proof_roots, cw in zip(proof_streams, roots, last):
            for root in proof_roots:
                stream.push(MerkleRoot(Hash(root.tobytes())))
            stream.push(FieldElements(tuple(int(v) for v in cw)))
        return cws, forests

    def _chain(self, codewords: torch.Tensor, sponge: HB.Sponge, packed: G.Packed):
        """The device chain's launches (:meth:`commit_batch`), writing into
        ``packed``'s last, roots and alphas: (codewords, forests)."""
        rounds = self.num_rounds()
        b, n = codewords.shape
        dev = codewords.device
        last, roots, alphas = self._chain_views(packed, b)
        cws, forests = [], []
        codeword = codewords
        for r in range(rounds):
            forest = Forest.from_values(codeword)
            cws.append(codeword)
            forests.append(forest)
            if r == rounds - 1:
                sponge.absorb(forest.roots_dev(), copy=roots[r])
                break
            codeword = FOLD.fold_dyn(codeword, self._plan.inv_x_mont(r, dev), sponge,
                                     forest.roots_dev(), copy=roots[r], alpha=alphas[r],
                                     out=last if r == rounds - 2 else None)
        if rounds == 1:
            last.copy_(codeword)
        cws[-1] = last
        return cws, forests

    def _chain_start(self, dev, b: int, fiat_shamirs: list,
                     upstream: Upstream | None = None):
        """The device chain's state for B codewords: the sponge
        (K9, B lanes) seeded with each transcript so far, and the buffer for
        the one fetch (:meth:`packed_sections`); or ``upstream``'s sponge
        and buffer.  Returns (sponge, packed)."""
        if upstream is not None:
            return upstream.sponge, upstream.packed
        prefixes = [bytes(fs.transcript) for fs in fiat_shamirs]
        if len({len(x) for x in prefixes}) != 1:
            raise ValueError("the transcripts' prefixes differ in length")
        sponge = HB.Sponge(b, dev)
        prefix = np.frombuffer(b"".join(prefixes), dtype=np.uint8).reshape(b, -1)
        sponge.absorb(torch.from_numpy(prefix.copy()).to(dev))
        return sponge, G.Packed(self.packed_sections(b), dev)

    def _chain_views(self, packed: G.Packed, b: int):
        """(last (B, n_last), roots (rounds, B, 32) u8, alphas (rounds - 1,
        B)): the chain's views of ``packed``."""
        rounds = self.num_rounds()
        v = packed.dev
        return (v["last"].view(b, -1), v["roots"].view(torch.uint8).view(rounds, b, 32),
                v["alphas"].view(rounds - 1, b))

    def _chain_replay(self, host: dict, b: int, fiat_shamirs: list) -> tuple:
        """The host side of the chain's fetch (``host``: the fetched
        sections of :meth:`packed_sections`): absorb the roots into each
        transcript, raise if an alpha it draws differs from the card's.
        Returns views of the fetch: (the roots (B, rounds, 32) u8, the last
        codewords (B, n_last) u32)."""
        with span("fri.chain_replay"):
            rounds = self.num_rounds()
            roots_h = host["roots"].view(np.uint8).reshape(rounds, b, 32)
            alphas_h = host["alphas"].reshape(rounds - 1, b)
            for j, fs in enumerate(fiat_shamirs):
                for r in range(rounds):
                    fs.absorb(roots_h[r, j].tobytes())
                    if r < rounds - 1:
                        alpha = fs.challenge(self.field)  # pure; unreduced u64
                        if alpha.value % P != int(alphas_h[r, j]):
                            # The tie between the card's challenges and the
                            # transcript: not an assert, so that -O keeps it.
                            raise RuntimeError("device/host transcript divergence")
            return roots_h.transpose(1, 0, 2), host["last"].reshape(b, -1)

    # -- index sampling (fri.rs:168-213) ----------------------------------------

    def sample_indices(
        self, seed: bytes, size: int, reduced_size: int, number: int
    ) -> list[int]:
        """Seeded hash + LE u32 counter, each digest folded into a u128 mod
        size, deduplicated on index mod reduced_size (native engine)."""
        assert number <= 2 * reduced_size, (
            "not enough entropy in indices wrt last codeword"
        )
        assert number <= reduced_size, (
            "cannot sample more indices than available in last codeword; "
            f"requested: {number}, available: {reduced_size}"
        )
        return native.sample_indices(seed, size, reduced_size, number)

    # -- query (fri.rs:215-248) ---------------------------------------------------

    @staticmethod
    def _round_dispatch(current, nxt, c_indices, current_stack, next_stack,
                        plan: G.GatherPlan):
        """Add one round's reads for B proofs to ``plan`` (the prover
        fetches it once for every round): ``current`` (B, n) and ``nxt``
        (B, n/2) codewords, ``c_indices`` (B, k), and the level stacks of
        the two rounds' trees or forests (merkle.Forest): per proof the a,
        b and c values and the three paths.  Returns the round's slots."""
        b, n = current.shape
        half = n // 2
        c = np.asarray(c_indices, dtype=np.int64).reshape(b, -1)
        rows = np.arange(b, dtype=np.int64)[:, None]
        ab = np.concatenate([c, c + half], axis=1)
        return (
            plan.values(current.reshape(-1), ab + n * rows),
            plan.values(nxt.reshape(-1), c + half * rows),
            plan.paths(current_stack, ab + n * rows, (n).bit_length() - 1),
            plan.paths(next_stack, c + half * rows, (half).bit_length() - 1),
        )

    def _round_objects(self, layout: ProofLayout, r: int, n: int) -> None:
        """Round r's objects (its codeword of n points), in the order of
        fri.rs:215-248 (stark_tpu/fri.py:1020-1032): k triples (a, b, c),
        then per test the paths of a, b (depth log2 n) and c."""
        k, depth = self.num_colinearity_tests, n.bit_length() - 1
        layout.add(f"fri.round{r}.triples", k, (VALUES, 3))
        layout.add(f"fri.round{r}.paths", k, (PATH, depth), (PATH, depth), (PATH, depth - 1))

    def proof_objects(self, layout: ProofLayout) -> None:
        """The FRI's objects of a proof (fri.rs:250-311): every round's
        root, the last codeword, then each query round's
        (:meth:`_round_objects`)."""
        rounds = self.num_rounds()
        layout.add("fri.roots", rounds, (ROOT,))
        layout.add("fri.last", 1, (VALUES, self.domain_length >> max(rounds - 1, 0)))
        for r in range(rounds - 1):
            self._round_objects(layout, r, self.domain_length >> r)

    @staticmethod
    def _round_emit(r: int, slots, fetched: np.ndarray, views: dict) -> None:
        """Round r's values and paths from the fetched words into its views
        of a proof layout (:meth:`_round_objects`), B proofs at once."""
        with span("fri.round_emit"):
            (triples,), (path_a, path_b, path_c) = (views[f"fri.round{r}.triples"],
                                                    views[f"fri.round{r}.paths"])
            b, k = triples.shape[:2]
            cur_vals, nxt_vals, cur_sib, nxt_sib = (s.take(fetched) for s in slots)
            cur_vals = cur_vals.reshape(b, 2, k)
            triples[:, :, 0] = cur_vals[:, 0]
            triples[:, :, 1] = cur_vals[:, 1]
            triples[:, :, 2] = nxt_vals.reshape(b, k)
            cur_sib = cur_sib.reshape(b, 2, k, -1)
            path_a[...] = cur_sib[:, 0]
            path_b[...] = cur_sib[:, 1]
            path_c[...] = nxt_sib.reshape(b, k, -1)

    def _push_rounds(self, rounds: list, fetched: np.ndarray, proof_streams: list,
                     lengths: list) -> None:
        """The query rounds' objects (``rounds``: each round's slots, its
        codeword of ``lengths[r]`` points) pushed to each stream as one
        raw segment."""
        if not rounds:
            return
        layout = ProofLayout(len(proof_streams))
        for r in range(len(rounds)):
            self._round_objects(layout, r, lengths[r])

        def fill(views):
            for r, slots in enumerate(rounds):
                self._round_emit(r, slots, fetched, views)

        layout.push(proof_streams, fill)

    def query(
        self,
        current_codeword,
        next_codeword,
        c_indices: list[int],
        proof_stream: ProofStream,
        current_tree: MerkleTree,
        next_tree: MerkleTree,
    ) -> list[int]:
        """Single-round query (fri.rs:215-248): dispatch, fetch, emit."""
        plan = G.GatherPlan()
        slots = self._round_dispatch(current_codeword[None, :], next_codeword[None, :],
                                     [c_indices], current_tree._stack,
                                     next_tree._stack, plan)
        n = int(current_codeword.shape[0])
        self._push_rounds([slots], plan.fetch(), [proof_stream], [n])
        half = n // 2
        return list(c_indices) + [i + half for i in c_indices]

    # -- prove (fri.rs:250-311) -----------------------------------------------------

    def prove(
        self,
        initial_codeword: torch.Tensor,
        fiat_shamir,
        proof_stream: ProofStream,
        timer=NULL_TIMER,
        extra_dispatch=None,
        extra_emit=None,
    ) -> list[int]:
        """Commit, sample, query; returns the top-level query indices.
        ``extra_dispatch(top_level_indices, plan) -> meta`` lets a caller
        (the STARK layer's trace openings) add its reads to the query
        phase's plan, and ``extra_emit(meta, fetched)`` emits them after
        the rounds (stark_tpu/fri.py:1250-1301).  One proof of
        :meth:`prove_batch`."""
        assert self.domain_length == initial_codeword.shape[0], (
            "initial codeword length does not match domain length"
        )
        batch_dispatch = None
        if extra_dispatch is not None:
            def batch_dispatch(indices, plan):
                return extra_dispatch(indices[0], plan)
        return self.prove_batch(initial_codeword[None, :], [fiat_shamir],
                                [proof_stream], timer, batch_dispatch, extra_emit)[0]

    # -- the seams the sharded FRI (parallel/pstark.py) overrides -----------------

    def _commit(self, codewords: torch.Tensor, proof_streams: list,
                fiat_shamirs: list, upstream: Upstream | None = None) -> tuple[list, list]:
        """The commit phase of :meth:`prove_batch`: (codewords, stacks), per
        round the (B, n) codewords and their forest's level stack (None
        where no tree was built).  ``upstream``: the STARK layer's
        sections ride the commit's one read."""
        b = codewords.shape[0]
        if self.num_rounds() == 0:
            # No round, no tree: each stream gets its codeword as the
            # last codeword (stark_tpu/batch.py:_prove_batch_classic
            # over zero rounds), the B of them in one read.
            if upstream is None:
                last = G.to_host(codewords.reshape(-1)).reshape(b, -1)
            else:
                upstream.packed.dev["last"].copy_(codewords.reshape(-1))
                host = upstream.packed.host(G.to_host(upstream.packed.buf))
                upstream.replay(host)
                last = host["last"].reshape(b, -1)
            for stream, cw in zip(proof_streams, last):
                stream.push(FieldElements(tuple(int(v) for v in cw)))
            return [codewords], [None]
        if self.device_chain:
            cws, forests = self.commit_batch(codewords, proof_streams, fiat_shamirs, upstream)
            return cws, [f.stack for f in forests]
        if upstream is not None:
            raise ValueError("the host commit path takes no device transcript")
        if b == 1:
            cws, trees = self.commit(codewords[0], proof_streams[0], fiat_shamirs[0])
            return ([cw[None, :] for cw in cws],
                    [None if t is None else t._stack for t in trees])
        raise ValueError("the host commit path proves one codeword at a time")

    def _gather_plan(self) -> G.GatherPlan:
        """The query phase's plan (one K13 gather, one fetch)."""
        return G.GatherPlan()

    def prove_batch(self, codewords: torch.Tensor, fiat_shamirs: list,
                    proof_streams: list, timer=NULL_TIMER, extra_dispatch=None,
                    extra_emit=None, upstream: Upstream | None = None) -> list[list[int]]:
        """Commit, sample, query for B proofs of (B, n) codewords; returns
        each proof's top-level query indices.  The commit is the device
        chain (:meth:`commit_batch`) or, for one proof with ``device_chain``
        False, the host path (:meth:`commit`); with no FRI round (4 tests
        or more a point of the last codeword) each stream gets its codeword
        as the last codeword, and no tree.  The query phase is one K13
        gather and one fetch for every round of every proof: the indices
        are host ints, so each round's reduction is done here first.
        ``extra_dispatch(indices, plan) -> meta`` (``indices``: a list of
        each proof's top-level indices) adds the caller's reads to the same
        plan and ``extra_emit(meta, fetched)`` emits them after the
        rounds.  ``upstream``: the STARK layer's device transcript, whose
        sections ride the commit's read (stark_tpu's
        commit(transcript_dev_prefix=)); the query phase is a read of its
        own.  :meth:`chain_launches` is the single-fetch form."""
        b = codewords.shape[0]
        with timer.phase("fri_commit"):
            cws, stacks = self._commit(codewords, proof_streams, fiat_shamirs, upstream)

        with timer.phase("fri_sample"):
            sample_size = int(cws[1].shape[1] if len(cws) > 1 else cws[0].shape[1])
            indices = []
            for fs in fiat_shamirs:
                # Seed from the RAW (unreduced) challenge value (fri.rs:272).
                seed = Hash.from_u64(fs.challenge(self.field).value).data
                indices.append(self.sample_indices(
                    seed, sample_size, int(cws[-1].shape[1]),
                    self.num_colinearity_tests))

        with timer.phase("fri_query"):
            plan = self._gather_plan()
            rounds = []
            reduced = np.asarray(indices, dtype=np.int64).reshape(b, -1)
            for i in range(len(cws) - 1):
                reduced = reduced % (int(cws[i].shape[1]) // 2)
                rounds.append(self._round_dispatch(
                    cws[i], cws[i + 1], reduced, stacks[i], stacks[i + 1], plan))
            meta = None
            if extra_dispatch is not None:
                meta = extra_dispatch(indices, plan)
            if plan.requests:
                fetched = plan.fetch()
                self._push_rounds(rounds, fetched, proof_streams,
                                  [int(cw.shape[1]) for cw in cws])
                if extra_emit is not None:
                    extra_emit(meta, fetched)
        return indices

    # -- the single-fetch prove (stark_tpu/fri.py:_prove_chained) ---------------------

    def rule_plan(self) -> G.RulePlan:
        """A new plan for the single-fetch prove's query gather (the sharded
        FRI's gathers a rank's share and combines)."""
        return G.RulePlan()

    def _round_cut(self, r: int) -> tuple[bool, bool]:
        """Whether round r's codeword and its forest are cut over a mesh
        (the sharded FRI's layout; here neither)."""
        return False, False

    def query_rules(self, plan: G.RulePlan, b: int) -> list:
        """Declare every round's (B, n) codewords and forest as sources of
        ``plan`` (bound in that order: codeword, stack, round by round; each
        cut or whole as :meth:`_round_cut` says) and add each round's reads
        as rule slots, in :meth:`_round_dispatch`'s order (stark_tpu/fri.py:
        _query_gather_fn): per round the slots :meth:`_round_emit` takes."""
        k, rounds = self.num_colinearity_tests, self.num_rounds()
        src = []
        for i in range(rounds):
            n = self.domain_length >> i
            cut, tree_cut = self._round_cut(i)
            src.append((plan.values_source((b, n), b * n, split=cut),
                        plan.stack_source(b * n, n.bit_length() - 1, split=tree_cut)))
        slots = []
        for i in range(rounds - 1):
            n = self.domain_length >> i
            ab = G.Rule(b, k, n // 2, h=2, stride=n)
            c = G.Rule(b, k, n // 2, stride=n // 2)
            slots.append((plan.values(src[i][0], ab), plan.values(src[i + 1][0], c),
                          plan.paths(src[i][1], ab), plan.paths(src[i + 1][1], c)))
        return slots

    def chain_launches(self, codewords: torch.Tensor, sponge: HB.Sponge, packed: G.Packed,
                       plan: G.RulePlan, extra_sources: list, timer=NULL_TIMER) -> list:
        """The single-fetch prove's launches for B (B, n) codewords
        (stark_tpu/fri.py:_prove_chained, :739-1035, and _mega_prove_fn,
        :154-304; stark_tpu/batch.py:_batch_mega_fn): the device chain goes
        on from ``sponge`` (K15's), K10 samples each proof's indices from the
        sponge after the last root, and K13 gathers ``plan`` (:meth:`query_rules`'
        slots, then the caller's, whose sources are ``extra_sources``) from
        the card's indices, all into ``packed``.  Nothing here reads from the
        card: a CUDA graph can hold it (stark.py).  Returns the gather's
        sources, as :meth:`chained_replay` takes them."""
        b, n = codewords.shape
        k, rounds = self.num_colinearity_tests, self.num_rounds()
        if not self._chainable() or self.domain_length != n:
            raise ValueError("the single-fetch prove needs a chainable FRI and codewords "
                             f"of {self.domain_length}, got {tuple(codewords.shape)}")
        with timer.phase("fri_commit"):
            cws, forests = self._chain(codewords, sponge, packed)
        indices_dev = packed.dev["indices"].view(b, k)
        with timer.phase("fri_sample"):
            HB.sample_indices(sponge, n // 2, n >> (rounds - 1), k, 2 * k + _SAMPLE_SLACK,
                              indices_dev, packed.dev["counts"])
        sources = [t for cw, f in zip(cws, forests) for t in (cw, f.stack)]
        sources += list(extra_sources)
        with timer.phase("fri_query"):
            plan.run(sources, indices_dev, packed.dev["gather"])
        return sources

    def chained_replay(self, host: dict, fiat_shamirs: list, plan: G.RulePlan,
                       round_slots: list, sources: list, views: dict) -> np.ndarray:
        """The host side of the single-fetch prove, from the fetched sections
        of :meth:`chain_launches`' buffer (``host``; the STARK layer's part
        of each transcript replayed first): the chain's replay, then the
        sampling's (native.sample_indices); raises RuntimeError where a
        card's value differs from the replay; writes the roots, the last
        codewords and every round's reads into ``views`` (a proof layout's,
        :meth:`proof_objects`); returns the gathered words, where the
        caller's reads lie.  Where a proof's candidates gave fewer than
        ``tests`` distinct indices, the host's indices go through ``plan``
        over ``sources`` on the card and a second read (stark_tpu's
        idx_override re-run; counted in :attr:`shortfalls`): the sources
        must still hold this prove's values."""
        b = len(fiat_shamirs)
        k, rounds = self.num_colinearity_tests, self.num_rounds()
        size, reduced = self.domain_length // 2, self.domain_length >> (rounds - 1)
        roots, last = self._chain_replay(host, b, fiat_shamirs)
        views["fri.roots"][0][...] = roots
        views["fri.last"][0][:, 0] = last
        with span("fri.sample_replay"):
            got, counts = host["indices"].reshape(b, k), host["counts"]
            indices, short = [], False
            for j, fs in enumerate(fiat_shamirs):
                # Seed from the RAW (unreduced) challenge value (fri.rs:272).
                seed = Hash.from_u64(fs.challenge(self.field).value).data
                want = self.sample_indices(seed, size, reduced, k)
                indices.append(want)
                if int(counts[j]) < k:
                    short = True
                elif [int(v) for v in got[j]] != want:
                    raise RuntimeError("device/host transcript divergence (query indices)")
        fetched = host["gather"]
        if short:
            with span("fri.second_read"):
                self.shortfalls += 1
                dev = sources[0].device
                out = torch.empty(plan.words, dtype=torch.int32, device=dev)
                plan.run(sources, torch.tensor(indices, dtype=torch.int32).to(dev), out)
                fetched = G.to_host(out)
        for r, slots in enumerate(round_slots):
            self._round_emit(r, slots, fetched, views)
        return fetched

    # -- verify (fri.rs:313-504) -------------------------------------------------------

    def verify(
        self,
        proof_stream: ProofStream,
        fiat_shamir,
        polynomial_values: list,
        path_sink: list | None = None,
    ) -> bool:
        """Host-only: numpy, the native engine and a small coset iNTT.
        ``path_sink``: when given, the Merkle authentication triples are
        appended to it instead of verified here, so that a caller verifies
        many proofs' paths in one native call (StarkVerifier.verify_batch);
        every other check still runs, and True then means "valid if the
        sunk paths authenticate"."""
        field = self.field
        omega = self.omega % P
        offset = self.offset % P
        rounds = self.num_rounds()

        roots: list[Hash] = []
        alphas: list[int] = []
        for _ in range(rounds):
            obj = proof_stream.pop()
            if not isinstance(obj, MerkleRoot):
                reason("missing_root", "Failed to extract Merkle root")
                return False
            roots.append(obj.hash)
            fiat_shamir.absorb(obj.hash.data)
            alphas.append(fiat_shamir.challenge(field).value)  # raw u64

        obj = proof_stream.pop()
        if not isinstance(obj, FieldElements):
            reason("missing_last_codeword", "Failed to extract last codeword")
            return False
        last_codeword = obj.values_u64()  # raw u64 wire values

        if not roots:
            reason("no_roots", "No FRI roots extracted")
            return False
        # Hostile streams may carry a last codeword whose length is zero or
        # not a power of two (the reference panics, merkle.rs:12-17).
        n_last = int(last_codeword.shape[0])
        if n_last == 0 or n_last & (n_last - 1) != 0:
            reason(
                "last_codeword_malformed",
                "last codeword length is not a power of two",
            )
            return False
        # Leaves hash the RAW u64 wire value (fri.rs:349-352).
        hostile_last = bool((last_codeword >= P).any())
        if hostile_last:
            last_tree = MerkleTree(
                [Hash.from_field_elements([int(v)]) for v in last_codeword]
            )
        else:
            last_tree = MerkleTree.from_leaf_values(
                last_codeword.astype(np.uint32)
            )
        if roots[-1] != last_tree.root:
            reason("last_codeword_malformed", "last codeword is not well formed")
            return False

        # Low-degree check (fri.rs:360-397) via coset iNTT (the last domain is
        # the smooth coset {last_offset * last_omega^i}) instead of the
        # reference's O(n^3) Lagrange — same unique interpolant.
        degree_bound = n_last // self.expansion_factor
        if degree_bound == 0:
            reason("last_codeword_too_small", "last codeword too small")
            return False
        degree = degree_bound - 1
        last_omega, last_offset = omega, offset
        for _ in range(rounds - 1):
            last_omega = (last_omega * last_omega) % P
            last_offset = (last_offset * last_offset) % P

        # check the domain is consistent (last_omega must have order n_last)
        if pow(last_omega, n_last, P) != 1 or (
            n_last > 1 and pow(last_omega, n_last // 2, P) == 1
        ):
            reason("bad_last_omega", "last omega has wrong order")
            return False
        vals = (last_codeword % P).astype(np.uint32)
        coeffs = NTT.host_coset_interp(vals, last_offset)
        re_eval = NTT.host_coset_eval(coeffs, last_offset)
        # The reference compares FieldElements by RAW value (ff.rs:50-58):
        # a wire value >= p can never equal the (canonical) re-evaluation.
        if hostile_last or not np.array_equal(re_eval, vals):
            reason("reeval_mismatch", "re-evaluated codeword does not match original!")
            return False
        nonzero = np.nonzero(coeffs)[0]
        observed_degree = int(nonzero[-1]) if len(nonzero) else -1
        if observed_degree > degree:
            reason(
                "degree_too_high",
                "last codeword does not correspond to polynomial of low "
                f"enough degree (observed degree: {observed_degree}, "
                f"but should be: {degree})",
            )
            return False

        # Index resampling (fri.rs:400-405) — seed from RAW challenge.
        seed = Hash.from_u64(fiat_shamir.challenge(field).value).data
        top_level_indices = self.sample_indices(
            seed,
            self.domain_length >> 1,
            self.domain_length >> (rounds - 1),
            self.num_colinearity_tests,
        )

        for r in range(rounds - 1):
            half_len = self.domain_length >> (r + 1)
            c_indices = [idx % half_len for idx in top_level_indices]
            a_indices = list(c_indices)
            b_indices = [idx + half_len for idx in a_indices]

            aa, bb, cc = [], [], []
            for s in range(self.num_colinearity_tests):
                obj = proof_stream.pop()
                if not isinstance(obj, FieldElements):
                    reason("missing_triple", "Failed to extract triple values")
                    return False
                if len(obj) != 3:
                    reason("bad_triple_arity", "Expected triple of values")
                    return False
                ay, by, cy = obj.values_ints()
                aa.append(ay)
                bb.append(by)
                cc.append(cy)

                if r == 0:
                    polynomial_values.append((a_indices[s], field.new_element(ay)))
                    polynomial_values.append((b_indices[s], field.new_element(by)))

                ax = (offset * pow(omega, a_indices[s], P)) % P
                bx = (offset * pow(omega, b_indices[s], P)) % P
                cx = alphas[r]  # raw u64 — colinearity math reduces per-op
                if not _test_colinearity_scalar((ax, ay), (bx, by), (cx, cy)):
                    reason("colinearity", "colinearity check failure")
                    return False

            # Authentication paths: one native batch call per round (first
            # failure in pop order wins, as in the scalar walk).
            triples = []
            for i in range(self.num_colinearity_tests):
                for label, idx, val, root in (
                    ("aa", a_indices[i], aa[i], roots[r]),
                    ("bb", b_indices[i], bb[i], roots[r]),
                    ("cc", c_indices[i], cc[i], roots[r + 1]),
                ):
                    obj = proof_stream.pop()
                    if not isinstance(obj, MerklePath):
                        # Paths popped before the malformed object fail
                        # first, with their own reason.  (With a sink the
                        # proof is rejected either way.)
                        bad_q = None if path_sink is not None else _verify_paths_batch(triples)
                        if bad_q is not None:
                            reason(
                                "path_verify",
                                "merkle authentication path verification "
                                f"fails for {triples[bad_q][0]}",
                            )
                            return False
                        reason("missing_path", f"Failed to extract path for {label}")
                        return False
                    triples.append((label, idx, val, root, obj))
            if path_sink is not None:
                path_sink.extend(triples)
            else:
                bad_q = _verify_paths_batch(triples)
                if bad_q is not None:
                    reason(
                        "path_verify",
                        "merkle authentication path verification fails "
                        f"for {triples[bad_q][0]}",
                    )
                    return False

            omega = (omega * omega) % P
            offset = (offset * offset) % P
        return True


def _verify_paths_batch(triples):
    """``triples``: [(label, idx, raw_val_or_row, root_hash, path_obj)] in
    pop order (a raw u64 wire value, or a list of them for multi-value
    leaves; callers check the arity first).  Returns the first failing
    position, or None when every path verifies.  Paths of equal (length,
    leaf arity) go through ONE native call per group; the global first
    failure is the minimum over groups' first failures, since group
    members keep their relative order.  A group whose leaves the native
    engine does not take (more than 64 values) is verified path by path,
    as stark_tpu/fri.py:1520-1548 does."""
    if not triples:
        return None

    def _row(val):
        return val if isinstance(val, (list, tuple)) else [val]

    def _scalar(qs):
        for q in qs:
            _, idx, val, root, path_obj = triples[q]
            leaf = Hash.from_field_elements(_row(val))
            if not MerkleTree.verify(leaf, idx, list(path_obj.path), root):
                return q
        return None

    groups: dict[tuple, list[int]] = {}
    for q, (_, _, val, _, path_obj) in enumerate(triples):
        groups.setdefault((len(path_obj), len(_row(val))), []).append(q)
    fails = []
    for (L, _), qs in groups.items():
        paths_flat = b"".join(triples[q][4].raw_bytes() for q in qs)
        roots_flat = b"".join(triples[q][3].data for q in qs)
        f = native.merkle_verify_batch(
            [_row(triples[q][2]) for q in qs],
            [triples[q][1] for q in qs],
            paths_flat,
            L,
            roots_flat,
        )
        if f == -2:  # leaf arity the native engine does not take
            f_scalar = _scalar(qs)
            if f_scalar is not None:
                fails.append(f_scalar)
        elif f >= 0:
            fails.append(qs[f])
    return min(fails) if fails else None


_U128_MASK = (1 << 128) - 1


def _sub_ref(l: int, r: int) -> int:
    """Field subtraction with the reference's exact u128 semantics
    (ff.rs:154-160): (p + l - r) in u128 *wrapping* arithmetic."""
    return ((P + l - r) & _U128_MASK) % P


def _test_colinearity_scalar(p0, p1, p2) -> bool:
    """Cross-multiplication colinearity (fri.rs:507-525).  Coordinates may be
    raw (unreduced) u64s; each op reduces, matching ff.rs per-op semantics."""
    (x0, y0), (x1, y1), (x2, y2) = p0, p1, p2
    dy1 = _sub_ref(y1, y0)
    dx1 = _sub_ref(x1, x0)
    dy2 = _sub_ref(y2, y0)
    dx2 = _sub_ref(x2, x0)
    return (dy1 * dx2) % P == (dy2 * dx1) % P
