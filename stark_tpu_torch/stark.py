"""STARK composer: AIR -> composition polynomial -> FRI.

Counterpart of stark_tpu/stark.py.  By default its single-fetch prove
(chain_upstream, :398-444): the trace root never crosses to the host
before the end; kernel K15 draws the constraint challenges from it on the
card and writes the composition's weights, and the FRI chain, the index
sampling and the query gather go on from there (fri.Fri.chain_launches):
one read from the card a prove, or a batch, after which the host replays
every transcript and checks the card's values.  On a card that device
work, from the witness columns to the buffer read, is one CUDA graph a
batch size and slot, captured once and replayed (StarkProver._dispatch;
stark_tpu's one jit, batch.py:_batch_mega_fn).  With ``Fri.fused_round``
False, the classic flow: the trace roots read first, the challenges drawn
on the host, three reads.  Protocol (prover):

 1. Interpolate each trace register over the trace domain {w^i} (iNTT)
    and low-degree-extend onto the evaluation coset {g * W^j},
    |coset| = T * blowup (NTT) — kernels K1-K3.             [device]
 2. Merkle-commit the trace LDE (row hashes K6, tree K7/K8); absorb the
    root.                                                   [device]
 3. Draw two Fiat-Shamir challenges (alpha_k, beta_k) per constraint; the
    transcript absorbs each challenge's 8 LE bytes (challenge() is pure).
                                           [device: K15; or host]
 4. Evaluate transition constraints pointwise on the coset, divide by the
    transition zerofier Z(x) = (x^T - 1) / prod_{tail}(x - w^i), add
    boundary quotients, degree-adjust each term with alpha_k * x^shift +
    beta_k, and sum: the composition codeword.              [device]
 5. FRI-prove the composition codeword (fri.py; folds are kernel K4-dyn,
    the query indices kernel K10).
 6. Open the trace Merkle tree at every FRI round-0 query point and its
    frame-shifted companions: these reads join FRI's query phase, one
    gather (kernel K13) and one fetch for the whole of it.

The verifier mirrors 2-5 from the proof stream on the host, then checks at
each FRI query point that the composition value FRI recorded equals the one
recomputed from the opened trace values.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from stark_tpu_torch.convert import witness_to_device
from stark_tpu_torch.field import FiniteField
from stark_tpu_torch.fri import Fri, Upstream, _verify_paths_batch
from stark_tpu_torch.hashfn import Hash
from stark_tpu_torch.merkle import Forest
from stark_tpu_torch.models.air import Air, BoundaryConstraint, ScalarOps
from stark_tpu_torch.ops import compose as CO
from stark_tpu_torch.ops import cuda
from stark_tpu_torch.ops import gather as G
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.ops import ntt as NTT
from stark_tpu_torch.ops.fieldops import GENERATOR, P, primitive_nth_root
from stark_tpu_torch.stream import (
    FieldElements,
    MerklePath,
    MerkleRoot,
    ProofStream,
    wire_field_elements,
    wire_merkle_paths,
)
from stark_tpu_torch.transcript import FiatShamir
from stark_tpu_torch.utils.profiling import NULL_TIMER, proof_span, reason, span


@dataclass(frozen=True)
class StarkConfig:
    trace_length: int
    blowup: int = 4                  # = FRI expansion factor
    num_colinearity_tests: int = 8
    offset: int = GENERATOR          # evaluation coset offset

    def __post_init__(self):
        assert self.trace_length & (self.trace_length - 1) == 0
        assert self.blowup & (self.blowup - 1) == 0 and self.blowup >= 4

    @property
    def domain_size(self) -> int:
        return self.trace_length * self.blowup


class _Domain:
    """Shared prover/verifier domain quantities (host ints)."""

    def __init__(self, cfg: StarkConfig, air: Air):
        self.cfg = cfg
        self.air = air
        T, N = cfg.trace_length, cfg.domain_size
        self.T, self.N = T, N
        self.omega = primitive_nth_root(T)       # trace-domain generator
        self.Omega = primitive_nth_root(N)       # coset generator
        self.offset = cfg.offset % P
        self.max_off = air.max_offset
        # Transition enforcement rows: 0 .. T-1-max_off; zerofier
        # Z(x) = (x^T - 1) / E(x), E(x) = prod_{i=T-max_off}^{T-1} (x - w^i).
        self.excluded = [pow(self.omega, i, P) for i in range(T - self.max_off, T)]
        self.num_transition = air.num_transition_constraints()
        # Python ints: a numpy scalar boundary value would wrap the
        # verifier's spot-check arithmetic at uint64 width.
        self.boundary = [
            BoundaryConstraint(int(bc.row), int(bc.register), int(bc.value))
            for bc in air.boundary_constraints(T)
        ]
        # Degree bookkeeping: trace polys have degree T-1; a constraint of
        # degree d has degree d*(T-1), its quotient that minus deg Z =
        # T - max_off.  The composition target is the FRI low-degree bound
        # N/expansion - 1; for quotient degrees above T-1 the expansion
        # factor drops to blowup/h (h the smallest power of two that
        # admits the quotients), same domain N, target degree h*T - 1.
        cdeg = max(air.constraint_degree * (T - 1) - (T - self.max_off), 0)
        h = 1
        while h * T - 1 < cdeg:
            h *= 2
        if cfg.blowup < 4 * h:
            raise ValueError(
                "AIR out of range for this blowup: constraint degree "
                f"{air.constraint_degree} with frame depth {self.max_off} "
                f"gives a quotient of degree {cdeg} > blowup/4 * T - 1; "
                f"the FRI expansion factor blowup/h = {cfg.blowup}/{h} "
                "must stay >= 4 (fri.rs:41-45).  Use "
                f"blowup >= {4 * h}."
            )
        self.h = h
        self.target_degree = h * T - 1
        self.transition_shift = self.target_degree - cdeg
        self.boundary_shift = self.target_degree - (T - 2)
        assert self.transition_shift >= 0 and self.boundary_shift >= 0

    def fri(self) -> Fri:
        return Fri(
            omega=self.Omega,
            offset=self.offset,
            domain_length=self.N,
            expansion_factor=self.cfg.blowup // self.h,
            num_colinearity_tests=self.cfg.num_colinearity_tests,
        )

    # -- scalar evaluation at one point (verifier spot checks) ----------------

    def znum_at(self, x: int) -> int:
        """x^T - 1, the numerator of the transition zerofier."""
        return (pow(x, self.T, P) - 1) % P

    def excluded_at(self, x: int) -> int:
        """E(x), the product of (x - w^i) over the excluded rows."""
        e = 1
        for w in self.excluded:
            e = (e * (x - w)) % P
        return e

    def composition_value_at(
        self, idx: int, trace_rows: dict[int, list[int]], alphas, betas
    ) -> int:
        """Recompute the composition codeword value at coset index idx from
        opened trace rows (trace_rows[k] = registers at index idx+k*blowup)."""
        x = (self.offset * pow(self.Omega, idx, P)) % P
        frame = {k: [v % P for v in trace_rows[k]] for k in self.air.frame_offsets}
        cons = self.air.transition_constraints(frame, ScalarOps)
        znum = self.znum_at(x)
        assert znum != 0
        zinv = pow(znum, P - 2, P)
        exc = self.excluded_at(x)
        total = 0
        ci = 0
        xs_t = pow(x, self.transition_shift, P)
        for c in cons:
            q = (c * exc) % P * zinv % P
            w = (alphas[ci] * xs_t + betas[ci]) % P
            total = (total + w * q) % P
            ci += 1
        xs_b = pow(x, self.boundary_shift, P)
        for bc in self.boundary:
            tv = frame[0][bc.register]
            denom = (x - pow(self.omega, bc.row, P)) % P
            q = (tv - bc.value) % P * pow(denom, P - 2, P) % P
            w = (alphas[ci] * xs_b + betas[ci]) % P
            total = (total + w * q) % P
            ci += 1
        return total


def _draw_constraint_challenges(fs: FiatShamir, field: FiniteField, count: int):
    """count (alpha, beta) pairs; each raw challenge's 8 LE bytes are
    absorbed so successive challenges differ (challenge() is pure)."""
    alphas, betas = [], []
    for _ in range(count):
        a = fs.challenge(field).value
        fs.absorb(a.to_bytes(8, "little"))
        b = fs.challenge(field).value
        fs.absorb(b.to_bytes(8, "little"))
        alphas.append(a % P)
        betas.append(b % P)
    return alphas, betas


class _Slot:
    """One batch's device state for the single-fetch prove, at addresses that
    stay (the buffers of stark_tpu/batch.py:_batch_mega_fn): the (B, c, T)
    columns the body starts from, K15's sponge and K11's weight words, the
    one buffer the body writes (``packed``), the host buffer its read
    lands in (pinned on a card), and K8's and K8-forest's ticket words;
    on a card its CUDA graph (``graph``, ops/cuda.Graph), whose result is
    the gather's sources it writes: the trace LDE, the trace forest's
    stack, every round's codewords and forest stacks, tensors of the
    graph's own memory pool.  ``warm``: the body has run eagerly on it
    (a capture's warm-up); ``busy``: from a dispatch to its finish()."""

    def __init__(self, shape: tuple, n_terms: int, sections: dict, device):
        b = shape[0]
        self.b = b
        self.cols = torch.empty(shape, dtype=torch.int32, device=device)
        self.sponge = HB.Sponge(b, device)
        self.weights = torch.empty((b, 4 * n_terms), dtype=torch.int32, device=device)
        self.packed = G.Packed(sections, device)
        self.host = torch.empty(self.packed.buf.shape, dtype=torch.int32,
                                pin_memory=torch.device(device).type == "cuda")
        self.tickets = torch.zeros(HB.FOREST_MAX_TREES, dtype=torch.int32, device=device)
        self.graph: cuda.Graph | None = None
        self.warm = False
        self.busy = False

    def nbytes(self) -> dict:
        """Bytes held: ``device`` by the slot's own buffers, ``pool`` by its
        graph's memory pool (0 before the capture), ``host`` pinned."""
        sponge = self.sponge
        own = (self.cols, sponge.state, sponge.pending, sponge.next_state,
               sponge.next_pending, self.weights, self.packed.buf, self.tickets)
        return {"device": sum(t.numel() * t.element_size() for t in own),
                "pool": 0 if self.graph is None else self.graph.pool_bytes,
                "host": self.host.numel() * self.host.element_size()}


class StarkProver:
    """Proves on ``device`` (default ``cuda``; the CPU runs every kernel's
    plain version).  ``lazy_ntt`` takes the NTT kernels' [0, 2p)
    butterflies; the proof bytes are the same.  Deterministic: no
    randomness anywhere."""

    def __init__(self, air: Air, cfg: StarkConfig, device="cuda",
                 lazy_ntt: bool = False):
        device = cuda.device_or_raise(device, "StarkProver")
        self.air = air
        self.cfg = cfg
        self.device = device
        self.lazy_ntt = lazy_ntt
        self.dom = d = _Domain(cfg, air)
        self.fri = d.fri()
        # The composition kernel generated from the AIR (K11), and its
        # trace-independent (N,) tables: int32 canonical values on the
        # device, made once here and read once a point.
        self.program = CO.ComposeProgram(air, d.boundary)
        self.tables = self._tables(*self._points())
        # The single-fetch prove's gather plan and slots, by batch size (the
        # plan's structure depends on the shapes only).
        self._rule_plans: dict[int, tuple] = {}
        self._slots: dict[int, list[_Slot]] = {}
        self._eager_depth = 0

    def _points(self) -> tuple[int, int]:
        """(first, count): the coset points whose codeword values this
        prover computes, all N of them (a rank's share when sharded)."""
        return 0, self.dom.N

    def _tables(self, start: int, count: int) -> CO.Tables:
        """K11's tables at the points start .. start + count - 1."""
        d = self.dom
        return CO.Tables.build(
            n=d.N, trace_length=d.T, blowup=self.cfg.blowup, offset=d.offset,
            omega_n=d.Omega, omega_t=d.omega, excluded=d.excluded,
            shift_t=d.transition_shift, shift_b=d.boundary_shift,
            rows=self.program.rows, device=self.device, start=start, count=count)

    def _compose(self, trace_lde: torch.Tensor, alphas=None, betas=None, *,
                 weights: torch.Tensor | None = None) -> torch.Tensor:
        """(c, N) int32 LDE -> (N,) int32 composition codeword, or B proofs
        at once: (B, c, N) -> (B, N) (stark_tpu/stark.py:_compose_impl,
        which stark_tpu/batch.py vmaps): kernel K11 on a card, its plain
        version on the CPU (ops/compose.py).  ``alphas``, ``betas``: the
        terms' weights, (terms,) host ints for one proof, (B, terms) for B;
        or ``weights``, K15's (B, 4 terms) weight words on the device."""
        return CO.compose(self.program, trace_lde, self.tables, alphas, betas,
                          self.cfg.blowup, weights=weights)

    # -- the seams the sharded prover (parallel/pstark.py) overrides ------------

    def _lde_trace(self, cols: torch.Tensor) -> torch.Tensor:
        """(B, c, T) witness columns -> (B, c, N) trace LDEs on the coset
        (stark_tpu/stark.py:340): iNTT, then the LDE (the pad and scale in
        its pass 1's first round) over the B c rows at once."""
        b, c, t = cols.shape
        return NTT.lde(NTT.intt(cols.reshape(b * c, t), self.lazy_ntt), self.cfg.blowup,
                       self.dom.offset, self.lazy_ntt).reshape(b, c, self.dom.N)

    def _trace_tree(self, trace_lde: torch.Tensor) -> Forest:
        """The B trace trees, one forest (row digests, every level)."""
        return Forest.from_rows(trace_lde)

    def _trace_sources(self, plan: G.RulePlan, b: int) -> tuple[int, int]:
        """Declare the (B, c, N) trace LDE and the trace forest's stack as
        sources of the single-fetch prove's ``plan``: (their ids)."""
        d, c = self.dom, self.air.num_registers
        return (plan.values_source((b, c, d.N), d.N, c),
                plan.stack_source(b * d.N, d.N.bit_length() - 1))

    def _composition(self, trace_lde: torch.Tensor, alphas=None, betas=None, *,
                     weights: torch.Tensor | None = None) -> torch.Tensor:
        """The (B, N) composition codewords of the (B, c, N) trace LDEs."""
        b = int(trace_lde.shape[0])
        return self._compose(trace_lde if b > 1 else trace_lde[0], alphas, betas,
                             weights=weights).reshape(b, self.dom.N)

    def _witness(self, trace_rows, trace_cols) -> torch.Tensor:
        """The (c, T) int32 witness on the prover's device: host rows or
        columns are uploaded once; a tensor must already lie there."""
        d = self.dom
        if trace_cols is None:
            if trace_rows is None or len(trace_rows) != d.T:
                raise ValueError(f"trace_rows must hold {d.T} rows")
            cols = witness_to_device(trace_rows, self.device)
        elif trace_rows is not None:
            raise ValueError("pass trace_rows or trace_cols, not both")
        elif isinstance(trace_cols, torch.Tensor):
            if trace_cols.device != self.device:
                raise ValueError(f"trace_cols on {trace_cols.device}, the prover "
                                 f"on {self.device}")
            if trace_cols.dtype != torch.int32:
                raise ValueError(f"trace_cols must be int32, got {trace_cols.dtype}")
            cols = trace_cols
        else:
            cols = witness_to_device(trace_cols, self.device, rows=False)
        if tuple(cols.shape) != (self.air.num_registers, d.T):
            raise ValueError(f"the witness is {tuple(cols.shape)}, the AIR needs "
                             f"{(self.air.num_registers, d.T)}")
        return cols

    def prove(self, trace_rows=None, timer=NULL_TIMER, *, trace_cols=None) -> bytes:
        """``trace_rows``: (T, c) rows (list or ndarray, reference
        trace.rs:29-34 ingestion semantics).  ``trace_cols``: instead, the
        (c, T) columns of reduced values: an int32 tensor on the prover's
        device (models.fibonacci_trace_cols_device,
        models.examples.mds_square_trace_cols_device: the witness never
        crosses from the host), or numpy columns, uploaded once
        (stark_tpu/stark.py:364-387)."""
        with proof_span():
            with timer.phase("lde"):
                cols = self._witness(trace_rows, trace_cols)
            return self._prove_columns(cols[None], timer)[0]

    def _prove_columns(self, cols: torch.Tensor, timer=NULL_TIMER) -> list[bytes]:
        """B proofs of (B, c, T) int32 witness columns on the prover's device,
        each byte-identical to its own prove (stark_tpu/stark.py:364-568;
        for B > 1 stark_tpu/batch.py:_prove_batch_mega, :716-940, and
        _prove_batch_classic, :941-1149): :meth:`_dispatch`, then its
        finish."""
        return self._dispatch(cols, timer)()

    def _dispatch(self, cols: torch.Tensor, timer=NULL_TIMER, ring: int = 1):
        """Start B proofs of (B, c, T) witness columns; returns ``finish()``
        -> the B proofs.  The single-fetch prove (the device chain with
        ``fused_round``, where the FRI is ``_chainable``) runs on one of
        ``ring`` slots of B (:class:`_Slot`): the columns copied into it, its
        device work (:meth:`_body`) issued and its one read issued, and
        ``finish`` waits for the read (stark_tpu/batch.py:_mega_dispatch,
        _mega_finish): a caller may start the next batch, on another slot,
        between the two.  On a card the body is one CUDA graph a slot,
        captured at the slot's second prove (its first runs the body eagerly,
        the warm-up the capture needs) and replayed from then on; on the CPU,
        in :meth:`_eager` and on a sharded prover whose collectives no graph
        can hold (gloo) it runs eagerly.  The
        other paths run to their end here: two reads with the challenges
        still on the card (the FRI not chainable: :meth:`_prove_two_reads`),
        three with ``fused_round`` False (:meth:`_prove_three_reads`)."""
        fri = self.fri
        if not (fri.device_chain and fri.fused_round):
            proofs = self._prove_three_reads(cols, timer)
            return lambda: proofs
        if not fri._chainable():
            proofs = self._prove_two_reads(cols, timer)
            return lambda: proofs
        b = int(cols.shape[0])
        fss = [FiatShamir() for _ in range(b)]
        streams = [ProofStream() for _ in range(b)]
        plan, round_slots, open_slots = self._rule_plan(b)
        slot = self._slot(b, ring)
        slot.busy = True
        try:
            if slot.warm and self._graphs and not self._eager_depth \
                    and self.device.type == "cuda":
                with timer.phase("dispatch"):
                    slot.cols.copy_(cols)
                    if slot.graph is None:
                        slot.graph = self._capture(slot)
                    slot.graph.replay()
                    pending = G.to_host(slot.packed.buf, wait=False, into=slot.host)
                sources = slot.graph.result
            else:
                with timer.phase("lde"):
                    slot.cols.copy_(cols)
                sources = self._body(slot, timer)
                with timer.phase("fri_query"):
                    pending = G.to_host(slot.packed.buf, wait=False, into=slot.host)
                slot.warm = True
        except BaseException:
            slot.busy = False
            raise

        def finish() -> list[bytes]:
            try:
                with timer.phase("fri_fetch"):
                    with span("stark.fetch_wait"):
                        words = pending.wait()
                    # A copy: the slot's next prove lands in the same buffer.
                    with span("stark.fetch_copy"):
                        host = slot.packed.host(words.copy())
                with timer.phase("fri_emit"):
                    self._prefix_replay(host, fss, streams)
                    fri.chained_replay(host, fss, streams, plan, round_slots, sources,
                                       lambda fetched: self._open_emit(open_slots, fetched,
                                                                       streams))
            finally:
                slot.busy = False
            return [stream.serialize() for stream in streams]

        return finish

    #: Whether the single-fetch prove's body is captured as a CUDA graph on a
    #: card (the sharded prover's: where its mesh's collectives can be held
    #: in one, parallel/pstark.graphs_allowed).
    _graphs = True

    def _capture(self, slot: "_Slot") -> cuda.Graph:
        """The slot's body captured as one CUDA graph: its launches recorded,
        nothing run."""
        return cuda.Graph(lambda: self._body(slot), self.device)

    def close(self) -> None:
        """Release every slot and its CUDA graph (ops/cuda.Graph.close); a
        later prove makes its slots anew.  Proves still in flight (a
        ``prove_many`` interrupted) lose their state.  A sharded prover on
        NCCL must be closed before ``destroy_process_group``, which waits for
        every graph holding NCCL's operations."""
        for slots in self._slots.values():
            for slot in slots:
                if slot.graph is not None:
                    slot.graph.close()
                    slot.graph = None
        self._slots.clear()

    @contextlib.contextmanager
    def _eager(self):
        """Within the block the single-fetch prove's body runs eagerly on a
        card too, every kernel launched from Python as on the CPU: the
        yardstick that the graph path is held against (chip_smoke.py,
        tools/prove_wall.py).  The slots and their graphs stay."""
        self._eager_depth += 1
        try:
            yield
        finally:
            self._eager_depth -= 1

    def _slot(self, b: int, ring: int) -> "_Slot":
        """A free slot of B proofs among the first ``ring`` (made when
        fewer exist); raises RuntimeError when all ``ring`` hold a prove
        whose finish() has not run: a slot is never overwritten."""
        slots = self._slots.setdefault(b, [])
        for slot in slots[:ring]:
            if not slot.busy:
                return slot
        if len(slots) >= ring:
            raise RuntimeError(f"every one of the {ring} slot(s) of B = {b} holds a prove "
                               "whose finish() has not run")
        d = self.dom
        sections = self.fri.packed_sections(b, self._prefix(b), self._rule_plan(b)[0].words)
        slot = _Slot((b, self.air.num_registers, d.T), d.num_transition + len(d.boundary),
                     sections, self.device)
        slots.append(slot)
        return slot

    def _body(self, slot: "_Slot", timer=NULL_TIMER) -> list:
        """The single-fetch prove's device work on ``slot`` (stark_tpu/batch.py:
        _batch_mega_fn, its LDE's dispatches with it): from the slot's
        columns, the LDE, the trace forest, K15 (the constraint challenges
        into the slot's sponge, weights and buffer), K11, then the FRI's
        launches (Fri.chain_launches: the chain, K10, K13) into the slot's
        buffer.  It reads nothing from the card and takes nothing but the
        slot, so one CUDA graph a slot holds it.  Returns the query
        gather's sources (the trace LDE and forest, every round's codewords
        and forests)."""
        with HB.own_tickets(slot.tickets):
            trace_lde, trace_forest, composition = self._front(
                slot.cols, slot.sponge, slot.weights, slot.packed, timer)
            # 5. FRI, with the trace openings (step 6) in the same gather
            return self.fri.chain_launches(composition, slot.sponge, slot.packed,
                                           self._rule_plan(slot.b)[0],
                                           [trace_lde, trace_forest.stack], timer)

    def _front(self, cols: torch.Tensor, sponge: HB.Sponge, weights: torch.Tensor,
               packed: G.Packed, timer=NULL_TIMER) -> tuple:
        """Steps 1-4 on the card, nothing read back: the (B, c, T) columns'
        LDE, the trace forest, K15 (the constraint challenges into
        ``sponge``, K11's ``weights`` and ``packed``'s prefix sections),
        K11.  Returns (trace LDE, trace forest, (B, N) codewords)."""
        b = int(cols.shape[0])
        n_terms = self.dom.num_transition + len(self.dom.boundary)
        # 1. trace columns -> coefficients -> LDE on the coset  [device]
        with timer.phase("lde"):
            trace_lde = self._lde_trace(cols)

        # 2. commit the traces: row digests and every level of the B trees
        # (one forest); the roots stay on the card  [device]
        with timer.phase("trace_commit"):
            trace_forest = self._trace_tree(trace_lde)

        # 3. constraint-combination challenges from the trace roots, and the
        # composition's weights: K15, into the one buffer  [device]
        with timer.phase("challenges"):
            HB.constraint_challenges(
                trace_forest.roots_dev(), 2 * n_terms, sponge,
                packed.dev["trace_roots"].view(torch.uint8).view(b, 32),
                packed.dev["digests"].view(torch.uint8).view(b, 2 * n_terms, 8), weights)

        # 4. composition codewords  [device]
        with timer.phase("compose"):
            composition = self._composition(trace_lde, weights=weights)
        return trace_lde, trace_forest, composition

    def _prefix(self, b: int) -> dict:
        """The STARK layer's sections of a single-fetch buffer of B proofs
        (Fri.packed_sections' prefix): the trace roots, the challenges'
        bytes (words each)."""
        n_terms = self.dom.num_transition + len(self.dom.boundary)
        return {"trace_roots": 8 * b, "digests": 4 * n_terms * b}

    def _prefix_replay(self, host: dict, fss: list, streams: list) -> None:
        """The host's replay of the trace roots and the challenge draws from
        the fetched sections (stark_tpu/stark.py:426-444); raises on a
        device/host divergence."""
        with span("stark.prefix_replay"):
            b = len(fss)
            field = FiniteField()
            n_terms = self.dom.num_transition + len(self.dom.boundary)
            roots = host["trace_roots"].view(np.uint8).reshape(b, 32)
            digests = host["digests"].view(np.uint8).reshape(b, 2 * n_terms, 8)
            for j in range(b):
                root = Hash(roots[j].tobytes())
                streams[j].push(MerkleRoot(root))
                fss[j].absorb(root.data)
                for i in range(2 * n_terms):
                    raw = fss[j].challenge(field).value.to_bytes(8, "little")
                    if raw != digests[j, i].tobytes():
                        raise RuntimeError("device/host transcript divergence "
                                           "(constraint challenges)")
                    fss[j].absorb(raw)

    def _prove_two_reads(self, cols: torch.Tensor, timer=NULL_TIMER) -> list[bytes]:
        """B proofs where the FRI is not chainable (fewer than two rounds,
        or a last codeword the device sampler does not take): K15 still
        draws the challenges on the card, its bytes ride the chain's fetch,
        then the query gather with host indices: two reads."""
        d, fri = self.dom, self.fri
        b = int(cols.shape[0])
        fss = [FiatShamir() for _ in range(b)]
        streams = [ProofStream() for _ in range(b)]
        sponge = HB.Sponge(b, self.device)
        weights = torch.empty((b, 4 * (d.num_transition + len(d.boundary))),
                              dtype=torch.int32, device=self.device)
        packed = G.Packed(fri.packed_sections(b, self._prefix(b)), self.device)
        trace_lde, trace_forest, composition = self._front(cols, sponge, weights, packed,
                                                           timer)
        fri.prove_batch(composition, fss, streams, timer=timer,
                        extra_dispatch=self._open_dispatch(trace_lde, trace_forest),
                        extra_emit=lambda slots, fetched: self._open_emit(
                            slots, fetched, streams),
                        upstream=Upstream(sponge, packed,
                                          lambda host: self._prefix_replay(host, fss, streams)))
        return [stream.serialize() for stream in streams]

    def _rule_plan(self, b: int) -> tuple:
        """The single-fetch prove's query gather for B proofs, made once per
        B: (plan, each FRI round's slots, the openings' slots).  Its sources
        are bound as the FRI rounds' codewords and forests, then the (B, c,
        N) trace LDE and the trace forest's stack (:meth:`_trace_sources`;
        the sharded prover's: a rank's share of each, Fri.rule_plan)."""
        got = self._rule_plans.get(b)
        if got is None:
            d, cfg = self.dom, self.cfg
            c, k = self.air.num_registers, cfg.num_colinearity_tests
            plan = self.fri.rule_plan()
            round_slots = self.fri.query_rules(plan, b)
            lde, stack = self._trace_sources(plan, b)
            # The FRI round-0 points (a, a + N/2) of each index, each frame
            # offset's row (stark_tpu/stark.py:_dev_cols_idx).
            offs = tuple(o * cfg.blowup for o in self.air.frame_offsets)
            rule = dict(rows=b, number=k, half=d.N // 2, h=2, offsets=offs, wrap=d.N,
                        order=1)
            open_slots = ([plan.values(lde, G.Rule(stride=c * d.N, **rule))],
                          plan.paths(stack, G.Rule(stride=d.N, **rule)))
            got = self._rule_plans[b] = (plan, round_slots, open_slots)
        return got

    def _open_dispatch(self, trace_lde: torch.Tensor, trace_forest: Forest):
        """The openings' reads with host indices: ``dispatch(indices, plan)``
        adds, per FRI round-0 query point (a, a + half) of each sampled
        index, each frame offset's row: per proof its values, and every
        proof's paths in one request."""
        d, cfg = self.dom, self.cfg
        b = int(trace_lde.shape[0])
        offs = np.asarray([k * cfg.blowup for k in self.air.frame_offsets])
        half = d.N // 2

        def dispatch(indices, plan):
            a = np.asarray(indices, dtype=np.int64).reshape(b, -1) % half
            qp = np.stack([a, a + half], axis=2).reshape(b, -1, 1)
            cols_idx = ((qp + offs[None, None, :]) % d.N).reshape(b, -1)
            return ([plan.values(trace_lde[j], cols_idx[j]) for j in range(b)],
                    plan.paths(trace_forest.stack, trace_forest.global_index(cols_idx),
                               trace_forest.depth))

        return dispatch

    def _open_emit(self, slots, fetched: np.ndarray, streams: list) -> None:
        """Per opening its values, then its path (raw wire segments), a
        segment a proof.  ``slots``: the values' slots (one a proof, or one
        for all) and the paths' slot."""
        with span("stark.open_emit"):
            vals, sib = slots
            b = len(streams)
            vals = np.concatenate([s.take(fetched) for s in vals]).reshape(
                b, -1, self.air.num_registers)
            sib = sib.take(fetched)
            sib = sib.reshape((b, -1) + sib.shape[1:])
            for j in range(b):
                streams[j].push_raw(np.concatenate(
                    [wire_field_elements(vals[j]), wire_merkle_paths(sib[j])], axis=1,
                ).tobytes())

    def _prove_three_reads(self, cols: torch.Tensor, timer=NULL_TIMER) -> list[bytes]:
        """B proofs with the challenges drawn on the host (the classic flow,
        ``Fri.fused_round`` False; stark_tpu's chain_upstream False): three
        reads from the card for the batch: the B trace roots, the FRI
        chain's one fetch, the query phase's one gather."""
        d = self.dom
        field = FiniteField()
        b = int(cols.shape[0])
        fss = [FiatShamir() for _ in range(b)]
        streams = [ProofStream() for _ in range(b)]

        # 1. trace columns -> coefficients -> LDE on the coset  [device]
        with timer.phase("lde"):
            trace_lde = self._lde_trace(cols)

        # 2. commit the traces: row digests and every level of the B trees
        # (one forest), then the B roots in one read  [device]
        with timer.phase("trace_commit"):
            trace_forest = self._trace_tree(trace_lde)
            roots = G.to_host(trace_forest.roots_dev().view(torch.int32))
            for j in range(b):
                root = Hash(roots[j].tobytes())
                streams[j].push(MerkleRoot(root))
                fss[j].absorb(root.data)

        # 3. constraint-combination challenges (host transcripts)
        with timer.phase("challenges"):
            n_terms = d.num_transition + len(d.boundary)
            drawn = np.asarray([_draw_constraint_challenges(fs, field, n_terms)
                                for fs in fss], dtype=np.int64).reshape(b, 2, n_terms)
            alphas, betas = (drawn[0, 0], drawn[0, 1]) if b == 1 else (
                drawn[:, 0], drawn[:, 1])

        # 4. composition codewords  [device]
        with timer.phase("compose"):
            composition = self._composition(trace_lde, alphas, betas)

        # 5. FRI, with the trace openings (step 6) riding the query phase's
        # one gather and one fetch (stark_tpu/stark.py:446-548).
        self.fri.prove_batch(composition, fss, streams, timer=timer,
                             extra_dispatch=self._open_dispatch(trace_lde, trace_forest),
                             extra_emit=lambda slots, fetched: self._open_emit(
                                 slots, fetched, streams))
        return [stream.serialize() for stream in streams]


class StarkVerifier:
    """Host-only verification (numpy, the native engine, a small iNTT)."""

    def __init__(self, air: Air, cfg: StarkConfig):
        self.air = air
        self.cfg = cfg
        self.dom = _Domain(cfg, air)
        self.fri = self.dom.fri()

    def verify(self, proof: bytes, path_sink: list | None = None) -> bool:
        """``path_sink``: defer Merkle path authentication to the caller
        (see :meth:`verify_batch`); every other check still runs here."""
        d, cfg = self.dom, self.cfg
        field = FiniteField()
        fs = FiatShamir()
        stream = ProofStream.deserialize(proof, field)

        obj = stream.pop()
        if not isinstance(obj, MerkleRoot):
            reason("missing_trace_root", "missing trace commitment")
            return False
        trace_root = obj.hash
        fs.absorb(trace_root.data)

        n_terms = d.num_transition + len(d.boundary)
        alphas, betas = _draw_constraint_challenges(fs, field, n_terms)

        polynomial_values: list = []
        if not self.fri.verify(stream, fs, polynomial_values, path_sink=path_sink):
            return False

        # Trace openings: pop rows + paths in stream order, authenticate
        # every path in one native batch call, then spot-check composition
        # consistency at every query point.
        openings: list = []   # (idx, comp_fe, {k: values})
        triples: list = []    # _verify_paths_batch operands
        for idx, comp_fe in polynomial_values:
            trace_rows: dict[int, list[int]] = {}
            for k in self.air.frame_offsets:
                j = (idx + k * cfg.blowup) % d.N
                row_obj = stream.pop()
                path_obj = stream.pop()
                if not isinstance(row_obj, FieldElements) or not isinstance(
                    path_obj, MerklePath
                ):
                    reason("missing_trace_opening", "missing trace opening")
                    return False
                values = row_obj.values_ints()
                if len(values) != self.air.num_registers:
                    reason("bad_opening_arity", "bad trace opening arity")
                    return False
                triples.append(("trace", j, values, trace_root, path_obj))
                trace_rows[k] = values
            openings.append((idx, comp_fe, trace_rows))
        if path_sink is not None:
            path_sink.extend(triples)
        elif _verify_paths_batch(triples) is not None:
            reason("trace_path_verify", "trace opening fails authentication")
            return False
        for idx, comp_fe, trace_rows in openings:
            expected = d.composition_value_at(idx, trace_rows, alphas, betas)
            if comp_fe.value >= P or comp_fe.value != expected:
                reason("composition_mismatch", "composition spot check failed")
                return False
        return True

    def verify_batch(self, proofs: list[bytes]) -> list[bool]:
        """Every proof's checks but the Merkle paths run as in
        :meth:`verify`; then ALL proofs' paths go through one amortized
        native batch call (grouped by path length and leaf arity).  If any
        path fails, the proofs still standing are verified one by one, so
        each result stays exact (stark_tpu/stark.py:703-730)."""
        results, all_triples = [], []
        for proof in proofs:
            sink: list = []
            ok = self.verify(proof, path_sink=sink)
            if ok:
                all_triples.extend(sink)
            results.append(ok)
        if _verify_paths_batch(all_triples) is None:
            return results
        return [
            self.verify(proof) if ok else False
            for proof, ok in zip(proofs, results)
        ]
