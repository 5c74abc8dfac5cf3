"""STARK composer: AIR -> composition polynomial -> FRI.

Counterpart of stark_tpu/stark.py, classic flow: host Fiat-Shamir
challenges, device data path.  Protocol (prover):

 1. Interpolate each trace register over the trace domain {w^i} (iNTT)
    and low-degree-extend onto the evaluation coset {g * W^j},
    |coset| = T * blowup (NTT) — kernels K1-K3.             [device]
 2. Merkle-commit the trace LDE (row hashes); absorb the root.
 3. Draw two Fiat-Shamir challenges (alpha_k, beta_k) per constraint; the
    transcript absorbs each challenge's 8 LE bytes (challenge() is pure).
 4. Evaluate transition constraints pointwise on the coset, divide by the
    transition zerofier Z(x) = (x^T - 1) / prod_{tail}(x - w^i), add
    boundary quotients, degree-adjust each term with alpha_k * x^shift +
    beta_k, and sum: the composition codeword.              [device]
 5. FRI-prove the composition codeword (fri.py; folds are kernel K4).
 6. Open the trace Merkle tree at every FRI round-0 query point and its
    frame-shifted companions.

The verifier mirrors 2-5 from the proof stream on the host, then checks at
each FRI query point that the composition value FRI recorded equals the one
recomputed from the opened trace values.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stark_tpu_torch.convert import field_to_numpy, witness_to_device
from stark_tpu_torch.field import FiniteField
from stark_tpu_torch.fri import Fri, _verify_paths_batch
from stark_tpu_torch.merkle import MerkleTree
from stark_tpu_torch.models.air import Air, BatchOps, BoundaryConstraint, ScalarOps
from stark_tpu_torch.ops import fieldops as F
from stark_tpu_torch.ops import hash_batch as HB
from stark_tpu_torch.ops import ntt as NTT
from stark_tpu_torch.ops.fieldops import GENERATOR, P, primitive_nth_root
from stark_tpu_torch.stream import FieldElements, MerklePath, MerkleRoot, ProofStream
from stark_tpu_torch.transcript import FiatShamir
from stark_tpu_torch.utils.profiling import NULL_TIMER, reason


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

    def composition_value_at(
        self, idx: int, trace_rows: dict[int, list[int]], alphas, betas
    ) -> int:
        """Recompute the composition codeword value at coset index idx from
        opened trace rows (trace_rows[k] = registers at index idx+k*blowup)."""
        x = (self.offset * pow(self.Omega, idx, P)) % P
        frame = {k: [v % P for v in trace_rows[k]] for k in self.air.frame_offsets}
        cons = self.air.transition_constraints(frame, ScalarOps)
        znum = (pow(x, self.T, P) - 1) % P
        assert znum != 0
        zinv = pow(znum, P - 2, P)
        exc = 1
        for w in self.excluded:
            exc = (exc * (x - w)) % P
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


class StarkProver:
    """Proves on ``device`` (default ``cuda``; the CPU runs every kernel's
    plain version).  Deterministic: no randomness anywhere."""

    def __init__(self, air: Air, cfg: StarkConfig, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StarkProver: no CUDA device (pass device='cpu' for the "
                "plain torch path)"
            )
        self.air = air
        self.cfg = cfg
        self.device = device
        self.dom = d = _Domain(cfg, air)
        self.fri = d.fri()
        # Trace-independent (N,) domain tables, int64 on the device.
        self.x_dom = F.powers(d.Omega, d.N, scale=d.offset, device=device)
        rho = pow(d.Omega, d.T, P)                                  # order = blowup
        zinv_cycle = [
            F.host_inv(pow(d.offset, d.T, P) * pow(rho, j, P) - 1)
            for j in range(cfg.blowup)
        ]
        self.zinv = torch.tensor(zinv_cycle, dtype=torch.int64, device=device).repeat(d.T)
        excl = torch.ones(d.N, dtype=torch.int64, device=device)
        for w in d.excluded:
            excl = F.mulmod(excl, F.submod(self.x_dom, w))
        self.excl = excl
        self.xshift_t = F.powers(
            pow(d.Omega, d.transition_shift, P), d.N,
            scale=pow(d.offset, d.transition_shift, P), device=device,
        )
        self.xshift_b = F.powers(
            pow(d.Omega, d.boundary_shift, P), d.N,
            scale=pow(d.offset, d.boundary_shift, P), device=device,
        )
        # Boundary-quotient denominators 1/(x - w^row), trace-independent.
        self.dinv = [
            F.invmod(F.submod(self.x_dom, pow(d.omega, bc.row, P)))
            for bc in d.boundary
        ]

    def _compose(self, trace_lde: torch.Tensor, alphas, betas) -> torch.Tensor:
        """(c, N) int32 LDE -> (N,) int32 composition codeword (elementwise
        int64 torch ops; stark_tpu/stark.py:_compose_impl)."""
        d = self.dom
        lde = trace_lde.long()
        # ONE roll of the whole (c, N) tensor per frame offset.
        frame = {
            k: list(lde if k == 0 else torch.roll(lde, -k * self.cfg.blowup, -1))
            for k in self.air.frame_offsets
        }
        cons = self.air.transition_constraints(frame, BatchOps)
        total = torch.zeros(d.N, dtype=torch.int64, device=self.device)
        ci = 0
        for c in cons:
            q = F.mulmod(F.mulmod(c, self.excl), self.zinv)
            w = F.addmod(F.mulmod(self.xshift_t, alphas[ci]), betas[ci])
            total = F.addmod(total, F.mulmod(w, q))
            ci += 1
        for bi, bc in enumerate(d.boundary):
            num = F.submod(frame[0][bc.register], bc.value % P)
            q = F.mulmod(num, self.dinv[bi])
            w = F.addmod(F.mulmod(self.xshift_b, alphas[ci]), betas[ci])
            total = F.addmod(total, F.mulmod(w, q))
            ci += 1
        return total.to(torch.int32)

    def prove(self, trace_rows, timer=NULL_TIMER) -> bytes:
        """``trace_rows``: (T, c) rows (list or ndarray, reference
        trace.rs:29-34 ingestion semantics)."""
        d, cfg = self.dom, self.cfg
        field = FiniteField()
        fs = FiatShamir()
        stream = ProofStream()

        # 1. trace columns -> coefficients -> LDE on the coset  [device]
        with timer.phase("lde"):
            assert len(trace_rows) == d.T
            cols = witness_to_device(trace_rows, self.device)
            assert tuple(cols.shape) == (self.air.num_registers, d.T)
            trace_lde = NTT.lde(NTT.intt(cols), cfg.blowup, d.offset)  # (c, N)

        # 2. commit the trace (row digests on the device, narrow top on host)
        with timer.phase("trace_commit"):
            trace_tree = MerkleTree.from_leaf_digests(HB.row_hash(trace_lde))
            stream.push(MerkleRoot(trace_tree.root))
            fs.absorb(trace_tree.root.data)

        # 3. constraint-combination challenges (host transcript)
        with timer.phase("challenges"):
            n_terms = d.num_transition + len(d.boundary)
            alphas, betas = _draw_constraint_challenges(fs, field, n_terms)

        # 4. composition codeword  [device]
        with timer.phase("compose"):
            composition = self._compose(trace_lde, alphas, betas)

        # 5. FRI
        top_indices = self.fri.prove(composition, fs, stream, timer=timer)

        # 6. trace openings at the FRI round-0 query points + frame shifts
        with timer.phase("trace_open"):
            half = d.N // 2
            query_points = []
            for idx in top_indices:
                a = idx % half
                query_points.extend([a, a + half])
            cols_idx = [
                (qp + k * cfg.blowup) % d.N
                for qp in query_points
                for k in self.air.frame_offsets
            ]
            vals = field_to_numpy(
                trace_lde[:, torch.tensor(cols_idx, device=self.device)]
            )
            paths = trace_tree.open_batch(cols_idx)
            for t in range(len(cols_idx)):
                stream.push(FieldElements(tuple(int(v) for v in vals[:, t])))
                stream.push(MerklePath(tuple(paths[t])))

        return stream.serialize()


class StarkVerifier:
    """Host-only verification (numpy, the native engine, a small iNTT)."""

    def __init__(self, air: Air, cfg: StarkConfig):
        self.air = air
        self.cfg = cfg
        self.dom = _Domain(cfg, air)
        self.fri = self.dom.fri()

    def verify(self, proof: bytes) -> bool:
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
        if not self.fri.verify(stream, fs, polynomial_values):
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
        if _verify_paths_batch(triples) is not None:
            reason("trace_path_verify", "trace opening fails authentication")
            return False
        for idx, comp_fe, trace_rows in openings:
            expected = d.composition_value_at(idx, trace_rows, alphas, betas)
            if comp_fe.value >= P or comp_fe.value != expected:
                reason("composition_mismatch", "composition spot check failed")
                return False
        return True
