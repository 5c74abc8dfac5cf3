"""A plain STARK prover: the proof bytes a statement must get, worked out
with nothing but torch's elementwise operations and Python integers.

It follows the protocol of the stark-rs reference (hash.rs, merkle.rs,
fiat_shamir.rs, fri.rs, stream.rs) and the STARK layer on top of it, step
by step and from first principles: a radix-2 NTT for the interpolation
and the low-degree extension, the byte-oriented hash over many messages at
once (one row of bytes a message, as a (bytes, messages) tensor), whole
Merkle levels, the transcript hashed on the host, the composition
codeword, the FRI folds, the index sampling, the openings, and the wire
format.  It imports nothing of the measured program: it is the yardstick
the benchmark holds every served proof against.  It runs on whatever
device its inputs lie on; on a card its largest temporaries are a few
(32, N) int32 tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

P = 998244353
GENERATOR = 3
TWO_ADICITY = 23

# -- the field ---------------------------------------------------------------------


def root_of_unity(n: int) -> int:
    """The primitive n-th root g^((p-1)/n), n a power of two <= 2^23."""
    if n & (n - 1) or n > 1 << TWO_ADICITY:
        raise ValueError(f"no {n}-th root of unity of this field is used")
    return pow(GENERATOR, (P - 1) // n, P)


def powers(base: int, n: int, device, scale: int = 1) -> torch.Tensor:
    """(n,) int64: scale * base^i mod p, by doubling."""
    out = torch.tensor([scale % P], dtype=torch.int64, device=device)
    step = base % P
    while out.numel() < n:
        out = torch.cat([out, out * step % P])
        step = step * step % P
    return out[:n]


def tensor_pow(x: torch.Tensor, e: int) -> torch.Tensor:
    """x^e mod p elementwise (square and multiply)."""
    out = torch.ones_like(x)
    base = x.clone()
    while e:
        if e & 1:
            out = out * base % P
        e >>= 1
        if e:
            base = base * base % P
    return out


def tensor_inv(x: torch.Tensor) -> torch.Tensor:
    """x^-1 mod p elementwise (Fermat); x has no zero."""
    return tensor_pow(x, P - 2)


# -- the NTT ---------------------------------------------------------------------


def _bit_reverse(n: int, device) -> torch.Tensor:
    lg = n.bit_length() - 1
    i = torch.arange(n, dtype=torch.int64, device=device)
    r = torch.zeros_like(i)
    for b in range(lg):
        r |= ((i >> b) & 1) << (lg - 1 - b)
    return r


def ntt(a: torch.Tensor, root: int) -> torch.Tensor:
    """(rows, n) int64 coefficients -> their values at root^j, j < n (root a
    primitive n-th root): iterative radix-2, decimation in time."""
    rows, n = a.shape
    a = a[:, _bit_reverse(n, a.device)]
    h = 1
    while h < n:
        tw = powers(pow(root, n // (2 * h), P), h, a.device)
        a = a.reshape(rows, n // (2 * h), 2, h)
        u, v = a[:, :, 0, :], a[:, :, 1, :] * tw % P
        a = torch.stack([(u + v) % P, (u - v) % P], dim=2)
        h *= 2
    return a.reshape(rows, n)


def intt(a: torch.Tensor, root: int) -> torch.Tensor:
    n = a.shape[1]
    return ntt(a, pow(root, P - 2, P)) * pow(n, P - 2, P) % P


# -- the hash (hash.rs) -------------------------------------------------------------

_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53)
_ROUND_CONSTANTS = (
    0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80,
    0x1B, 0x36, 0x6C, 0xD8, 0xAB, 0x4D, 0x9A, 0x2F,
    0x5E, 0xBC, 0x63, 0xC6, 0x97, 0x35, 0x6A, 0xD4,
    0xB3, 0x7D, 0xFA, 0xEF, 0xC5, 0x91, 0x39, 0x72,
)


def _rotl8(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x << n) | (x >> (8 - n))) & 0xFF


def _mix(s: torch.Tensor) -> torch.Tensor:
    """One mix round of (32, m) int32 states (hash.rs:59-86): the sbox, the
    XOR groups of four, the in-place neighbour diffusion (a prefix sum), the
    round constants."""
    s = _rotl8(s * 251 & 0xFF, 1) ^ 0x63
    t0, t1, t2, t3 = s.reshape(8, 4, -1).unbind(1)
    s = torch.stack([t0 ^ t1 ^ t3, t0 ^ t2 ^ t3, t0 ^ t1 ^ t2, t1 ^ t2 ^ t3], 1).reshape(32, -1)
    d = torch.cat([(s[0] + s[1] + s[31])[None], s[1:31] + s[2:32]])
    new = torch.cumsum(d, 0, dtype=torch.int32)
    last = (s[31] + new[0] + new[30])[None]
    rc = torch.tensor(_ROUND_CONSTANTS, dtype=torch.int32, device=s.device)[:, None]
    return (torch.cat([new, last]) + rc) & 0xFF


def hash_messages(msg: torch.Tensor) -> torch.Tensor:
    """(L, m) int32 bytes, one message of L bytes a column -> (32, m) int32
    digests (hash.rs:7-30)."""
    length, m = msg.shape
    s = torch.tensor([_PRIMES[i % 16] for i in range(32)], dtype=torch.int32,
                     device=msg.device)[:, None].repeat(1, m)
    for start in range(0, length, 32):
        chunk = msg[start:start + 32]
        rows = list(s.unbind(0))
        for i in range(chunk.shape[0]):
            v = _rotl8((rows[i] + chunk[i]) & 0xFF, 3)
            rows[i] = v
            rows[(i + 7) % 32] = rows[(i + 7) % 32] ^ v
        s = _mix(torch.stack(rows))
    for _ in range(8):
        s = _mix(s)
    return s


def hash_bytes(data: bytes) -> bytes:
    """The digest of one message on the host (the transcript's)."""
    msg = torch.tensor(list(data), dtype=torch.int32).reshape(-1, 1)
    return bytes(hash_messages(msg)[:, 0].tolist())


def value_bytes(values: torch.Tensor) -> torch.Tensor:
    """(c, m) field values -> (8 c, m) int32 bytes: each a little-endian u64
    (hash.rs:32-35, Hash::from_field_elements of a row)."""
    c, m = values.shape
    shifts = torch.arange(0, 32, 8, device=values.device)
    low = (values[:, None, :] >> shifts[None, :, None]) & 0xFF          # (c, 4, m)
    out = torch.cat([low, torch.zeros_like(low)], 1)                    # (c, 8, m)
    return out.reshape(8 * c, m).to(torch.int32)


# -- Merkle trees (merkle.rs) -------------------------------------------------------


class Tree:
    """Every level of a tree, each (32, width) int32 digests, leaves first."""

    def __init__(self, leaves: torch.Tensor):
        width = leaves.shape[1]
        if width & (width - 1):
            raise ValueError("a tree's width is a power of two")
        self.levels = [leaves]
        while self.levels[-1].shape[1] > 1:
            lv = self.levels[-1]
            self.levels.append(hash_messages(torch.cat([lv[:, 0::2], lv[:, 1::2]])))

    @classmethod
    def of_rows(cls, values: torch.Tensor) -> "Tree":
        """leaf j: the hash of column j of the (c, m) values."""
        return cls(hash_messages(value_bytes(values)))

    def root(self) -> bytes:
        return bytes(self.levels[-1][:, 0].tolist())

    def paths(self, indices) -> np.ndarray:
        """(k, depth, 32) uint8: the siblings of leaves ``indices``, bottom up."""
        idx = torch.as_tensor(np.asarray(indices, dtype=np.int64))
        sib = [lv[:, ((idx >> l) ^ 1).to(lv.device)].T for l, lv in enumerate(self.levels[:-1])]
        return torch.stack(sib, 1).to(torch.uint8).cpu().numpy()


# -- the transcript and the wire (fiat_shamir.rs, stream.rs) -------------------------


class Transcript:
    def __init__(self):
        self.data = bytearray()

    def absorb(self, data: bytes) -> None:
        self.data.extend(data)

    def challenge(self) -> int:
        """The raw u64 of the first 8 digest bytes of everything absorbed."""
        return int.from_bytes(hash_bytes(bytes(self.data))[:8], "little")


def wire_root(root: bytes) -> bytes:
    return b"\x00" + root


def wire_values(values) -> bytes:
    vals = [int(v) for v in values]
    return b"\x02" + len(vals).to_bytes(8, "little") + b"".join(
        v.to_bytes(8, "little") for v in vals)


def wire_path(sib: np.ndarray) -> bytes:
    return b"\x03" + len(sib).to_bytes(8, "little") + sib.tobytes()


# -- the statement ------------------------------------------------------------------


@dataclass(frozen=True)
class Statement:
    """What a proof is about: an AIR (``air``: a module of
    benchmark/reference/airs), its witness columns, the parameters."""

    air: object
    trace_length: int
    blowup: int = 4
    num_colinearity_tests: int = 16


class Domain:
    """The STARK layer's degree bookkeeping: the zerofier's excluded rows,
    the target degree, each term's degree shift, the FRI's expansion."""

    def __init__(self, st: Statement):
        air, T = st.air, st.trace_length
        self.T, self.N = T, T * st.blowup
        self.omega, self.Omega = root_of_unity(T), root_of_unity(self.N)
        self.offset = GENERATOR
        max_off = max(air.FRAME_OFFSETS)
        self.excluded = [pow(self.omega, i, P) for i in range(T - max_off, T)]
        cdeg = max(air.CONSTRAINT_DEGREE * (T - 1) - (T - max_off), 0)
        h = 1
        while h * T - 1 < cdeg:
            h *= 2
        if st.blowup < 4 * h:
            raise ValueError("the AIR's quotient needs a larger blowup")
        target = h * T - 1
        self.transition_shift = target - cdeg
        self.boundary_shift = target - (T - 2)
        self.expansion = st.blowup // h

    def fri_rounds(self, tests: int) -> int:
        length, rounds = self.N, 0
        while length > self.expansion and 4 * tests < length:
            length //= 2
            rounds += 1
        return rounds


def _sample_indices(seed: bytes, size: int, reduced: int, number: int) -> list[int]:
    """fri.rs:168-213: H(seed || counter LE u32), folded big-endian into a
    u128, mod size; an index whose value mod ``reduced`` was drawn is
    skipped."""
    if number > reduced:
        raise ValueError("more indices than the last codeword holds")
    out, seen, counter = [], set(), 0
    while len(out) < number:
        digest = hash_bytes(seed + counter.to_bytes(4, "little"))
        index = int.from_bytes(digest[16:], "big") % size
        counter += 1
        if index % reduced not in seen:
            seen.add(index % reduced)
            out.append(index)
    return out


def composition(st: Statement, dom: Domain, lde: torch.Tensor, alphas, betas) -> torch.Tensor:
    """(c, N) int64 trace LDE -> the (N,) composition codeword: every
    transition constraint times E(x) / (x^T - 1), every boundary quotient
    (t(x) - v) / (x - w^row), each weighted alpha x^shift + beta, summed."""
    air, N, T = st.air, dom.N, dom.T
    x = powers(dom.Omega, N, lde.device, scale=dom.offset)
    frame = {k: torch.roll(lde, -k * st.blowup, dims=1) for k in air.FRAME_OFFSETS}
    zinv = tensor_inv((tensor_pow(x, T) - 1) % P)
    exc = torch.ones_like(x)
    for w in dom.excluded:
        exc = exc * ((x - w) % P) % P
    xs_t, xs_b = tensor_pow(x, dom.transition_shift), tensor_pow(x, dom.boundary_shift)
    total = torch.zeros_like(x)
    terms = [(c * exc % P * zinv % P, xs_t) for c in air.transition(frame)]
    denominators: dict[int, torch.Tensor] = {}
    for row, register, value in air.boundary(T):
        if row not in denominators:
            denominators[row] = tensor_inv((x - pow(dom.omega, row, P)) % P)
        terms.append(((frame[0][register] - value) % P * denominators[row] % P, xs_b))
    for (q, xs), a, b in zip(terms, alphas, betas):
        total = (total + (a * xs + b) % P * q) % P
    return total


def prove(st: Statement, columns: torch.Tensor) -> bytes:
    """The proof bytes of the (c, T) witness ``columns`` (any integer dtype,
    values in [0, p)), on the columns' device."""
    air, dom = st.air, Domain(st)
    T, N, k = dom.T, dom.N, st.num_colinearity_tests
    device = columns.device
    cols = columns.to(torch.int64) % P
    if tuple(cols.shape) != (air.REGISTERS, T):
        raise ValueError(f"the witness is {tuple(cols.shape)}, the AIR needs {(air.REGISTERS, T)}")
    out, fs = bytearray(), Transcript()

    # 1. interpolate, scale by the coset offset, extend: the trace LDE
    coeffs = intt(cols, dom.omega) * powers(dom.offset, T, device) % P
    lde = ntt(torch.cat([coeffs, torch.zeros(air.REGISTERS, N - T, dtype=torch.int64,
                                            device=device)], 1), dom.Omega)
    del coeffs
    # 2. commit the rows
    trace_tree = Tree.of_rows(lde)
    out += wire_root(trace_tree.root())
    fs.absorb(trace_tree.root())
    # 3. two challenges a term, each absorbed
    n_terms = air.TRANSITIONS + len(air.boundary(T))
    alphas, betas = [], []
    for _ in range(n_terms):
        for got in (alphas, betas):
            raw = fs.challenge()
            fs.absorb(raw.to_bytes(8, "little"))
            got.append(raw % P)
    # 4. the composition codeword
    codeword = composition(st, dom, lde, alphas, betas)

    # 5. FRI: commit, fold with each round's challenge
    rounds = dom.fri_rounds(k)
    codewords, trees = [], []
    omega, offset = dom.Omega, dom.offset
    inv2 = pow(2, P - 2, P)
    for r in range(rounds):
        tree = Tree(hash_messages(value_bytes(codeword[None])))
        out += wire_root(tree.root())
        fs.absorb(tree.root())
        codewords.append(codeword)
        trees.append(tree)
        if r == rounds - 1:
            break
        alpha = fs.challenge() % P
        half = codeword.numel() // 2
        inv_x = powers(pow(omega, P - 2, P), half, device, scale=pow(offset, P - 2, P))
        a, b = codeword[:half], codeword[half:]
        codeword = ((a + b) + alpha * inv_x % P * ((a - b) % P)) % P * inv2 % P
        omega, offset = omega * omega % P, offset * offset % P
    out += wire_values(codewords[-1].tolist())

    # 6. the query indices, then each round's colinearity triples and paths
    size = codewords[1].numel() if len(codewords) > 1 else codewords[0].numel()
    seed = hash_bytes(fs.challenge().to_bytes(8, "little"))
    indices = _sample_indices(seed, size, codewords[-1].numel(), k)
    top = list(indices)
    half0 = N // 2
    a0 = np.asarray([i % half0 for i in top], dtype=np.int64)
    points = np.stack([a0, a0 + half0], 1).reshape(-1)
    for r in range(len(codewords) - 1):
        cur, nxt = codewords[r], codewords[r + 1]
        half = cur.numel() // 2
        a = np.asarray([i % half for i in top], dtype=np.int64)
        b = a + half
        ia = torch.as_tensor(a, device=device)
        va, vb, vc = (cur[ia].tolist(), cur[ia + half].tolist(), nxt[ia].tolist())
        for s in range(k):
            out += wire_values([va[s], vb[s], vc[s]])
        pa, pb, pc = trees[r].paths(a), trees[r].paths(b), trees[r + 1].paths(a)
        for s in range(k):
            out += wire_path(pa[s]) + wire_path(pb[s]) + wire_path(pc[s])

    # 7. the trace openings at every round-0 point (a, a + N/2) and its frame rows
    rows = (points[:, None] + np.asarray(air.FRAME_OFFSETS)[None, :] * st.blowup) % N
    rows = rows.reshape(-1)
    vals = lde[:, torch.as_tensor(rows, device=device)].T.tolist()
    paths = trace_tree.paths(rows)
    for j in range(len(rows)):
        out += wire_values(vals[j]) + wire_path(paths[j])
    return bytes(out)
