"""ctypes bindings for the native host engine (hash.c).

The C source is the JAX package's host engine, copied so that this package
never imports ``stark_tpu`` (which imports jax).  It is compiled with ``cc``
into ``stark_tpu_torch/_build/`` at first use (utils/build.py) and serves
the host control plane: the Fiat-Shamir hash, index sampling, the narrow
Merkle levels, the verifier's path checks and the MDS witness's seed walk.  The numpy engine in
hashfn.py is the cross-check the tests hold it against.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from stark_tpu_torch.utils.build import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hash.c")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_u64 = ctypes.c_uint64
_u32p = ctypes.POINTER(ctypes.c_uint32)

_SIGNATURES = {
    "stark_hash": ([_u8p, _u64, _u8p], None),
    "stark_sample_indices": ([_u8p, _u64, _u64, _u64, _u64p], ctypes.c_int64),
    "stark_hash_u64s": ([_u64p, _u64, _u8p], None),
    "stark_merkle_levels": ([_u8p, _u64, _u8p], None),
    "stark_merkle_verify": ([_u8p, _u64, _u8p, _u64, _u8p], ctypes.c_int),
    "stark_merkle_verify_batch": (
        [_u64p, _u64, _u64p, _u8p, _u64, _u8p, _u64],
        ctypes.c_int64,
    ),
    "stark_mds_seed_walk": ([_u32p, _u32p, _u32p, _u64, _u64, _u64, _u32p], None),
}


@functools.cache
def _lib() -> ctypes.CDLL:
    path = build_library(
        "stark_host", [_SRC], [], ["cc", "-O3", "-shared", "-fPIC"]
    )
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def _u8(b: bytes):
    return ctypes.cast(
        ctypes.create_string_buffer(b, len(b)), _u8p
    )


def hash_bytes(data: bytes) -> bytes:
    out = (ctypes.c_uint8 * 32)()
    _lib().stark_hash(_u8(data), len(data), out)
    return bytes(out)


def sample_indices(
    seed: bytes, size: int, reduced_size: int, number: int
) -> list[int]:
    out = (ctypes.c_uint64 * number)()
    rc = _lib().stark_sample_indices(_u8(seed), size, reduced_size, number, out)
    if rc < 0:
        raise AssertionError(
            "cannot sample more indices than available in last codeword; "
            f"requested: {number}, available: {reduced_size}"
        )
    return list(out)


def hash_u64s(values) -> np.ndarray:
    """(n,) u64 values -> (n, 32) u8 leaf digests."""
    vals = np.ascontiguousarray(values, dtype=np.uint64)
    out = np.empty((len(vals), 32), dtype=np.uint8)
    _lib().stark_hash_u64s(
        vals.ctypes.data_as(_u64p), len(vals), out.ctypes.data_as(_u8p)
    )
    return out


def merkle_levels(leaf_digests) -> list[np.ndarray]:
    """(w, 32) u8 leaf digests -> list of (w_l, 32) u8 levels, leaf first."""
    leaves = np.ascontiguousarray(leaf_digests, dtype=np.uint8)
    w = leaves.shape[0]
    flat = np.empty((2 * w - 1, 32), dtype=np.uint8)
    _lib().stark_merkle_levels(
        leaves.ctypes.data_as(_u8p), w, flat.ctypes.data_as(_u8p)
    )
    levels = []
    off = 0
    while w >= 1:
        levels.append(flat[off : off + w])
        off += w
        if w == 1:
            break
        w //= 2
    return levels


def merkle_verify(leaf: bytes, index: int, path: list[bytes], root: bytes) -> bool:
    return bool(
        _lib().stark_merkle_verify(
            _u8(leaf), index, _u8(b"".join(path)), len(path), _u8(root)
        )
    )


def merkle_verify_batch(
    leaf_rows, indices, paths_flat: bytes, path_len: int, roots_flat: bytes
) -> int:
    """k same-length paths verified in one call.  ``leaf_rows``: (k, c)
    raw u64 wire values (leaf = Hash::from_field_elements(row));
    ``paths_flat``: k*path_len*32 bytes; ``roots_flat``: k*32 bytes.
    Returns -1 if all verify, -2 if the row arity is unsupported (caller
    must fall back), else the first failing position."""
    vals = np.ascontiguousarray(leaf_rows, dtype=np.uint64)
    if vals.ndim == 1:
        vals = vals[:, None]
    idxs = np.ascontiguousarray(indices, dtype=np.uint64)
    k, c = vals.shape
    return int(
        _lib().stark_merkle_verify_batch(
            vals.ctypes.data_as(_u64p),
            c,
            idxs.ctypes.data_as(_u64p),
            _u8(paths_flat),
            path_len,
            _u8(roots_flat),
            k,
        )
    )


def mds_seed_walk(m, rc, s0, nb: int, block: int, p: int) -> np.ndarray:
    """Walk the width-8 quadratic chain s' = (M s)^2 + rc mod p for
    nb*block steps from ``s0`` and return the (nb, 8) uint32 block-start
    states; the card re-expands the blocks in parallel
    (models/examples.mds_square_trace_cols_device)."""
    m = np.ascontiguousarray(m, dtype=np.uint32)
    rc = np.ascontiguousarray(rc, dtype=np.uint32)
    s0 = np.ascontiguousarray(s0, dtype=np.uint32)
    assert m.shape == (8, 8) and rc.shape == (8,) and s0.shape == (8,)
    out = np.empty((nb, 8), dtype=np.uint32)
    _lib().stark_mds_seed_walk(
        m.ctypes.data_as(_u32p),
        rc.ctypes.data_as(_u32p),
        s0.ctypes.data_as(_u32p),
        nb,
        block,
        p,
        out.ctypes.data_as(_u32p),
    )
    return out
