"""ctypes bindings for the native graph runtime (copy of han_tpu/native/
__init__.py; graphcore.cpp is a byte-for-byte copy of han_tpu's, held so by
tests/test_torch_sampled.py).

Builds the library with ``g++ -O3`` on first use into ``build/native/``
beside the package (the name carries a hash of the source and flags, so an
edited source is rebuilt). Every entry point has a scipy/numpy fallback so
the port works without a toolchain; ``available()`` says whether the C++
library is in use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "graphcore.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_LIB = None
_TRIED = False


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libgraphcore-{digest.hexdigest()[:16]}.so"


def _build(so: pathlib.Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return True


def _lib():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    i64, i32p, i64p, u64 = (ctypes.c_int64, np.ctypeslib.ndpointer(np.int32),
                            np.ctypeslib.ndpointer(np.int64), ctypes.c_uint64)
    lib.csr_from_coo.restype = i64
    lib.csr_from_coo.argtypes = [i64, i64, i32p, i32p, i64p, i32p]
    lib.spgemm_binary.restype = i64
    lib.spgemm_binary.argtypes = [i64, i64, i64p, i32p, i64p, i32p,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.sample_neighbors.restype = None
    lib.sample_neighbors.argtypes = [i64, i64p, i32p, i64, u64, i32p]
    lib.sample_block.restype = i64
    lib.sample_block.argtypes = [i64, i64p, i32p, i64, i32p, i64, i64, i64,
                                 u64, i32p, i32p]
    lib.connected_components.restype = i64
    lib.connected_components.argtypes = [i64, i64p, i32p, i64p]
    _LIB = lib
    return lib


def available() -> bool:
    return _lib() is not None


def csr_from_coo(n: int, rows: np.ndarray, cols: np.ndarray):
    """COO → deduplicated CSR (row_ptr int64[n+1], col_idx int32[nnz])."""
    lib = _lib()
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    if lib is None:
        import scipy.sparse as sp

        m = sp.coo_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)),
                          shape=(n, n)).tocsr()
        m.sum_duplicates()
        return m.indptr.astype(np.int64), m.indices.astype(np.int32)
    row_ptr = np.empty(n + 1, np.int64)
    col_idx = np.empty(max(rows.shape[0], 1), np.int32)
    nnz = lib.csr_from_coo(n, rows.shape[0], rows, cols, row_ptr, col_idx)
    return row_ptr, col_idx[:nnz].copy()


def spgemm_binary(a_row_ptr, a_col_idx, b_row_ptr, b_col_idx, n: int, p: int):
    """binarize(A @ B) for unweighted CSR graphs → (row_ptr, col_idx)."""
    lib = _lib()
    a_rp = np.ascontiguousarray(a_row_ptr, np.int64)
    a_ci = np.ascontiguousarray(a_col_idx, np.int32)
    b_rp = np.ascontiguousarray(b_row_ptr, np.int64)
    b_ci = np.ascontiguousarray(b_col_idx, np.int32)
    if lib is None:
        import scipy.sparse as sp

        a = sp.csr_matrix((np.ones(a_ci.shape[0], np.float32), a_ci,
                           a_rp.astype(np.int64)), shape=(n, b_rp.shape[0] - 1))
        b = sp.csr_matrix((np.ones(b_ci.shape[0], np.float32), b_ci,
                           b_rp.astype(np.int64)), shape=(b_rp.shape[0] - 1, p))
        c = (a @ b).tocsr()
        c.sum_duplicates()
        return c.indptr.astype(np.int64), c.indices.astype(np.int32)
    nnz = lib.spgemm_binary(n, p, a_rp, a_ci, b_rp, b_ci, None, None)
    row_ptr = np.empty(n + 1, np.int64)
    col_idx = np.empty(max(nnz, 1), np.int32)
    lib.spgemm_binary(n, p, a_rp, a_ci, b_rp, b_ci,
                      row_ptr.ctypes.data_as(ctypes.c_void_p),
                      col_idx.ctypes.data_as(ctypes.c_void_p))
    return row_ptr, col_idx[:nnz]


def sample_neighbors(row_ptr, col_idx, fanout: int, seed: int = 0) -> np.ndarray:
    """Uniform per-row neighbor sample without replacement → int32[n, fanout]
    padded with sentinel n (deterministic in seed)."""
    lib = _lib()
    rp = np.ascontiguousarray(row_ptr, np.int64)
    ci = np.ascontiguousarray(col_idx, np.int32)
    n = rp.shape[0] - 1
    if lib is None:
        rng = np.random.default_rng(seed)
        out = np.full((n, fanout), n, np.int32)
        for i in range(n):
            nbrs = ci[rp[i]:rp[i + 1]]
            if nbrs.shape[0] <= fanout:
                out[i, :nbrs.shape[0]] = nbrs
            else:
                out[i] = np.sort(rng.choice(nbrs, fanout, replace=False))
        return out
    out = np.empty((n, fanout), np.int32)
    lib.sample_neighbors(n, rp, ci, fanout, seed, out.reshape(-1))
    return out


def sample_block(row_ptr, col_idx, seeds, *, fanout: int, hops: int,
                 block_size: int, seed: int = 0):
    """L-hop bounded-fanout block sample around ``seeds`` →
    (nodes int32[block_size] -1-padded, nbr int32[block_size, fanout]
    local-index padded with block_size, n_real). Returns None when the
    native library is unavailable (caller falls back to Python)."""
    lib = _lib()
    if lib is None:
        return None
    rp = np.ascontiguousarray(row_ptr, np.int64)
    ci = np.ascontiguousarray(col_idx, np.int32)
    sd = np.ascontiguousarray(seeds, np.int32)
    nodes = np.empty(block_size, np.int32)
    nbr = np.empty((block_size, fanout), np.int32)
    n_real = lib.sample_block(rp.shape[0] - 1, rp, ci, sd.shape[0], sd,
                              fanout, hops, block_size, np.uint64(seed),
                              nodes, nbr.reshape(-1))
    return nodes, nbr, int(n_real)


def connected_components(row_ptr, col_idx) -> tuple[int, np.ndarray]:
    lib = _lib()
    rp = np.ascontiguousarray(row_ptr, np.int64)
    ci = np.ascontiguousarray(col_idx, np.int32)
    n = rp.shape[0] - 1
    if lib is None:
        import scipy.sparse as sp
        from scipy.sparse.csgraph import connected_components as cc

        m = sp.csr_matrix((np.ones(ci.shape[0], np.float32), ci, rp), shape=(n, n))
        k, comp = cc(m, directed=False)
        return int(k), comp.astype(np.int64)
    comp = np.empty(n, np.int64)
    k = lib.connected_components(n, rp, ci, comp)
    return int(k), comp
