"""Meta-path graph construction (numpy/scipy copy of han_tpu/graph/build.py).

Meta-path composition runs host-side in scipy (sparse × sparse):

    PAP  = binarize(P→A  @  A→P)        (papers sharing an author)
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import scipy.sparse as sp

from han_tpu_torch.graph.bcsr import DEF_BM, DEF_BN, BCSRGraph, bcsr_from_scipy
from han_tpu_torch.graph.containers import (CSRGraph, DenseGraph,
                                            csr_from_scipy, dense_from_numpy)


def compose_metapath(incidences: Sequence[sp.spmatrix], *,
                     binarize: bool = True) -> sp.csr_matrix:
    """``M0 @ M1 @ ... @ Mk`` (square for a valid meta-path), binarized by
    default — the reference treats meta-path adjacency as unweighted."""
    out = incidences[0].tocsr().astype(np.float32)
    for m in incidences[1:]:
        out = out @ m.tocsr().astype(np.float32)
    if out.shape[0] != out.shape[1]:
        raise ValueError(f"meta-path did not close: result shape {out.shape}")
    if binarize:
        out.data = np.ones_like(out.data)
    out.setdiag(out.diagonal())  # keep explicit diagonal if present
    out.eliminate_zeros()
    return out.tocsr()


def symmetric_metapath(incidence: sp.spmatrix, *,
                       binarize: bool = True) -> sp.csr_matrix:
    """M @ M.T — the common 2-hop meta-path (PAP, MAM, APA, ...)."""
    return compose_metapath([incidence, incidence.T.tocsr()], binarize=binarize)


def with_self_loops(adj: sp.spmatrix) -> sp.csr_matrix:
    """Ensure every node attends to itself; output is binarized.

    Built directly on the index arrays (drop any existing diagonal, then
    splice one self-loop per row): scipy's ``A + I`` re-canonicalizes the
    whole matrix, which takes minutes at the 100M-edge scale.
    """
    a = adj.tocsr()
    n = a.shape[0]
    indptr = a.indptr.astype(np.int64)
    indices = a.indices.astype(np.int32)
    # dtypes are matched on every ufunc: mixed-dtype cumsum/repeat paths
    # are far slower than the monomorphic ones
    counts = np.diff(indptr).astype(np.int64)
    row_of = np.repeat(np.arange(n, dtype=np.int64), counts).astype(np.int32)
    keep = indices != row_of
    kept = indices[keep]
    cum = np.concatenate([
        np.zeros(1, np.int64), keep.astype(np.int64).cumsum()])
    new_indptr = cum[indptr] + np.arange(n + 1, dtype=np.int64)
    new_indices = np.empty(kept.shape[0] + n, np.int32)
    new_indices[new_indptr[:-1]] = np.arange(n, dtype=np.int32)
    fill = np.ones(new_indices.shape[0], bool)
    fill[new_indptr[:-1]] = False
    new_indices[fill] = kept
    data = np.ones(new_indices.shape[0], np.float32)
    out = sp.csr_matrix((data, new_indices, new_indptr), shape=(n, n))
    out.sort_indices()
    return out


def metapath_to_csr(adj: sp.spmatrix, *, add_self_loops: bool = True,
                    edge_pad_to: int = 128) -> CSRGraph:
    a = with_self_loops(adj) if add_self_loops else adj.tocsr()
    return csr_from_scipy(a, edge_pad_to=edge_pad_to)


def metapath_to_dense(adj: sp.spmatrix | np.ndarray, *,
                      add_self_loops: bool = True, nhood: int = 1) -> DenseGraph:
    a = adj.toarray() if sp.issparse(adj) else np.asarray(adj)
    return dense_from_numpy(a, add_self_loops=add_self_loops, nhood=nhood)


def metapath_to_bcsr(adj: sp.spmatrix, *, add_self_loops: bool = True,
                     bm: int | None = None, bn: int | None = None) -> BCSRGraph:
    """Block-sparse tile-list container (graph/bcsr.py), the flash-kernel
    input; stores only occupied tiles, never a dense N² array."""
    a = with_self_loops(adj) if add_self_loops else adj.tocsr()
    return bcsr_from_scipy(a, bm=bm or DEF_BM, bn=bn or DEF_BN)


def normalize_adj(adj: sp.spmatrix) -> sp.csr_matrix:
    """Symmetric normalization D^{-1/2} A D^{-1/2} (reference
    ``normalize_adj``, utils/process.py:144-151); zero-degree rows stay
    zero. For GCN-style propagation add self-loops first
    (``preprocess_adj``, utils/process.py:154-157 = normalize_adj(A + I))."""
    a = adj.tocsr().astype(np.float64)
    deg = np.asarray(a.sum(axis=1)).ravel()
    inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1e-12)), 0.0)
    d = sp.diags(inv_sqrt)
    return (d @ a @ d).tocsr().astype(np.float32)


def preprocess_adj(adj: sp.spmatrix) -> sp.csr_matrix:
    """normalize_adj(A + I) — reference utils/process.py:154-157."""
    return normalize_adj(with_self_loops(adj))


def row_normalize_features(x: np.ndarray) -> np.ndarray:
    """Row-normalize a feature matrix (reference preprocess_features,
    utils/process.py:134-141); zero rows stay zero."""
    x = np.asarray(x, dtype=np.float32)
    s = x.sum(axis=1, keepdims=True)
    inv = np.where(s > 0, 1.0 / np.maximum(s, 1e-12), 0.0)
    return x * inv
