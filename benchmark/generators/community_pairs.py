"""A heterogeneous graph with a stated number of edges in each meta-path:
nodes in planted communities (contiguous in node order), each meta-path an
undirected graph without self-loops whose pairs are drawn without
replacement to the exact count, a pair inside a community weighted so that
a sparse meta-path keeps about ``homophily`` of its pairs inside; a dense
meta-path fills up past that. Features, labels and the class-balanced
split are those of the program's ``planted_hetero`` (``han_tpu_torch/
graph/synthetic.py``), drawn after the edges from the same generator.

``edges_with_self_loops`` is each meta-path's edge count as a published
dataset states it (its adjacency with every node's self-loop): it has to
be n plus an even number, since the graph is undirected.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from benchmark.data import Inputs


def metapath_pairs(rng, comm: np.ndarray, n_pairs: int, homophily: float) -> sp.csr_matrix:
    """A symmetric 0/1 CSR (n, n) with ``2 · n_pairs`` stored entries and an
    empty diagonal: ``n_pairs`` of the n·(n − 1)/2 node pairs, drawn without
    replacement with weight w inside a community and 1 across (the
    exponential race: the smallest Exp(1) / w keys)."""
    n = comm.shape[0]
    iu, ju = np.triu_indices(n, k=1)
    same = comm[iu] == comm[ju]
    n_in = int(same.sum())
    if not 0 <= n_pairs <= iu.shape[0]:
        raise ValueError(f"{n_pairs} pairs of {n} nodes")
    w = homophily / (1.0 - homophily) * (iu.shape[0] - n_in) / max(n_in, 1)
    keys = rng.exponential(size=iu.shape[0]) / np.where(same, w, 1.0)
    pick = np.argpartition(keys, n_pairs - 1)[:n_pairs] if n_pairs else np.zeros(0, np.int64)
    i, j = iu[pick], ju[pick]
    a = sp.coo_matrix((np.ones(2 * n_pairs, np.float32),
                       (np.concatenate([i, j]), np.concatenate([j, i]))), shape=(n, n))
    return a.tocsr()


def community_pairs(*, n_nodes, n_feats, n_classes, edges_with_self_loops, homophily,
                    feat_signal=1.5, train_per_class, n_val, n_communities=None, seed):
    """(adjs, features, labels, train_mask, val_mask, test_mask)."""
    rng = np.random.default_rng(seed)
    n_comm = n_communities or max(4 * n_classes, 8)
    comm = (np.arange(n_nodes) * n_comm) // n_nodes
    y = comm % n_classes
    adjs = []
    for edges, h in zip(edges_with_self_loops, homophily, strict=True):
        off = edges - n_nodes
        if off < 0 or off % 2:
            raise ValueError(f"{edges} edges with self-loops on {n_nodes} nodes: not n "
                             "plus an even number")
        adjs.append(metapath_pairs(rng, comm, off // 2, h))
    feats = (rng.random((n_nodes, n_feats)) < 0.02).astype(np.float32)
    block = n_feats // n_classes
    for cidx in range(n_classes):
        idx = np.where(y == cidx)[0]
        lo, hi = cidx * block, (cidx + 1) * block
        boost = (rng.random((idx.shape[0], hi - lo)) < 0.02 * feat_signal).astype(np.float32)
        feats[idx[:, None], np.arange(lo, hi)[None, :]] += boost
    feats = np.minimum(feats, 1.0)
    labels = np.zeros((n_nodes, n_classes), dtype=np.float32)
    labels[np.arange(n_nodes), y] = 1.0
    train_mask = np.zeros(n_nodes, dtype=bool)
    for cidx in range(n_classes):
        idx = np.where(y == cidx)[0]
        train_mask[rng.permutation(idx)[:train_per_class]] = True
    rest = rng.permutation(np.where(~train_mask)[0])
    val_mask = np.zeros(n_nodes, dtype=bool)
    val_mask[rest[:n_val]] = True
    test_mask = np.zeros(n_nodes, dtype=bool)
    test_mask[rest[n_val:]] = True
    return adjs, feats, labels, train_mask, val_mask, test_mask


def make_inputs(args: dict, seed: int) -> Inputs:
    return Inputs(*community_pairs(**args, seed=seed))
