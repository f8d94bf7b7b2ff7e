"""Planetoid citation-graph loader for cora / citeseer / pubmed (numpy copy
of han_tpu/datasets/planetoid.py:22-79).

Format and semantics follow the reference ``utils/process.py:47-98``
(tkipf/gcn lineage): pickled ``x/y/tx/ty/allx/ally/graph`` shards plus a
test-index reorder file, with the citeseer isolated-node fix. Returns the
standard homogeneous semi-supervised task (one adjacency, one "meta-path",
so it plugs into the GAT and HAN pipelines). The raw shards are not in the
repository; ``write_planetoid`` writes a seeded fixture of a given shape
(Pubmed's by default) in their format.
"""

from __future__ import annotations

import pathlib
import pickle

import numpy as np
import scipy.sparse as sp

from han_tpu_torch.graph.build import row_normalize_features
from han_tpu_torch.graph.synthetic import HeteroDataset


def load_planetoid(root: str | pathlib.Path, name: str) -> HeteroDataset:
    root = pathlib.Path(root)
    keys = ["x", "y", "tx", "ty", "allx", "ally", "graph"]
    objs = []
    for k in keys:
        with open(root / f"ind.{name}.{k}", "rb") as f:
            objs.append(pickle.load(f, encoding="latin1"))
    x, y, tx, ty, allx, ally, graph = objs

    with open(root / f"ind.{name}.test.index") as f:
        test_idx = np.array([int(line.strip()) for line in f])
    test_range = np.sort(test_idx)

    if name == "citeseer":
        # isolated test nodes: re-insert as zero rows (process.py:62-71)
        full = range(int(test_idx.min()), int(test_idx.max()) + 1)
        tx_ext = sp.lil_matrix((len(full), x.shape[1]))
        tx_ext[test_range - test_range.min(), :] = tx
        tx = tx_ext
        ty_ext = np.zeros((len(full), y.shape[1]))
        ty_ext[test_range - test_range.min(), :] = ty
        ty = ty_ext

    features = sp.vstack((allx, tx)).tolil()
    features[test_idx, :] = features[test_range, :]
    labels = np.vstack((ally, ty))
    labels[test_idx, :] = labels[test_range, :]

    n = labels.shape[0]
    rows, cols = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            rows.append(u)
            cols.append(v)
    adj = sp.coo_matrix((np.ones(len(rows), np.float32), (rows, cols)),
                        shape=(n, n))
    adj = ((adj + adj.T) > 0).astype(np.float32).tocsr()
    adj.setdiag(0)
    adj.eliminate_zeros()

    train_mask = np.zeros(n, bool)
    train_mask[: y.shape[0]] = True
    val_mask = np.zeros(n, bool)
    val_mask[y.shape[0]: y.shape[0] + 500] = True
    test_mask = np.zeros(n, bool)
    test_mask[test_range] = True

    return HeteroDataset(
        metapath_adjs=[adj],
        features=np.asarray(row_normalize_features(features.toarray()),
                            dtype=np.float32),
        labels=labels.astype(np.float32),
        train_mask=train_mask,
        val_mask=val_mask,
        test_mask=test_mask,
        name=name,
        metapath_names=("CITES",),
    )


def write_planetoid(root, name: str = "pubmed", *, n_nodes: int = 19_717, n_feats: int = 500,
                    n_classes: int = 3, n_edges: int = 44_324, n_train: int = 60,
                    n_test: int = 1_000, gaps=(), seed: int = 0) -> None:
    """Write a Planetoid-format fixture: shards
    ind.NAME.{x,y,tx,ty,allx,ally,graph,test.index} under root, as
    :func:`load_planetoid` reads them (reference utils/process.py:47-98);
    the defaults are Pubmed's shape (Yang et al. 2016: 19,717 nodes, 500
    features, 3 classes, 44,324 undirected edges, 60 train nodes; the
    loader takes the next 500 as validation and the last 1,000 are test).
    Features are sparse, non-negative and class-correlated (each class
    weighs its own third of the columns up); 80 % of the edges join two
    nodes of one class. ``gaps``: offsets into the test range left
    out of tx, ty, test.index and every edge (citeseer's isolated nodes,
    which the loader re-inserts as zero rows). test.index lists the test
    nodes shuffled, tx in that order."""
    root = pathlib.Path(root)
    rng = np.random.default_rng(seed)
    n_allx = n_nodes - n_test
    label = rng.integers(0, n_classes, n_nodes)
    onehot = np.eye(n_classes)[label]
    cols = np.arange(n_feats) * n_classes // n_feats  # the class each column favours
    vals = rng.random((n_nodes, n_feats)) * (rng.random((n_nodes, n_feats)) < 0.08)
    vals *= np.where(cols[None] == label[:, None], 10.0, 1.0)
    feats = sp.csr_matrix(vals.astype(np.float32))

    test_ids = np.arange(n_allx, n_nodes)
    gap_ids = test_ids[list(gaps)]
    present = np.setdiff1d(test_ids, gap_ids)
    shuffled = rng.permutation(present)

    # edges: endpoints u uniform, v of u's class with probability 0.8
    by_class = np.argsort(label, kind="stable")
    starts = np.searchsorted(label[by_class], np.arange(n_classes + 1))
    m = 3 * n_edges
    u = rng.integers(0, n_nodes, m)
    same = rng.random(m) < 0.8
    lo, hi = starts[label[u]], starts[label[u] + 1]
    v = np.where(same, by_class[lo + (rng.random(m) * (hi - lo)).astype(np.int64)],
                 rng.integers(0, n_nodes, m))
    pairs = np.unique(np.sort(np.stack([u, v], 1), axis=1), axis=0)
    pairs = pairs[(pairs[:, 0] != pairs[:, 1]) & ~np.isin(pairs, gap_ids).any(1)]
    pairs = pairs[rng.permutation(len(pairs))[:n_edges]]
    graph = {i: [] for i in range(n_nodes)}
    for a, b in pairs.tolist():
        graph[a].append(b)  # one direction: the loader symmetrizes

    shards = {"x": feats[:n_train], "y": onehot[:n_train], "allx": feats[:n_allx],
              "ally": onehot[:n_allx], "tx": feats[shuffled], "ty": onehot[shuffled],
              "graph": graph}
    for key, obj in shards.items():
        with open(root / f"ind.{name}.{key}", "wb") as f:
            pickle.dump(obj, f)
    with open(root / f"ind.{name}.test.index", "w") as f:
        f.write("\n".join(str(int(i)) for i in shuffled) + "\n")
