"""Inductive multi-graph (PPI-style) pipeline (numpy copy of
han_tpu/datasets/ppi.py:1-217, with scikit-learn's StandardScaler written
out in numpy).

Reference: utils/process_ppi.py: load a GraphSAGE-format dataset (G.json
node-link graph, id_map, class_map, feats.npy), split the union graph into
connected components, assign each component wholly to train/val/test
(verifying isolation), standardize features on train nodes, and pad every
component to the largest component's size — dense [G, N_max, *] batches
with per-graph node masks.

Beside the dense ``adj`` a dataset may hold each graph's edge list
(``edges``), which the inductive trainer's sparse attention reads
(:meth:`MultiGraphDataset.graph_edges`): a dataset made from edge lists
alone (``adj`` None) never builds the (G, N_max, N_max) adjacency unless
the dense path asks for it, and one made from ``adj`` derives each edge
list from it once.

The raw PPI files are not in the repository, so a deterministic synthetic
multi-graph fixture with the same schema (``ppi_synthetic``) stands in for
tests and for the ``ppi`` name when the files are absent.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import scipy.sparse as sp


SPLITS = {"train": 0, "val": 1, "test": 2}


@dataclasses.dataclass
class MultiGraphDataset:
    """Fixed-shape batched multi-graph dataset (host arrays). ``adj`` may
    be None where ``edges`` holds every graph's edge list (the module
    docstring)."""

    adj: np.ndarray | None  # bool [G, N_max, N_max]
    features: np.ndarray  # float32 [G, N_max, F]
    labels: np.ndarray    # float32 [G, N_max, C] (multi-hot for PPI)
    node_mask: np.ndarray  # bool [G, N_max]
    graph_split: np.ndarray  # int8 [G]: 0 train / 1 val / 2 test
    name: str = "ppi"
    # per graph (rows, cols) int32 arrays: node i attends to node j, local
    # indices, as ``adj[g]``'s nonzeros in row-major order
    edges: list | None = None

    def __post_init__(self):
        if self.adj is None and self.edges is None:
            raise ValueError("a MultiGraphDataset needs adj or edges")

    @property
    def n_graphs(self) -> int:
        return int(self.features.shape[0])

    def graph_ids(self, which: str) -> np.ndarray:
        """The indices of the split's graphs, in dataset order."""
        return np.flatnonzero(self.graph_split == SPLITS[which])

    def graph_edges(self, g: int) -> tuple[np.ndarray, np.ndarray]:
        """Graph ``g``'s edges (rows, cols), derived from ``adj`` once."""
        if self.edges is None:
            self.edges = [tuple(x.astype(np.int32) for x in np.nonzero(a)) for a in self.adj]
        return self.edges[g]

    def dense_adj(self) -> np.ndarray:
        """``adj``, built from ``edges`` at its first use where it is None."""
        if self.adj is None:
            g, n = self.node_mask.shape
            self.adj = np.zeros((g, n, n), dtype=bool)
            for i, (r, c) in enumerate(self.edges):
                self.adj[i, r, c] = True
        return self.adj

    def split(self, which: str):
        sel = self.graph_split == SPLITS[which]
        return (self.dense_adj()[sel], self.features[sel], self.labels[sel],
                self.node_mask[sel])


def _components(adj: sp.csr_matrix) -> np.ndarray:
    """Connected-component id per node (iterative; the reference uses a
    recursive DFS, process_ppi.py:8-32 — same result)."""
    n = adj.shape[0]
    comp = np.full(n, -1, dtype=np.int64)
    cur = 0
    indptr, indices = adj.indptr, adj.indices
    for start in range(n):
        if comp[start] >= 0:
            continue
        stack = [start]
        comp[start] = cur
        while stack:
            u = stack.pop()
            for v in indices[indptr[u]:indptr[u + 1]]:
                if comp[v] < 0:
                    comp[v] = cur
                    stack.append(v)
        cur += 1
    return comp


def _check_isolation(adj: sp.coo_matrix, split_of_node: np.ndarray) -> None:
    """No edge may cross split boundaries (reference `test`,
    process_ppi.py:34-42)."""
    coo = adj.tocoo()
    bad = split_of_node[coo.row] != split_of_node[coo.col]
    if bad.any():
        raise ValueError(f"{int(bad.sum())} edges cross split boundaries")


def standard_scale(features: np.ndarray, fit_rows: np.ndarray) -> np.ndarray:
    """scikit-learn's ``StandardScaler().fit(features[fit_rows])
    .transform(features)``: the mean and the population std (ddof 0) of
    the fit rows in float64, a scale of 1 for a constant column (sklearn's
    ``_is_constant_feature`` test), and the subtraction and division done
    in place on a float32 copy, as sklearn does on float32 input."""
    fit = np.asarray(features[fit_rows], dtype=np.float64)
    n = fit.shape[0]
    mean = fit.mean(axis=0)
    var = ((fit - mean) ** 2).mean(axis=0)
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    out = np.array(features, dtype=np.float32)
    out -= mean
    out /= scale
    return out


def batch_components(
    adj: sp.csr_matrix,
    features: np.ndarray,
    labels: np.ndarray,
    node_split: np.ndarray,  # int8 per node: 0/1/2 (from val/test flags)
    *,
    min_component: int = 3,
    standardize: bool = True,
) -> MultiGraphDataset:
    """Component → padded batch conversion (process_ppi.py:138-271)."""
    comp = _components(adj)

    # tiny components are regrouped into one bucket per split
    # (process_ppi.py:141-174). The sizes are read once, before any bucket
    # id exists: han_tpu reads them after the first split's bucket is made,
    # and its bucket id indexes past them (IndexError) when tiny components
    # fall in two splits.
    sizes = np.bincount(comp)
    small = sizes[comp] < min_component
    comp = comp.copy()
    next_id = comp.max() + 1
    for s in range(3):
        tiny = np.where(small & (node_split == s))[0]
        if tiny.size:
            comp[tiny] = next_id + s

    # a component's split = majority split of its nodes; then enforce purity
    comp_ids = np.unique(comp)
    comp_split = np.zeros(comp_ids.shape[0], dtype=np.int8)
    remap = {c: i for i, c in enumerate(comp_ids)}
    for i, c in enumerate(comp_ids):
        members = np.where(comp == c)[0]
        comp_split[i] = np.bincount(node_split[members], minlength=3).argmax()
        node_split[members] = comp_split[i]
    _check_isolation(adj, node_split)

    if standardize:
        features = standard_scale(features, node_split == 0)

    g = comp_ids.shape[0]
    n_max = int(max(np.bincount([remap[c] for c in comp]).max(), 1))
    fdim, cdim = features.shape[1], labels.shape[1]
    adj_b = np.zeros((g, n_max, n_max), dtype=bool)
    fts_b = np.zeros((g, n_max, fdim), dtype=np.float32)
    lab_b = np.zeros((g, n_max, cdim), dtype=np.float32)
    mask_b = np.zeros((g, n_max), dtype=bool)
    a_rows = adj.tocsr()
    for i, c in enumerate(comp_ids):
        members = np.where(comp == c)[0]
        k = members.shape[0]
        sub = a_rows[members][:, members].toarray() > 0
        adj_b[i, :k, :k] = sub
        fts_b[i, :k] = features[members]
        lab_b[i, :k] = labels[members]
        mask_b[i, :k] = True
    return MultiGraphDataset(adj=adj_b, features=fts_b, labels=lab_b,
                             node_mask=mask_b, graph_split=comp_split)


def load_ppi(root: str | pathlib.Path, prefix: str = "ppi") -> MultiGraphDataset:
    """Load GraphSAGE-format {prefix}-G.json / -id_map.json / -class_map.json
    / -feats.npy (process_ppi.py:85-136)."""
    root = pathlib.Path(root)
    with open(root / f"{prefix}-G.json") as f:
        gdata = json.load(f)
    with open(root / f"{prefix}-id_map.json") as f:
        id_map = {k: int(v) for k, v in json.load(f).items()}
    with open(root / f"{prefix}-class_map.json") as f:
        class_map = json.load(f)
    feats = np.load(root / f"{prefix}-feats.npy").astype(np.float32)

    n = feats.shape[0]
    rows, cols = [], []
    for e in gdata["links"]:
        rows.append(int(e["source"]))
        cols.append(int(e["target"]))
    adj = sp.coo_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    adj = ((adj + adj.T) > 0).astype(np.float32).tocsr()

    node_split = np.zeros(n, dtype=np.int8)
    for node in gdata["nodes"]:
        i = id_map[str(node["id"])]
        if node.get("val"):
            node_split[i] = 1
        elif node.get("test"):
            node_split[i] = 2

    any_label = next(iter(class_map.values()))
    cdim = len(any_label) if isinstance(any_label, list) else int(max(
        class_map.values())) + 1
    labels = np.zeros((n, cdim), dtype=np.float32)
    for k, v in class_map.items():
        i = id_map[str(k)]
        if isinstance(v, list):
            labels[i] = np.asarray(v, dtype=np.float32)
        else:
            labels[i, int(v)] = 1.0

    return batch_components(adj, feats, labels, node_split)


def ppi_synthetic(
    *,
    n_graphs: int = 12,
    nodes_per_graph: int = 48,
    n_feats: int = 16,
    n_labels: int = 9,
    avg_degree: float = 5.0,
    seed: int = 0,
) -> MultiGraphDataset:
    """Deterministic multi-graph fixture with the PPI schema (multi-hot
    labels, per-graph 70/15/15 splits); each graph has k nodes, k drawn in
    [nodes_per_graph / 2, nodes_per_graph]."""
    rng = np.random.default_rng(seed)
    n_max = nodes_per_graph
    adj = np.zeros((n_graphs, n_max, n_max), dtype=bool)
    fts = np.zeros((n_graphs, n_max, n_feats), dtype=np.float32)
    lab = np.zeros((n_graphs, n_max, n_labels), dtype=np.float32)
    mask = np.zeros((n_graphs, n_max), dtype=bool)
    for g in range(n_graphs):
        k = int(rng.integers(n_max // 2, n_max + 1))
        p = avg_degree / max(k - 1, 1)
        a = rng.random((k, k)) < p
        a = np.triu(a, 1)
        a = a | a.T | np.eye(k, dtype=bool)
        adj[g, :k, :k] = a
        # labels correlated with features so the task is learnable
        proto = rng.standard_normal((n_labels, n_feats)).astype(np.float32)
        z = rng.standard_normal((k, n_feats)).astype(np.float32)
        logits = z @ proto.T
        lab[g, :k] = (logits > 0.3).astype(np.float32)
        fts[g, :k] = z + 0.5 * lab[g, :k] @ proto
        mask[g, :k] = True
    split = np.zeros(n_graphs, dtype=np.int8)
    split[int(n_graphs * 0.7):] = 1
    split[int(n_graphs * 0.85):] = 2
    return MultiGraphDataset(adj=adj, features=fts, labels=lab,
                             node_mask=mask, graph_split=split,
                             name="ppi_synthetic")
