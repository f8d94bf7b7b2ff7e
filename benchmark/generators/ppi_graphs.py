"""Graphs of PPI's published shape (GAT, arXiv:1710.10903 Table 1; the
GraphSAGE PPI split): a stated number of graphs and nodes in each split,
a stated number of undirected edges in all, features and multi-hot
labels, drawn from the seed (the node counts once, from ``sizes_seed``) in
vectorised numpy.

- Node counts: in each split, ``split_graphs[s]`` graphs summing to
  ``split_nodes[s]``, each between ``min_nodes`` and ``max_nodes``; one
  train graph holds exactly ``max_nodes``, and the others share the rest
  by a Dirichlet draw. The counts are drawn once, from ``sizes_seed``,
  and the run's seed only orders them within each split: the tiles that
  the program keeps on the card, and so its memory, follow the counts
  (drawn from the run's seed they moved ``peak_mem_gib`` by a quartile
  spread of 0.39-0.52 % over six seeds, against half its bound, 0.5 %;
  PERF.md §6).
- Edges: ``undirected_edges`` node pairs in all, each graph's share in
  proportion to its nodes (PPI's degree is about even across its graphs),
  drawn uniformly without replacement and without self-loops; each pair
  is taken both ways, and every node gets one self-loop. Node order is
  random, so a graph of n nodes occupies about every one of its
  ⌈n / 128⌉² tiles.
- Features: standard normal. Labels: each of ``n_labels`` a threshold of
  a random projection of the features plus noise at the
  ``label_density`` quantile, so that the task is learnable and about
  that share of the labels is on.

Returns :class:`GraphSet`: the dataset's padded arrays (``features`` (G,
N_max, F), ``labels`` (G, N_max, C), ``node_mask`` (G, N_max)), the split of
each graph (0 train, 1 val, 2 test) and each graph's edges (rows, cols,
row-major, self-loops included).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphSet:
    features: np.ndarray   # float32 (G, N_max, F)
    labels: np.ndarray     # float32 (G, N_max, C)
    node_mask: np.ndarray  # bool (G, N_max)
    split: np.ndarray      # int8 (G,)
    edges: list            # per graph (rows, cols) int32, self-loops included
    sizes: np.ndarray      # int64 (G,) nodes a graph

    def graph_ids(self, split: int) -> np.ndarray:
        return np.flatnonzero(self.split == split)


def split_sizes(rng, n_graphs: int, total: int, lo: int, hi: int) -> np.ndarray:
    """``n_graphs`` sizes in [lo, hi] summing to ``total``."""
    if not n_graphs * lo <= total <= n_graphs * hi:
        raise ValueError(f"{n_graphs} graphs of {lo}-{hi} nodes cannot hold {total}")
    sizes = lo + np.floor(rng.dirichlet(np.full(n_graphs, 4.0)) * (total - n_graphs * lo))
    sizes = np.minimum(sizes.astype(np.int64), hi)
    while sizes.sum() < total:  # what the floor and the cap left, where there is room
        room = np.flatnonzero(sizes < hi)
        add = min(total - int(sizes.sum()), len(room))
        sizes[rng.choice(room, add, replace=False)] += 1
    return sizes


def pairs(rng, n: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """``m`` distinct unordered pairs (i < j) of ``n`` nodes, uniformly."""
    if m > n * (n - 1) // 2:
        raise ValueError(f"{m} pairs of {n} nodes")
    keys = np.zeros(0, np.int64)
    while keys.shape[0] < m:
        k = int((m - keys.shape[0]) * 1.05) + 64
        i, j = rng.integers(0, n, k), rng.integers(0, n, k)
        keep = i != j
        lo, hi = np.minimum(i, j)[keep], np.maximum(i, j)[keep]
        keys = np.unique(np.concatenate([keys, lo * n + hi]))
    keys = rng.permutation(keys)[:m]
    return keys // n, keys % n


def make_inputs(args: dict, seed: int) -> GraphSet:
    rng, fixed = np.random.default_rng(seed), np.random.default_rng(args["sizes_seed"])
    lo, hi = args["min_nodes"], args["max_nodes"]
    counts, totals = args["split_graphs"], args["split_nodes"]
    sizes = [np.concatenate([[hi], split_sizes(fixed, counts[0] - 1, totals[0] - hi, lo, hi)])]
    sizes += [split_sizes(fixed, g, t, lo, hi) for g, t in zip(counts[1:], totals[1:])]
    sizes = np.concatenate([rng.permutation(s) for s in sizes])
    split = np.repeat(np.arange(len(counts), dtype=np.int8), counts)
    # each graph's share of the undirected edges, by its nodes
    m = np.floor(args["undirected_edges"] * sizes / sizes.sum()).astype(np.int64)
    m[np.argsort(-sizes, kind="stable")[:args["undirected_edges"] - int(m.sum())]] += 1
    f, c = args["n_feats"], args["n_labels"]
    g_n, n_max = sizes.shape[0], int(sizes.max())
    node_mask = np.arange(n_max)[None, :] < sizes[:, None]
    features = np.zeros((g_n, n_max, f), np.float32)
    features[node_mask] = rng.standard_normal((int(sizes.sum()), f), dtype=np.float32)
    proj = rng.standard_normal((f, c), dtype=np.float32) / np.sqrt(f)
    score = features[node_mask] @ proj + rng.standard_normal(
        (int(sizes.sum()), c), dtype=np.float32)
    labels = np.zeros((g_n, n_max, c), np.float32)
    labels[node_mask] = score > np.quantile(score, 1.0 - args["label_density"], axis=0)
    edges = []
    for n, mg in zip(sizes.tolist(), m.tolist()):
        i, j = pairs(rng, n, mg)
        loop = np.arange(n)
        rows, cols = np.concatenate([i, j, loop]), np.concatenate([j, i, loop])
        order = np.argsort(rows * n + cols, kind="stable")
        edges.append((rows[order].astype(np.int32), cols[order].astype(np.int32)))
    return GraphSet(features=features, labels=labels, node_mask=node_mask, split=split,
                    edges=edges, sizes=sizes)
