"""Node reordering for block locality (numpy copy of han_tpu/graph/reorder.py,
on the port's own dataset container; tests/test_torch_bench.py holds the
orderings equal to han_tpu's).

The flash kernels skip adjacency tiles with no edges, so their throughput
on real meta-path graphs depends on edge *clustering*: community-sorted
node orderings concentrate edges into few dense tiles. Utilities here
compute an ordering and apply it consistently to every meta-path
adjacency, features, labels and masks of a dataset.

Orderings:
- ``labels``  — sort by class label (meta-path graphs are strongly
  homophilous, han.pdf Table 3, so labels approximate communities).
- ``degree`` — sort by total degree (hub clustering; helps skewed graphs).
- ``bfs``    — reverse Cuthill–McKee ordering of the union graph (no label
  information at all).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from han_tpu_torch.graph.synthetic import HeteroDataset


def ordering(ds: HeteroDataset, method: str = "bfs") -> np.ndarray:
    """Return a permutation ``perm`` such that new_index = position of
    old node ``perm[i]`` — i.e. ``x_new = x_old[perm]``."""
    if method == "labels":
        y = np.argmax(ds.labels, axis=1)
        return np.argsort(y, kind="stable")
    if method == "degree":
        deg = sum(np.asarray(a.sum(axis=1)).ravel() for a in ds.metapath_adjs)
        return np.argsort(-deg, kind="stable")
    if method == "bfs":
        union = ds.metapath_adjs[0]
        for a in ds.metapath_adjs[1:]:
            union = union + a
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        return np.asarray(reverse_cuthill_mckee(union.tocsr(), symmetric_mode=True))
    raise ValueError(f"unknown ordering method {method!r}")


def apply_ordering(ds: HeteroDataset, perm: np.ndarray) -> HeteroDataset:
    """Permute every node-indexed array of the dataset consistently."""
    return HeteroDataset(
        metapath_adjs=[a.tocsr()[perm][:, perm] for a in ds.metapath_adjs],
        features=ds.features[perm],
        labels=ds.labels[perm],
        train_mask=ds.train_mask[perm],
        val_mask=ds.val_mask[perm],
        test_mask=ds.test_mask[perm],
        name=ds.name,
        metapath_names=ds.metapath_names,
    )


def reorder(ds: HeteroDataset, method: str = "bfs") -> HeteroDataset:
    return apply_ordering(ds, ordering(ds, method))


def block_density(adj: sp.spmatrix, block: int = 128) -> float:
    """Fraction of (block × block) tiles holding at least one edge — the
    work fraction of the block-sparse kernels (the port's tile is 128)."""
    a = adj.tocoo()
    nb = -(-adj.shape[0] // block)
    tiles = set(zip(a.row // block, a.col // block))
    return len(tiles) / (nb * nb)
