"""Neighbor sampling: bounded-fanout ELL views of huge graphs (numpy port of
han_tpu/graph/sampling.py).

``NeighborSampler`` draws a fresh fixed-shape ``EllGraph`` per epoch through
the native sampler (han_tpu_torch.native.sample_neighbors, C++ partial
Fisher–Yates) with a numpy fallback; deterministic in (seed, epoch).

Mini-batch (seed-node) sampling composes on top: ``sample_subgraph`` takes
a seed-node batch, samples L fanout-bounded hops, and emits the induced
block with globally-padded static shapes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from han_tpu_torch import native
from han_tpu_torch.graph.containers import EllGraph


def _host(a) -> np.ndarray:
    """A numpy view of a CPU or CUDA tensor, or of an array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class NeighborSampler:
    """Fresh bounded-fanout ELL view of a CSR graph per epoch."""

    csr: object  # CSRGraph or any row_ptr/col_idx/n_nodes/n_edges view
    fanout: int
    seed: int = 0

    def __post_init__(self):
        self._row_ptr = _host(self.csr.row_ptr).astype(np.int64)
        self._col_idx = _host(self.csr.col_idx)[: self.csr.n_edges]

    def sample(self, epoch: int) -> EllGraph:
        nbr = native.sample_neighbors(
            self._row_ptr, self._col_idx, self.fanout,
            seed=np.uint64(self.seed * 1_000_003 + epoch))
        deg = np.diff(self._row_ptr).astype(np.int32)
        return EllGraph(
            nbr=torch.from_numpy(nbr),
            deg=torch.from_numpy(deg),
            n_nodes=self.csr.n_nodes,
            n_edges=int(np.minimum(deg, self.fanout).sum()),
        )


@dataclasses.dataclass
class SubgraphBatch:
    """Fixed-shape L-hop sampled block around a seed-node batch.

    ``nodes`` lists the unique nodes of the block (seeds first), padded
    with ``-1``; ``nbr`` holds per-node neighbor positions *local to the
    block* (padding = n_block); feeding it as an EllGraph over the gathered
    feature rows gives exact bounded-fanout message passing for the seeds.
    """

    nodes: np.ndarray       # int32[n_block] global ids, -1 pad
    nbr: np.ndarray         # int32[n_block, fanout] local indices, pad = n_block
    seed_mask: np.ndarray   # bool[n_block] True on seed rows
    n_real: int

    def ell(self) -> EllGraph:
        n_block = self.nodes.shape[0]
        deg = (self.nbr < n_block).sum(axis=1).astype(np.int32)
        return EllGraph(
            nbr=torch.from_numpy(self.nbr), deg=torch.from_numpy(deg),
            n_nodes=n_block, n_edges=int(deg.sum()))

    def gather_features(self, features: np.ndarray) -> np.ndarray:
        """(n_block, F) block features; padded rows are zero."""
        out = np.zeros((self.nodes.shape[0], features.shape[1]), features.dtype)
        real = self.nodes >= 0
        out[real] = features[self.nodes[real]]
        return out


def sample_subgraph(
    csr,
    seeds: np.ndarray,
    *,
    fanout: int,
    hops: int = 2,
    block_size: int | None = None,
    seed: int = 0,
) -> SubgraphBatch:
    """Uniform L-hop neighborhood sample around ``seeds`` with a static
    output size (``block_size``; default = worst-case seeds·(fanout+1)^hops,
    truncated breadth-first when exceeded). Uses the native C++ sampler
    (graphcore.cpp ``sample_block``) when built; Python fallback below."""
    # np.asarray(..., dtype) is a no-op when dtypes already match (astype
    # would copy the 100M-edge arrays every call)
    row_ptr = np.asarray(_host(csr.row_ptr), dtype=np.int64)
    col_idx = _host(csr.col_idx)[: csr.n_edges]
    seeds = np.asarray(seeds, dtype=np.int32)
    cap = block_size or int(seeds.shape[0] * (fanout + 1) ** hops)

    nat = native.sample_block(row_ptr, col_idx, seeds, fanout=fanout,
                              hops=hops, block_size=cap, seed=seed)
    if nat is not None:
        nodes, nbr, n_real = nat
        seed_mask = np.zeros(cap, bool)
        seed_mask[: seeds.shape[0]] = True
        return SubgraphBatch(nodes=nodes, nbr=nbr, seed_mask=seed_mask,
                             n_real=n_real)

    rng = np.random.default_rng(seed)

    order: list[int] = list(seeds)
    # duplicate seeds map to their FIRST occurrence (matches the native
    # sampler, graphcore.cpp sample_block); tail batches pad by repeating a
    # real in-batch seed, so the mask=1 row keeps its sampled edges
    position: dict[int, int] = {}
    for i, s in enumerate(seeds):
        position.setdefault(int(s), i)
    sampled_nbrs: dict[int, np.ndarray] = {}
    frontier = list(seeds)
    for _ in range(hops):
        nxt = []
        for u in frontier:
            lo, hi = row_ptr[u], row_ptr[u + 1]
            nbrs = col_idx[lo:hi]
            if nbrs.shape[0] > fanout:
                nbrs = rng.choice(nbrs, fanout, replace=False)
            sampled_nbrs.setdefault(int(u), np.sort(nbrs))
            for v in nbrs:
                v = int(v)
                if v not in position and len(order) < cap:
                    position[v] = len(order)
                    order.append(v)
                    nxt.append(v)
        frontier = nxt
        if len(order) >= cap:
            break

    n_block = cap
    nodes = np.full(n_block, -1, np.int32)
    nodes[: len(order)] = np.asarray(order, np.int32)
    nbr = np.full((n_block, fanout), n_block, np.int32)
    for u, nbrs in sampled_nbrs.items():
        row = position[u]
        locals_ = [position[int(v)] for v in nbrs if int(v) in position]
        nbr[row, : len(locals_)] = np.asarray(locals_, np.int32)
    seed_mask = np.zeros(n_block, bool)
    seed_mask[: seeds.shape[0]] = True
    return SubgraphBatch(nodes=nodes, nbr=nbr, seed_mask=seed_mask,
                         n_real=len(order))
