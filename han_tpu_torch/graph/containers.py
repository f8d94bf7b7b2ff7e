"""Graph containers as tensor holders (port of han_tpu/graph/containers.py).

- :class:`DenseGraph` — boolean N×N adjacency and its additive ``-1e9``
  attention bias; the small-graph oracle path.
- :class:`CSRGraph` — row_ptr/col_idx with the edge arrays padded to a fixed
  length; padding edges point at the sentinel row ``n_nodes``
  (``csr_from_dense`` and ``dense_from_csr`` convert between the two).
- :class:`EllGraph` — ELLPACK: per-row neighbor lists padded to a fixed
  fanout ``(N, F)``; the sampled mini-batch blocks. :class:`TreeEllGraph`
  adds the parent maps of the device sampler's tree-shaped blocks.

Each container moves between devices with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

MASK_VALUE = -1e9  # additive mask for non-edges (reference utils/process.py:25)


def _to(obj, device):
    """Copy of a frozen dataclass with every tensor field moved to device."""
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass(frozen=True)
class DenseGraph:
    """``adj[i, j] = True`` iff node *i* attends to node *j*."""

    adj: torch.Tensor  # bool[N, N]
    n_nodes: int

    @property
    def bias(self) -> torch.Tensor:
        """Additive attention bias: 0 on edges, -1e9 off-edge."""
        return torch.where(self.adj, 0.0, MASK_VALUE).to(torch.float32)

    def to(self, device) -> "DenseGraph":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Padded CSR. Rows are destination nodes; columns are source neighbors.

    ``col_idx``/``row_idx`` have fixed length ``e_pad`` ≥ nnz; entries past
    ``n_edges`` are padding and hold the sentinel value ``n_nodes``.
    """

    row_ptr: torch.Tensor  # int64[N + 1]
    col_idx: torch.Tensor  # int64[e_pad], pad = n_nodes
    row_idx: torch.Tensor  # int64[e_pad], pad = n_nodes
    n_nodes: int
    n_edges: int

    @property
    def e_pad(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def edge_mask(self) -> torch.Tensor:
        """bool[e_pad]: True on real edges."""
        return torch.arange(self.e_pad, device=self.col_idx.device) < self.n_edges

    def to(self, device) -> "CSRGraph":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class EllGraph:
    """ELLPACK: fixed-fanout padded neighbor lists.

    ``nbr[i, f]`` is the f-th in-neighbor of node i, or the sentinel
    ``n_nodes`` when ``f >= degree(i)``. Gather targets are therefore
    padded with one extra zero row at index ``n_nodes``.
    """

    nbr: torch.Tensor  # int32[N, F], pad = n_nodes
    deg: torch.Tensor  # int32[N] true degree (may exceed F if truncated/sampled)
    n_nodes: int
    n_edges: int

    @property
    def fanout(self) -> int:
        return int(self.nbr.shape[1])

    @property
    def nbr_mask(self) -> torch.Tensor:
        """bool[N, F]: True where a real neighbor is stored."""
        return self.nbr < self.n_nodes

    def to(self, device) -> "EllGraph":
        return _to(self, device)


@dataclasses.dataclass(frozen=True)
class TreeEllGraph(EllGraph):
    """ELL block whose rows form a tree: every non-root row is referenced by
    exactly one (row, slot) of ``nbr`` — the no-dedup L-hop layout of the
    device sampler (train/sampled._device_sample_block).

    ``parent_row[j] / parent_slot[j]`` invert that reference (sentinel
    n_nodes when j is a root or pad row), so the attention backward's
    transposes are gathers (ops/tree_ell.py).
    """

    parent_row: torch.Tensor = None   # int32[N], sentinel = n_nodes
    parent_slot: torch.Tensor = None  # int32[N], sentinel = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def dense_from_numpy(adj: np.ndarray, *, add_self_loops: bool = True,
                     nhood: int = 1) -> DenseGraph:
    """Reachability closure of ``adj_to_bias(adj, sizes, nhood)``
    (utils/process.py:14-25): mask[i, j] iff j is reachable from i in
    ≤ nhood hops of (A + I)."""
    a = np.asarray(adj)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"adjacency must be square 2-D, got {a.shape}")
    n = a.shape[0]
    reach = (a != 0)
    if add_self_loops:
        reach = reach | np.eye(n, dtype=bool)
    if nhood > 1:
        step = reach.copy()
        for _ in range(nhood - 1):
            reach = (reach.astype(np.float32) @ step.astype(np.float32)) > 0
    return DenseGraph(adj=torch.from_numpy(reach), n_nodes=n)


def csr_from_dense(graph: DenseGraph | np.ndarray, *, edge_pad_to: int = 128) -> CSRGraph:
    """Convert a dense adjacency (a DenseGraph or an array; nonzero = edge)
    into padded CSR on the CPU."""
    if isinstance(graph, DenseGraph):
        a = graph.adj.cpu().numpy()
    else:
        a = np.asarray(graph) != 0
    n = a.shape[0]
    rows, cols = np.nonzero(a)  # row-major, so sorted by (row, col)
    nnz = rows.shape[0]
    e_pad = max(_round_up(max(nnz, 1), edge_pad_to), edge_pad_to)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=row_ptr[1:])
    col_idx = np.full(e_pad, n, dtype=np.int64)
    row_idx = np.full(e_pad, n, dtype=np.int64)
    col_idx[:nnz] = cols
    row_idx[:nnz] = rows
    return CSRGraph(row_ptr=torch.from_numpy(row_ptr), col_idx=torch.from_numpy(col_idx),
                    row_idx=torch.from_numpy(row_idx), n_nodes=n, n_edges=int(nnz))


def dense_from_csr(csr: CSRGraph) -> DenseGraph:
    """Materialize a CSRGraph as a dense boolean adjacency on the CPU."""
    n = csr.n_nodes
    a = torch.zeros((n, n), dtype=torch.bool)
    a[csr.row_idx[: csr.n_edges].cpu(), csr.col_idx[: csr.n_edges].cpu()] = True
    return DenseGraph(adj=a, n_nodes=n)


def csr_from_scipy(sp_mat: Any, *, edge_pad_to: int = 128) -> CSRGraph:
    """Build padded CSR from any scipy.sparse matrix."""
    m = sp_mat.tocsr().astype(bool)
    m.sum_duplicates()
    n = m.shape[0]
    nnz = int(m.nnz)
    e_pad = max(_round_up(max(nnz, 1), edge_pad_to), edge_pad_to)
    col_idx = np.full(e_pad, n, dtype=np.int64)
    row_idx = np.full(e_pad, n, dtype=np.int64)
    col_idx[:nnz] = m.indices
    row_idx[:nnz] = np.repeat(np.arange(n, dtype=np.int64),
                              np.diff(m.indptr).astype(np.int64))
    return CSRGraph(
        row_ptr=torch.from_numpy(m.indptr.astype(np.int64)),
        col_idx=torch.from_numpy(col_idx),
        row_idx=torch.from_numpy(row_idx),
        n_nodes=n,
        n_edges=nnz,
    )


def ell_from_csr(csr: CSRGraph, *, fanout: int | None = None, pad_to: int = 8) -> EllGraph:
    """Convert padded CSR (host) to ELLPACK with fanout = max degree (or given)."""
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    col_idx = csr.col_idx.cpu().numpy()[: csr.n_edges]
    n = csr.n_nodes
    deg = np.diff(row_ptr)
    f = int(deg.max()) if fanout is None else int(fanout)
    f = max(_round_up(max(f, 1), pad_to), pad_to)
    nbr = np.full((n, f), n, dtype=np.int32)
    for i in range(n):
        d = min(int(deg[i]), f)
        nbr[i, :d] = col_idx[row_ptr[i] : row_ptr[i] + d]
    return EllGraph(
        nbr=torch.from_numpy(nbr),
        deg=torch.from_numpy(deg.astype(np.int32)),
        n_nodes=n,
        n_edges=csr.n_edges,
    )
