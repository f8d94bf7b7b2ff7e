"""Edge partitioning of CSR graphs over the mesh's graph axis (port of
han_tpu/parallel/edge_partition.py, numpy host code).

Destination nodes are split into S contiguous row blocks (N padded up to a
multiple of S); every shard owns its rows' incoming edges, with their
source indices global (the source features stay replicated:
parallel/shard_attn.py). Degree skew is handled by edge-balanced block
boundaries: contiguous row ranges chosen so each shard's edge count is
near-equal, then every block padded to the largest. Per-shard edge arrays
are padded to one length (the largest, rounded up to ``edge_pad_to``), so
the stacked (S, e_loc) arrays are rectangular; pads point at the source
sentinel ``n_nodes`` and at the local row sentinel ``n_loc``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from han_tpu_torch.graph.containers import CSRGraph, _to


@dataclasses.dataclass(frozen=True)
class PartitionedCSR:
    """CSR row-partitioned into S shards with common shapes.

    row_ptr:   int64[S, n_loc + 1]: per-shard local CSR row pointers
    col_idx:   int64[S, e_loc]: GLOBAL source ids, pad = n_nodes
    row_idx:   int64[S, e_loc]: LOCAL destination rows, pad = n_loc
    row_start: int64[S]: global id of each shard's first row
    perm:      int64[n_nodes]: padded position of each global row
    mesh:      the mesh attention runs on (set by the trainer); None: every
               rank of the default process group
    """

    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    row_idx: torch.Tensor
    row_start: torch.Tensor
    perm: torch.Tensor
    n_nodes: int      # true global node count (unpadded)
    n_nodes_pad: int  # S * n_loc
    n_edges: int
    n_shards: int
    mesh: object | None = None

    @property
    def n_loc(self) -> int:
        return int(self.row_ptr.shape[1]) - 1

    @property
    def e_loc(self) -> int:
        return int(self.col_idx.shape[1])

    def to(self, device) -> "PartitionedCSR":
        return _to(self, device)


def partition_csr(csr: CSRGraph, n_shards: int, *, balance_edges: bool = True,
                  edge_pad_to: int = 128) -> PartitionedCSR:
    """Host-side partitioner: CSRGraph → PartitionedCSR with S row blocks."""
    n = csr.n_nodes
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    col = csr.col_idx.cpu().numpy()[: csr.n_edges].astype(np.int64)
    nnz = csr.n_edges

    # contiguous row-block boundaries
    if balance_edges and nnz > 0:
        targets = (np.arange(1, n_shards) * nnz) / n_shards
        bounds = np.clip(np.searchsorted(row_ptr, targets, side="left"), 0, n)
        starts = np.maximum.accumulate(np.concatenate([[0], bounds, [n]]))
    else:
        per = -(-n // n_shards)
        starts = np.minimum(np.arange(n_shards + 1) * per, n)

    n_loc = max(int(max(starts[1:] - starts[:-1])), 1)
    e_counts = row_ptr[starts[1:]] - row_ptr[starts[:-1]]
    e_loc = int(e_counts.max()) if nnz else edge_pad_to
    e_loc = max(((e_loc + edge_pad_to - 1) // edge_pad_to) * edge_pad_to, edge_pad_to)

    rp = np.zeros((n_shards, n_loc + 1), dtype=np.int64)
    ci = np.full((n_shards, e_loc), n, dtype=np.int64)
    ri = np.full((n_shards, e_loc), n_loc, dtype=np.int64)
    perm = np.zeros(n, dtype=np.int64)
    for s in range(n_shards):
        r0, r1 = int(starts[s]), int(starts[s + 1])
        perm[r0:r1] = s * n_loc + np.arange(r1 - r0, dtype=np.int64)
        e0, e1 = int(row_ptr[r0]), int(row_ptr[r1])
        ci[s, :e1 - e0] = col[e0:e1]
        local_deg = row_ptr[r0:r1 + 1] - row_ptr[r0]
        ri[s, :e1 - e0] = np.repeat(np.arange(r1 - r0, dtype=np.int64),
                                    np.diff(row_ptr[r0:r1 + 1]))
        rp[s, :r1 - r0 + 1] = local_deg
        rp[s, r1 - r0 + 1:] = local_deg[-1]

    t = torch.from_numpy
    return PartitionedCSR(row_ptr=t(rp), col_idx=t(ci), row_idx=t(ri),
                          row_start=t(starts[:-1].astype(np.int64)), perm=t(perm),
                          n_nodes=n, n_nodes_pad=n_shards * n_loc, n_edges=nnz,
                          n_shards=n_shards)
