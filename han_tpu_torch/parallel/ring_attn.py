"""Ring attention over csr edge buckets: feature blocks rotate instead of
being replicated (port of han_tpu/parallel/ring_attn.py).

``partitioned_attention`` (shard_attn.py) replicates the source features
on every rank of the graph axis. Here node features stay sharded: rank s
holds the uniform block [s·n_loc, (s+1)·n_loc) of rows; at each of the S
ring steps it processes the edge bucket whose sources live in the block it
holds (``partition_csr_2d``: edges grouped by (destination shard, source
shard)), then passes the block to the next rank (parallel/mesh.py:
``ring_shift``; the backward rotates the gradients back). A rank holds
O(N/S · K · D) features instead of O(N · K · D).

Softmax statistics need no features: the per-head logit terms are small
and logit_src stays replicated, so the global row max and denominator come
first, over every bucket (han_tpu l.103-139), and the coefficients are
exact. On a heads axis each rank runs its K / heads heads. Coefficient
dropout draws one stream per (destination shard, source shard, heads
rank), as han_tpu folds the three into its key (l.154-161), through the
counter hash of shard_attn.py. Its S steps are a Python loop, as the other
ring's are; the last rotation, which han_tpu's uniform loop makes and never reads, is
skipped.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from han_tpu_torch.graph.containers import MASK_VALUE, CSRGraph, _to
from han_tpu_torch.ops import flash_gat as fg
from han_tpu_torch.parallel.mesh import (Axis, Mesh, gather_heads, gather_rows, local_heads,
                                         local_rows, make_mesh, ring_shift, sum_grads, wait)
from han_tpu_torch.parallel.shard_attn import _lrelu, shard_keep


@dataclasses.dataclass(frozen=True)
class PartitionedCSR2D:
    """Edges bucketed by (dst shard, src shard); uniform node blocks.

    row_local:  int64[S, S, E2] destination row within the dst shard, pad = n_loc
    col_local:  int64[S, S, E2] source row within the src shard, pad = n_loc
    col_global: int64[S, S, E2] global source id, pad = n_nodes
    mesh:       the mesh attention runs on (set by the trainer); None: every
                rank of the default process group
    """

    row_local: torch.Tensor
    col_local: torch.Tensor
    col_global: torch.Tensor
    n_nodes: int
    n_loc: int
    n_edges: int
    n_shards: int
    mesh: object | None = None

    @property
    def e_bucket(self) -> int:
        return int(self.row_local.shape[2])

    def to(self, device) -> "PartitionedCSR2D":
        return _to(self, device)


def partition_csr_2d(csr: CSRGraph, n_shards: int, *, pad_to: int = 128) -> PartitionedCSR2D:
    """Host-side 2-D edge bucketing with uniform contiguous node blocks;
    within a bucket the edges keep their CSR order (han_tpu fills the
    buckets edge by edge; this sorts them stably, the same arrays)."""
    n = csr.n_nodes
    n_loc = -(-n // n_shards)
    row_ptr = csr.row_ptr.cpu().numpy().astype(np.int64)
    cols = csr.col_idx.cpu().numpy()[: csr.n_edges].astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))

    bucket = (rows // n_loc) * n_shards + cols // n_loc
    counts = np.bincount(bucket, minlength=n_shards * n_shards)
    e2 = int(counts.max()) if csr.n_edges else pad_to
    e2 = max(((e2 + pad_to - 1) // pad_to) * pad_to, pad_to)

    order = np.argsort(bucket, kind="stable")
    b_sorted = bucket[order]
    slot = np.arange(order.shape[0]) - np.concatenate([[0], np.cumsum(counts)])[b_sorted]
    row_local = np.full((n_shards * n_shards, e2), n_loc, np.int64)
    col_local = np.full((n_shards * n_shards, e2), n_loc, np.int64)
    col_global = np.full((n_shards * n_shards, e2), n, np.int64)
    r, c = rows[order], cols[order]
    row_local[b_sorted, slot] = r - (r // n_loc) * n_loc
    col_local[b_sorted, slot] = c - (c // n_loc) * n_loc
    col_global[b_sorted, slot] = c

    shape = (n_shards, n_shards, e2)
    t = lambda a: torch.from_numpy(a.reshape(shape))
    return PartitionedCSR2D(row_local=t(row_local), col_local=t(col_local),
                            col_global=t(col_global), n_nodes=n, n_loc=n_loc,
                            n_edges=csr.n_edges, n_shards=n_shards)


class _Rotate(torch.autograd.Function):
    """A block to the next rank of the ring; its gradient back to the
    previous one."""

    @staticmethod
    def forward(ctx, x, ring: Axis):
        ctx.ring = ring
        (out,), works = ring_shift([x], ring)
        wait(works)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,), works = ring_shift([g], ctx.ring, step=-1)
        wait(works)
        return out, None


def ring_attention(
    graph: PartitionedCSR2D,
    fts: torch.Tensor,        # (N, K, D)
    logit_dst: torch.Tensor,  # (N, K)
    logit_src: torch.Tensor,  # (N, K)
    *,
    mesh: Mesh | None = None,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Global tensors in, global (N, K, D) out on every rank; each rank
    holds one feature block (and one in flight) of its heads. ``mesh``
    defaults to ``graph.mesh``, else every rank of the default process
    group on the graph axis."""
    fg.check_args(slope, coef_dropout, generator, fts, dtypes=(torch.float32,))
    mesh = mesh or graph.mesh or make_mesh(device=fts.device)
    ax_g, ax_h = mesh.graph, mesh.heads
    s_n = graph.n_shards
    if s_n != ax_g.size:
        raise ValueError(f"the graph has {s_n} shards, the mesh's graph axis "
                         f"{ax_g.size} ranks")
    n, k, d = fts.shape
    if k % ax_h.size:
        raise ValueError(f"{k} heads do not split over a heads axis of {ax_h.size}")
    k_loc, n_loc, s = k // ax_h.size, graph.n_loc, ax_g.rank
    pad = s_n * n_loc - n
    blk = local_heads(local_rows(torch.nn.functional.pad(fts, (0, 0, 0, 0, 0, pad)), ax_g),
                      ax_h)                                                   # (n_loc, k_loc, D)
    ld = local_heads(local_rows(torch.nn.functional.pad(
        logit_dst.to(torch.float32), (0, 0, 0, pad)), ax_g), ax_h, dim=-1)    # (n_loc, k_loc)
    ls = local_heads(sum_grads(logit_src.to(torch.float32), ax_g), ax_h, dim=-1)  # (N, k_loc)
    ld_pad = torch.cat([ld, ld.new_zeros((1, k_loc))])
    ls_pad = torch.cat([ls, ls.new_zeros((1, k_loc))])
    rl_all, cl_all, cg_all = graph.row_local[s], graph.col_local[s], graph.col_global[s]

    def bucket_logits(b):
        valid = cg_all[b] < n
        le = _lrelu(ld_pad[rl_all[b]] + ls_pad[cg_all[b]], slope)
        return torch.where(valid[:, None], le, MASK_VALUE), valid

    # softmax statistics over every local bucket (no features needed); the
    # max is a shift the coefficients do not depend on
    n_seg = n_loc + 1
    with torch.no_grad():
        m = ld.new_full((n_seg, k_loc), MASK_VALUE)
        for b in range(s_n):
            le, _ = bucket_logits(b)
            m = m.scatter_reduce(0, rl_all[b][:, None].expand(-1, k_loc), le, reduce="amax")
        # a scalar bound, not a tensor made from a host value: no copy to
        # the card inside a captured step
        m = torch.where(torch.isfinite(m), m, 0.0).clamp_min(MASK_VALUE * 0.5)
    denom = ld.new_zeros((n_seg, k_loc))
    for b in range(s_n):
        le, valid = bucket_logits(b)
        e = torch.where(valid[:, None], torch.exp(le - m[rl_all[b]]), 0.0)
        denom = denom.index_add(0, rl_all[b], e)

    seed = fg.draw_seed(coef_dropout, generator)
    acc = fts.new_zeros((n_loc, k_loc, d))
    for t in range(s_n):
        src = (s - t) % s_n
        rl, cl = rl_all[src], cl_all[src]
        le, valid = bucket_logits(src)
        e = torch.where(valid[:, None], torch.exp(le - m[rl]), 0.0)
        coefs = e / denom[rl].clamp_min(1e-30)                              # (E2, k_loc)
        if coef_dropout > 0.0:
            # reference order: softmax first, dropout on the coefficients
            keep = shard_keep(seed, (s, src, ax_h.rank), graph.e_bucket, k_loc,
                              coef_dropout, fts.device)
            coefs = torch.where(keep, coefs / (1.0 - coef_dropout), 0.0)
        blk_pad = torch.cat([blk, blk.new_zeros((1, k_loc, d))])
        vals = coefs[:, :, None] * blk_pad[cl.clamp_max(n_loc)]
        acc = acc + vals.new_zeros((n_seg, k_loc, d)).index_add(0, rl, vals)[:n_loc]
        if t < s_n - 1:
            blk = _Rotate.apply(blk, ax_g)
    out = gather_rows(gather_heads(acc, ax_h), ax_g)
    return out[:n]
