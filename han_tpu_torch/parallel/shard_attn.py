"""Sharded csr attention over the ('graph', 'heads') mesh axes (port of
han_tpu/parallel/shard_attn.py).

``partitioned_attention`` is the distributed sibling of
``ops/attention.py:csr_attention``, plain PyTorch as that is (han_tpu runs
XLA segment ops here, no Pallas kernel):

- the graph axis partitions destination rows and their incoming edges
  (parallel/edge_partition.py): each rank runs SDDMM → segment softmax →
  SpMM on its own edge block;
- the heads axis partitions the K attention heads (independent per head,
  reference gat.py:42-46), so no collective is needed inside;
- source features and logit_src are replicated (the model outside
  attention runs replicated): each rank takes its heads of them, and the
  gradients of its edge block's partial sums add over the graph axis
  (parallel/mesh.py), as ``shard_map``'s AD gives han_tpu.

Coefficient dropout draws one stream per (graph rank, heads rank), as
han_tpu folds both coordinates into its key (shard_attn.py:70-77): a seed
drawn on the device from the run's generator (the same on every rank, no
host round trip), folded with the rank's two coordinates into a key, and a
counter hash of (key, edge slot, head) — ops/flash_gat.py's — gives the
mask. The backward replays it through autograd.
"""

from __future__ import annotations

import torch

from han_tpu_torch.graph.containers import MASK_VALUE
from han_tpu_torch.ops import flash_gat as fg
from han_tpu_torch.parallel.edge_partition import PartitionedCSR
from han_tpu_torch.parallel.mesh import (Mesh, gather_heads, gather_rows, local_heads,
                                         local_rows, make_mesh, sum_grads)


def _lrelu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def shard_keep(seed, coords: tuple[int, ...], n: int, k: int, p: float,
               device) -> torch.Tensor:
    """bool[n, k]: the kept (slot, head) pairs of the stream that ``seed``
    (an int32 tensor or an int) and the shard's mesh ``coords`` key."""
    key = fg._seed_bits(seed)
    for c in coords:
        key = fg.fmix32(key ^ fg.fmix32((c + fg._GOLDEN) & fg._M32))
    return fg.dropout_keep(key, torch.arange(n, device=device),
                           torch.arange(k, device=device), 0, p)


def segment_softmax_local(le: torch.Tensor, row: torch.Tensor, valid: torch.Tensor,
                          n_seg: int) -> torch.Tensor:
    """Softmax of edge logits ``le`` (E, K) over each segment of ``row``;
    invalid edges get 0 (han_tpu's segment_max / segment_sum pair)."""
    k = le.shape[1]
    seg_max = le.new_full((n_seg, k), float("-inf")).scatter_reduce(
        0, row[:, None].expand(-1, k), le.detach(), reduce="amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    e = torch.where(valid[:, None], torch.exp(le - seg_max[row]), 0.0)
    seg_sum = e.new_zeros((n_seg, k)).index_add(0, row, e)
    return e / seg_sum[row].clamp_min(1e-30)


def partitioned_attention(
    graph: PartitionedCSR,
    fts: torch.Tensor,        # (N, K, D), replicated
    logit_dst: torch.Tensor,  # (N, K), replicated
    logit_src: torch.Tensor,  # (N, K), replicated
    *,
    mesh: Mesh | None = None,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """csr attention on this rank's edge block and heads; global tensors
    in, global (N, K, D) out on every rank. ``mesh`` defaults to
    ``graph.mesh``, else every rank of the default process group on the
    graph axis."""
    fg.check_args(slope, coef_dropout, generator, fts, dtypes=(torch.float32,))
    mesh = mesh or graph.mesh or make_mesh(device=fts.device)
    ax_g, ax_h = mesh.graph, mesh.heads
    if graph.n_shards != ax_g.size:
        raise ValueError(f"the graph has {graph.n_shards} shards, the mesh's graph axis "
                         f"{ax_g.size} ranks")
    n, k, d = fts.shape
    if k % ax_h.size:
        raise ValueError(f"{k} heads do not split over a heads axis of {ax_h.size}")
    k_loc, n_loc, s = k // ax_h.size, graph.n_loc, ax_g.rank
    fts = local_heads(sum_grads(fts, ax_g), ax_h)                          # (N, k_loc, D)
    ls = local_heads(sum_grads(logit_src.to(torch.float32), ax_g), ax_h, dim=-1)
    ld_all = logit_dst.new_zeros((graph.n_nodes_pad, k)).index_copy(
        0, graph.perm, logit_dst.to(torch.float32))
    ld = local_heads(local_rows(ld_all, ax_g), ax_h, dim=-1)                # (n_loc, k_loc)

    col, row = graph.col_idx[s], graph.row_idx[s]
    valid = col < n
    ld_pad = torch.cat([ld, ld.new_zeros((1, k_loc))])
    ls_pad = torch.cat([ls, ls.new_zeros((1, k_loc))])
    le = torch.where(valid[:, None], _lrelu(ld_pad[row] + ls_pad[col], slope), MASK_VALUE)
    coefs = segment_softmax_local(le, row, valid, n_loc + 1)               # (e_loc, k_loc)
    if coef_dropout > 0.0:
        keep = shard_keep(fg.draw_seed(coef_dropout, generator), (s, ax_h.rank),
                          graph.e_loc, k_loc, coef_dropout, fts.device)
        coefs = torch.where(keep, coefs / (1.0 - coef_dropout), 0.0)
    fts_pad = torch.cat([fts, fts.new_zeros((1, k_loc, d))])
    vals = coefs[:, :, None] * fts_pad[col]
    out = vals.new_zeros((n_loc + 1, k_loc, d)).index_add(0, row, vals)[:n_loc]
    out = gather_rows(gather_heads(out, ax_h), ax_g)                       # (n_pad, K, D)
    return out.index_select(0, graph.perm)
