"""Gather-only attention for TREE-structured ELL blocks (device-sampled
mini-batches); port of han_tpu/ops/tree_ell.py.

The device sampler's no-dedup L-hop block (train/sampled.py
``_device_sample_block``) references every non-root row from exactly one
``nbr[r, f]`` slot: the block is a forest rooted at the seeds. The
backward's d_logit_src / d_values transposes, scatter-adds for a general
graph, are then single gathers through the parent maps:

    dls[j] = dz[parent_row[j], parent_slot[j]]
    dv[j]  = c~[parent_row[j], parent_slot[j]] * g[parent_row[j]]

Forward math is that of the ELL attention (ops/ell_fused.py's plain
version, flat (K·D) gather layout); coefficient dropout draws its keep mask
once per call (``ell_fused.draw_keep``) so the backward replays it. Plain
torch on every device: han_tpu has no Pallas kernel here. Dispatched by
container type (graph/containers.TreeEllGraph) from attention_aggregate.
"""

from __future__ import annotations

import numpy as np
import torch

from han_tpu_torch.graph.containers import TreeEllGraph
from han_tpu_torch.ops.ell_fused import draw_keep, ell_dz, ell_fused_fwd_plain

tree_ell_calls = 0  # tree_ell_attention calls (plain torch: no kernel launch)


class _TreeEll(torch.autograd.Function):
    """(fts (N, K·D), ld, ls) → out (N, K·D) over a tree block."""

    @staticmethod
    def forward(ctx, fts, ld, ls, nbr, parent_row, parent_slot, keep, slope, p):
        ctx.save_for_backward(fts, ld, ls, nbr, parent_row, parent_slot, keep)
        ctx.slope, ctx.p = slope, p
        return ell_fused_fwd_plain(nbr, ld, ls, fts, keep, slope, p)

    @staticmethod
    def backward(ctx, g):
        fts, ld, ls, nbr, parent_row, parent_slot, keep = ctx.saved_tensors
        n, k = ld.shape
        g = g.contiguous()
        dz, c_agg, _ = ell_dz(nbr, ld, ls, fts, keep, g, ctx.slope, ctx.p)
        # the tree transposes: gathers through the parent maps, no scatter
        has = (parent_row < n)[:, None]
        pr = torch.where(has[:, 0], parent_row, 0).long()
        ps = parent_slot.long()
        dls = torch.where(has, dz[pr, ps], 0.0)                  # (N, K)
        c_sel = torch.where(has, c_agg[pr, ps], 0.0)             # (N, K)
        dv = (c_sel[:, :, None] * g.view(n, k, -1)[pr]).reshape(n, -1)
        return dv, dz.sum(dim=1), dls, None, None, None, None, None, None


def tree_ell_attention(
    graph: TreeEllGraph,
    fts: torch.Tensor,        # (N, K, D)
    logit_dst: torch.Tensor,  # (N, K)
    logit_src: torch.Tensor,  # (N, K)
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    global tree_ell_calls
    n, k, d = fts.shape
    keep = None
    if coef_dropout > 0.0:
        if generator is None:
            raise ValueError("coef_dropout > 0 requires a generator")
        keep = draw_keep(n, graph.fanout, k, coef_dropout, generator, fts.device)
    tree_ell_calls += 1
    out = _TreeEll.apply(fts.reshape(n, k * d), logit_dst, logit_src,
                         graph.nbr, graph.parent_row, graph.parent_slot, keep,
                         float(slope), float(coef_dropout))
    return out.view(n, k, d)


def tree_parent_maps(batch: int, fanout: int, hops: int,
                     block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Static parent maps of the no-dedup L-hop block layout
    (train/sampled._device_sample_block): level l+1 row ``base + r*F + f``
    is referenced by (level-l row r, slot f); roots/pads get sentinel
    block_size. Depends only on (batch, fanout, hops, block_size) — built
    once on the host."""
    pr = np.full(block_size, block_size, np.int32)
    ps = np.zeros(block_size, np.int32)
    level_base = 0
    level_size = batch
    for _ in range(hops):
        child_base = level_base + level_size
        idx = np.arange(level_size * fanout)
        pr[child_base: child_base + level_size * fanout] = \
            level_base + idx // fanout
        ps[child_base: child_base + level_size * fanout] = idx % fanout
        level_base = child_base
        level_size *= fanout
    return pr, ps
