"""Attention over TREE-structured ELL blocks (device-sampled mini-batches);
port of han_tpu/ops/tree_ell.py.

The device sampler's no-dedup L-hop block (train/sampled.py
``_device_sample_block``) references every non-root row from exactly one
``nbr[r, f]`` slot: the block is a forest rooted at the seeds. The
backward's d_logit_src / d_values transposes, scatter-adds for a general
graph, then write each child row once, from its parent's slot:

    dls[nbr[r, f]] = dz[r, f]
    dv[nbr[r, f]]  = c~[r, f] * g[r]

Forward: the ELL attention's (ops/ell_fused.py: the ``ell_fused_fwd_kernel``
on the card, its plain version on the CPU). Backward: on the card
``tree_ell_bwd_kernel`` (csrc/ell_fused.cu), one warp a parent row that
recomputes the row's softmax as the forward does and writes its children's
rows, no atomics; on the CPU its plain version :func:`tree_ell_bwd_plain`.
Coefficient dropout draws its keep mask once per call
(``ell_fused.draw_keep``) so the backward replays it. Features f32 or bf16,
logits and every sum f32, d_fts in the features' dtype. han_tpu has no
Pallas kernel here (XLA gathers through the parent maps). Dispatched by
container type (graph/containers.TreeEllGraph) from attention_aggregate.

For a CUDA tensor the wrappers launch the kernels or raise; there is no
fallback. ``tree_ell_bwd_launches`` counts the backward's launches; the
forward's count in ``ell_fused.ell_fused_launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from han_tpu_torch.graph.containers import TreeEllGraph
from han_tpu_torch.ops import ell_fused as ef
from han_tpu_torch.ops.ell_fused import draw_keep, ell_dz, ell_fused_fwd

tree_ell_calls = 0  # tree_ell_attention calls
tree_ell_bwd_launches = 0


def tree_ell_bwd_plain(nbr, ld, ls, fts, keep, g, slope: float, p: float):
    """The kernel's math in plain torch, parent by parent: each row's dz
    and c̃ (``ell_dz``), dld their sum over the slots; each valid slot
    (r, f) writes its child j = nbr[r, f]: dls[j] = dz[r, f], dv[j] =
    c̃[r, f]·g[r]. A row no valid slot holds reads 0. nbr must be a tree
    (each row held by at most one valid slot). Returns (dv (N, K·D) in
    fts's dtype, dld (N, K), dls (N, K)), summed in f32."""
    n, k = ld.shape
    kd = fts.shape[1]
    dz, c_agg, safe = ell_dz(nbr, ld, ls, fts, keep, g, slope, p)
    to = safe.reshape(-1)  # empty slots write the dropped row n
    dls = ld.new_zeros((n + 1, k)).index_copy_(0, to, dz.reshape(-1, k))[:n]
    cg = c_agg[..., None] * g.view(n, 1, k, kd // k).float()
    dv = ld.new_zeros((n + 1, kd)).index_copy_(0, to, cg.reshape(-1, kd))[:n]
    return dv.to(fts.dtype), dz.sum(dim=1), dls


def tree_ell_bwd_cuda(nbr, parent_row, parent_slot, ld, ls, fts, keep, g,
                      slope: float, p: float):
    """The tree backward kernel; the contract of :func:`tree_ell_bwd_plain`,
    with the parent maps that invert nbr's valid slots (int32 (N,),
    sentinel N)."""
    global tree_ell_bwd_launches
    dev = ld.device
    n, k = ld.shape
    f = nbr.shape[1]
    kd = fts.shape[1]
    want = {"nbr": (nbr, torch.int32, (n, f)), "parent_row": (parent_row, torch.int32, (n,)),
            "parent_slot": (parent_slot, torch.int32, (n,)),
            "ld": (ld, torch.float32, (n, k)), "ls": (ls, torch.float32, (n, k)),
            "fts": (fts, fts.dtype, (n, kd)), "g": (g, fts.dtype, (n, kd))}
    if keep is not None:
        want["keep"] = (keep, torch.uint8, (n, f, k))
    ef.check_inputs("tree_ell backward", dev, fts.dtype, want)
    dv = torch.empty((n, kd), dtype=fts.dtype, device=dev)
    dld = torch.empty((n, k), dtype=torch.float32, device=dev)
    dls = torch.empty((n, k), dtype=torch.float32, device=dev)
    rc = ef._lib().han_tree_ell_bwd(
        nbr.data_ptr(), parent_row.data_ptr(), parent_slot.data_ptr(), ld.data_ptr(),
        ls.data_ptr(), fts.data_ptr(), keep.data_ptr() if keep is not None else None,
        g.data_ptr(), dv.data_ptr(), dld.data_ptr(), dls.data_ptr(),
        n, f, k, kd // k, int(fts.dtype == torch.bfloat16), float(slope),
        1.0 / (1.0 - p) if keep is not None else 1.0,
        torch.cuda.current_stream(dev).cuda_stream)
    ef.check_launch(rc, "tree_ell backward", f, k)
    tree_ell_bwd_launches += 1
    return dv, dld, dls


def tree_ell_bwd(nbr, parent_row, parent_slot, ld, ls, fts, keep, g, slope: float,
                 p: float):
    if ld.device.type == "cpu":
        return tree_ell_bwd_plain(nbr, ld, ls, fts, keep, g, slope, p)
    return tree_ell_bwd_cuda(nbr, parent_row, parent_slot, ld, ls, fts, keep, g, slope, p)


class _TreeEll(torch.autograd.Function):
    """(fts (N, K·D), ld, ls) → out (N, K·D) over a tree block."""

    @staticmethod
    def forward(ctx, fts, ld, ls, nbr, parent_row, parent_slot, keep, slope, p):
        ctx.save_for_backward(fts, ld, ls, nbr, parent_row, parent_slot, keep)
        ctx.slope, ctx.p = slope, p
        return ell_fused_fwd(nbr, ld, ls, fts, keep, slope, p)

    @staticmethod
    def backward(ctx, g):
        fts, ld, ls, nbr, parent_row, parent_slot, keep = ctx.saved_tensors
        dv, dld, dls = tree_ell_bwd(nbr, parent_row, parent_slot, ld, ls, fts, keep,
                                    g.contiguous(), ctx.slope, ctx.p)
        return dv, dld, dls, None, None, None, None, None, None


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
    out = _TreeEll.apply(fts.reshape(n, k * d).contiguous(), logit_dst.contiguous(),
                         logit_src.contiguous(), graph.nbr.contiguous(),
                         graph.parent_row.contiguous(), graph.parent_slot.contiguous(),
                         keep, float(slope), float(coef_dropout))
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
