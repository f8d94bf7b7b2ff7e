"""Graph attention aggregation ops (port of han_tpu/ops/attention.py:77-277,
285-404).

One mathematical spec, several executions:

    logits[i, j, k] = leaky_relu(logit_dst[i, k] + logit_src[j, k])
    coefs[i, :, k]  = softmax over in-neighbors j of node i
    out[i, k, :]    = sum_j coefs[i, j, k] * fts[j, k, :]

- ``dense`` — materialized (K, N, N) masked softmax; the oracle.
- ``ell``   — gather over fixed-fanout ELLPACK neighbor lists; O(N·F)
  memory; plain torch.
- ``csr``   — edge domain: SDDMM → segment softmax (``scatter_reduce`` amax,
  ``index_add``) → SpMM; O(E) memory.
- ``ell_fused`` — the fused ELL CUDA forward kernel with a plain-torch
  backward (ops/ell_fused.py).
- ``flash`` — the fused block-sparse CUDA kernels over the occupied tiles
  of a BCSRGraph (ops/flash_gat.py).

A TreeEllGraph (device-sampled block) goes to the tree attention
(ops/tree_ell.py: the ELL forward, a backward that writes each child row
from its parent's slot), a PartitionedBCSR to the edge-partitioned flash
backend (parallel/flash_shard.py), a RingBCSR to the ring backend
(parallel/ring_bcsr.py), a PartitionedCSR to the sharded csr backend
(parallel/shard_attn.py) and a PartitionedCSR2D to the csr ring
(parallel/ring_attn.py), whatever ``impl`` says.

A stack of P graphs (graph/stack.py; HAN's meta-path towers) comes with
P-stacked features ``(P, N, K, D)``: a BCSRGraph or PartitionedBCSR stack
goes to the flash kernels in one launch for the P paths, any other stack
path by path.

All take features in head-major layout ``fts: (N, K, D)`` and per-head node
logit terms ``logit_dst, logit_src: (N, K)`` and return ``(N, K, D)``.
Features may be bfloat16 on dense, csr, ell and flash: the logits and
coefficients stay f32, the aggregate is summed in f32 and cast back to
``fts.dtype`` (han_tpu/ops/attention.py:106-108,156-159,217).
"""

from __future__ import annotations

from typing import Literal

import torch

from han_tpu_torch.graph.bcsr import BCSRGraph
from han_tpu_torch.graph.containers import (MASK_VALUE, CSRGraph, DenseGraph,
                                            EllGraph, TreeEllGraph)
from han_tpu_torch.ops.ell_fused import ell_fused_attention
from han_tpu_torch.ops.flash_gat import flash_gat_attention
from han_tpu_torch.ops.tree_ell import tree_ell_attention
from han_tpu_torch.graph.stack import path
from han_tpu_torch.parallel.edge_partition import PartitionedCSR
from han_tpu_torch.parallel.flash_shard import PartitionedBCSR, sharded_flash_attention
from han_tpu_torch.parallel.ring_attn import PartitionedCSR2D, ring_attention
from han_tpu_torch.parallel.ring_bcsr import RingBCSR, ring_flash_attention
from han_tpu_torch.parallel.shard_attn import partitioned_attention

Impl = Literal["auto", "dense", "ell", "ell_fused", "csr", "flash"]

# The flash-vs-csr crossover of ``impl="auto"`` on a BCSRGraph that carries
# its edge view, in tile elements swept per real edge
# (BCSRGraph.elems_per_edge), by tile geometry (bm, bn): above it the csr
# backend's forward + backward takes less device time than flash's.
# 128 x 128: scripts/flash_scale_demo_torch.py --sweep on an NVIDIA H100
# 80GB HBM3 at 700 W, K = D = 8, 14 graphs from 1.8 (DBLP's APTPA) to 6,833
# elements an edge: csr starts to win at 497 elements an edge with
# coefficient dropout 0.6 (the presets' training setting) and at 655 with
# dropout 0; the table holds the lower figure (PERF.md, section 6).
# han_tpu's figures (2000 and 5500 at 512-wide tiles) are v5e numbers and
# are not carried over. A geometry not in the table takes
# FLASH_MAX_ELEMS_PER_EDGE, the 128 x 128 figure.
FLASH_MAX_ELEMS_PER_EDGE_BY_TILE = {
    (128, 128): 497.0,
}
FLASH_MAX_ELEMS_PER_EDGE = FLASH_MAX_ELEMS_PER_EDGE_BY_TILE[(128, 128)]


def flash_csr_threshold(bm: int, bn: int) -> float:
    """The flash-to-csr crossover (swept elements an edge) of a tile
    geometry; the 128 x 128 figure for a geometry not measured."""
    return FLASH_MAX_ELEMS_PER_EDGE_BY_TILE.get((int(bm), int(bn)), FLASH_MAX_ELEMS_PER_EDGE)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def _coef_dropout(coefs: torch.Tensor, p: float,
                  generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout on materialized coefficients; the mask is drawn on
    the coefficients' device from ``generator``."""
    if p <= 0.0:
        return coefs
    if generator is None:
        raise ValueError("coef_dropout > 0 requires a generator")
    keep = 1.0 - p
    mask = torch.rand(coefs.shape, generator=generator,
                      device=coefs.device) < keep
    return torch.where(mask, coefs / keep, 0.0)


def dense_attention(
    graph: DenseGraph,
    fts: torch.Tensor,        # (N, K, D) features used for aggregation
    logit_dst: torch.Tensor,  # (N, K)
    logit_src: torch.Tensor,  # (N, K)
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
    return_coefs: bool = False,
):
    # (K, N, N) logits: row i attends over columns j
    logits = logit_dst.T[:, :, None] + logit_src.T[:, None, :]
    coefs = torch.softmax(leaky_relu(logits, slope) + graph.bias[None], dim=-1)
    raw_coefs = coefs
    coefs = _coef_dropout(coefs, coef_dropout, generator)
    out = torch.einsum("knm,mkd->nkd", coefs, fts.float()).to(fts.dtype)
    if return_coefs:
        return out, raw_coefs
    return out


def ell_attention(
    graph: EllGraph,
    fts: torch.Tensor,        # (N, K, D)
    logit_dst: torch.Tensor,  # (N, K)
    logit_src: torch.Tensor,  # (N, K)
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Gather attention over ELL neighbor lists. The feature table is
    gathered in the flat (N, K·D) layout with a zero sentinel row at index
    N; the (N, F, K) keep mask is ``torch.rand((N, F, K), generator) <
    1 - p``, the draw ell_fused and tree_ell make."""
    n, k, d = fts.shape
    f = graph.nbr.shape[1]
    valid = graph.nbr_mask  # (N, F)
    nbr = graph.nbr.long()  # sentinel n
    fts_pad = torch.cat([fts.reshape(n, k * d), fts.new_zeros((1, k * d))])
    ls_pad = torch.cat([logit_src, logit_src.new_zeros((1, k))])
    logits = leaky_relu(logit_dst[:, None, :] + ls_pad[nbr], slope)  # (N, F, K)
    logits = torch.where(valid[:, :, None], logits, MASK_VALUE)
    # stable softmax over F (the max is a shift the coefficients do not
    # depend on); fully-padded rows produce exactly 0 output
    m = logits.amax(dim=1, keepdim=True).detach()
    e = torch.where(valid[:, :, None], torch.exp(logits - m), 0.0)
    coefs = e / e.sum(dim=1, keepdim=True).clamp_min(1e-30)  # (N, F, K)
    coefs = _coef_dropout(coefs, coef_dropout, generator)
    g_fts = fts_pad[nbr].view(n, f, k, d)
    return torch.einsum("nfk,nfkd->nkd", coefs, g_fts.float()).to(fts.dtype)


def sddmm_edge_logits(graph: CSRGraph, logit_dst: torch.Tensor,
                      logit_src: torch.Tensor, *, slope: float = 0.2) -> torch.Tensor:
    """Edge logits l_e = leaky_relu(logit_dst[row_e] + logit_src[col_e]).

    Returns (E_pad, K); padding edges get MASK_VALUE.
    """
    zero = logit_dst.new_zeros((1, logit_dst.shape[1]))
    ld_pad = torch.cat([logit_dst, zero])
    ls_pad = torch.cat([logit_src, zero])
    le = leaky_relu(ld_pad[graph.row_idx] + ls_pad[graph.col_idx], slope)
    return torch.where(graph.edge_mask[:, None], le, MASK_VALUE)


def segment_softmax(graph: CSRGraph, edge_logits: torch.Tensor) -> torch.Tensor:
    """Numerically-stable softmax over each destination row's edges.

    edge_logits: (E_pad, K) → coefs (E_pad, K); padded edges → 0; rows with
    no edges produce no contribution anywhere.
    """
    n_seg = graph.n_nodes + 1  # sentinel row collects padding
    rows = graph.row_idx
    k = edge_logits.shape[1]
    # the max is a shift the normalized coefficients do not depend on
    seg_max = edge_logits.new_full((n_seg, k), float("-inf")).scatter_reduce(
        0, rows[:, None].expand(-1, k), edge_logits.detach(), reduce="amax")
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    e = torch.exp(edge_logits - seg_max[rows])
    e = torch.where(graph.edge_mask[:, None], e, 0.0)
    seg_sum = e.new_zeros((n_seg, k)).index_add(0, rows, e)
    return e / seg_sum[rows].clamp_min(1e-30)


def spmm_aggregate(graph: CSRGraph, coefs: torch.Tensor,
                   fts: torch.Tensor) -> torch.Tensor:
    """out[i] = sum over edges e with row_e == i of coefs[e] * fts[col_e].

    coefs: (E_pad, K); fts: (N, K, D) → out (N, K, D), in flat (K·D) layout.
    """
    n, k, d = fts.shape
    fts_pad = torch.cat([fts.reshape(n, k * d), fts.new_zeros((1, k * d))])
    vals = torch.repeat_interleave(coefs, d, dim=1) * fts_pad[graph.col_idx]
    out = vals.new_zeros((n + 1, k * d)).index_add(0, graph.row_idx, vals)
    return out[:n].reshape(n, k, d).to(fts.dtype)


def edge_attention_coefs(graph: CSRGraph, logit_dst: torch.Tensor,
                         logit_src: torch.Tensor, *, slope: float = 0.2) -> torch.Tensor:
    """Per-edge attention coefficients (E_pad, K) for analysis, computed one
    head at a time over 1-D edge arrays, so the peak is O(E) a head instead
    of the (E, K) edge tensors of :func:`csr_attention`; padding edges get
    exactly 0 (han_tpu/ops/attention.py:220-250; reference coefficient
    output, gat.py:148-173)."""
    k = logit_dst.shape[1]
    zero = logit_dst.new_zeros((1, k))
    ld_pad = torch.cat([logit_dst, zero])
    ls_pad = torch.cat([logit_src, zero])
    rows, cols, real = graph.row_idx, graph.col_idx, graph.edge_mask
    n_seg = graph.n_nodes + 1
    outs = []
    for h in range(k):
        le = leaky_relu(ld_pad[rows, h] + ls_pad[cols, h], slope)
        le = torch.where(real, le, MASK_VALUE)
        seg_max = le.new_full((n_seg,), float("-inf")).scatter_reduce(
            0, rows, le, reduce="amax")
        seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
        e = torch.where(real, torch.exp(le - seg_max[rows]), 0.0)
        seg_sum = e.new_zeros(n_seg).index_add_(0, rows, e)
        outs.append(e / seg_sum[rows].clamp_min(1e-30))
    return torch.stack(outs, dim=1)


def csr_attention(
    graph: CSRGraph,
    fts: torch.Tensor,
    logit_dst: torch.Tensor,
    logit_src: torch.Tensor,
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
    return_coefs: bool = False,
):
    le = sddmm_edge_logits(graph, logit_dst, logit_src, slope=slope)
    coefs = segment_softmax(graph, le)
    # pre-dropout coefs, (E_pad, K) aligned with graph.row_idx/col_idx,
    # padding edges exactly 0
    raw_coefs = coefs
    coefs = _coef_dropout(coefs, coef_dropout, generator)
    out = spmm_aggregate(graph, coefs, fts)
    if return_coefs:
        return out, raw_coefs
    return out


def attention_aggregate(
    graph,
    fts: torch.Tensor,
    logit_dst: torch.Tensor,
    logit_src: torch.Tensor,
    *,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
    impl: Impl = "auto",
    return_coefs: bool = False,
    towers: tuple[int, int, int] | None = None,
):
    """Dispatch on graph container type / requested implementation.

    ``generator`` draws, on the features' device, the dense, csr, ell,
    ell_fused and tree dropout masks and the flash kernels' dropout seed
    (a device tensor: no host round trip, so a captured step draws anew at
    every replay). ``auto`` sends an EllGraph to ell and a BCSRGraph to
    flash, or, where it carries its edge view and sweeps more tile
    elements an edge than :func:`flash_csr_threshold` of its geometry, its
    edge view to csr, as han_tpu does; a stack has no edge view and stays
    on flash. ``towers``: a stack's paths are towers lo..hi−1 of P
    (ops/flash_gat.py:draw_path_seeds).
    """
    if fts.dim() == 4 and not isinstance(graph, (BCSRGraph, PartitionedBCSR)):
        # a stack without a batched kernel: path by path, each drawing its own
        # masks
        if return_coefs:
            raise NotImplementedError("return_coefs unsupported on a stack of graphs")
        return torch.stack([attention_aggregate(
            path(graph, p), fts[p], logit_dst[p], logit_src[p], slope=slope,
            coef_dropout=coef_dropout, generator=generator, impl=impl)
            for p in range(fts.shape[0])])
    if isinstance(graph, TreeEllGraph):
        # device-sampled tree blocks: the backward writes each child row
        # from its parent's slot (ops/tree_ell.py)
        if return_coefs:
            raise NotImplementedError("return_coefs unsupported on TreeEllGraph")
        return tree_ell_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator)
    # the partitioned containers are the distribution strategy: the same
    # model code runs the sharded kernels over the default process group
    if isinstance(graph, PartitionedBCSR):
        if return_coefs:
            raise NotImplementedError("return_coefs unsupported on PartitionedBCSR")
        return sharded_flash_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator, towers=towers)
    if isinstance(graph, RingBCSR):
        if return_coefs:
            raise NotImplementedError("return_coefs unsupported on RingBCSR")
        return ring_flash_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator)
    if isinstance(graph, PartitionedCSR):
        if return_coefs:
            raise NotImplementedError("return_coefs unsupported on PartitionedCSR")
        return partitioned_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator)
    if isinstance(graph, PartitionedCSR2D):
        if return_coefs:
            raise NotImplementedError("return_coefs unsupported on PartitionedCSR2D")
        return ring_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator)
    if impl == "auto":
        if isinstance(graph, DenseGraph):
            impl = "dense"
        elif isinstance(graph, EllGraph):
            impl = "ell"
        elif isinstance(graph, CSRGraph):
            impl = "csr"
        elif isinstance(graph, BCSRGraph):
            # occupancy-aware: flash's work grows with the swept tile area,
            # csr's with the edges
            if (graph.edge_col is not None
                    and graph.elems_per_edge() > flash_csr_threshold(graph.bm, graph.bn)):
                graph, impl = graph.as_csr(), "csr"
            else:
                impl = "flash"
        else:
            raise TypeError(f"unknown graph container {type(graph)}")
    if impl == "dense":
        return dense_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator,
            return_coefs=return_coefs)
    if impl == "csr":
        return csr_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator,
            return_coefs=return_coefs)
    if return_coefs:
        # the fused kernels never materialize per-edge coefficients
        raise NotImplementedError(
            "return_coefs is supported by the dense and csr impls only")
    if impl == "ell":
        return ell_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator)
    if impl == "ell_fused":
        return ell_fused_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator)
    if impl == "flash":
        return flash_gat_attention(
            graph, fts, logit_dst, logit_src, slope=slope,
            coef_dropout=coef_dropout, generator=generator, towers=towers)
    raise ValueError(f"unknown impl {impl!r}")
