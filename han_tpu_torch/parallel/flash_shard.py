"""Edge-partitioned flash-GAT over the ('graph', 'heads') mesh axes (port
of han_tpu/parallel/flash_shard.py).

Destination rows are split into contiguous row-block-aligned strips, one
per rank of the graph axis. Each rank owns its rows' incoming edge tiles
as a BCSR strip (rows local, columns global) and sweeps them with the same
CUDA flash kernels as one device (ops/flash_gat.py) for its K / heads
heads, at ``row_block_offset`` = its first global row block and
``head_offset`` = heads-rank × K / heads (han_tpu's ``h_off``), so the
dropout keys, and the masks, are those of a one-device run, head for head.

Source features and logit_src are replicated: the model outside attention
runs replicated on every rank. The collectives (parallel/mesh.py) are
those ``shard_map``'s AD gives han_tpu:

- forward: rank (g, h) slices its strip's logit_dst through ``perm`` and
  its heads of every input, runs the strip, and the strips are gathered
  over the heads axis, then the graph axis, and reordered by ``perm``;
- backward: each rank's strip gives dld for its rows and heads (gathered)
  and partial dls and dv over all columns for its heads (gathered over the
  heads axis, all-reduced over the graph axis), so every rank returns the
  same full gradients and the replicated parameters stay equal with no
  data-parallel pass.

A stacked partition (graph/stack.py, HAN's meta-path towers) sweeps every
path's strip in one launch of each kernel, each path at its own row-block
offsets (read by the kernels from device memory).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from han_tpu_torch.graph.bcsr import DEF_BM, DEF_BN, BCSRGraph, build_tile_arrays, pick_tiles
from han_tpu_torch.graph.containers import _to
from han_tpu_torch.ops import flash_gat as fg
from han_tpu_torch.parallel.mesh import (Mesh, gather_heads, gather_rows, local_heads,
                                         local_rows, make_mesh, sum_grads)


@dataclasses.dataclass(frozen=True)
class PartitionedBCSR:
    """Per-shard BCSR row strips with common shapes.

    tiles:     int8[S, T_max, bm, bn]: shard-local occupied tiles
    fwd_*:     per-shard forward map over its nb_r_loc local row blocks
    bwd_*:     per-shard backward map over the nb_c GLOBAL column blocks
    row_block_off: each shard's first global row block (host ints)
    perm:      int64[n_nodes]: global row → padded slot (s·n_loc + local)
    mesh:      the mesh attention runs on (set by the trainer); None: every
               rank of the default process group

    A stack of P partitions (graph/stack.py) has a leading P axis on every
    array and P tuples of offsets, and ``path_row_block_off``: the offsets
    as int32[P, S] on the stack's device, which the kernels read (made when
    the stack is, so that a captured step copies nothing from the host).
    """

    tiles: torch.Tensor
    fwd_count: torch.Tensor
    fwd_col: torch.Tensor
    fwd_tile: torch.Tensor
    bwd_count: torch.Tensor
    bwd_row: torch.Tensor
    bwd_tile: torch.Tensor
    row_block_off: tuple[int, ...]
    perm: torch.Tensor
    n_nodes: int
    n_pad: int   # global column padding (multiple of bm and bn)
    n_loc: int   # rows per shard (multiple of bm)
    bm: int
    bn: int
    n_edges: int
    n_shards: int
    mesh: Mesh | None = None
    path_row_block_off: torch.Tensor | None = None

    @property
    def n_paths(self) -> int | None:
        """P for a stack of P partitions, None for one."""
        return int(self.tiles.shape[0]) if self.tiles.dim() == 5 else None

    def strip(self, s: int) -> BCSRGraph:
        """Shard s as a BCSRGraph over n_loc rows × n_pad columns (views of
        the stacked tensors; edge counts per shard are not kept); of a
        stack, the P paths' strips s as a stacked BCSRGraph (copies: the
        kernels take each path's arrays back to back)."""
        if self.n_paths is None:
            pick = lambda t: t[s]
        else:
            pick = lambda t: t[:, s].contiguous()
        return BCSRGraph(
            tiles=pick(self.tiles), fwd_count=pick(self.fwd_count),
            fwd_col=pick(self.fwd_col), fwd_tile=pick(self.fwd_tile),
            bwd_count=pick(self.bwd_count), bwd_row=pick(self.bwd_row),
            bwd_tile=pick(self.bwd_tile), n_nodes=self.n_loc, n_pad=self.n_loc,
            bm=self.bm, bn=self.bn, n_edges=0, n_tiles=int(self.tiles.shape[-3]))

    def strip_row_block_off(self, s: int) -> int | torch.Tensor:
        """Shard s's first global row block: an int, or of a stack, an int32
        tensor of one a path on the stack's device (the kernels read it
        there)."""
        if self.n_paths is None:
            return self.row_block_off[s]
        return self.path_row_block_off[:, s].contiguous()

    def to(self, device) -> "PartitionedBCSR":
        return _to(self, device)


def partition_bcsr(adj, n_shards: int, *, bm: int = DEF_BM, bn: int = DEF_BN,
                   balance_edges: bool = True) -> PartitionedBCSR:
    """Host-side partitioner: scipy adjacency → S row-strip BCSR shards
    (numpy copy of han_tpu's, with the port's tile rules).

    Strip boundaries are chosen on row-block (bm) granularity, balancing
    edge counts across shards, and every shard's row blocks keep their
    GLOBAL block indices via row_block_off: the one-device tile grid is
    partitioned, never re-tiled.
    """
    m = adj.tocoo().astype(bool)
    m.sum_duplicates()
    rows = np.asarray(m.row, np.int64)
    cols = np.asarray(m.col, np.int64)
    n = m.shape[0]
    nnz = int(rows.shape[0])

    bm, bn, n_pad = pick_tiles(n, bm, bn)
    nb_r = n_pad // bm
    nb_c = n_pad // bn

    # edge-balanced boundaries in row-block units
    blk_edges = np.bincount(rows // bm, minlength=nb_r).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(blk_edges)])
    if balance_edges and nnz > 0:
        targets = (np.arange(1, n_shards) * nnz) / n_shards
        bounds = np.searchsorted(cum, targets, side="left")
    else:
        per = -(-nb_r // n_shards)
        bounds = np.minimum(np.arange(1, n_shards) * per, nb_r)
    starts = np.concatenate([[0], np.clip(bounds, 0, nb_r), [nb_r]])
    starts = np.maximum.accumulate(starts)

    nb_r_loc = int(max((starts[1:] - starts[:-1]).max(), 1))
    n_loc = nb_r_loc * bm

    order = np.argsort(rows, kind="stable")
    rows_s, cols_s = rows[order], cols[order]
    row_bounds = np.searchsorted(rows_s, starts * bm)

    parts = []
    for s in range(n_shards):
        lo, hi = row_bounds[s], row_bounds[s + 1]
        local_rows_ = rows_s[lo:hi] - starts[s] * bm
        parts.append(build_tile_arrays(local_rows_, cols_s[lo:hi],
                                       nb_r_loc, nb_c, bm, bn))

    t_max = max(max(p[0].shape[0] for p in parts), 1)
    c_max = max(p[2].shape[1] for p in parts)
    r_max = max(p[5].shape[1] for p in parts)

    def pad_tiles(t):
        return np.pad(t, ((0, t_max - t.shape[0]), (0, 0), (0, 0)))

    def pad_map(a, w):
        # repeat the last column (the map padding convention) out to width w
        return np.concatenate(
            [a] + [a[:, -1:]] * (w - a.shape[1]), axis=1) if a.shape[1] < w else a

    perm = np.zeros(n, np.int64)
    for s in range(n_shards):
        r0 = int(starts[s]) * bm
        r1 = min(int(starts[s + 1]) * bm, n)
        if r1 > r0:
            perm[r0:r1] = s * n_loc + np.arange(r1 - r0, dtype=np.int64)

    t = torch.from_numpy
    return PartitionedBCSR(
        tiles=t(np.stack([pad_tiles(p[0]) for p in parts])),
        fwd_count=t(np.stack([p[1] for p in parts])),
        fwd_col=t(np.stack([pad_map(p[2], c_max) for p in parts])),
        fwd_tile=t(np.stack([pad_map(p[3], c_max) for p in parts])),
        bwd_count=t(np.stack([p[4] for p in parts])),
        bwd_row=t(np.stack([pad_map(p[5], r_max) for p in parts])),
        bwd_tile=t(np.stack([pad_map(p[6], r_max) for p in parts])),
        row_block_off=tuple(int(x) for x in starts[:-1]),
        perm=t(perm),
        n_nodes=n, n_pad=n_pad, n_loc=n_loc, bm=bm, bn=bn,
        n_edges=nnz, n_shards=n_shards,
    )


def sharded_flash_attention(
    graph: PartitionedBCSR,
    fts: torch.Tensor,        # ([P,] N, K, D), replicated
    logit_dst: torch.Tensor,  # ([P,] N, K), replicated
    logit_src: torch.Tensor,  # ([P,] N, K), replicated
    *,
    mesh: Mesh | None = None,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
    towers: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """Distributed sibling of flash_gat_attention: the same math and
    kernels, one row strip per rank of the graph axis and K / heads heads
    per rank of the heads axis; global tensors in, global ([P,] N, K, D)
    out on every rank. ``mesh`` defaults to ``graph.mesh``, else every rank
    of the default process group on the graph axis; ``generator`` (on this
    rank's device) draws the dropout seeds as a device tensor, the same on
    every rank (the same generator seed and draw order; ``towers``: see
    ops/flash_gat.py:draw_path_seeds). Features f32 or bf16, as
    flash_gat_attention takes them: bf16 v streams to the kernels' bf16
    instantiations; logits, lse and the strips' partial sums stay f32 (the
    partial gradients of the features are summed over the graph axis in
    f32), and the output comes in ``fts.dtype`` (han_tpu computes in f32
    and casts back, flash_shard.py:189-192,241). Captured in a step where
    the mesh's axes hold no process group (train/graphed.py); eager with one
    (NCCL collectives inside a captured step are not ported)."""
    fg.check_args(slope, coef_dropout, generator, fts)
    mesh = mesh or graph.mesh or make_mesh(device=fts.device)
    ax_g, ax_h = mesh.graph, mesh.heads
    if graph.n_shards != ax_g.size:
        raise ValueError(f"the graph has {graph.n_shards} shards, the mesh's graph axis "
                         f"{ax_g.size} ranks")
    n, k, d = fts.shape[-3:]
    if k % ax_h.size:
        raise ValueError(f"{k} heads do not split over a heads axis of {ax_h.size}")
    n_paths = graph.n_paths
    lead = fts.shape[:-3]
    if lead != (() if n_paths is None else (n_paths,)):
        raise ValueError(f"features {tuple(fts.shape)} do not match a partition of "
                         f"{n_paths or 1} path(s)")
    k_loc = k // ax_h.size
    s = ax_g.rank
    # replicated inputs: each rank takes its heads (the backward gathers the
    # heads' gradients) and its strip's partial sums add over the graph axis
    dtype = fts.dtype
    fts = local_heads(sum_grads(fts.float(), ax_g), ax_h).to(dtype)
    logit_src = local_heads(sum_grads(logit_src.to(torch.float32), ax_g), ax_h, dim=-1)
    v = F.pad(fts.reshape(*lead, n, k_loc * d), (0, 0, 0, graph.n_pad - n)).contiguous()
    ls = F.pad(logit_src.transpose(-1, -2), (0, graph.n_pad - n)).contiguous()
    slots = graph.n_shards * graph.n_loc
    if n_paths is None:
        ld_all = logit_dst.new_zeros((slots, k)).index_copy(
            0, graph.perm, logit_dst.to(torch.float32))
    else:
        path_idx = torch.arange(n_paths, device=fts.device)[:, None]
        ld_all = logit_dst.new_zeros((n_paths, slots, k)).index_put(
            (path_idx, graph.perm), logit_dst.to(torch.float32))
    ld = local_heads(local_rows(ld_all, ax_g, dim=-2), ax_h, dim=-1)  # ([P,] n_loc, k_loc)
    meta = fg.FlashMeta(slope=float(slope), dropout_p=float(coef_dropout),
                        seed=fg.draw_path_seeds(coef_dropout, generator, n_paths or 1, towers),
                        row_block_offset=graph.strip_row_block_off(s),
                        head_offset=ax_h.rank * k_loc)
    out = fg._FlashGAT.apply(ld.transpose(-1, -2).contiguous(), ls, v, graph.strip(s), meta)
    out = gather_heads(out.view(*lead, graph.n_loc, k_loc, d), ax_h)
    out = gather_rows(out, ax_g, dim=-3)  # ([P,] S·n_loc, K, D)
    if n_paths is None:
        return out.index_select(0, graph.perm).to(dtype)
    return out[path_idx, graph.perm].to(dtype)
