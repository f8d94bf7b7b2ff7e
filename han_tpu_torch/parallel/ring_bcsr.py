"""Ring rotation over BCSR tiles: distributed flash-GAT whose features stay
sharded (port of han_tpu/parallel/ring_bcsr.py).

- The global tile grid is 2-D partitioned: rank s owns the row strip
  [s·n_loc, (s+1)·n_loc) of destination rows and all its occupied tiles.
- Node features and logit_src enter attention in uniform n_loc blocks and
  rotate around the ring (``dist.batch_isend_irecv`` to rank (s+1) mod S),
  never gathered: a rank holds one resident block plus one rotation
  buffer.
- At ring step t, rank s sweeps the occupied tiles of cell
  (row strip s × column strip (s−t) mod S) with the same CUDA forward
  kernel as one device, at ``col_block_offset`` = the strip's first global
  column block, so the dropout keys are global; the steps merge by
  log-sum-exp:
      LSE' = logaddexp(LSE, lse_t)
      OUT' = OUT·e^{LSE−LSE'} + out_t·e^{lse_t−LSE'}
- The backward re-rotates the blocks on the same schedule and feeds every
  step the GLOBAL lse and delta = g·out, so each cell yields exactly its
  edges' part of the global gradients: dld accumulates in place; dv and
  dls accumulate into blocks that rotate with the data, one step behind it
  (each step's part is merged and sent at the start of the next step, so
  the rotation never waits on the step's kernel), and come home with one
  last rotation after the loop.

On a heads axis each rank runs its K / heads heads at ``head_offset`` =
heads-rank × K / heads (han_tpu's ``h_off``, ring_bcsr.py:377-378), so the
masks are the one-device run's head for head, and the outputs gather over
the heads axis.

Each step posts the next step's sends and receives before it launches its
kernel and waits on them after, as han_tpu issues the rotation before the
kernel. Unlike han_tpu's uniform ``fori_loop`` body, the forward skips the
rotation after its last step and the backward the accumulators' empty
first one: the result is the same with fewer messages. The model outside
attention runs replicated, so the blocks come from (and the output goes
back to) global tensors through ``local_rows`` and ``gather_rows``
(parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from han_tpu_torch.graph.bcsr import DEF_BM, DEF_BN, BCSRGraph, build_tile_arrays, pick_tiles
from han_tpu_torch.graph.containers import MASK_VALUE, _to
from han_tpu_torch.ops import flash_gat as fg
from han_tpu_torch.parallel.mesh import (Axis, Mesh, gather_heads, gather_rows,
                                         local_heads, local_rows, make_mesh, ring_shift,
                                         wait)


@dataclasses.dataclass(frozen=True)
class RingBCSR:
    """2-D (row strip × column strip) tile partition, maps pre-rolled by
    ring step: index [s, t] holds the cell (s, (s−t) mod S).

    tiles:      int8[S, T_max, bm, bn]: shard s's occupied tiles (all
                column strips), ids local to the shard buffer
    fwd_count:  int32[S, S, nb_r_loc]
    fwd_col:    int32[S, S, nb_r_loc, c_max]: column-block ids LOCAL to
                the step's column strip (0..nb_c_loc−1)
    fwd_tile:   int32[S, S, nb_r_loc, c_max]
    bwd_count:  int32[S, S, nb_c_loc]
    bwd_row:    int32[S, S, nb_c_loc, r_max]
    bwd_tile:   int32[S, S, nb_c_loc, r_max]
    cs_of_step: [s][t] global column-strip id (host ints)
    mesh:       the mesh attention runs on (set by the trainer); None:
                every rank of the default process group
    """

    tiles: torch.Tensor
    fwd_count: torch.Tensor
    fwd_col: torch.Tensor
    fwd_tile: torch.Tensor
    bwd_count: torch.Tensor
    bwd_row: torch.Tensor
    bwd_tile: torch.Tensor
    cs_of_step: tuple[tuple[int, ...], ...]
    n_nodes: int
    n_pad: int
    n_loc: int
    bm: int
    bn: int
    n_edges: int
    n_shards: int
    mesh: Mesh | None = None

    @property
    def nb_r_loc(self) -> int:
        return self.n_loc // self.bm

    @property
    def nb_c_loc(self) -> int:
        return self.n_loc // self.bn

    def cell(self, s: int, t: int) -> BCSRGraph:
        """Rank s's cell at ring step t as a BCSRGraph over n_loc × n_loc
        (views of the stacked tensors)."""
        return BCSRGraph(
            tiles=self.tiles[s], fwd_count=self.fwd_count[s, t],
            fwd_col=self.fwd_col[s, t], fwd_tile=self.fwd_tile[s, t],
            bwd_count=self.bwd_count[s, t], bwd_row=self.bwd_row[s, t],
            bwd_tile=self.bwd_tile[s, t], n_nodes=self.n_loc, n_pad=self.n_loc,
            bm=self.bm, bn=self.bn, n_edges=0, n_tiles=int(self.tiles.shape[1]))

    def step_meta(self, meta: fg.FlashMeta, s: int, t: int) -> fg.FlashMeta:
        """The kernels' meta at step t: the column-block offset of the
        step's strip (han_tpu's meta[3] = cs · nb_c_loc)."""
        return dataclasses.replace(
            meta, col_block_offset=self.cs_of_step[s][t] * self.nb_c_loc)

    def to(self, device) -> "RingBCSR":
        return _to(self, device)


def ring_partition_bcsr(adj, n_shards: int, *, bm: int = DEF_BM,
                        bn: int = DEF_BN) -> RingBCSR:
    """Host-side 2-D tile partitioner: scipy adjacency → RingBCSR (numpy
    copy of han_tpu's, with the port's tile rules).

    Node blocks are UNIFORM (they rotate), n_loc a common multiple of
    (bm, bn); shard s's tile buffer concatenates its per-column-strip tile
    lists (one zero dummy tile per empty cell keeps map padding valid)."""
    m = adj.tocoo().astype(bool)
    m.sum_duplicates()
    rows = np.asarray(m.row, np.int64)
    cols = np.asarray(m.col, np.int64)
    n = m.shape[0]
    s_n = n_shards

    bm, bn, _ = pick_tiles(n, bm, bn)
    blk = math.lcm(bm, bn)
    n_loc = ((-(-n // s_n) + blk - 1) // blk) * blk
    n_pad = s_n * n_loc
    nb_r_loc, nb_c_loc = n_loc // bm, n_loc // bn

    cells = [[None] * s_n for _ in range(s_n)]  # [s][cs]
    tile_bufs = []
    for s in range(s_n):
        sel = (rows // n_loc) == s
        r_loc = rows[sel] - s * n_loc
        c_glb = cols[sel]
        buf, off = [], 0
        for cs in range(s_n):
            sel2 = (c_glb // n_loc) == cs
            (tiles, fc, fcol, ftl, bc, brow, btl, _nt) = build_tile_arrays(
                r_loc[sel2], c_glb[sel2] - cs * n_loc,
                nb_r_loc, nb_c_loc, bm, bn)
            cells[s][cs] = (fc, fcol, ftl + off, bc, brow, btl + off)
            buf.append(tiles)
            off += tiles.shape[0]
        tile_bufs.append(np.concatenate(buf, axis=0))

    t_max = max(b.shape[0] for b in tile_bufs)
    c_max = max(c[1].shape[1] for row in cells for c in row)
    r_max = max(c[4].shape[1] for row in cells for c in row)

    def pad_w(a, w):
        return (np.concatenate([a] + [a[:, -1:]] * (w - a.shape[1]), axis=1)
                if a.shape[1] < w else a)

    # pre-roll by ring step: index [s, t] = cell (s, (s - t) % S)
    fwd_count = np.zeros((s_n, s_n, nb_r_loc), np.int32)
    fwd_col = np.zeros((s_n, s_n, nb_r_loc, c_max), np.int32)
    fwd_tile = np.zeros((s_n, s_n, nb_r_loc, c_max), np.int32)
    bwd_count = np.zeros((s_n, s_n, nb_c_loc), np.int32)
    bwd_row = np.zeros((s_n, s_n, nb_c_loc, r_max), np.int32)
    bwd_tile = np.zeros((s_n, s_n, nb_c_loc, r_max), np.int32)
    cs_of_step = np.zeros((s_n, s_n), np.int32)
    for s in range(s_n):
        for t in range(s_n):
            cs = (s - t) % s_n
            fc, fcol, ftl, bc, brow, btl = cells[s][cs]
            fwd_count[s, t] = fc
            fwd_col[s, t] = pad_w(fcol, c_max)
            fwd_tile[s, t] = pad_w(ftl, c_max)
            bwd_count[s, t] = bc
            bwd_row[s, t] = pad_w(brow, r_max)
            bwd_tile[s, t] = pad_w(btl, r_max)
            cs_of_step[s, t] = cs

    tiles = np.stack([np.pad(b, ((0, t_max - b.shape[0]), (0, 0), (0, 0)))
                      for b in tile_bufs])
    t = torch.from_numpy
    return RingBCSR(
        tiles=t(tiles),
        fwd_count=t(fwd_count), fwd_col=t(fwd_col), fwd_tile=t(fwd_tile),
        bwd_count=t(bwd_count), bwd_row=t(bwd_row), bwd_tile=t(bwd_tile),
        cs_of_step=tuple(tuple(int(c) for c in row) for row in cs_of_step),
        n_nodes=n, n_pad=n_pad, n_loc=n_loc, bm=bm, bn=bn,
        n_edges=int(rows.shape[0]), n_shards=s_n,
    )


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, K·D) rows scaled per head by w (K, n)."""
    n, kd = x.shape
    k = w.shape[0]
    return (x.view(n, k, kd // k) * w.T[:, :, None]).view(n, kd)


class _RingFlash(torch.autograd.Function):
    """This rank's blocks (ld (K, n_loc), ls (K, n_loc), v (n_loc, K·D)) →
    its rows' out (n_loc, K·D), over the S ring steps of the graph axis
    ``ring``."""

    @staticmethod
    def forward(ctx, ld, ls, v, graph: RingBCSR, meta: fg.FlashMeta, ring: Axis):
        s, n_s = ring.rank, ring.size
        k, n_loc = ld.shape
        out = ld.new_zeros((n_loc, v.shape[1]))  # f32, whatever v's type
        lse = ld.new_full((k, n_loc), MASK_VALUE)
        vb, lb = v, ls
        for t in range(n_s):
            # the next step's blocks fly while this step's kernel runs
            nxt, works = ring_shift([vb, lb] if t < n_s - 1 else [], ring)
            o_t, lse_t = fg.flash_fwd(graph.cell(s, t), ld, lb, vb,
                                      graph.step_meta(meta, s, t))
            new_lse = torch.logaddexp(lse, lse_t)
            out = _heads(out, torch.exp(lse - new_lse)) + _heads(o_t, torch.exp(lse_t - new_lse))
            lse = new_lse
            wait(works)
            if works:
                vb, lb = nxt
        ctx.save_for_backward(ld, ls, v, out, lse)
        ctx.graph, ctx.meta, ctx.ring = graph, meta, ring
        return out

    @staticmethod
    def backward(ctx, g):
        ld, ls, v, out, lse = ctx.saved_tensors
        graph, meta, ring = ctx.graph, ctx.meta, ctx.ring
        s, n_s = ring.rank, ring.size
        k, n_loc = ld.shape
        g = g.contiguous()
        delta = fg.head_delta(g, out, k)
        dld = torch.zeros_like(ld)
        # rotate with the data, summed in f32 whatever v's type
        dv, dls = torch.zeros_like(v, dtype=ld.dtype), torch.zeros_like(ls)
        pv = pl = None  # the previous step's part, merged one step late
        vb, lb = v, ls
        for t in range(n_s):
            send = [vb, lb] if t < n_s - 1 else []
            if t > 0:
                send += [dv + pv, dls + pl]
            recv, works = ring_shift(send, ring)
            dld_t, dls_t, dv_t = fg.flash_bwd(graph.cell(s, t), ld, lb, vb, g, lse,
                                              delta, graph.step_meta(meta, s, t))
            dld += dld_t
            wait(works)
            if t < n_s - 1 and works:
                vb, lb = recv[:2]
            if t > 0 and works:
                dv, dls = recv[-2:]
            pv, pl = dv_t, dls_t
        (dv, dls), works = ring_shift([dv + pv, dls + pl], ring)  # the last hop home
        wait(works)
        return dld, dls, dv.to(v.dtype), None, None, None


def ring_flash_attention(
    graph: RingBCSR,
    fts: torch.Tensor,        # (N, K, D)
    logit_dst: torch.Tensor,  # (N, K)
    logit_src: torch.Tensor,  # (N, K)
    *,
    mesh: Mesh | None = None,
    slope: float = 0.2,
    coef_dropout: float = 0.0,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """Distributed flash attention with O(N/S) feature blocks per rank in
    attention: the same math and masks as flash_gat_attention. Global
    tensors in, global (N, K, D) out on every rank; ``mesh`` defaults to
    ``graph.mesh``, else every rank of the default process group on the
    graph axis. ``generator`` (on this rank's device) draws the dropout
    seed as a device tensor, the same on every rank. Features f32 or bf16,
    as flash_gat_attention takes them: bf16 v blocks rotate and stream to
    the kernels' bf16 instantiations; logits, lse, delta, the merge of the
    steps' partial outputs and the rotating gradients stay f32, and the
    output comes in ``fts.dtype`` (han_tpu computes in f32 and casts back,
    ring_bcsr.py:360-362,408). Captured in a step where the mesh's axes
    hold no process group (train/graphed.py); eager with one (NCCL
    collectives inside a captured step are not ported)."""
    fg.check_args(slope, coef_dropout, generator, fts)
    mesh = mesh or graph.mesh or make_mesh(device=fts.device)
    ax_g, ax_h = mesh.graph, mesh.heads
    if graph.n_shards != ax_g.size:
        raise ValueError(f"the graph has {graph.n_shards} shards, the mesh's graph axis "
                         f"{ax_g.size} ranks")
    n, k, d = fts.shape
    if k % ax_h.size:
        raise ValueError(f"{k} heads do not split over a heads axis of {ax_h.size}")
    k_loc = k // ax_h.size
    pad = graph.n_pad - n

    def block(x):  # this rank's rows and heads, the backward gathering both
        return local_heads(local_rows(F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad)), ax_g),
                           ax_h, dim=1)

    v = block(fts.float()).reshape(graph.n_loc, k_loc * d).to(fts.dtype)
    ld = block(logit_dst.to(torch.float32))
    ls = block(logit_src.to(torch.float32))
    meta = fg.FlashMeta(slope=float(slope), dropout_p=float(coef_dropout),
                        seed=fg.draw_seed(coef_dropout, generator),
                        row_block_offset=ax_g.rank * graph.nb_r_loc,
                        head_offset=ax_h.rank * k_loc)
    out = _RingFlash.apply(ld.T.contiguous(), ls.T.contiguous(), v, graph, meta, ax_g)
    out = gather_heads(out.view(graph.n_loc, k_loc, d), ax_h)
    return gather_rows(out, ax_g)[:n].to(fts.dtype)
