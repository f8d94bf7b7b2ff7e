"""Block-sparse (BCSR / tile-list) graph container for the flash-GAT kernels
(port of han_tpu/graph/bcsr.py).

Only the **occupied (bm × bn) tiles** are stored, plus both traversal maps,
precomputed once on the host:

- ``tiles`` int8[T, bm, bn]: bitmap of each occupied tile, in row-major
  (row-block, col-block) order.
- forward map (row block → its occupied column tiles): drives the forward
  kernel, one thread block per (row block, head).
- backward map (column block → its occupied row tiles): drives the fused
  backward kernel, one thread block per (column block, head).

Map padding convention (as in han_tpu): steps past a block's count repeat
the last active entry (index 0 for empty blocks).

The container may also carry an edge view of the same graph (han_tpu's):
the edges sorted row-major as int32 ``edge_row_ptr`` [N + 1], ``edge_col``
and ``edge_row`` [E], 8 bytes an edge beside the tiles, so that
``impl="auto"`` can send a graph whose tiles are nearly empty to the csr
backend (:meth:`BCSRGraph.as_csr`, ops/attention.flash_csr_threshold)
without rebuilding it. :func:`bcsr_from_coo` keeps it unless asked not to;
a graph of a stack (:meth:`BCSRGraph.path`, graph/stack.py) has none.

Tile geometry is the port's own. The kernels (csrc/flash_gat.cu) give a
warp 16 rows (forward) or 32 columns (backward column sweep) of a tile and
the row sweep 4 threads a row, so bm and bn are multiples of 32 and at
most 256 (:func:`tile_error`). The TPU rules (bn a multiple of
128 and a whole number of 512-wide VMEM strips) do not apply here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from han_tpu_torch.graph.containers import CSRGraph, _to

_MAX_TILE = 256  # the largest bm and bn the flash kernels take

# 128 x 128: a forward block of 8 warps per (row block, head); at the DBLP
# shape (N = 4057, K = 8) that is 32 x 8 = 256 blocks, two per SM resident
# on 132 SMs. A starting point: no sweep on the H100 yet.
DEF_BM = 128
DEF_BN = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def tile_error(bm: int, bn: int) -> str | None:
    """Why the flash kernels cannot take (bm, bn) tiles, or None (the module
    docstring; csrc/flash_gat.cu:bad_geometry is the same rule on the card)."""
    for name, b in (("bm", bm), ("bn", bn)):
        if b % 32 or not 32 <= b <= _MAX_TILE:
            return f"{name} = {b}: the flash kernels need a multiple of 32 in [32, {_MAX_TILE}]"
    return None


def pick_tiles(n: int, bm: int = DEF_BM, bn: int = DEF_BN) -> tuple[int, int, int]:
    """Clamp requested tile sizes to the node count (rounded up to a warp)
    and return (bm, bn, n_pad) with n_pad divisible by both."""
    err = tile_error(bm, bn)
    if err:
        raise ValueError(err)
    cap = _round_up(max(n, 1), 32)
    bm, bn = min(bm, cap), min(bn, cap)
    return bm, bn, _round_up(n, math.lcm(bm, bn))


@dataclasses.dataclass(frozen=True)
class BCSRGraph:
    """Occupied-tile adjacency + precomputed forward/backward block maps."""

    tiles: torch.Tensor      # int8[T_pad, bm, bn]
    fwd_count: torch.Tensor  # int32[nb_r] occupied tiles in each row block
    fwd_col: torch.Tensor    # int32[nb_r, c_max] column-block id per step
    fwd_tile: torch.Tensor   # int32[nb_r, c_max] tile id per step
    bwd_count: torch.Tensor  # int32[nb_c]
    bwd_row: torch.Tensor    # int32[nb_c, r_max] row-block id per step
    bwd_tile: torch.Tensor   # int32[nb_c, r_max]
    n_nodes: int
    n_pad: int  # padded rows (and columns, on a square graph)
    bm: int
    bn: int
    n_edges: int
    n_tiles: int  # true occupied tile count (T_pad >= n_tiles)
    # optional edge view (module docstring): the edges sorted by (row, col)
    edge_row_ptr: torch.Tensor | None = None  # int32[N + 1]
    edge_col: torch.Tensor | None = None      # int32[E]
    edge_row: torch.Tensor | None = None      # int32[E]

    # the block counts come from the maps, so the same container holds a
    # rectangle: a graph-axis shard's strip (local rows × global columns)
    # or a ring cell (parallel/); on a square graph they are n_pad / bm
    # and n_pad / bn. A stack of P graphs (graph/stack.py) has a leading P
    # axis on every array.
    @property
    def nb_r(self) -> int:
        return int(self.fwd_count.shape[-1])

    @property
    def nb_c(self) -> int:
        return int(self.bwd_count.shape[-1])

    @property
    def c_max(self) -> int:
        return int(self.fwd_col.shape[-1])

    @property
    def r_max(self) -> int:
        return int(self.bwd_row.shape[-1])

    @property
    def n_paths(self) -> int | None:
        """P for a stack of P graphs, None for one graph."""
        return int(self.tiles.shape[0]) if self.tiles.dim() == 4 else None

    def path(self, p: int) -> "BCSRGraph":
        """Graph p of a stack (views; a stack carries no edge view)."""
        return dataclasses.replace(self, **{
            f: getattr(self, f)[p] for f in ("tiles", "fwd_count", "fwd_col", "fwd_tile",
                                            "bwd_count", "bwd_row", "bwd_tile")})

    def occupancy(self) -> float:
        """Fraction of the padded dense tile grid that is occupied."""
        return self.n_tiles / (self.nb_r * self.nb_c)

    def elems_per_edge(self) -> float:
        """Tile elements the flash kernels sweep per real edge: the
        quantity ``impl="auto"`` compares with the flash-vs-csr crossover
        (flash's work grows with the swept tile area, csr's with E)."""
        return self.n_tiles * self.bm * self.bn / max(self.n_edges, 1)

    def as_csr(self) -> CSRGraph:
        """The edge view as a CSRGraph for the csr backend (its index
        tensors int64, as CSRGraph holds them); raises ValueError when the
        graph was built without it (``keep_edges=False``)."""
        if self.edge_col is None:
            raise ValueError("this BCSRGraph was built with keep_edges=False; rebuild "
                             "with keep_edges=True for csr dispatch")
        return CSRGraph(row_ptr=self.edge_row_ptr.long(), col_idx=self.edge_col.long(),
                        row_idx=self.edge_row.long(), n_nodes=self.n_nodes,
                        n_edges=self.n_edges)

    def to(self, device) -> "BCSRGraph":
        return _to(self, device)


def _group_map(block_of_step: np.ndarray, other_of_step: np.ndarray,
               tile_of_step: np.ndarray, n_blocks: int):
    """Group (block → [(other_block, tile_id)]) into padded count/idx/tile
    arrays; padding repeats the last active entry (index 0 for empty rows)."""
    counts = np.bincount(block_of_step, minlength=n_blocks).astype(np.int32)
    width = max(int(counts.max()) if counts.size else 1, 1)
    other = np.zeros((n_blocks, width), np.int32)
    tile = np.zeros((n_blocks, width), np.int32)
    start = np.zeros(n_blocks + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    for b in range(n_blocks):
        lo, hi = start[b], start[b + 1]
        c = hi - lo
        if c:
            other[b, :c] = other_of_step[lo:hi]
            tile[b, :c] = tile_of_step[lo:hi]
            other[b, c:] = other[b, c - 1]
            tile[b, c:] = tile[b, c - 1]
    return counts, other, tile


def build_tile_arrays(rows: np.ndarray, cols: np.ndarray, nb_r: int,
                      nb_c: int, bm: int, bn: int):
    """Tile-list build (host, O(E)): COO edges over an (nb_r·bm × nb_c·bn)
    grid → (tiles, fwd_count, fwd_col, fwd_tile, bwd_count, bwd_row,
    bwd_tile, n_tiles) numpy arrays."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size == 0:
        return (np.zeros((1, bm, bn), np.int8),
                np.zeros(nb_r, np.int32), np.zeros((nb_r, 1), np.int32),
                np.zeros((nb_r, 1), np.int32),
                np.zeros(nb_c, np.int32), np.zeros((nb_c, 1), np.int32),
                np.zeros((nb_c, 1), np.int32), 0)

    rb = rows // bm
    cb = cols // bn
    key = rb * nb_c + cb
    # tile ids in row-major (rb, cb) order
    uniq, tid_of_edge = np.unique(key, return_inverse=True)
    n_tiles = int(uniq.shape[0])

    tiles = np.zeros((n_tiles, bm, bn), np.int8)
    tiles[tid_of_edge, rows % bm, cols % bn] = 1

    tile_rb = (uniq // nb_c).astype(np.int64)
    tile_cb = (uniq % nb_c).astype(np.int64)
    tids = np.arange(n_tiles, dtype=np.int32)

    # forward: uniq is sorted row-major, so each row block's tiles are
    # grouped with ascending column block
    fwd_count, fwd_col, fwd_tile = _group_map(tile_rb, tile_cb.astype(np.int32),
                                              tids, nb_r)
    order = np.lexsort((tile_rb, tile_cb))  # backward: column-major
    bwd_count, bwd_row, bwd_tile = _group_map(
        tile_cb[order], tile_rb[order].astype(np.int32), tids[order], nb_c)
    return (tiles, fwd_count, fwd_col, fwd_tile,
            bwd_count, bwd_row, bwd_tile, n_tiles)


def flat_fwd_map(fwd_count: np.ndarray, fwd_col: np.ndarray,
                 fwd_tile: np.ndarray):
    """Flatten the grouped forward map into one active-tile step list
    (row-block-major): 4 int32[T_steps] arrays (row, col, tile, active),
    with one inactive step per empty row block. This is han_tpu's sequential
    TPU grid; the CUDA forward walks the grouped map instead, one block per
    row block."""
    rows_l, cols_l, tiles_l, act_l = [], [], [], []
    for rb, c in enumerate(np.asarray(fwd_count)):
        c = int(c)
        if c:
            rows_l += [rb] * c
            cols_l += list(np.asarray(fwd_col[rb, :c]))
            tiles_l += list(np.asarray(fwd_tile[rb, :c]))
            act_l += [1] * c
        else:
            rows_l.append(rb)
            cols_l.append(0)
            tiles_l.append(0)
            act_l.append(0)
    mk = lambda x: np.asarray(x, np.int32)
    return (mk(rows_l), mk(cols_l), mk(tiles_l), mk(act_l))


def bcsr_from_coo(rows: np.ndarray, cols: np.ndarray, n: int, *,
                  bm: int = DEF_BM, bn: int = DEF_BN,
                  n_edges: int | None = None, keep_edges: bool = True) -> BCSRGraph:
    """Build a BCSRGraph (on the CPU) from COO edge lists (host-side, O(E)).
    ``keep_edges`` also stores the row-sorted edge view (+8 B an edge)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    bm, bn, n_pad = pick_tiles(n, bm, bn)
    nb_r, nb_c = n_pad // bm, n_pad // bn
    (tiles, fwd_count, fwd_col, fwd_tile, bwd_count, bwd_row, bwd_tile,
     n_tiles) = build_tile_arrays(rows, cols, nb_r, nb_c, bm, bn)
    t = torch.from_numpy
    view = {}
    if keep_edges:
        order = np.lexsort((cols, rows))  # row-major, as the segment ops expect
        counts = np.bincount(rows, minlength=n)
        view = {"edge_row": t(rows[order].astype(np.int32)),
                "edge_col": t(cols[order].astype(np.int32)),
                "edge_row_ptr": t(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))}
    return BCSRGraph(
        tiles=t(tiles),
        fwd_count=t(fwd_count), fwd_col=t(fwd_col), fwd_tile=t(fwd_tile),
        bwd_count=t(bwd_count), bwd_row=t(bwd_row), bwd_tile=t(bwd_tile),
        n_nodes=n, n_pad=n_pad, bm=bm, bn=bn,
        n_edges=int(rows.shape[0]) if n_edges is None else int(n_edges),
        n_tiles=n_tiles, **view,
    )


def bcsr_from_scipy(sp_mat: Any, *, bm: int = DEF_BM, bn: int = DEF_BN) -> BCSRGraph:
    m = sp_mat.tocoo().astype(bool)
    m.sum_duplicates()
    return bcsr_from_coo(m.row, m.col, m.shape[0], bm=bm, bn=bn)


def bcsr_from_dense(adj: np.ndarray, *, bm: int = DEF_BM,
                    bn: int = DEF_BN) -> BCSRGraph:
    a = np.asarray(adj) != 0
    rows, cols = np.nonzero(a)
    return bcsr_from_coo(rows, cols, a.shape[0], bm=bm, bn=bn)


def bcsr_from_csr(csr: CSRGraph, *, bm: int = DEF_BM, bn: int = DEF_BN) -> BCSRGraph:
    """The BCSRGraph of a CSRGraph's real edges (host-side)."""
    rows = csr.row_idx[: csr.n_edges].cpu().numpy()
    cols = csr.col_idx[: csr.n_edges].cpu().numpy()
    return bcsr_from_coo(rows, cols, csr.n_nodes, bm=bm, bn=bn)
