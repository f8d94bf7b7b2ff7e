"""Block-diagonal unions of small graphs: the inductive trainer's batch of
B graphs as ONE graph of B slots (train/inductive.py), so that a batch
goes through the model once, over a sparse attention path.

Each graph of a split is built once, on the host, into a piece of its
format and kept on the device; a batch's union is assembled from the
pieces there, by block and edge offsets whose values the host knows, so
no batch builds a graph on the host or reads a device value back. Graph
``g`` of a batch sits in slot ``i``: rows and columns ``i·S .. i·S + S − 1``
(S = ``slot_rows``, a whole number of tiles), with its own diagonal block.
No edge crosses slots, and the rows past a graph's nodes, and every row of
an empty slot (the zero-node graphs that pad a short last batch), have no
edges.

Every union of a split has the same shapes, so one captured step serves
all of its batches (train/graphed.py):

- ``bcsr``: the tiles padded to a static budget, the sum of the ``slots``
  largest pieces' tile counts plus one tile that holds no edge; the padding
  tiles are in no map, so no kernel sweeps them. The maps' widths are the
  split's widest piece's, padded by repeating the last entry as
  graph/bcsr.py pads them.
- ``csr``: the edges padded to the sum of the ``slots`` largest pieces'
  edge counts with the sentinel row and column (the union's row count),
  and ``n_edges`` is that budget: the pads point at the sentinel row,
  whose segment every consumer drops (graph/stack.py pads a stack so).

:func:`union_graph` rebuilds the container from a union's tensors and
shapes alone, as a captured step's body does from its static buffers.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from han_tpu_torch.graph.bcsr import DEF_BM, DEF_BN, BCSRGraph, build_tile_arrays, tile_error
from han_tpu_torch.graph.containers import CSRGraph

FORMATS = ("bcsr", "csr")


def tile_count(rows: np.ndarray, cols: np.ndarray, bm: int = DEF_BM, bn: int = DEF_BN) -> int:
    """Occupied (bm × bn) tiles of a graph's edges."""
    if rows.size == 0:
        return 0
    rb, cb = rows.astype(np.int64) // bm, cols.astype(np.int64) // bn
    return int(np.unique(rb * (int(cb.max()) + 1) + cb).shape[0])


def slot_rows(n_max: int, bm: int = DEF_BM, bn: int = DEF_BN) -> int:
    """The rows of a slot: ``n_max`` rounded up to a whole number of tiles."""
    m = math.lcm(bm, bn)
    return max(-(-n_max // m), 1) * m


def _widen(a: np.ndarray, width: int) -> np.ndarray:
    """A map padded to ``width`` columns by repeating its last column."""
    return np.pad(a, ((0, 0), (0, width - a.shape[1])), mode="edge")


class GraphUnion:
    """The graphs ``edges`` ((rows, cols) local indices each) of one split
    as pieces of format ``fmt`` on ``device``, and the union of any
    ``slots`` of them (the module docstring). ``n_tiles``: the graphs'
    tile counts (:func:`tile_count`), where the caller has them."""

    def __init__(self, edges: Sequence[tuple[np.ndarray, np.ndarray]], *, slots: int,
                 rows: int, fmt: str, bm: int = DEF_BM, bn: int = DEF_BN,
                 device: torch.device | str = "cpu", n_tiles: np.ndarray | None = None):
        if fmt not in FORMATS:
            raise ValueError(f"graph format {fmt!r}: a union is bcsr or csr")
        err = tile_error(bm, bn)
        if err:
            raise ValueError(err)
        if rows % math.lcm(bm, bn):
            raise ValueError(f"slot rows {rows} are not a whole number of {bm} x {bn} tiles")
        self.fmt, self.slots, self.rows, self.bm, self.bn = fmt, slots, rows, bm, bn
        self.device = torch.device(device)
        self.n_edges = np.array([r.shape[0] for r, _ in edges], np.int64)
        self.n_tiles = (np.array([tile_count(r, c, bm, bn) for r, c in edges], np.int64)
                        if n_tiles is None else np.asarray(n_tiles, np.int64))
        top = lambda counts: int(np.sort(counts)[::-1][:slots].sum())
        if fmt == "bcsr":
            self._build_bcsr(edges)
            self.budget = top(self.n_tiles) + 1
        else:
            self._build_csr(edges)
            self.budget = max(top(self.n_edges), 1)

    # -- the pieces ----------------------------------------------------------

    def _build_bcsr(self, edges) -> None:
        nb_r, nb_c = self.rows // self.bm, self.rows // self.bn
        built = [build_tile_arrays(r, c, nb_r, nb_c, self.bm, self.bn) for r, c in edges]
        c_max = max(b[2].shape[1] for b in built)
        r_max = max(b[5].shape[1] for b in built)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        # a piece's tiles are its first n_tiles (build_tile_arrays gives an
        # empty graph one blank tile)
        self.tiles = t(np.concatenate([b[0][:n] for b, n in zip(built, self.n_tiles)]
                                      or [np.zeros((0, self.bm, self.bn), np.int8)]))
        self.tile_off = np.concatenate([[0], np.cumsum(self.n_tiles)])
        self.maps = {
            "fwd_count": t(np.stack([b[1] for b in built])),
            "fwd_col": t(np.stack([_widen(b[2], c_max) for b in built])),
            "fwd_tile": t(np.stack([_widen(b[3], c_max) for b in built])),
            "bwd_count": t(np.stack([b[4] for b in built])),
            "bwd_row": t(np.stack([_widen(b[5], r_max) for b in built])),
            "bwd_tile": t(np.stack([_widen(b[6], r_max) for b in built])),
        }

    def _build_csr(self, edges) -> None:
        cols_l, rows_l, ptrs = [], [], []
        for r, c in edges:
            order = np.lexsort((c, r))  # row-major, as the segment ops expect
            rows_l.append(r[order].astype(np.int64))
            cols_l.append(c[order].astype(np.int64))
            ptr = np.zeros(self.rows + 1, np.int64)
            np.cumsum(np.bincount(r, minlength=self.rows), out=ptr[1:])
            ptrs.append(ptr)
        t = lambda a: torch.from_numpy(a).to(self.device)
        self.edge_row = t(np.concatenate(rows_l or [np.zeros(0, np.int64)]))
        self.edge_col = t(np.concatenate(cols_l or [np.zeros(0, np.int64)]))
        self.row_ptr = t(np.stack(ptrs))
        self.edge_off = np.concatenate([[0], np.cumsum(self.n_edges)])

    # -- a batch's union -----------------------------------------------------

    def counts(self, sel: Sequence[int]) -> tuple[int, int]:
        """(tile elements of the union's BCSR, real edges) of the graphs
        ``sel`` (−1: an empty slot)."""
        real = [g for g in sel if g >= 0]
        return (int(self.n_tiles[real].sum()) * self.bm * self.bn,
                int(self.n_edges[real].sum()))

    def union(self, sel: Sequence[int]) -> tuple[torch.Tensor, ...]:
        """The tensors of the union of the pieces ``sel`` in slots 0..len − 1
        (−1 an empty slot; ``len(sel)`` is ``slots``), on the device."""
        if len(sel) != self.slots:
            raise ValueError(f"a union of {self.slots} slots, got {len(sel)} graphs")
        return self._bcsr(sel) if self.fmt == "bcsr" else self._csr(sel)

    def _bcsr(self, sel) -> tuple[torch.Tensor, ...]:
        # what an entry of each map gains in slot i: a block index the
        # slot's first block, a tile id the tiles of the slots before it,
        # a count nothing
        blocks = {"fwd_col": self.rows // self.bn, "bwd_row": self.rows // self.bm}
        parts, maps, base = [], {k: [] for k in self.maps}, 0
        for i, g in enumerate(sel):
            for k, m in self.maps.items():
                if g < 0:
                    maps[k].append(torch.zeros_like(m[0]))
                else:
                    shift = i * blocks[k] if k in blocks else base if k.endswith("tile") else 0
                    maps[k].append(m[g] + shift if shift else m[g])
            if g >= 0:
                lo, hi = int(self.tile_off[g]), int(self.tile_off[g + 1])
                parts.append(self.tiles[lo:hi])
                base += hi - lo
        parts.append(self.tiles.new_zeros((self.budget - base, self.bm, self.bn)))
        return (torch.cat(parts), *(torch.cat(maps[k]) for k in self.maps))

    def _csr(self, sel) -> tuple[torch.Tensor, ...]:
        n = self.slots * self.rows
        ptrs, rows, cols, base = [], [], [], 0
        for i, g in enumerate(sel):
            if g < 0:
                ptrs.append(torch.full((self.rows,), base, dtype=torch.int64,
                                       device=self.device))
                continue
            lo, hi = int(self.edge_off[g]), int(self.edge_off[g + 1])
            ptrs.append(self.row_ptr[g, :-1] + base)
            rows.append(self.edge_row[lo:hi] + i * self.rows)
            cols.append(self.edge_col[lo:hi] + i * self.rows)
            base += hi - lo
        ptrs.append(torch.full((1,), base, dtype=torch.int64, device=self.device))
        pad = torch.full((self.budget - base,), n, dtype=torch.int64, device=self.device)
        return torch.cat(ptrs), torch.cat([*rows, pad]), torch.cat([*cols, pad])


def union_graph(tensors: Sequence[torch.Tensor], fmt: str, bm: int = DEF_BM,
                bn: int = DEF_BN) -> BCSRGraph | CSRGraph:
    """The container of a union's tensors (:meth:`GraphUnion.union`), its
    sizes read from their shapes alone."""
    if fmt == "csr":
        row_ptr, row_idx, col_idx = tensors
        return CSRGraph(row_ptr=row_ptr, col_idx=col_idx, row_idx=row_idx,
                        n_nodes=int(row_ptr.shape[0]) - 1, n_edges=int(col_idx.shape[0]))
    tiles, fwd_count, fwd_col, fwd_tile, bwd_count, bwd_row, bwd_tile = tensors
    n = int(fwd_count.shape[0]) * bm
    return BCSRGraph(tiles=tiles, fwd_count=fwd_count, fwd_col=fwd_col, fwd_tile=fwd_tile,
                     bwd_count=bwd_count, bwd_row=bwd_row, bwd_tile=bwd_tile, n_nodes=n,
                     n_pad=n, bm=bm, bn=bn, n_edges=0, n_tiles=int(tiles.shape[0]))
