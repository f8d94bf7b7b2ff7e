"""Stack P per-meta-path graph containers into ONE container with a leading
P axis on every array (port of han_tpu/graph/stack.py): the input of HAN's
meta-path towers run together (``HAN(vmap_towers=True)``, nn/models.py),
which the towers' independence until the semantic fusion allows
(reference models/gat.py:39-58).

Containers of one type share their scalar fields after padding; the
per-graph counts that must survive live in arrays (the BCSR maps'
counts), so the padding (zero tiles, repeated map columns, sentinel edges)
never changes a result:

- BCSRGraph: tiles zero-padded to the largest tile list, the maps widened
  by repeating their last column; one launch of each flash kernel then
  sweeps all P graphs (ops/flash_gat.py).
- PartitionedBCSR: per-shard arrays gain the P axis, (P, S, ...); each
  meta-path's strips are edge-balanced on their own, so the row strips
  widen to the largest ``n_loc`` (zero-count row blocks) and ``perm`` is
  remapped into the widened slots; the strips' row-block offsets are kept
  on the stack's device too, as the kernels read them.
- CSRGraph: edge arrays padded with the sentinel ``n_nodes`` to the
  longest; ``n_edges`` becomes the largest (the pads beyond a graph's own
  count point at the sentinel row, which every consumer drops).
- EllGraph: neighbor lists padded to the largest fanout with the sentinel.
- DenseGraph: the adjacencies stacked.

:func:`path` and :func:`paths` take one graph, or a run of them, back out
of a stack (views).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from han_tpu_torch.graph.bcsr import BCSRGraph
from han_tpu_torch.graph.containers import CSRGraph, DenseGraph, EllGraph
from han_tpu_torch.parallel.flash_shard import PartitionedBCSR


def _pad_axis(a: torch.Tensor, width: int, axis: int, fill) -> torch.Tensor:
    pad = width - a.shape[axis]
    if pad == 0:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    return torch.cat([a, a.new_full(shape, fill)], dim=axis)


def _pad_map(a: torch.Tensor, width: int) -> torch.Tensor:
    """Widen a block map by repeating its last column (the map padding
    convention)."""
    if a.shape[-1] >= width:
        return a
    return torch.cat([a, a[..., -1:].expand(*a.shape[:-1], width - a.shape[-1])], dim=-1)


def stack_graphs(graphs: Sequence):
    """[container, ...] (one type, one node set) → one container whose
    arrays carry a leading P axis; scalar fields unified."""
    kinds = {type(g) for g in graphs}
    if len(kinds) != 1:
        raise TypeError(f"cannot stack mixed container types {kinds}")
    g0 = graphs[0]
    if any(g.n_nodes != g0.n_nodes for g in graphs):
        raise ValueError("stacked meta-path graphs must share the node set")
    stack = torch.stack

    if isinstance(g0, DenseGraph):
        return DenseGraph(adj=stack([g.adj for g in graphs]), n_nodes=g0.n_nodes)

    if isinstance(g0, BCSRGraph):
        if any((g.bm, g.bn, g.n_pad) != (g0.bm, g0.bn, g0.n_pad) for g in graphs):
            raise ValueError("stacked BCSR graphs must share tile geometry")
        t_max = max(max(g.tiles.shape[0] for g in graphs), 1)
        c_max = max(g.c_max for g in graphs)
        r_max = max(g.r_max for g in graphs)
        return BCSRGraph(
            tiles=stack([_pad_axis(g.tiles, t_max, 0, 0) for g in graphs]),
            fwd_count=stack([g.fwd_count for g in graphs]),
            fwd_col=stack([_pad_map(g.fwd_col, c_max) for g in graphs]),
            fwd_tile=stack([_pad_map(g.fwd_tile, c_max) for g in graphs]),
            bwd_count=stack([g.bwd_count for g in graphs]),
            bwd_row=stack([_pad_map(g.bwd_row, r_max) for g in graphs]),
            bwd_tile=stack([_pad_map(g.bwd_tile, r_max) for g in graphs]),
            n_nodes=g0.n_nodes, n_pad=g0.n_pad, bm=g0.bm, bn=g0.bn,
            n_edges=max(g.n_edges for g in graphs), n_tiles=t_max)

    if isinstance(g0, PartitionedBCSR):
        if any((g.bm, g.bn, g.n_pad, g.n_shards) != (g0.bm, g0.bn, g0.n_pad, g0.n_shards)
               for g in graphs):
            raise ValueError("stacked PartitionedBCSR graphs must share tile geometry "
                             "and shard count")
        n_loc = max(g.n_loc for g in graphs)
        nb_r_loc = n_loc // g0.bm
        t_max = max(g.tiles.shape[1] for g in graphs)
        c_max = max(g.fwd_col.shape[2] for g in graphs)
        r_max = max(g.bwd_row.shape[2] for g in graphs)

        def widen_rows(a):
            # (S, nb_r_old[, w]) → (S, nb_r_loc[, w]), repeating the last row
            # block (its count is 0, so it sweeps nothing)
            pad = nb_r_loc - a.shape[1]
            return a if pad == 0 else torch.cat([a] + [a[:, -1:]] * pad, dim=1)

        def fixed_perm(g):
            return g.perm + (g.perm // g.n_loc) * (n_loc - g.n_loc)

        return PartitionedBCSR(
            tiles=stack([_pad_axis(g.tiles, t_max, 1, 0) for g in graphs]),
            fwd_count=stack([_pad_axis(g.fwd_count, nb_r_loc, 1, 0) for g in graphs]),
            fwd_col=stack([widen_rows(_pad_map(g.fwd_col, c_max)) for g in graphs]),
            fwd_tile=stack([widen_rows(_pad_map(g.fwd_tile, c_max)) for g in graphs]),
            bwd_count=stack([g.bwd_count for g in graphs]),
            bwd_row=stack([_pad_map(g.bwd_row, r_max) for g in graphs]),
            bwd_tile=stack([_pad_map(g.bwd_tile, r_max) for g in graphs]),
            row_block_off=tuple(g.row_block_off for g in graphs),
            perm=stack([fixed_perm(g) for g in graphs]),
            n_nodes=g0.n_nodes, n_pad=g0.n_pad, n_loc=n_loc, bm=g0.bm, bn=g0.bn,
            n_edges=max(g.n_edges for g in graphs), n_shards=g0.n_shards, mesh=g0.mesh,
            path_row_block_off=torch.tensor([g.row_block_off for g in graphs],
                                            dtype=torch.int32, device=g0.perm.device))

    if isinstance(g0, CSRGraph):
        e_pad = max(g.e_pad for g in graphs)
        n = g0.n_nodes
        return CSRGraph(
            row_ptr=stack([g.row_ptr for g in graphs]),
            col_idx=stack([_pad_axis(g.col_idx, e_pad, 0, n) for g in graphs]),
            row_idx=stack([_pad_axis(g.row_idx, e_pad, 0, n) for g in graphs]),
            n_nodes=n, n_edges=max(g.n_edges for g in graphs))

    if isinstance(g0, EllGraph):
        f = max(g.fanout for g in graphs)
        n = g0.n_nodes
        return EllGraph(nbr=stack([_pad_axis(g.nbr, f, 1, n) for g in graphs]),
                        deg=stack([g.deg for g in graphs]),
                        n_nodes=n, n_edges=max(g.n_edges for g in graphs))

    raise TypeError(f"unsupported container {type(g0)}")


def _index(graph, key):
    """Every array field (and a stacked partition's per-path offsets)
    indexed on the P axis by ``key``."""
    fields = {}
    for f in dataclasses.fields(graph):
        val = getattr(graph, f.name)
        if isinstance(val, torch.Tensor) or f.name == "row_block_off":
            fields[f.name] = val[key]
    return dataclasses.replace(graph, **fields)


def path(graph, p: int):
    """Graph p of a stack."""
    return _index(graph, p)


def paths(graph, lo: int, hi: int):
    """Graphs lo..hi−1 of a stack, as a stack."""
    return _index(graph, slice(lo, hi))
