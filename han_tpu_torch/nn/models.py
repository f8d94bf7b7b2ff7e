"""The model family (port of han_tpu/nn/models.py:31-230):

- :class:`GAT` ↔ reference ``GAT.inference`` (gat.py:8-32): multi-head
  concat layers, then an output layer whose heads project to n_classes and
  are averaged.
- :class:`HAN` ↔ reference ``HeteGAT_multi.inference`` (gat.py:34-77):
  independent GAT towers per meta-path, semantic attention fusion, and a
  classifier that averages n_heads[-1] Dense layers.
- :class:`HANShared` ↔ reference ``HeteGAT.inference`` (gat.py:132-203):
  one feature input shared by the towers, and with ``return_coefs`` each
  tower's first-layer attention coefficients, averaged over heads.

``HAN(vmap_towers=True)`` is han_tpu's meta-path (expert) parallelism
(han_tpu/nn/models.py:135-166): the P towers' parameters are stacked on a
leading P axis (flax's vmapped ``towers`` subtree) and run together over a
stack of P graphs (graph/stack.py) and features (P, N, F), so each flash
kernel is one launch for the P towers; each tower draws its own dropout
masks and flash seed. On a mesh with an mp axis each rank runs its P / mp
towers (``mesh``): it slices its towers' parameters, the embeddings are
all-gathered over the mp axis for the semantic fusion, and since the model
is replicated, the towers' parameter gradients (zero outside a rank's
towers) are summed over the mp axis, so every rank's optimizer sees the
whole gradient.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from han_tpu_torch.graph.stack import paths
from han_tpu_torch.nn.layers import (DropoutGenerators, GATConv,
                                     SemanticAttention, glorot_uniform_)
from han_tpu_torch.ops.attention import Impl
from han_tpu_torch.parallel.mesh import Mesh, gather_rows, sum_grads


class Dense(nn.Module):
    """flax ``nn.Dense`` with its (in, out) kernel layout, glorot-uniform
    kernel and zero bias."""

    def __init__(self, in_dim: int, out_dim: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel = nn.Parameter(glorot_uniform_(torch.empty(in_dim, out_dim), generator))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class _MetapathTower(nn.Module):
    """One per-meta-path GAT stack: n_heads[0] concat heads at hid_units[0]
    without a residual, then the deeper layers with ``residual`` (reference
    gat.py:14-23,42-57)."""

    def __init__(self, in_dim: int, hid_units: Sequence[int],
                 n_heads: Sequence[int], *, activation: Callable,
                 residual: bool, attn_drop: float, ffd_drop: float,
                 impl: Impl, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, n_paths: int | None = None):
        super().__init__()
        common = dict(activation=activation, attn_drop=attn_drop,
                      ffd_drop=ffd_drop, impl=impl, dtype=dtype, generator=generator)
        if n_paths is not None:  # P stacked towers (GATConv's n_paths)
            common["n_paths"] = n_paths
        layers = [GATConv(in_dim, hid_units[0], n_heads[0], residual=False, **common)]
        for i in range(1, len(hid_units)):
            layers.append(GATConv(hid_units[i - 1] * n_heads[i - 1], hid_units[i],
                                  n_heads[i], residual=residual, **common))
        self.layers = nn.ModuleList(layers)

    def forward(self, graph, x: torch.Tensor, *, deterministic: bool = True,
                rngs: DropoutGenerators | None = None, return_coefs: bool = False,
                towers: tuple[int, int, int] | None = None):
        """The tower's output; with ``return_coefs`` also the first layer's
        coefficients averaged over heads (reference gat.py:172-173): dense
        (K, N, N) → (N, N), csr (E_pad, K) → (E_pad,), aligned with the
        graph's row_idx/col_idx. ``towers``: see ``GATConv.forward``."""
        h, coefs = x, None
        for i, layer in enumerate(self.layers):
            if return_coefs and i == 0:
                h, coefs = layer(graph, h, deterministic=deterministic, rngs=rngs,
                                 return_coefs=True)
                coefs = coefs.mean(dim=0) if coefs.dim() == 3 else coefs.mean(dim=-1)
            else:
                h = layer(graph, h, deterministic=deterministic, rngs=rngs, towers=towers)
        return (h, coefs) if return_coefs else h


class GAT(_MetapathTower):
    """Homogeneous multi-layer GAT: ``forward(graph, x)`` → logits (N, C).
    A tower's layers, then an output layer of n_heads[-1] heads at
    n_classes with an identity activation and the head mean (reference
    gat.py:24-30). ``dtype`` is the layers' compute type (see
    ``GATConv``)."""

    def __init__(self, in_dim: int, n_classes: int, *,
                 hid_units: Sequence[int] = (8,), n_heads: Sequence[int] = (8, 1),
                 activation: Callable = F.elu, residual: bool = False,
                 attn_drop: float = 0.0, ffd_drop: float = 0.0,
                 impl: Impl = "auto", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        common = dict(attn_drop=attn_drop, ffd_drop=ffd_drop, impl=impl, dtype=dtype,
                      generator=generator)
        super().__init__(in_dim, hid_units, n_heads, activation=activation,
                         residual=residual, **common)
        last = len(hid_units) - 1
        self.layers.append(GATConv(hid_units[last] * n_heads[last], n_classes, n_heads[-1],
                                   activation=lambda v: v, residual=False,
                                   concat_heads=False, **common))


class HAN(nn.Module):
    """Heterogeneous graph attention network (reference HeteGAT_multi).

    ``forward(graphs, xs)`` takes P graphs (one per meta-path) and P feature
    tensors (typically the same tensor repeated); returns
    ``(logits (N, C), embedding (N, K*hid), alphas (N, P))``. ``dtype`` is
    the towers' compute type (see ``GATConv``); the semantic attention and
    the classifier run in f32.

    ``vmap_towers``: ``graphs`` is ONE stack of the P graphs
    (graph/stack.py) and ``xs`` a (P, N, F) tensor, the towers one stacked
    module whose parameters equal those the sequential towers draw from the
    same generator (nn/convert.py:stack_towers maps one layout onto the
    other); ``mesh``: the run's mesh, whose mp axis splits the towers (the
    module docstring).
    """

    def __init__(self, in_dim: int, n_classes: int, n_metapaths: int, *,
                 hid_units: Sequence[int] = (8,),
                 n_heads: Sequence[int] = (8, 1), semantic_dim: int = 128,
                 activation: Callable = F.elu, residual: bool = False,
                 attn_drop: float = 0.0, ffd_drop: float = 0.0,
                 impl: Impl = "auto", dtype: torch.dtype = torch.float32,
                 vmap_towers: bool = False, mesh: Mesh | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        tower = dict(activation=activation, residual=residual, attn_drop=attn_drop,
                     ffd_drop=ffd_drop, impl=impl, dtype=dtype)
        towers = [_MetapathTower(in_dim, hid_units, n_heads, generator=generator, **tower)
                  for _ in range(n_metapaths)]
        self.vmap_towers, self.mesh, self.n_metapaths = vmap_towers, mesh, n_metapaths
        if vmap_towers:
            mp = 1 if mesh is None else mesh.mp.size
            if n_metapaths % mp:
                raise ValueError(f"{n_metapaths} meta-path towers do not split over an mp "
                                 f"axis of {mp}")
            # the sequential towers' parameters, stacked: one generator
            # draws the same weights in both layouts
            self.towers = _MetapathTower(in_dim, hid_units, n_heads, n_paths=n_metapaths,
                                         generator=torch.Generator(), **tower)
            with torch.no_grad():
                for name, t in self.towers.named_parameters():
                    t.copy_(torch.stack([tw.get_parameter(name) for tw in towers]))
        else:
            if mesh is not None and mesh.mp.size > 1:
                raise ValueError("an mp mesh axis needs vmap_towers")
            self.towers = nn.ModuleList(towers)
        emb_dim = hid_units[-1] * n_heads[len(hid_units) - 1]
        self.semantic = SemanticAttention(emb_dim, semantic_dim, generator=generator)
        # classifier: mean of n_heads[-1] Dense layers (reference gat.py:66-76)
        self.classifiers = nn.ModuleList(
            Dense(emb_dim, n_classes, generator=generator)
            for _ in range(n_heads[-1]))

    def forward(self, graphs, xs, *, deterministic: bool = True,
                rngs: DropoutGenerators | None = None):
        if self.vmap_towers:
            return self._fuse(self._stacked_towers(graphs, xs, deterministic, rngs))
        embeds = [tower(graph, x, deterministic=deterministic, rngs=rngs)
                  for tower, graph, x in zip(self.towers, graphs, xs)]
        return self._fuse(torch.stack(embeds, dim=1))

    def _stacked_towers(self, graphs, xs: torch.Tensor, deterministic: bool,
                        rngs: DropoutGenerators | None) -> torch.Tensor:
        """The P towers over the stack: (N, P, K*hid). On an mp axis this
        rank runs towers lo..hi−1 with its slice of the stacked parameters,
        whose gradients sum over the axis, and gathers the embeddings."""
        mp = None if self.mesh is None else self.mesh.mp
        kw = dict(deterministic=deterministic, rngs=rngs)
        if mp is None or mp.size == 1:
            embeds = self.towers(graphs, xs, **kw)
        else:
            per = self.n_metapaths // mp.size
            lo, hi = mp.rank * per, (mp.rank + 1) * per
            params = {name: sum_grads(t, mp)[lo:hi]
                      for name, t in self.towers.named_parameters()}
            embeds = torch.func.functional_call(
                self.towers, params, (paths(graphs, lo, hi), xs[lo:hi]),
                {**kw, "towers": (lo, hi, self.n_metapaths)})
            embeds = gather_rows(embeds, mp)
        return embeds.transpose(0, 1)  # (N, P, K*hid)

    def _fuse(self, multi: torch.Tensor):
        """Semantic attention over the towers' embeddings (N, P, K*hid),
        then the classifier: (logits, embedding, alphas)."""
        final, alphas = self.semantic(multi)
        logits = sum(c(final) for c in self.classifiers) / len(self.classifiers)
        return logits, final, alphas


class HANShared(HAN):
    """HAN with one feature input shared by the meta-path towers (reference
    HeteGAT): ``forward(graphs, x)`` → ``(logits, embedding, alphas)``, and
    with ``return_coefs`` a fourth item, each tower's coefficients (see
    ``_MetapathTower.forward``): dense (N, N) matrices or csr per-edge
    vectors. The fused backends (flash, ell_fused, the partitioned ones)
    never materialize coefficients and raise NotImplementedError on
    ``return_coefs``. Parameters and their names are HAN's."""

    def __init__(self, in_dim: int, n_classes: int, n_metapaths: int, *,
                 return_coefs: bool = False, **kwargs):
        super().__init__(in_dim, n_classes, n_metapaths, **kwargs)
        self.return_coefs = return_coefs

    def forward(self, graphs: Sequence, x: torch.Tensor, *, deterministic: bool = True,
                rngs: DropoutGenerators | None = None):
        outs = [tower(graph, x, deterministic=deterministic, rngs=rngs,
                      return_coefs=self.return_coefs)
                for tower, graph in zip(self.towers, graphs)]
        if not self.return_coefs:
            return self._fuse(torch.stack(outs, dim=1))
        return (*self._fuse(torch.stack([h for h, _ in outs], dim=1)),
                [c for _, c in outs])
