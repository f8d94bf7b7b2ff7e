"""Neural layers: multi-head graph attention, the constant-attention
ablation and semantic attention (port of han_tpu/nn/layers.py:39-209).

Parameters keep the flax shapes (``kernel (F,K,D)``, ``attn_dst_kernel
(K,D)``, ...) and flax's initializers, so ``nn/convert.py`` maps a flax
parameter tree onto a ``state_dict`` name for name.

- ``GATConv`` reproduces the reference ``attn_head`` (utils/layers.py:7-46)
  with K heads batched into single einsums: per-head feature transform W_k
  (no bias), per-head scalar projections f_1/f_2 (with bias), LeakyReLU(0.2)
  → mask → row softmax → per-head output bias → activation. Input dropout is
  drawn independently per head, as the reference's per-head
  ``tf.nn.dropout`` calls. ``dtype`` is the compute type of the features
  (han_tpu/nn/layers.py:55-61): x and ``kernel`` are cast to it, the
  einsums sum in f32 and are cast back, the attention logits and the
  output are f32, and the parameters stay f32.
- ``ConstAttention`` reproduces ``attn_head_const_1`` (utils/layers.py:
  49-81): the logits are the adjacency (1 on edges), not learned, so every
  neighbor gets the same weight; dense graphs only.
- ``SemanticAttention`` reproduces ``SimpleAttLayer`` (utils/layers.py:
  132-164) including the *per-node* softmax over meta-paths and normal(0.1)
  initialization.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from han_tpu_torch.graph.containers import DenseGraph
from han_tpu_torch.ops.attention import Impl, attention_aggregate, leaky_relu


@dataclasses.dataclass
class DropoutGenerators:
    """The random streams of one training run. ``device`` draws, where the
    tensors live, the input, feature and coefficient dropout masks and the
    flash kernels' dropout seeds (device tensors), so no draw needs a
    device-to-host sync and a step captured as a CUDA graph with this
    generator registered draws anew at every replay."""

    device: torch.Generator


def glorot_uniform_(t: torch.Tensor, generator: torch.Generator | None = None):
    """flax ``glorot_uniform``: variance_scaling(1, fan_avg, uniform) with
    in_axis=-2, out_axis=-1, so a rank-3 (F,K,D) kernel has fan_in = K·F and
    fan_out = D·F."""
    receptive = math.prod(t.shape[:-2])
    fan_in, fan_out = t.shape[-2] * receptive, t.shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


def normal01_(t: torch.Tensor, generator: torch.Generator | None = None):
    with torch.no_grad():
        return t.normal_(0.0, 0.1, generator=generator)


def _rand(shape: tuple, towers: tuple[int, int, int] | None, rngs: DropoutGenerators,
          device) -> torch.Tensor:
    """Uniform draws of ``shape``; with ``towers`` = (lo, hi, P) (a rank's
    towers of an mp mesh axis) the draws of all P towers, sliced to
    lo..hi−1, so each tower's mask is the one a one-device run draws."""
    if towers is None:
        return torch.rand(shape, generator=rngs.device, device=device)
    lo, hi, total = towers
    return torch.rand((total, *shape[1:]), generator=rngs.device, device=device)[lo:hi]


class GATConv(nn.Module):
    """Multi-head graph attention convolution (reference attn_head × K heads).

    Output is the concatenation over heads, (N, K * out_dim), when
    ``concat_heads`` else the head mean, (N, out_dim).

    ``n_paths`` = P stacks P independent layers (HAN's meta-path towers run
    together, han_tpu's ``nn.vmap`` over the towers): every parameter gains
    a leading P axis, each path's initialized as one layer's, and the
    forward takes a stack of P graphs (graph/stack.py) and x (P, N, F).
    """

    def __init__(self, in_dim: int, out_dim: int, num_heads: int, *,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.elu,
                 slope: float = 0.2, attn_drop: float = 0.0,
                 ffd_drop: float = 0.0, residual: bool = False,
                 concat_heads: bool = True, impl: Impl = "auto",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, n_paths: int | None = None):
        super().__init__()
        k, d = num_heads, out_dim
        self.dtype = dtype
        self.activation = activation
        self.slope, self.attn_drop, self.ffd_drop = slope, attn_drop, ffd_drop
        self.residual, self.concat_heads, self.impl = residual, concat_heads, impl
        lead = () if n_paths is None else (n_paths,)

        def param(shape, init):
            t = torch.zeros((*lead, *shape))
            for view in (t,) if n_paths is None else t.unbind(0):
                if init is not None:
                    init(view, generator)
            return nn.Parameter(t)

        self.kernel = param((in_dim, k, d), glorot_uniform_)
        self.attn_dst_kernel = param((k, d), glorot_uniform_)
        self.attn_dst_bias = param((k,), None)
        self.attn_src_kernel = param((k, d), glorot_uniform_)
        self.attn_src_bias = param((k,), None)
        self.bias = param((k, d), None)
        self.res_kernel = (param((in_dim, k, d), glorot_uniform_)
                           if residual and in_dim != out_dim else None)

    def forward(self, graph, x: torch.Tensor, *, deterministic: bool = True,
                rngs: DropoutGenerators | None = None,
                return_coefs: bool = False, towers: tuple[int, int, int] | None = None):
        """``towers`` = (lo, hi, P): this stacked layer runs towers lo..hi−1
        of P (an mp mesh axis), and its dropout draws are those towers' of
        a one-device run."""
        lead, (n, f) = x.shape[:-2], x.shape[-2:]
        k, d = self.bias.shape[-2:]
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype)
        drop_in = 0.0 if deterministic else self.ffd_drop
        drop_coef = 0.0 if deterministic else self.attn_drop
        if (drop_in > 0.0 or drop_coef > 0.0) and rngs is None:
            raise ValueError("dropout needs rngs (DropoutGenerators)")

        if drop_in > 0.0:
            # independent input dropout per head (reference drops `seq`
            # inside each attn_head call, layers.py:18-19)
            keep = 1.0 - drop_in
            mask = _rand((*lead, k, n, f), towers, rngs, x.device) < keep
            xk = torch.where(mask, x.unsqueeze(-3) / keep, 0.0)  # ([P,] K, N, F)
            fts = torch.einsum("...knf,...fkd->...nkd", xk.float(), w.float()).to(self.dtype)
        else:
            fts = torch.einsum("...nf,...fkd->...nkd", x.float(), w.float()).to(self.dtype)

        # per-head scalar attention terms (reference f_1 / f_2, layers.py:23-24),
        # f32 whatever the compute dtype
        logit_dst = (torch.einsum("...nkd,...kd->...nk", fts.float(), self.attn_dst_kernel)
                     + self.attn_dst_bias.unsqueeze(-2))
        logit_src = (torch.einsum("...nkd,...kd->...nk", fts.float(), self.attn_src_kernel)
                     + self.attn_src_bias.unsqueeze(-2))

        # feature dropout before aggregation (reference layers.py:31-32)
        fts_agg = fts
        if drop_in > 0.0:
            mask = _rand(fts.shape, towers, rngs, x.device) < keep
            fts_agg = torch.where(mask, fts / keep, 0.0)

        agg = attention_aggregate(
            graph, fts_agg, logit_dst, logit_src, slope=self.slope,
            coef_dropout=drop_coef,
            generator=rngs.device if rngs is not None else None,
            impl=self.impl, return_coefs=return_coefs, towers=towers)
        if return_coefs:
            agg, coefs = agg

        ret = agg.float() + self.bias.unsqueeze(-3)  # ([P,] N, K, D), f32
        if self.residual:
            if self.res_kernel is not None:
                ret = ret + torch.einsum("...nf,...fkd->...nkd", x.float(), self.res_kernel)
            else:
                ret = ret + x.unsqueeze(-2).float()

        out = self.activation(ret)
        out = out.reshape(*lead, n, k * d) if self.concat_heads else out.mean(dim=-2)
        if return_coefs:
            return out, coefs
        return out


class ConstAttention(nn.Module):
    """Uniform-over-neighbors ablation head (reference attn_head_const_1):
    logits = the 0/1 adjacency rather than learned, then the masked softmax
    and aggregation of ``GATConv``. Input dropout is one mask over x (not
    one a head), then the coefficient and feature dropout, drawn in that
    order."""

    def __init__(self, in_dim: int, out_dim: int, num_heads: int, *,
                 activation: Callable[[torch.Tensor], torch.Tensor] = F.elu,
                 slope: float = 0.2, attn_drop: float = 0.0, ffd_drop: float = 0.0,
                 concat_heads: bool = True, generator: torch.Generator | None = None):
        super().__init__()
        self.activation = activation
        self.slope, self.attn_drop, self.ffd_drop = slope, attn_drop, ffd_drop
        self.concat_heads = concat_heads
        self.kernel = nn.Parameter(
            glorot_uniform_(torch.empty(in_dim, num_heads, out_dim), generator))
        self.bias = nn.Parameter(torch.zeros(num_heads, out_dim))

    def forward(self, graph: DenseGraph, x: torch.Tensor, *, deterministic: bool = True,
                rngs: DropoutGenerators | None = None) -> torch.Tensor:
        if not isinstance(graph, DenseGraph):
            raise TypeError("ConstAttention requires a DenseGraph")
        n = x.shape[0]
        k, d = self.bias.shape
        drop_in = 0.0 if deterministic else self.ffd_drop
        drop_coef = 0.0 if deterministic else self.attn_drop
        if (drop_in > 0.0 or drop_coef > 0.0) and rngs is None:
            raise ValueError("dropout needs rngs (DropoutGenerators)")

        def dropout(t: torch.Tensor, p: float) -> torch.Tensor:
            if p <= 0.0:
                return t
            keep = 1.0 - p
            mask = torch.rand(t.shape, generator=rngs.device, device=t.device) < keep
            return torch.where(mask, t / keep, 0.0)

        fts = torch.einsum("nf,fkd->nkd", dropout(x, drop_in), self.kernel)
        # reference: the adjacency recovered as 1 - bias/-1e9
        logits = leaky_relu(graph.adj.float(), self.slope)
        coefs = dropout(torch.softmax(logits + graph.bias, dim=-1), drop_coef)  # (N, N)
        agg = torch.einsum("nm,mkd->nkd", coefs, dropout(fts, drop_in))
        out = self.activation(agg + self.bias[None])
        return out.reshape(n, k * d) if self.concat_heads else out.mean(dim=1)


class SemanticAttention(nn.Module):
    """Fuse P per-meta-path embeddings into one (reference SimpleAttLayer).

    Input (N, P, D) → (output (N, D), alphas (N, P)); alphas are per-node
    (softmax over the meta-path axis, utils/layers.py:155-156).
    """

    def __init__(self, in_dim: int, attention_dim: int = 128, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.w_omega = nn.Parameter(normal01_(torch.empty(in_dim, attention_dim), generator))
        self.b_omega = nn.Parameter(normal01_(torch.empty(attention_dim), generator))
        self.u_omega = nn.Parameter(normal01_(torch.empty(attention_dim), generator))

    def forward(self, inputs: torch.Tensor):
        v = torch.tanh(torch.einsum("npd,da->npa", inputs, self.w_omega) + self.b_omega)
        vu = torch.einsum("npa,a->np", v, self.u_omega)
        alphas = torch.softmax(vu, dim=-1)  # (N, P)
        output = torch.sum(inputs * alphas[:, :, None], dim=1)  # (N, D)
        return output, alphas
