"""Operation and byte counts of the GAT configurations, from shapes and real
edges alone, so that they read the same work whatever implements it.

A step's shape gives the real nodes of a train step's graphs (``n_rows``)
and their real edges with self-loops (``edges``), the same of an
evaluation (``eval_rows``, ``eval_edges``), the input width and the
labels. Layer l has K_l heads of D_l (the hidden layers' ``n_heads`` and
``hid_units``; the output layer's last ``n_heads`` at the labels' width)
and input width F_l (the input, then K·D of the layer before).

Model FLOPs (``step_mfu``), 2 per multiply-add, on the real nodes N and
edges E, per layer: the projection 2·N·F·K·D, the residual projection
2·N·F·K·D on a hidden layer after the first whose input width differs
from D, the two attention-logit products 2·2·N·K·D and the aggregation
2·E·K·D; the output layer's head average N·K·D. A train step counts
forward and backward as three forwards; an evaluation one forward.

Flash work (``flash_roofline``): per layer pass, the least time on the
card is the largest of its exps over the SFU rate, its D-wide products
over the 3xTF32 product rate and its bytes over HBM's, on the real edges
and nodes, as ``counts/han.py`` counts a meta-path's pass: a forward takes
E·K exps and 2·E·K·D product FLOPs and moves 3·4·K·N + 2·4·N·K·D bytes;
the fused backward takes E·K exps and 4·E·K·D and moves 6·4·K·N +
3·4·N·K·D. A train step is a forward and a fused backward a layer, an
evaluation a forward a layer.
"""

from __future__ import annotations

from benchmark.counts.han import flash_pass_s


def layers(settings: dict, shape: dict) -> list:
    """(F, K, D, residual projection) of each layer."""
    m = settings["model"]
    heads, hid = list(m["n_heads"]), list(m["hid_units"])
    dims = list(zip(heads[:-1], hid)) + [(heads[-1], shape["n_classes"])]
    out, f = [], shape["in_dim"]
    for i, (k, d) in enumerate(dims):
        res = bool(m["residual"]) and 0 < i < len(dims) - 1 and f != d
        out.append((f, k, d, res))
        f = k * d
    return out


def forward_flops(settings: dict, shape: dict, n: float, e: float) -> float:
    """FLOPs of one forward over ``n`` real nodes and ``e`` real edges."""
    total = 0.0
    per_layer = layers(settings, shape)
    for f, k, d, res in per_layer:
        total += (2 + 2 * res) * n * f * k * d + 4 * n * k * d + 2 * e * k * d
    _, k, d, _ = per_layer[-1]
    return total + n * k * d


def model_flops(settings: dict, shape: dict, train_steps: int, eval_steps: int) -> float:
    """FLOPs of ``train_steps`` train steps and ``eval_steps`` evaluation
    steps (each a batch) of the step shape ``shape``."""
    fwd = forward_flops(settings, shape, shape["n_rows"], shape["edges"])
    ev = forward_flops(settings, shape, shape["eval_rows"], shape["eval_edges"])
    return 3.0 * fwd * train_steps + ev * eval_steps


def _pass_s(k: int, d: int, n: float, e: float, backward: bool, peaks: dict) -> float:
    model = {"model": {"n_heads": [k], "hid_units": [d]}}
    return flash_pass_s(model, n, e, backward, peaks)


def flash_least_s(settings: dict, shape: dict, train_steps: int, eval_steps: int,
                  peaks: dict) -> float:
    """Least seconds of the flash work of the steps."""
    dims = [(k, d) for _, k, d, _ in layers(settings, shape)]
    n, e = shape["n_rows"], shape["edges"]
    train = sum(_pass_s(k, d, n, e, False, peaks) + _pass_s(k, d, n, e, True, peaks)
                for k, d in dims)
    ev = sum(_pass_s(k, d, shape["eval_rows"], shape["eval_edges"], False, peaks)
             for k, d in dims)
    return train * train_steps + ev * eval_steps
