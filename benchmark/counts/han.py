"""Operation and byte counts of the HAN configurations, from shapes and real
edges alone, so that they read the same work whatever implements it.

Model FLOPs (``step_mfu``): the multiply-adds of the model's products,
2 per multiply-add, on the rows of the step's graph or block:

- per tower: the projection 2·N·F·K·D (one product a head of its dropped
  input), the two attention-logit products 2·2·N·K·D, and the aggregation
  2·E·K·D over the real edges E (self-loops included);
- semantic attention 2·N·P·E·A + 2·N·P·A, the classifier heads
  2·N·E·C a head (E = K·D here the embedding width).

A train step counts forward and backward as three forwards (the backward's
two products per forward product); an evaluation counts one forward.

Flash work (``flash_roofline``): per meta-path pass, the least time on the
card is the largest of its exps over the SFU rate, its D-wide products over
the 3xTF32 product rate, and its bytes over HBM's, counted on the real
edges: a forward takes E·K exps and 2·E·K·D product FLOPs and reads ld,
ls, v and writes out and lse once; the fused backward takes E·K exps (the
coefficients recomputed) and 4·E·K·D (g·v and cᵀg), reads ld, ls, v, g,
lse and delta and writes dld, dls and dv once. The graph's own bytes are
not counted (no layout is assumed), which keeps the count a bound.
"""

from __future__ import annotations


def _dims(settings: dict, shape: dict):
    m = settings["model"]
    k, d = m["n_heads"][0], m["hid_units"][0]
    return (shape["in_dim"], k, d, len(shape["edges"]), m["semantic_dim"],
            shape["n_classes"], m["n_heads"][-1])


def forward_flops(settings: dict, shape: dict, edges: list) -> float:
    """FLOPs of one forward over the step shape's ``n_rows`` rows and
    ``edges`` real edges a meta-path."""
    f, k, d, p, a, c, heads_out = _dims(settings, shape)
    n_rows = shape["n_rows"]
    e = k * d
    towers = sum(2 * n_rows * f * k * d + 4 * n_rows * k * d + 2 * ep * k * d for ep in edges)
    semantic = 2 * n_rows * p * e * a + 2 * n_rows * p * a
    return float(towers + semantic + 2 * n_rows * e * c * heads_out)


def model_flops(settings: dict, shape: dict, train_steps: int, eval_steps: int) -> float:
    """FLOPs of ``train_steps`` train steps and ``eval_steps`` evaluations
    on the step shape ``shape`` (``n_rows``, ``edges`` a meta-path,
    ``in_dim``, ``n_classes``; an evaluation's ``eval_edges`` if it
    differs)."""
    fwd = forward_flops(settings, shape, shape["edges"])
    ev = forward_flops(settings, shape, shape.get("eval_edges", shape["edges"]))
    return 3.0 * fwd * train_steps + ev * eval_steps


def flash_pass_s(settings: dict, n_rows: int, e: int, backward: bool, peaks: dict) -> float:
    """Least seconds of one flash pass over ``e`` real edges of a meta-path."""
    m = settings["model"]
    k, d = m["n_heads"][0], m["hid_units"][0]
    exps = e * k
    products = (4 if backward else 2) * e * k * d
    vec, feat = 4 * k * n_rows, 4 * n_rows * k * d
    nbytes = (6 * vec + 3 * feat) if backward else (3 * vec + 2 * feat)
    return max(exps / peaks["sfu_exp_per_s"], products / peaks["tf32x3_flops"],
               nbytes / peaks["hbm_bytes_per_s"])


def flash_least_s(settings: dict, shape: dict, train_steps: int, eval_steps: int,
                  peaks: dict) -> float:
    """Least seconds of the flash work of the steps: a forward and a fused
    backward a meta-path a train step, a forward a meta-path an
    evaluation."""
    n = shape["n_rows"]
    fwd = sum(flash_pass_s(settings, n, e, False, peaks) for e in shape["edges"])
    bwd = sum(flash_pass_s(settings, n, e, True, peaks) for e in shape["edges"])
    return (fwd + bwd) * train_steps + fwd * eval_steps
