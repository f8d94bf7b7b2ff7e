"""The comparison that decides ``correct`` for a training cell: the first
three steps of the program's own training object against the plain
reference's three steps from the same weights, inputs and dropout streams,
and the program's first evaluations against the reference's forward
without dropout at the same point of training.

The numbers, each the worst case over its parts unless it says otherwise:

- ``loss_gap``: the largest |L_prog − L_ref| / |L_ref| over the steps;
- ``first_loss_gap``: that of the first step alone, whose loss reads the
  forward from the same weights and no step of training;
- ``grad_gap``: the first step's gradient as Adam got it (its first moment
  after one step over 1 − β₁), by leaf: | ‖g_prog‖ − ‖g_ref‖ | over the
  larger of ‖g_ref‖ of that leaf and of the median leaf;
- ``update_gap``: the parameters' change over the three steps, by leaf, in
  the same measure, over the elements whose reference gradient is at
  least a thousandth of the median leaf's root mean square element. An
  element under that moves by round-off alone (Adam scales any gradient
  to a step of lr), as a key's bias does under the softmax, which it
  shifts along a row: an attention bias's head whose rows all lie on one
  side of the leaky ReLU's knee, or have one neighbour;
- ``median_update_gap``: the same leaves' gaps, their median;
- ``eval_gap``: the largest |E_prog − E_ref| / |E_ref| over the compared
  evaluations' losses (the masked mean cross-entropy without dropout).

The later steps' losses and the worst leaf's change carry the leaky
ReLU's knee: an edge whose input lies within round-off of 0 takes the
slope 1 on one side and 0.2 on the other in the backward, so the
attention vectors' gradient of that step differs by that edge's whole
term, and Adam's second and third steps carry it on. Where a cell's
edges are few, one such edge can move the third loss by 20 float32 ulps
and a 64-element attention vector's change by 1e-3, and a plain float32
run nudged by one ulp does the same (PERF.md): such a cell compares the
first step's loss and the median leaf's change in their place.

A cell compares the numbers that its limits name (``limits/<cell>.json``),
each held to its limit there.
"""

from __future__ import annotations

import statistics

import torch

NUMBERS = ("loss_gap", "first_loss_gap", "grad_gap", "update_gap", "median_update_gap",
           "eval_gap")
MOVING_SHARE = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """leaf → | ‖prog‖ − ‖ref‖ | / max(‖ref‖, median ‖ref‖) over ``leaves``."""
    pn, rn = _norms({k: prog[k] for k in leaves}), _norms({k: ref[k] for k in leaves})
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in leaves}


def leaf_gap(prog: dict, ref: dict, leaves) -> float:
    """The largest of :func:`leaf_gaps`."""
    return max(leaf_gaps(prog, ref, leaves).values())


def numbers(prog, ref, params0: dict) -> dict:
    """The numbers of program record ``prog`` against reference record
    ``ref`` (both with ``losses``, ``grads``, ``params`` after the third
    step and ``evals``), from the initial parameters ``params0``."""
    n, ne = len(ref.losses), len(ref.evals)
    read = list(prog.losses[:n]) + list(prog.evals[:ne])
    if (len(prog.losses) < n or len(prog.evals) < ne
            or any(not torch.isfinite(torch.tensor(x)) for x in read)):
        return {k: float("inf") for k in NUMBERS}
    loss_gap = _rel_gap(prog.losses, ref.losses)
    first_loss_gap = _rel_gap(prog.losses[:1], ref.losses[:1])
    leaves = sorted(ref.grads)
    grad_gap = leaf_gap({k: prog.grads[k].to(ref.grads[k].device) for k in leaves},
                        ref.grads, leaves)
    keep = moving(ref.grads)
    delta_p = {k: (prog.params[k].to(params0[k].device) - params0[k])[m] for k, m in keep.items()}
    delta_r = {k: (ref.params[k].to(params0[k].device) - params0[k])[m] for k, m in keep.items()}
    update = leaf_gaps(delta_p, delta_r, sorted(keep))
    return {"loss_gap": loss_gap, "first_loss_gap": first_loss_gap, "grad_gap": grad_gap,
            "update_gap": max(update.values()),
            "median_update_gap": statistics.median(update.values()),
            "eval_gap": _rel_gap(prog.evals, ref.evals)}


def _rel_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def moving(ref_grads: dict) -> dict:
    """leaf → bool mask of the elements the update gap compares: reference
    gradient at least a thousandth of the median leaf's root mean square
    element; leaves with none left out."""
    rms = statistics.median(float(torch.linalg.vector_norm(g.double())) / g.numel() ** 0.5
                            for g in ref_grads.values())
    masks = {k: g.abs() >= MOVING_SHARE * rms for k, g in ref_grads.items()}
    return {k: m for k, m in masks.items() if m.any()}


def still(ref_grads: dict) -> list:
    """The elements the update gap leaves out, as "leaf out/size"."""
    keep = moving(ref_grads)
    out = []
    for k, g in sorted(ref_grads.items()):
        n_out = g.numel() - (int(keep[k].sum()) if k in keep else 0)
        if n_out:
            out.append(f"{k} {n_out}/{g.numel()}")
    return out


def verdict(nums: dict, limits: dict) -> bool:
    """Every number that the cell's limits name within its limit."""
    return all(nums[k] <= limits[k] for k in limits)
