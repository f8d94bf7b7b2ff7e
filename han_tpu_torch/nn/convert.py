"""Parameter conversion between han_tpu's flax trees and this package's
``state_dict``s, for HAN, HANShared, GAT, GATConv and ConstAttention.

The torch modules keep the flax parameter names and shapes; only the
submodule paths differ:

    tower_{p}/GATConv_{i}/…   ↔  towers.{p}.layers.{i}.…
    towers/GATConv_{i}/…      ↔  towers.layers.{i}.…  (HAN(vmap_towers): P stacked)
    SemanticAttention_0/…     ↔  semantic.…
    classifier_{i}/…          ↔  classifiers.{i}.…
    GATConv_{i}/… (GAT)       ↔  layers.{i}.…

HANShared's tree has HAN's names (``tower_{p}``, ``SemanticAttention_0``,
``classifier_{i}``). A bare GATConv tree, and ConstAttention's ``kernel``
and ``bias``, map name for name. :func:`stack_towers` and
:func:`unstack_towers` map a sequential HAN's ``state_dict`` onto a
``vmap_towers`` HAN's and back (the counterpart of
tests/test_metapath_ep.py:26-35), so one set of weights drives both.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_TO_TORCH = [(r"^tower_(\d+)\.GATConv_(\d+)\.", r"towers.\1.layers.\2."),
             (r"^towers\.GATConv_(\d+)\.", r"towers.layers.\1."),
             (r"^SemanticAttention_0\.", "semantic."),
             (r"^classifier_(\d+)\.", r"classifiers.\1."),
             (r"^GATConv_(\d+)\.", r"layers.\1.")]
_TO_FLAX = [(r"^towers\.(\d+)\.layers\.(\d+)\.", r"tower_\1.GATConv_\2."),
            (r"^towers\.layers\.(\d+)\.", r"towers.GATConv_\1."),
            (r"^semantic\.", "SemanticAttention_0."),
            (r"^classifiers\.(\d+)\.", r"classifier_\1."),
            (r"^layers\.(\d+)\.", r"GATConv_\1.")]


def _rename(name: str, rules) -> str:
    for pat, rep in rules:
        name = re.sub(pat, rep, name)
    return name


def _flatten(tree: Mapping, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flatten(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def params_from_flax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """flax ``model.init`` output (or its ``"params"`` collection), with
    numpy-convertible leaves → a ``state_dict`` for ``load_state_dict``."""
    if "params" in tree:
        tree = tree["params"]
    return {_rename(name, _TO_TORCH): torch.from_numpy(np.array(leaf, np.float32))
            for name, leaf in _flatten(tree)}


def flax_from_params(state_dict: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The reverse: a ``state_dict`` → ``{"params": nested dict of numpy}``."""
    params: dict[str, Any] = {}
    for name, t in state_dict.items():
        *path, leaf = _rename(name, _TO_FLAX).split(".")
        node = params
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t.detach().cpu().numpy()
    return {"params": params}


_SEQ_TOWER = re.compile(r"^towers\.(\d+)\.(.*)$")


def stack_towers(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A sequential HAN's ``state_dict`` (``towers.{p}.…``) → a
    ``vmap_towers`` HAN's (``towers.…`` with a leading P axis)."""
    towers: dict[str, dict[int, torch.Tensor]] = {}
    out = {}
    for name, t in state_dict.items():
        m = _SEQ_TOWER.match(name)
        if m:
            towers.setdefault(m.group(2), {})[int(m.group(1))] = t
        else:
            out[name] = t
    for name, per in towers.items():
        out[f"towers.{name}"] = torch.stack([per[p] for p in range(len(per))])
    return out


def unstack_towers(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The reverse of :func:`stack_towers`."""
    out = {}
    for name, t in state_dict.items():
        if name.startswith("towers."):
            for p, tp in enumerate(t.unbind(0)):
                out[f"towers.{p}.{name[len('towers.'):]}"] = tp.clone()
        else:
            out[name] = t
    return out
