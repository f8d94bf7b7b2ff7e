"""Parameter conversion between han_tpu's flax trees and this package's
``state_dict``s, for HAN, HANShared, GAT, GATConv and ConstAttention.

The torch modules keep the flax parameter names and shapes; only the
submodule paths differ:

    tower_{p}/GATConv_{i}/…   ↔  towers.{p}.layers.{i}.…
    SemanticAttention_0/…     ↔  semantic.…
    classifier_{i}/…          ↔  classifiers.{i}.…
    GATConv_{i}/… (GAT)       ↔  layers.{i}.…

HANShared's tree has HAN's names (``tower_{p}``, ``SemanticAttention_0``,
``classifier_{i}``). A bare GATConv tree, and ConstAttention's ``kernel``
and ``bias``, map name for name.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_TO_TORCH = [(r"^tower_(\d+)\.GATConv_(\d+)\.", r"towers.\1.layers.\2."),
             (r"^SemanticAttention_0\.", "semantic."),
             (r"^classifier_(\d+)\.", r"classifiers.\1."),
             (r"^GATConv_(\d+)\.", r"layers.\1.")]
_TO_FLAX = [(r"^towers\.(\d+)\.layers\.(\d+)\.", r"tower_\1.GATConv_\2."),
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
