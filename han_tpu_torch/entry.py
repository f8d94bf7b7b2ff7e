"""The port's counterpart of ``__graft_entry__.entry()``: the flagship HAN's
forward on an ACM3025-shaped synthetic heterogeneous graph, through the csr
backend.

    from han_tpu_torch.entry import entry
    forward, args = entry()          # on the card; entry("cpu") on the CPU
    logits = forward(*args)          # (3025, 3)
"""

from __future__ import annotations

from typing import Callable

import torch

from han_tpu_torch.datasets.acm import acm_synthetic
from han_tpu_torch.train.config import preset
from han_tpu_torch.train.trainer import build_graphs, build_model
from han_tpu_torch.utils.device import resolve_device


def entry(device: torch.device | str | None = None) -> tuple[Callable, tuple]:
    """Returns (forward, (params, xs)): ``forward(params, xs)`` is the acm
    preset's HAN (graph_format and impl csr) on ``acm_synthetic(seed=0)``
    at the parameters ``params`` (a state_dict; the model's own, seeded 0,
    are given) and the per-meta-path features ``xs``, and returns the
    logits (3025, 3). On the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    ds = acm_synthetic(seed=0)
    cfg = preset("acm")
    cfg.data.graph_format = "csr"
    cfg.model.impl = "csr"
    graphs = build_graphs(ds, cfg, device)
    model = build_model(ds, cfg, generator=torch.Generator().manual_seed(0)).to(device)
    x = torch.from_numpy(ds.features).to(device)
    xs = [x for _ in graphs]

    @torch.no_grad()
    def forward(params: dict[str, torch.Tensor], xs: list[torch.Tensor]) -> torch.Tensor:
        logits, _, _ = torch.func.functional_call(model, params, (graphs, xs))
        return logits

    return forward, (dict(model.state_dict()), xs)
