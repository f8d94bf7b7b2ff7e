"""Masked losses and metrics (port of han_tpu/nn/losses.py:15-44,62-71;
reference models/base_gattn.py semantics).

All take dense one-hot ``labels (N, C)`` and a node ``mask (N,)``; the mask
is mean-normalized as in the reference: ``mask = mask / mean(mask)`` then a
plain mean over all nodes, equal to the mean over masked nodes.
"""

from __future__ import annotations

from typing import Iterable

import torch


def _norm_mask(mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)
    return m / m.mean().clamp_min(1e-12)  # empty mask → 0, not NaN


def masked_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Reference base_gattn.py:41-48."""
    loss = -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)  # (N,)
    return (loss * _norm_mask(mask)).mean()


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Reference base_gattn.py:61-69."""
    correct = (logits.argmax(dim=-1) == labels.argmax(dim=-1)).to(torch.float32)
    return (correct * _norm_mask(mask)).mean()


def l2_regularizer(params: Iterable[torch.Tensor], coef: float) -> torch.Tensor:
    """Global L2 over ALL trainable parameters, biases included, as the
    reference effectively does (its bias filter never matches,
    base_gattn.py:15-16): ``coef * sum(0.5 * ||v||^2)``."""
    return coef * 0.5 * sum(p.square().sum() for p in params)
