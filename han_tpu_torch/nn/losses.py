"""Masked losses and metrics (port of han_tpu/nn/losses.py; reference
models/base_gattn.py semantics).

The masked ones take dense one/multi-hot ``labels (N, C)`` and a node
``mask (N,)``; the mask is mean-normalized as in the reference: ``mask =
mask / mean(mask)`` then a plain mean over all nodes, equal to the mean
over masked nodes.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.nn.functional as F


def _norm_mask(mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.float32)
    return m / m.mean().clamp_min(1e-12)  # empty mask → 0, not NaN


def masked_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Reference base_gattn.py:41-48."""
    loss = -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)  # (N,)
    return (loss * _norm_mask(mask)).mean()


def masked_sigmoid_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Multi-label (PPI) loss; reference base_gattn.py:50-59."""
    labels = labels.to(torch.float32)
    # stable sigmoid CE: max(x,0) - x*z + log1p(exp(-|x|))
    loss = logits.clamp_min(0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return (loss.mean(dim=-1) * _norm_mask(mask)).mean()


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Reference base_gattn.py:61-69."""
    correct = (logits.argmax(dim=-1) == labels.argmax(dim=-1)).to(torch.float32)
    return (correct * _norm_mask(mask)).mean()


def micro_f1(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Multi-label micro-F1 from integer TP/FP/FN counts; reference
    base_gattn.py:71-94 (sigmoid → round → count)."""
    pred = (torch.sigmoid(logits) >= 0.5).to(torch.int32)
    lab = labels.to(torch.int32)
    m = mask.to(torch.int32)[:, None]
    tp = (pred * lab * m).sum()
    fp = (pred * (1 - lab) * m).sum()
    fn = ((1 - pred) * lab * m).sum()
    precision = tp / (tp + fp).clamp_min(1)
    recall = tp / (tp + fn).clamp_min(1)
    return (2 * precision * recall / (precision + recall).clamp_min(1e-12)).to(torch.float32)


def l2_regularizer(params: Iterable[torch.Tensor], coef: float) -> torch.Tensor:
    """Global L2 over ALL trainable parameters, biases included, as the
    reference effectively does (its bias filter never matches,
    base_gattn.py:15-16): ``coef * sum(0.5 * ||v||^2)``."""
    return coef * 0.5 * sum(p.square().sum() for p in params)


def confusion_matrix(logits: torch.Tensor, label_ids: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """(C, C) int32 confusion matrix, rows = true class, cols = argmax
    prediction; reference ``BaseGAttN.confmat`` (base_gattn.py:33-35)."""
    onehot_true = F.one_hot(label_ids.long(), n_classes).to(torch.int32)
    onehot_pred = F.one_hot(logits.argmax(dim=-1), n_classes).to(torch.int32)
    return onehot_true.T @ onehot_pred


def class_weighted_cross_entropy(logits: torch.Tensor, label_ids: torch.Tensor,
                                 n_classes: int, class_weights: torch.Tensor) -> torch.Tensor:
    """Integer-label CE scaled by per-class weights; reference
    base_gattn.py:5-10 (``BaseGAttN.loss``)."""
    label_ids = label_ids.long()
    sample_w = (F.one_hot(label_ids, n_classes) * class_weights).sum(dim=-1)
    ce = -torch.log_softmax(logits, dim=-1).gather(-1, label_ids[:, None])[:, 0]
    return (ce * sample_w).mean()
