"""Sigmoid focal loss, the RetinaNet classification loss (port of
``cpt_tpu/ops/focal_loss.py``).

The per-anchor, per-class focal term of the reference
``layers/sigmoid_focal_loss.py`` with its class-indexed positives: classes
are 1-indexed, a target of 0 is background, and a negative target (an
ignored anchor) adds nothing. Plain PyTorch, as the JAX package leaves it
to XLA.
"""
from __future__ import annotations

import torch


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                       gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """logits [N, C] (classes 1..C in columns 0..C-1) · targets [N] int
    (0 = background, c ≥ 1 = positive for column c-1) → the per-element
    loss [N, C] in f32 (the caller reduces)."""
    c = logits.shape[1]
    class_ids = torch.arange(1, c + 1, device=logits.device)[None, :]
    t = targets[:, None]
    pos = (t == class_ids).float()
    neg = ((t != class_ids) & (t >= 0)).float()
    p = torch.sigmoid(logits.float())
    term_pos = -pos * alpha * ((1 - p) ** gamma) * torch.log(
        torch.clamp(p, min=1e-12))
    term_neg = -neg * (1 - alpha) * (p ** gamma) * torch.log(
        torch.clamp(1 - p, min=1e-12))
    return term_pos + term_neg
