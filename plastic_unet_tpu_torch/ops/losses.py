"""Losses (counterpart of plastic_unet_tpu.ops.losses).

``bce_probs`` is the reference's torch ``nn.BCELoss`` on probabilities: the
mean of -(y*log(p) + (1-y)*log(1-p)) with each log term clamped at -100.
``F.binary_cross_entropy`` computes exactly that, value and gradient
(``(p - y) / max(p*(1-p), 1e-12)``), so the port uses it directly. ``bce_logits`` is the same quantity from the
pre-sigmoid logits, stable at saturation, and the training default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_probs(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Reference-exact BCE on probabilities, incl. the -100 log clamp."""
    return F.binary_cross_entropy(probs.reshape(-1), targets.reshape(-1).to(probs.dtype))


def bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Stable BCE from logits: mean(max(x,0) - x*y + log(1+exp(-|x|)))."""
    x = logits.reshape(-1)
    y = targets.reshape(-1).to(x.dtype)
    return torch.mean(torch.clamp_min(x, 0.0) - x * y + torch.log1p(torch.exp(-torch.abs(x))))
