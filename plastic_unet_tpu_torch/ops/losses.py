"""Losses (counterpart of plastic_unet_tpu.ops.losses).

``bce_probs`` is the reference's torch ``nn.BCELoss`` on probabilities: the
mean of -(y*log(p) + (1-y)*log(1-p)) with each log term clamped at -100.
``F.binary_cross_entropy`` computes exactly that, value and gradient
(``(p - y) / max(p*(1-p), 1e-12)``), so the port uses it directly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_probs(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Reference-exact BCE on probabilities, incl. the -100 log clamp."""
    return F.binary_cross_entropy(probs.reshape(-1), targets.reshape(-1).to(probs.dtype))
