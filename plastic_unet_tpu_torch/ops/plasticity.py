"""The plastic head in plain PyTorch (counterpart of
plastic_unet_tpu.ops.plasticity). This is the plain version that the CUDA
head kernel (ops.plastic_head) is held against.

  eff      = w + alpha * hebb         # 'free': alpha (nbf, nbf); 'yoked': a scalar
  activ    = activin @ eff            # fp32
  activout = sigmoid(activ)           # the predicted mask
  hebb'    = rank-1 trace update from ROW 0 of each sample's matrices:
    hebb: (1 - eta) * hebb + eta * outer(activin[0], activout[0])
    oja:  hebb + eta * (activin[0][:, None] - hebb * activout[0][None, :]) * activout[0][None, :]

Every function takes one sample ``(nbf, nbf)`` or a batch ``(B, nbf, nbf)``;
"row 0" is row 0 of each sample's matrix, never batch element 0. As in the
JAX package, the form of alpha follows its shape: broadcasting covers both
the matrix and the scalar with one expression.
"""

from __future__ import annotations

import torch

RULES = ("hebb", "oja")
ALFA_TYPES = ("free", "yoked")


def check_head_args(rule: str, alfa_type: str) -> None:
    if rule not in RULES:
        raise ValueError("Must select one learning rule ('hebb' or 'oja'), got %r" % (rule,))
    if alfa_type not in ALFA_TYPES:
        raise ValueError("Must select one plasticity coefficient type ('free' or 'yoked'), got %r" % (alfa_type,))


def hebb_update(hebb: torch.Tensor, activin: torch.Tensor, activout: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Hebbian trace: decay + rank-1 outer product of row 0."""
    outer = activin[..., 0, :, None] * activout[..., 0, None, :]
    return (1.0 - eta) * hebb + eta * outer


def oja_update(hebb: torch.Tensor, activin: torch.Tensor, activout: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Oja trace: stable bounded update from row 0."""
    yin = activin[..., 0, :, None]  # (..., nbf, 1)
    yout = activout[..., 0, None, :]  # (..., 1, nbf)
    return hebb + eta * (yin - hebb * yout) * yout


def plastic_head_logits(
    w: torch.Tensor,
    alpha: torch.Tensor,
    eta: torch.Tensor,
    activin: torch.Tensor,
    hebb: torch.Tensor,
    *,
    rule: str = "hebb",
    alfa_type: str = "free",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(activ, activout, new_hebb): the pre-sigmoid logits, the sigmoid mask
    and the updated trace."""
    check_head_args(rule, alfa_type)
    eff = w + alpha * hebb
    activ = torch.matmul(activin, eff)
    activout = torch.sigmoid(activ)
    update = hebb_update if rule == "hebb" else oja_update
    return activ, activout, update(hebb, activin, activout, eta)
