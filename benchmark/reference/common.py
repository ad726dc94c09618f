"""Pieces the reference architectures share: the plastic head with its
state and weight rule, the channel dropout, the reference's pad
arithmetic, the loss and Adam."""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


class PlasticHead(nn.Module):
    """The plastic head's parameters at the model's top level (keys ``w``,
    ``alpha``, ``eta``) and its forward.

      eff      = w + alpha * hebb
      activ    = activin @ eff
      activout = sigmoid(activ)
      hebb'    = (1 - eta) * hebb + eta * outer(activin[0], activout[0])         (hebb)
                 hebb + eta * (activin[0][:, None] - hebb * activout[0]) * activout[0]  (oja)

    "row 0" is row 0 of each sample's (nbf, nbf) matrix."""

    def add_head(self, nbf: int, rule: str) -> None:
        if rule not in ("hebb", "oja"):
            raise ValueError(f"rule must be 'hebb' or 'oja', got {rule!r}")
        self.nbf, self.rule = nbf, rule
        self.w = nn.Parameter(torch.zeros(nbf, nbf))
        self.alpha = nn.Parameter(torch.zeros(nbf, nbf))
        self.eta = nn.Parameter(torch.zeros(1))

    def head(self, activin: torch.Tensor, hebb: torch.Tensor):
        activ = torch.matmul(activin, self.w + self.alpha * hebb)
        activout = torch.sigmoid(activ)
        yin, yout = activin[:, 0, :, None], activout[:, 0, None, :]
        if self.rule == "hebb":
            new = (1.0 - self.eta) * hebb + self.eta * (yin * yout)
        else:
            new = hebb + self.eta * (yin - hebb * yout) * yout
        return activ, activout, new


def zero_trace(ref: PlasticHead, batch: int, device) -> torch.Tensor:
    """A plastic model's state at the start of each lifetime: a zero (batch, nbf, nbf) trace."""
    return torch.zeros((batch, ref.nbf, ref.nbf), device=device)


def plastic_init(shell: PlasticHead, generator: torch.Generator) -> dict:
    """{key: tensor} for a plastic model's state_dict, on the generator's device.

    torch's default initialisation for the published modules: every conv and
    transposed conv weight and bias uniform in (-1/sqrt(fan_in), 1/sqrt(fan_in))
    with fan_in = weight.shape[1] * kh * kw; the head's w = 0.01 * N(0, 1),
    alpha = 0.01 * U(0, 1), eta = 0.01. Two draws make all of it: one
    ``rand`` over the conv leaves in module order and then alpha, one
    ``randn`` for w. ``shell`` may be on the meta device; only its shapes are read.
    """
    conv_keys, bounds, counts = [], [], []
    for prefix, m in shell.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
            for leaf in ("weight", "bias"):
                p = getattr(m, leaf)
                conv_keys.append((f"{prefix}.{leaf}", tuple(p.shape)))
                bounds.append(bound)
                counts.append(p.numel())
    nbf, g = shell.nbf, generator
    device = g.device
    u = torch.rand(sum(counts) + nbf * nbf, generator=g, device=device)
    scale = torch.repeat_interleave(torch.tensor(bounds, device=device), torch.tensor(counts, device=device))
    conv_vals = (2 * u[: sum(counts)] - 1) * scale
    sd = {key: part.view(shape) for (key, shape), part in zip(conv_keys, torch.split(conv_vals, counts))}
    sd["alpha"] = (0.01 * u[sum(counts):]).view(nbf, nbf)
    sd["w"] = 0.01 * torch.randn((nbf, nbf), generator=g, device=device)
    sd["eta"] = torch.full((1,), 0.01, device=device)
    return sd


def dropout2d(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Dropout2d on NCHW: one keep draw per (sample, channel), kept channels
    scaled by 1 / (1 - rate). The draw is ``rand((B, 1, 1, C)) >= rate``
    from ``generator``, in the order the model meets its dropouts; None
    (eval) draws nothing."""
    if generator is None or rate == 0.0:
        return x
    b, c = x.shape[0], x.shape[1]
    keep = torch.rand((b, 1, 1, c), generator=generator, device=x.device) >= rate
    return x * keep.permute(0, 3, 1, 2).to(x.dtype) / (1.0 - rate)


def pad_to_match(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Pad or crop NCHW ``x`` to (h, w): top/left get diff // 2, bottom/right
    int(diff / 2), negative differences crop (the reference's F.pad)."""
    dh, dw = h - x.shape[2], w - x.shape[3]
    return F.pad(x, (dw // 2, int(dw / 2), dh // 2, int(dh / 2)))


def bce_logits(activ: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against the {0, 1} mask."""
    return F.binary_cross_entropy_with_logits(activ.reshape(-1), mask.reshape(-1))


class Adam:
    """Adam (betas 0.9, 0.999, eps 1e-8) by its formula, one rate; a
    parameter without a gradient is left alone, as torch.optim.Adam does."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = [0] * len(self.params)

    @torch.no_grad()
    def step(self) -> None:
        for i, p in enumerate(self.params):
            if p.grad is None:
                continue
            g = p.grad
            self.t[i] += 1
            t = self.t[i]
            self.m[i].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[i].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            m_hat = self.m[i] / (1 - self.b1 ** t)
            v_hat = self.v[i] / (1 - self.b2 ** t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


@contextlib.contextmanager
def numerics(tf32: bool = False):
    """float32 with TF32 off in cuDNN and cuBLAS (on only for a control's
    reading) and deterministic cuDNN algorithms, so that the reference gives
    the same bits on every run."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
