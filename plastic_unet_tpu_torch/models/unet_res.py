"""UNetPRes — the residual plastic U-Net (counterpart of
plastic_unet_tpu.models.unet_res; reference unet_p_res.py:9-140).

Encoder 4x (DownRes, 2x2 max-pool, channel dropout), Middle, decoder 4x
UpRes with skip concats, 1x1 outconv, then the plastic head on the
(nbf, nbf) logits. Widths are neurons x {1, 2, 4, 8, 16}; the 101-px track
is 101 -> 50 -> 25 -> 12 -> 6 -> (up) -> 101; the first pool drops at half
the rate. Inputs are NHWC ``(B, H, W, C)`` and the trace is ``(B, nbf, nbf)``,
one independent stream per batch element.

``quant`` is the int8 serving mode of the JAX module ('' off, 'calib'
records each quantized conv's range, 'int8' serves from them; see
models.blocks and submit.quant). The ranges live in non-persistent buffers
(:meth:`UNetPRes.quant_ranges`), so a reference ``.pth`` loads strictly
either way; the 1x1 outconv and the head stay fp32.

Not ported yet (see ROADMAP.md): fold_hires, trunk_pad, coord_conv,
remat_trunk, patch_conv, fast_dw, compute_dtype, batch_norm.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
from torch import nn

from plastic_unet_tpu_torch.models.blocks import (
    QUANT_MODES,
    DownRes,
    Middle,
    UpRes,
    channel_dropout,
    conv_nhwc,
    init_conv_,
    max_pool_2x2,
)
from plastic_unet_tpu_torch.ops.export_ops import plastic_head_forward
from plastic_unet_tpu_torch.ops.plastic_head import plastic_head
from plastic_unet_tpu_torch.ops.plasticity import check_head_args


class PlasticOutput(NamedTuple):
    activ: torch.Tensor  # pre-sigmoid logits of the head (B, nbf, nbf)
    activout: torch.Tensor  # sigmoid probabilities == predicted mask (B, nbf, nbf)
    hebb: torch.Tensor  # updated trace (B, nbf, nbf)


class OutConv(nn.Module):
    """1x1 conv (reference outconv; key ``outc.conv``)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 1)


class UNetPRes(nn.Module):
    """Residual plastic U-Net; arguments mirror the JAX module's.

    ``generator`` seeds the initial weights (torch-default conv init,
    w ~ 0.01*randn, alpha ~ 0.01*rand, eta = 0.01); None draws from the
    global generator. alpha is an (nbf, nbf) matrix for either alfa_type,
    as in the JAX module, where alfa_type only selects the head's contract."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1, neurons: int = 16,
                 dropout_ratio: float = 0.5, alfa_type: str = "free", rule: str = "hebb",
                 nbf: int = 128, plastic: bool = True, quant: str = "",
                 generator: torch.Generator | None = None):
        super().__init__()
        check_head_args(rule, alfa_type)
        n = neurons
        self.n_channels, self.neurons = n_channels, neurons
        self.nbf, self.rule, self.alfa_type, self.plastic, self.quant = nbf, rule, alfa_type, plastic, quant
        self.dropout_ratio = dropout_ratio
        if plastic:
            self.w = nn.Parameter(torch.empty(nbf, nbf))
            self.alpha = nn.Parameter(torch.empty(nbf, nbf))
            self.eta = nn.Parameter(torch.empty(1))
        self.conv1 = DownRes(n_channels, n)
        self.conv2 = DownRes(n, n * 2)
        self.conv3 = DownRes(n * 2, n * 4)
        self.conv4 = DownRes(n * 4, n * 8)
        self.mid = Middle(n * 8, n * 16)
        self.uconv4 = UpRes(n * 16, n * 8, dropout_ratio)
        self.uconv3 = UpRes(n * 8, n * 4, dropout_ratio)
        self.uconv2 = UpRes(n * 4, n * 2, dropout_ratio)
        self.uconv1 = UpRes(n * 2, n, dropout_ratio)
        self.outc = OutConv(n, n_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    init_conv_(m, generator)
            if self.plastic:
                self.w.copy_(0.01 * torch.randn(self.w.shape, generator=generator))
                self.alpha.copy_(0.01 * torch.rand(self.alpha.shape, generator=generator))
                self.eta.fill_(0.01)

    def quant_ranges(self) -> dict:
        """torch module prefix (``conv1.dconv.0``, ``uconv4.dconv``, ...) ->
        calibrated amax, for each quantized conv that has one."""
        return {name[: -len(".amax")]: b for name, b in self.named_buffers() if name.endswith(".amax")}

    def load_quant_ranges(self, ranges: Mapping) -> None:
        """Set every quantized conv's amax from ``ranges`` (prefix -> scalar),
        on the conv's device; the prefixes must be exactly the 49 convs'."""
        convs = {name: m for name, m in self.named_modules() if "amax" in m._buffers}
        if set(ranges) != set(convs):
            raise KeyError(f"quant ranges: missing {sorted(set(convs) - set(ranges))}, "
                           f"unknown {sorted(set(ranges) - set(convs))}")
        for name, v in ranges.items():
            conv = convs[name]
            conv.amax = torch.as_tensor(v, dtype=torch.float32).to(conv.weight.device).reshape(())

    def initial_zero_hebb(self, batch: int = 1, device=None) -> torch.Tensor:
        """Batched zero trace (reference initialZeroHebb)."""
        return torch.zeros((batch, self.nbf, self.nbf), device=device)

    def forward(self, x: torch.Tensor, hebb: torch.Tensor,
                generator: torch.Generator | None = None) -> PlasticOutput:
        """``generator`` (on ``x``'s device) feeds the channel dropout in
        train mode; eval mode draws nothing and needs none. A training
        caller passes the trace detached (train.loop does)."""
        if x.dim() == 3:  # unbatched convenience input
            x = x[None]
            hebb = hebb[None] if hebb.dim() == 2 else hebb
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant must be '', 'calib' or 'int8', got {self.quant!r}")
        x = x.contiguous()
        tr, r, g, q = self.training, self.dropout_ratio, generator, self.quant
        xc1 = self.conv1(x, q)
        x1 = channel_dropout(max_pool_2x2(xc1), r / 2, tr, g)
        xc2 = self.conv2(x1, q)
        x2 = channel_dropout(max_pool_2x2(xc2), r, tr, g)
        xc3 = self.conv3(x2, q)
        x3 = channel_dropout(max_pool_2x2(xc3), r, tr, g)
        xc4 = self.conv4(x3, q)
        x4 = channel_dropout(max_pool_2x2(xc4), r, tr, g)
        x5 = self.mid(x4, q)
        u = self.uconv4(x5, xc4, g, q)
        u = self.uconv3(u, xc3, g, q)
        u = self.uconv2(u, xc2, g, q)
        u = self.uconv1(u, xc1, g, q)
        out = conv_nhwc(self.outc.conv, u)  # (B, H, W, n_classes)

        b = out.shape[0]
        if out.numel() != b * self.nbf * self.nbf:
            raise ValueError(
                "U-Net output (%s) cannot be reshaped to (B, nbf=%d, nbf); nbf must equal "
                "the image width (reference sets nbf=img_width, train.py:285-288)"
                % (tuple(out.shape), self.nbf)
            )
        activin = out.reshape(b, self.nbf, self.nbf)
        if not self.plastic:
            # vanilla U-Net: sigmoid on the trunk logits; the trace passes through
            return PlasticOutput(activ=activin, activout=torch.sigmoid(activin), hebb=hebb)
        if torch.compiler.is_exporting():  # the same launch as a custom op torch.export can trace
            activ, activout, new_hebb = plastic_head_forward(
                self.w, self.alpha, self.eta, activin, hebb, self.rule, self.alfa_type)
        else:
            activ, activout, new_hebb = plastic_head(
                self.w, self.alpha, self.eta, activin, hebb, rule=self.rule, alfa_type=self.alfa_type
            )
        return PlasticOutput(activ=activ, activout=activout, hebb=new_hebb)
