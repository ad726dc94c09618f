"""UNetP — the classic plastic U-Net (counterpart of
plastic_unet_tpu.models.unet_classic; reference UNetp, unet_p.py:8-94).

inconv (-> 8), down1..4 (8 -> 16 -> 32 -> 64 -> 64, max-pool + double
conv), up1..4 with skip concats in the order [skip, x] (up 128 -> 32,
64 -> 16, 32 -> 8, 16 -> 8), a 1x1 outconv, then the same plastic head as
UNetPRes (ops.plastic_head: csrc/plastic_head.cu on the card). The convs,
the ConvTransposes and the bilinear upsample stay on cuDNN / ATen
(models.blocks, classic family). Inputs are NHWC ``(B, H, W, C)``, the
trace ``(B, nbf, nbf)``.

Geometry (kept from the reference): the upsampled map doubles exactly, so
the skips are cropped to it when the input is not divisible by 16; at
101 px the output is 96x96 and the (nbf, nbf) reshape raises the JAX
module's ValueError. The reference runs UNetp at 128 px only.

The constructor takes every field of the JAX module. ``use_pallas`` is
accepted and changes nothing (the CUDA head is the only path on the card);
``batch_norm`` puts flax-semantics BN (models.blocks.BatchNorm) after each
conv of every DoubleConv. UNetP has no dropout: ``forward`` takes a
``generator`` only to share UNetPRes's signature (train.loop, eval), and
reads none.
"""

from __future__ import annotations

import torch
from torch import nn

from plastic_unet_tpu_torch.models.blocks import Down, InConv, UpClassic, conv_nhwc, init_conv_
from plastic_unet_tpu_torch.models.unet_res import OutConv, PlasticHeadNet, PlasticOutput
from plastic_unet_tpu_torch.ops.plasticity import check_head_args


class UNetP(PlasticHeadNet):
    """Classic plastic U-Net; arguments mirror the JAX module's, in its
    order, and ``generator``, which seeds the initial weights (torch-default
    conv init, w ~ 0.01*randn, alpha ~ 0.01*rand, eta = 0.01; BN scale 1,
    bias 0); None draws from the global generator."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1, alfa_type: str = "free", rule: str = "hebb",
                 nbf: int = 128, batch_norm: bool = False, bilinear_upsample: bool = False,
                 use_pallas: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        check_head_args(rule, alfa_type)
        self.n_channels, self.nbf, self.rule, self.alfa_type = n_channels, nbf, rule, alfa_type
        self.batch_norm, self.bilinear_upsample, self.use_pallas = batch_norm, bilinear_upsample, use_pallas
        self.add_head(nbf)
        bn, bil = batch_norm, bilinear_upsample
        self.inc = InConv(n_channels, 8, bn)
        self.down1 = Down(8, 16, bn)
        self.down2 = Down(16, 32, bn)
        self.down3 = Down(32, 64, bn)
        self.down4 = Down(64, 64, bn)
        self.up1 = UpClassic(128, 32, bil, bn)
        self.up2 = UpClassic(64, 16, bil, bn)
        self.up3 = UpClassic(32, 8, bil, bn)
        self.up4 = UpClassic(16, 8, bil, bn)
        self.outc = OutConv(8, n_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    init_conv_(m, generator)
            self.reset_head(generator)

    def forward(self, x: torch.Tensor, hebb: torch.Tensor,
                generator: torch.Generator | None = None) -> PlasticOutput:
        if x.dim() == 3:  # unbatched convenience input
            x = x[None]
            hebb = hebb[None] if hebb.dim() == 2 else hebb
        x1 = self.inc(x.contiguous())
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        u = self.up1(x5, x4)
        u = self.up2(u, x3)
        u = self.up3(u, x2)
        u = self.up4(u, x1)
        out = conv_nhwc(self.outc.conv, u)  # (B, H, W, n_classes)

        b = out.shape[0]
        if out.numel() != b * self.nbf * self.nbf:
            raise ValueError(
                "UNetP output (%s) cannot be reshaped to (B, nbf=%d, nbf); "
                "UNetP requires inputs divisible by 16 (e.g. 128 px), as in "
                "the reference" % (tuple(out.shape), self.nbf)
            )
        return self.head(out.reshape(b, self.nbf, self.nbf), hebb)
