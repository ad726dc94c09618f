"""UNetP, the classic plastic U-Net, in plain PyTorch (published model:
yaricom/Plastic-UNet ``src/unet/unet_p.py``).

inconv (-> 8), down1..4 (max-pool 2x2, two 3x3 conv + ReLU; 8 -> 16 -> 32
-> 64 -> 64), up1..4 (2x2 transposed conv of stride 2, the skip padded or
cropped to it, concatenated [skip, up], two 3x3 conv + ReLU; 128 -> 32,
64 -> 16, 32 -> 8, 16 -> 8), a 1x1 conv, then the plastic head on the
(nbf, nbf) logits. The transposed-conv variant (``bilinear=False``).
Departure from the published file: a batch of independent samples, each
with its own trace.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reference.common import PlasticHead, pad_to_match, plastic_init, zero_trace


class DoubleConv(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(cin, c, 3, padding=1), nn.ReLU(), nn.Conv2d(c, c, 3, padding=1),
                                   nn.ReLU()])

    def forward(self, x):
        return F.relu(self.conv[2](F.relu(self.conv[0](x))))


class InConv(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.conv = DoubleConv(cin, c)


class Down(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.mpconv = nn.ModuleList([nn.MaxPool2d(2), DoubleConv(cin, c)])

    def forward(self, x):
        return self.mpconv[1](F.max_pool2d(x, 2))


class Up(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin // 2, cin // 2, 2, stride=2)
        self.conv = DoubleConv(cin, c)

    def forward(self, x, skip):
        x = self.up(x)
        skip = pad_to_match(skip, x.shape[2], x.shape[3])
        return self.conv(torch.cat([skip, x], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)


class UNetP(PlasticHead):
    def __init__(self, n_channels: int = 1, n_classes: int = 1, alfa_type: str = "free", rule: str = "hebb",
                 nbf: int = 128):
        super().__init__()
        if alfa_type != "free":
            raise ValueError("the reference holds alpha as an (nbf, nbf) matrix ('free')")
        self.add_head(nbf, rule)
        self.inc = InConv(n_channels, 8)
        self.down1 = Down(8, 16)
        self.down2 = Down(16, 32)
        self.down3 = Down(32, 64)
        self.down4 = Down(64, 64)
        self.up1 = Up(128, 32)
        self.up2 = Up(64, 16)
        self.up3 = Up(32, 8)
        self.up4 = Up(16, 8)
        self.outc = OutConv(8, n_classes)

    def forward(self, x, hebb, generator: torch.Generator | None = None):
        """x (B, C, H, W), hebb (B, nbf, nbf) -> (activ, activout, new hebb);
        UNetP has no dropout, so ``generator`` is not read."""
        x1 = self.inc.conv(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        u = self.up1(x5, x4)
        u = self.up2(u, x3)
        u = self.up3(u, x2)
        u = self.up4(u, x1)
        out = self.outc.conv(u)
        return self.head(out.reshape(out.shape[0], self.nbf, self.nbf), hebb)


Reference = UNetP
PORT = "plastic_unet_tpu_torch.models.unet_classic:UNetP"
initial_state = zero_trace
init_weights = plastic_init
