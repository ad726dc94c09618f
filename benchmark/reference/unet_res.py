"""UNetPRes, the residual plastic U-Net, in plain PyTorch (published model:
yaricom/Plastic-UNet ``src/unet/unet_p_res.py``).

Widths neurons x {1, 2, 4, 8, 16}. Each level's trunk is a 3x3 conv, two
residual blocks and a ReLU; a residual block is ReLU -> conv3x3 -> ReLU ->
conv3x3, plus the block's input after the leading ReLU (the published
block's in-place ReLU makes the skip add relu(input)). The encoder pools
2x2 (floor) and drops channels (the first pool at half the rate); each
decoder level is a 3x3 transposed conv of stride 2 (no padding), padded
or cropped to the skip, concatenated [up, skip], dropped out and run
through a trunk. A 1x1 conv gives the (nbf, nbf) logits of the plastic
head. Departure from the published file: inputs are one (B, C, H, W)
batch of independent samples, each with its own trace, as the port trains
lanes; at B=1 it is the published model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reference.common import PlasticHead, dropout2d, pad_to_match, plastic_init, zero_trace


class ConvModule(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.Conv2d(c, c, 3, padding=1)


class ResidualBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = nn.ModuleList([nn.ReLU(), ConvModule(c), ConvModule(c)])

    def forward(self, x):
        h = F.relu(x)
        c1, c2 = self.conv[1].conv, self.conv[2].conv
        return c2(F.relu(c1(h))) + h


def trunk(cin: int, c: int) -> nn.ModuleList:
    return nn.ModuleList([nn.Conv2d(cin, c, 3, padding=1), ResidualBlock(c), ResidualBlock(c), nn.ReLU()])


def run_trunk(seq: nn.ModuleList, x):
    return F.relu(seq[2](seq[1](seq[0](x))))


class Down(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.dconv = trunk(cin, c)

    def forward(self, x):
        return run_trunk(self.dconv, x)


class Middle(nn.Module):
    def __init__(self, cin: int, c: int):
        super().__init__()
        self.mconv = trunk(cin, c)

    def forward(self, x):
        return run_trunk(self.mconv, x)


class Up(nn.Module):
    def __init__(self, cin: int, c: int, rate: float):
        super().__init__()
        self.dconv = nn.ConvTranspose2d(cin, c, 3, stride=2)
        self.uconv = nn.ModuleList([nn.Dropout2d(rate), Middle(cin, c)])
        self.rate = rate

    def forward(self, x, skip, generator):
        x = pad_to_match(self.dconv(x), skip.shape[2], skip.shape[3])
        x = dropout2d(torch.cat([x, skip], dim=1), self.rate, generator)
        return self.uconv[1](x)


class OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1)


class UNetPRes(PlasticHead):
    def __init__(self, n_channels: int = 1, n_classes: int = 1, neurons: int = 16, dropout_ratio: float = 0.5,
                 alfa_type: str = "free", rule: str = "hebb", nbf: int = 101):
        super().__init__()
        if alfa_type != "free":
            raise ValueError("the reference holds alpha as an (nbf, nbf) matrix ('free')")
        n = neurons
        self.add_head(nbf, rule)
        self.rate = dropout_ratio
        self.conv1 = Down(n_channels, n)
        self.conv2 = Down(n, 2 * n)
        self.conv3 = Down(2 * n, 4 * n)
        self.conv4 = Down(4 * n, 8 * n)
        self.mid = Middle(8 * n, 16 * n)
        self.uconv4 = Up(16 * n, 8 * n, dropout_ratio)
        self.uconv3 = Up(8 * n, 4 * n, dropout_ratio)
        self.uconv2 = Up(4 * n, 2 * n, dropout_ratio)
        self.uconv1 = Up(2 * n, n, dropout_ratio)
        self.outc = OutConv(n, n_classes)

    def forward(self, x, hebb, generator: torch.Generator | None = None):
        """x (B, C, H, W), hebb (B, nbf, nbf) -> (activ, activout, new hebb).
        ``generator`` draws the dropout masks (training); None is eval."""
        r, g = self.rate, generator
        xc1 = self.conv1(x)
        xc2 = self.conv2(dropout2d(F.max_pool2d(xc1, 2), r / 2, g))
        xc3 = self.conv3(dropout2d(F.max_pool2d(xc2, 2), r, g))
        xc4 = self.conv4(dropout2d(F.max_pool2d(xc3, 2), r, g))
        x5 = self.mid(dropout2d(F.max_pool2d(xc4, 2), r, g))
        u = self.uconv4(x5, xc4, g)
        u = self.uconv3(u, xc3, g)
        u = self.uconv2(u, xc2, g)
        u = self.uconv1(u, xc1, g)
        out = self.outc.conv(u)
        return self.head(out.reshape(out.shape[0], self.nbf, self.nbf), hebb)


Reference = UNetPRes
PORT = "plastic_unet_tpu_torch.models.unet_res:UNetPRes"
initial_state = zero_trace
init_weights = plastic_init
