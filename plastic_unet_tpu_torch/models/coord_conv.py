"""CoordConv U-Net — the third model family (counterpart of
plastic_unet_tpu.models.coord_conv; the reference's independent Keras
solution, src/coord_conv_script.py:104-200).

input/255 -> CoordConv stem (ops.coords.add_coords, then a 1x1 conv of 8
filters and ReLU) -> the classic 4-level U-Net at widths 8/16/32/64/128:
two 3x3 SAME ReLU convs a level, 2x2 max-pools, ConvTranspose k2 s2 SAME
ups with the concat [up, skip] -> a 1x1 conv and a sigmoid. NHWC in,
``(B, H, W, 1)`` probabilities out; inputs must be divisible by 16.

Every layer runs on cuDNN / ATen, as the JAX module computes them with
``nn.Conv`` outside any Pallas kernel. The parameters are held in creation
order, as the flax tree names them: ``convs.i`` is ``Conv_i`` (i = 0..19,
the stem first, the 1x1 output conv last) and ``upconvs.j`` is
``ConvTranspose_j`` (utils.torch_interop.coord_conv_name_map). A flax
``ConvTranspose`` with SAME padding does not flip its kernel, where torch's
does: the name map carries the kernel flipped. Kernels take Keras's
glorot-uniform init, biases zero, from an explicit generator.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from plastic_unet_tpu_torch.models.blocks import conv_nhwc, max_pool_2x2
from plastic_unet_tpu_torch.ops.coords import add_coords

WIDTHS = (8, 16, 32, 64, 128)


def glorot_uniform_(conv: nn.Module, generator: torch.Generator | None) -> None:
    """Keras glorot_uniform on the kernel, U(-l, l) with l = sqrt(6 / (fan_in
    + fan_out)) over the receptive field, and a zero bias."""
    w = conv.weight
    fan_sum = (w.shape[0] + w.shape[1]) * w.shape[2] * w.shape[3]
    limit = math.sqrt(6.0 / fan_sum)
    with torch.no_grad():
        w.copy_(torch.rand(w.shape, generator=generator) * (2 * limit) - limit)
        conv.bias.zero_()


class CoordConvUNet(nn.Module):
    """CoordConv U-Net (reference construct_model); the fields of the JAX
    module and ``generator`` (None draws from the global generator)."""

    def __init__(self, im_chan: int = 1, with_r: bool = False, scale_input: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.im_chan, self.with_r, self.scale_input = im_chan, with_r, scale_input
        convs = [nn.Conv2d(im_chan + (3 if with_r else 2), WIDTHS[0], 1)]
        cin = WIDTHS[0]
        for f in WIDTHS:  # the contracting path and the bottom: two 3x3 convs a level
            convs += [nn.Conv2d(cin, f, 3, padding=1), nn.Conv2d(f, f, 3, padding=1)]
            cin = f
        ups = []
        for f in reversed(WIDTHS[:-1]):  # the expanding path: ConvT, then two 3x3 convs on [up, skip]
            ups.append(nn.ConvTranspose2d(cin, f, 2, stride=2))
            convs += [nn.Conv2d(2 * f, f, 3, padding=1), nn.Conv2d(f, f, 3, padding=1)]
            cin = f
        convs.append(nn.Conv2d(cin, 1, 1))
        self.convs, self.upconvs = nn.ModuleList(convs), nn.ModuleList(ups)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        for m in list(self.convs) + list(self.upconvs):
            glorot_uniform_(m, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:  # unbatched convenience input
            x = x[None]
        s = x / 255.0 if self.scale_input else x
        relu = torch.relu
        it = iter(self.convs)
        h = relu(conv_nhwc(next(it), add_coords(s, self.with_r)))
        skips = []
        for level in range(len(WIDTHS)):
            if level:
                h = max_pool_2x2(h)
            h = relu(conv_nhwc(next(it), h))
            h = relu(conv_nhwc(next(it), h))
            skips.append(h)
        skips.pop()  # the bottom level is not a skip
        for up in self.upconvs:
            h = torch.cat([conv_nhwc(up, h), skips.pop()], dim=-1)
            h = relu(conv_nhwc(next(it), h))
            h = relu(conv_nhwc(next(it), h))
        return torch.sigmoid(conv_nhwc(next(it), h))
