"""The UNetPRes residual tail (counterpart of the forward of
plastic_unet_tpu.ops.pallas_trunk, ``_tail_fwd_kernel``).

Every DownRes / Middle (and the Middle inside every UpRes) ends with two
residual blocks and a ReLU, with the reference's inplace-ReLU skip quirk
(the skip adds relu(input), not input):

    h1 = relu(x0);  x1 = conv(relu(conv(h1))) + h1
    h2 = relu(x1);  x2 = conv(relu(conv(h2))) + h2
    out = relu(x2)

On CUDA tensors :func:`residual_tail` runs this as four launches of the
conv3x3 kernel, every ReLU, bias and skip fused into their loads and
epilogues, with no elementwise pass in between:

    pre11 = conv(relu(x0)) + b11
    x1    = conv(relu(pre11)) + b12 + relu(x0)
    pre21 = conv(relu(x1)) + b21
    out   = relu(conv(relu(pre21)) + b22 + relu(x1))

pre11, x1 and pre21 go to device memory only because the next launch reads
them; keeping them on chip in one halo-tiled kernel, the point of the TPU
design, is later work. The TPU layout devices (pack_factor, worth_fusing,
128-lane padding) are not carried over: every width takes this path.
"""

from __future__ import annotations

import torch

from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, hwio


def residual_tail_plain(x0, w11, b11, w12, b12, w21, b21, w22, b22):
    """The plain PyTorch version (any device): the unfused block math.
    Weights are torch Conv2d weights (C, C, 3, 3)."""
    def conv(x, wt, bt):
        return conv3x3_plain(x, hwio(wt), bt)

    h1 = torch.relu(x0)
    x1 = conv(torch.relu(conv(h1, w11, b11)), w12, b12) + h1
    h2 = torch.relu(x1)
    x2 = conv(torch.relu(conv(h2, w21, b21)), w22, b22) + h2
    return torch.relu(x2)


def residual_tail(x0, w11, b11, w12, b12, w21, b21, w22, b22):
    """(B, H, W, C) -> (B, H, W, C). CUDA inputs take the four conv3x3
    launches or raise; CPU inputs take :func:`residual_tail_plain`."""
    if x0.device.type == "cpu":
        return residual_tail_plain(x0, w11, b11, w12, b12, w21, b21, w22, b22)
    k11, k12, k21, k22 = (hwio(w) for w in (w11, w12, w21, w22))
    b11, b12, b21, b22 = (b.contiguous() for b in (b11, b12, b21, b22))
    pre11 = conv3x3(x0, k11, b11, relu_in=True)
    x1 = conv3x3(pre11, k12, b12, x0, relu_in=True, relu_res=True)
    pre21 = conv3x3(x1, k21, b21, relu_in=True)
    out = conv3x3(pre21, k22, b22, x1, relu_in=True, relu_res=True, relu_out=True)
    residual_tail.launches += 1
    return out


residual_tail.launches = 0
