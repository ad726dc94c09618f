"""The UNetPRes residual tail, forward and backward (counterpart of
plastic_unet_tpu.ops.pallas_trunk, ``_tail_fwd_kernel`` and
``_tail_bwd_kernel``).

Every DownRes / Middle (and the Middle inside every UpRes) ends with two
residual blocks and a ReLU, with the reference's inplace-ReLU skip quirk
(the skip adds relu(input), not input):

    h1 = relu(x0);  x1 = conv(relu(conv(h1))) + h1
    h2 = relu(x1);  x2 = conv(relu(conv(h2))) + h2
    out = relu(x2)

Forward. On CUDA tensors :func:`residual_tail` runs this as four launches of
the conv3x3 kernel, every ReLU, bias and skip fused into their loads and
epilogues, with no elementwise pass in between:

    pre11 = conv(relu(x0)) + b11
    x1    = conv(relu(pre11)) + b12 + relu(x0)
    pre21 = conv(relu(x1)) + b21
    out   = relu(conv(relu(pre21)) + b22 + relu(x1))

pre11, x1 and pre21 go to device memory because the next launch reads them,
and when autograd tracks an input they are kept for the backward together
with x0 and ``out``. The TPU kernel saves x2; the port never materialises it
(the last launch fuses the ReLU) and needs only its sign:
``(out > 0) == (x2 > 0)``, so ``out`` stands in. Under ``torch.no_grad()``
or ``inference_mode()`` nothing is kept.

Backward (:func:`residual_tail_backward`). The reverse chain as four launches
of the conv3x3 kernel in its input-gradient form (ops.conv3x3.conv3x3_dgrad)
and four of ops.conv3x3_wgrad, every ReLU mask and skip sum fused:

    d_pre21, d_x2 = dgrad(g, w22, in_gate=out, gate=pre21)   # d_x2 = g * (out > 0)
    dw22, db22    = wgrad(relu(pre21), d_x2)
    d_x1          = dgrad(d_pre21, w21, residual=d_x2, gate=x1)
    dw21, db21    = wgrad(relu(x1), d_pre21)
    d_pre11       = dgrad(d_x1, w12, gate=pre11)
    dw12, db12    = wgrad(relu(pre11), d_x1)
    dx0           = dgrad(d_pre11, w11, residual=d_x1, gate=x0)
    dw11, db11    = wgrad(relu(x0), d_pre11)

d_x2 is written once, by the first launch as it loads ``g`` through the
mask, because three later passes read it; the ReLUs of the wgrad inputs are
applied on load. Weight gradients come back in torch layout (C, C, 3, 3).

The TPU layout devices (pack_factor, worth_fusing, 128-lane padding) are not
carried over: every width takes this path. Keeping the intermediates on chip
in one halo-tiled kernel, the point of the TPU design, is later work.
"""

from __future__ import annotations

import torch

from plastic_unet_tpu_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_dgrad,
    conv3x3_dgrad_plain,
    conv3x3_plain,
    hwio,
)
from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad, conv3x3_wgrad_plain


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


def _forward(x0, k11, b11, k12, b12, k21, b21, k22, b22, conv):
    """The four fused passes; ``conv`` is the kernel wrapper or its plain
    version. Returns (out, pre11, x1, pre21)."""
    pre11 = conv(x0, k11, b11, relu_in=True)
    x1 = conv(pre11, k12, b12, x0, relu_in=True, relu_res=True)
    pre21 = conv(x1, k21, b21, relu_in=True)
    out = conv(pre21, k22, b22, x1, relu_in=True, relu_res=True, relu_out=True)
    return out, pre11, x1, pre21


def _backward(g, x0, pre11, x1, pre21, out, k11, k12, k21, k22, dgrad, wgrad):
    """The reverse chain of the module docstring; ``dgrad`` / ``wgrad`` are
    the kernel wrappers or their plain versions, the weights (3, 3, C, C)."""
    d_pre21, d_x2 = dgrad(g, k22, in_gate=out, gate=pre21)
    dw22, db22 = wgrad(pre21, d_x2, relu_in=True, layout="oihw")
    d_x1, _ = dgrad(d_pre21, k21, d_x2, gate=x1)
    dw21, db21 = wgrad(x1, d_pre21, relu_in=True, layout="oihw")
    d_pre11, _ = dgrad(d_x1, k12, gate=pre11)
    dw12, db12 = wgrad(pre11, d_x1, relu_in=True, layout="oihw")
    dx0, _ = dgrad(d_pre11, k11, d_x1, gate=x0)
    dw11, db11 = wgrad(x0, d_pre11, relu_in=True, layout="oihw")
    return dx0, dw11, db11, dw12, db12, dw21, db21, dw22, db22


def residual_tail_backward_plain(g, x0, pre11, x1, pre21, out, w11, w12, w21, w22):
    """The plain PyTorch version of :func:`residual_tail_backward` (any
    device): the chain step by step from the saved activations, through the
    plain dgrad and wgrad. Weights are torch Conv2d weights (C, C, 3, 3)."""
    ks = [hwio(w) for w in (w11, w12, w21, w22)]
    return _backward(g, x0, pre11, x1, pre21, out, *ks, conv3x3_dgrad_plain, conv3x3_wgrad_plain)


def residual_tail_backward(g, x0, pre11, x1, pre21, out, k11, k12, k21, k22):
    """(dx0, dw11, db11, dw12, db12, dw21, db21, dw22, db22) from the output
    gradient ``g`` and what the forward kept; ``k*`` are the (3, 3, C, C)
    weights the forward read. Weight gradients are (C, C, 3, 3). CUDA tensors
    take four dgrad and four wgrad launches or raise; CPU tensors the plain
    versions."""
    res = _backward(g, x0, pre11, x1, pre21, out, k11, k12, k21, k22, conv3x3_dgrad, conv3x3_wgrad)
    if g.device.type == "cuda":
        residual_tail_backward.launches += 1
    return res


class _ResidualTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x0, w11, b11, w12, b12, w21, b21, w22, b22):
        x0 = x0.contiguous()
        ks = [hwio(w) for w in (w11, w12, w21, w22)]
        bs = [b.contiguous() for b in (b11, b12, b21, b22)]
        out, pre11, x1, pre21 = _forward(x0, ks[0], bs[0], ks[1], bs[1], ks[2], bs[2], ks[3], bs[3], conv3x3)
        if x0.device.type == "cuda":
            residual_tail.launches += 1
        ctx.save_for_backward(x0, pre11, x1, pre21, out, *ks)
        return out

    @staticmethod
    def backward(ctx, g):
        return residual_tail_backward(g.contiguous(), *ctx.saved_tensors)


def residual_tail(x0, w11, b11, w12, b12, w21, b21, w22, b22):
    """(B, H, W, C) -> (B, H, W, C), differentiable in every argument. CUDA
    inputs take the four conv3x3 launches (and, in the backward, the dgrad
    and wgrad launches) or raise; CPU inputs the plain versions of each."""
    return _ResidualTail.apply(x0, w11, b11, w12, b12, w21, b21, w22, b22)


residual_tail.launches = 0
residual_tail_backward.launches = 0
