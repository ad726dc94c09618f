"""Residual-family conv blocks of UNetPRes (counterpart of the residual
family in plastic_unet_tpu.models.blocks; reference unet_p_res.py:142-272).

Activations are contiguous NHWC ``(B, H, W, C)`` tensors. Attribute names
reproduce the reference state_dict keys (``dconv.0``, ``dconv.1.conv.1.conv``,
``uconv.1.mconv.0`` ...), so reference ``.pth`` files load strictly.

Where the JAX package leaves a conv to XLA, the port leaves it to cuDNN (in
parity precision): each level's entry conv (Cin != C), the ConvTranspose and
the 1x1 outconv, through a channels_last NCHW view of the NHWC tensor. The
3x3 convs of every residual tail run through ops.residual_tail (forward:
the fused tail kernel or the conv3x3 kernel, by its tail_plan; backward: the
conv3x3 and conv3x3_wgrad kernels) (while torch.export traces the
forward, through the same launches as the custom op of ops.export_ops); the
cuDNN layers, pool, pad, cat and dropout differentiate through autograd.
Weights and biases take the torch-default init (U(-1/sqrt(fan_in),
1/sqrt(fan_in))) from an explicit generator.

int8 serving (``quant``, the JAX blocks' QuantConv3 / QuantConvT3): the 49
quantized convs (each level's entry conv, the four tail convs of each of
the 9 trunks, the 4 ConvTransposes) carry a non-persistent ``amax`` buffer,
None until calibrated and absent from the state_dict. ``quant="calib"``
runs the ordinary forward (the tail on the conv3x3 kernel) and keeps the
running max|input| of each; ``quant="int8"`` runs each of them through
ops.quant (the tail as its four int8 convs with the ReLUs and relu-skips).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from plastic_unet_tpu_torch.ops.export_ops import residual_tail_forward
from plastic_unet_tpu_torch.ops.quant import qconv3_same, qconvT3_s2_valid
from plastic_unet_tpu_torch.ops.residual_tail import residual_tail, residual_tail_ranges

QUANT_MODES = ("", "calib", "int8")


def init_conv_(conv: nn.Module, generator: torch.Generator | None) -> None:
    """torch-default init of a Conv2d / ConvTranspose2d from ``generator``:
    kaiming_uniform(a=sqrt(5)) is U(-b, b) with b = 1/sqrt(fan_in), and the
    bias uses the same bound (fan_in from dim 1 of the weight, as torch does)."""
    w = conv.weight
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        for p in (conv.weight, conv.bias):
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)


def dense_strides(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, with the strides a fresh tensor of its shape has.

    A contiguous tensor's size-1 dims may carry any stride: numpy's newaxis
    gives 0 (images (N, H, W) -> (N, H, W, 1)), a copy or ``torch.cat`` 1.
    cuDNN reads the strides when it picks the algorithm, so the same image
    with another stride on its channel dim took another algorithm for the
    entry conv (Cin=1) and other bits (ROADMAP.md, C5: one pass a TTA view
    against the views folded into the batch). The view costs no copy."""
    x = x.contiguous()
    want, step = [], 1
    for size in reversed(x.shape):
        want.insert(0, step)
        step *= max(size, 1)
    return x if x.stride() == tuple(want) else x.as_strided(x.shape, want)


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An nn.Conv2d / nn.ConvTranspose2d on NHWC ``x`` through cuDNN's
    channels_last path; returns contiguous NHWC, as the kernels take it."""
    y = conv(dense_strides(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).contiguous()


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max-pool with floor semantics (torch MaxPool2d(2)) on NHWC."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : 2 * h2, : 2 * w2, :].reshape(b, h2, 2, w2, 2, c)
    return x.amax(dim=(2, 4))


def pad_to_match(x: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Pad/crop NHWC ``x`` to (target_h, target_w) with the reference's
    arithmetic: left/top gets diff//2 (floor), right/bottom int(diff/2)
    (truncation); negative diffs crop, as torch F.pad does."""
    dh, dw = target_h - x.shape[1], target_w - x.shape[2]
    top, bottom = dh // 2, int(dh / 2)
    left, right = dw // 2, int(dw / 2)
    if top or bottom or left or right:
        x = F.pad(x, (0, 0, left, right, top, bottom))
    return x


def channel_dropout(x: torch.Tensor, rate: float, training: bool,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """torch Dropout2d on NHWC: one keep/drop draw per (sample, channel),
    survivors scaled by 1/(1-rate). A no-op in eval mode (it draws nothing),
    which is all the serving path runs. The draws come from ``generator``,
    which lives on ``x``'s device; the global generator is never used."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("channel_dropout: training with dropout needs an explicit torch.Generator "
                         "on the input's device")
    keep = torch.rand((x.shape[0], 1, 1, x.shape[3]), device=x.device, generator=generator) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)


def quantizable(conv: nn.Module) -> nn.Module:
    """``conv`` with the non-persistent ``amax`` buffer of the quant modes (None: not calibrated)."""
    conv.register_buffer("amax", None, persistent=False)
    return conv


def _note_range(conv: nn.Module, m: torch.Tensor) -> None:
    """calib: the running max of ``m`` (a max|input|) over the calibration chunks."""
    conv.amax = m if conv.amax is None else torch.maximum(conv.amax, m)


def _calibrated(conv: nn.Module) -> torch.Tensor:
    if conv.amax is None:
        raise RuntimeError("quant='int8' needs calibrated activation ranges: run "
                           "submit.quant.quantize_for_serving (or load_quant_ranges) first")
    return conv.amax


def quant_conv_nhwc(conv: nn.Module, x: torch.Tensor, quant: str, int8_fn) -> torch.Tensor:
    """:func:`conv_nhwc` of a quantizable conv in mode ``quant``; ``int8_fn``
    is its ops.quant form (qconv3_same or qconvT3_s2_valid)."""
    if quant == "int8":
        return int8_fn(x, conv.weight, conv.bias, _calibrated(conv))
    if quant == "calib":
        _note_range(conv, x.abs().amax())
    return conv_nhwc(conv, x)


class ConvModule(nn.Module):
    """The parameters of a conv3x3 [+ReLU] (reference conv_module), under
    the reference's key ``conv``; ops.residual_tail does the math."""

    def __init__(self, features: int):
        super().__init__()
        self.conv = quantizable(nn.Conv2d(features, features, 3, padding=1))


class ResidualBlock(nn.Module):
    """The parameters of ReLU -> conv_module -> conv_module(no act), + skip
    (reference residual_block). The reference's leading
    ``nn.ReLU(inplace=True)`` mutates the block input, so the skip it adds is
    relu(input). A trunk's two blocks run as one ops.residual_tail, forward
    and backward; the block has no forward of its own."""

    def __init__(self, features: int):
        super().__init__()
        # Index 0 is the (parameter-free) ReLU, kept so the keys are conv.1 / conv.2.
        self.conv = nn.ModuleList([nn.ReLU(), ConvModule(features), ConvModule(features)])

    def convs(self) -> tuple:
        return self.conv[1].conv, self.conv[2].conv

    def tail_params(self) -> tuple:
        c1, c2 = self.convs()
        return c1.weight, c1.bias, c2.weight, c2.bias


def _trunk(in_features: int, features: int) -> nn.ModuleList:
    """Sequential(Conv2d, residual_block, residual_block, ReLU) of down/middle."""
    return nn.ModuleList([
        quantizable(nn.Conv2d(in_features, features, 3, padding=1)),
        ResidualBlock(features),
        ResidualBlock(features),
        nn.ReLU(),
    ])


def _int8_tail(convs, x0: torch.Tensor) -> torch.Tensor:
    """The residual tail as four int8 convs (ops.quant), the ReLUs and the relu-skips."""
    def q(conv, t):
        return qconv3_same(t, conv.weight, conv.bias, _calibrated(conv))

    c11, c12, c21, c22 = convs
    h1 = torch.relu(x0)
    x1 = q(c12, torch.relu(q(c11, h1))) + h1
    h2 = torch.relu(x1)
    return torch.relu(q(c22, torch.relu(q(c21, h2))) + h2)


def _trunk_forward(seq: nn.ModuleList, x: torch.Tensor, quant: str = "") -> torch.Tensor:
    x = quant_conv_nhwc(seq[0], x, quant, qconv3_same)
    convs = seq[1].convs() + seq[2].convs()
    if quant == "int8":
        return _int8_tail(convs, x)
    params = seq[1].tail_params() + seq[2].tail_params()
    if quant == "calib":
        out, ranges = residual_tail_ranges(x, *params)
        for conv, m in zip(convs, ranges):
            _note_range(conv, m)
        return out
    if torch.compiler.is_exporting():  # the same launches as a custom op torch.export can trace
        return residual_tail_forward(x, *params)
    return residual_tail(x, *params)


class DownRes(nn.Module):
    """conv3x3 -> 2x residual -> ReLU (reference down)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.dconv = _trunk(in_features, features)

    def forward(self, x: torch.Tensor, quant: str = "") -> torch.Tensor:
        return _trunk_forward(self.dconv, x, quant)


class Middle(nn.Module):
    """The same trunk as DownRes (reference middle)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.mconv = _trunk(in_features, features)

    def forward(self, x: torch.Tensor, quant: str = "") -> torch.Tensor:
        return _trunk_forward(self.mconv, x, quant)


class UpRes(nn.Module):
    """ConvT(k3, s2, VALID) -> pad/crop to skip -> cat[x, skip] ->
    channel dropout -> middle (reference up; its middle never uses
    batch_norm)."""

    def __init__(self, in_features: int, features: int, dropout_ratio: float):
        super().__init__()
        self.dconv = quantizable(nn.ConvTranspose2d(in_features, features, 3, stride=2))
        # Index 0 is the Dropout2d of the reference's Sequential (no parameters).
        self.uconv = nn.ModuleList([nn.Dropout2d(dropout_ratio), Middle(in_features, features)])
        self.dropout_ratio = dropout_ratio

    def forward(self, x: torch.Tensor, skip: torch.Tensor,
                generator: torch.Generator | None = None, quant: str = "") -> torch.Tensor:
        x = quant_conv_nhwc(self.dconv, x, quant, qconvT3_s2_valid)
        x = pad_to_match(x, skip.shape[1], skip.shape[2])
        x = torch.cat([x, skip], dim=-1)
        x = channel_dropout(x, self.dropout_ratio, self.training, generator)
        return self.uconv[1](x, quant)
