"""Residual-family conv blocks of UNetPRes (counterpart of the residual
family in plastic_unet_tpu.models.blocks; reference unet_p_res.py:142-272).

Activations are contiguous NHWC ``(B, H, W, C)`` tensors. Attribute names
reproduce the reference state_dict keys (``dconv.0``, ``dconv.1.conv.1.conv``,
``uconv.1.mconv.0`` ...), so reference ``.pth`` files load strictly.

The 3x3 convs of every residual tail run through ops.residual_tail (forward:
the fused tail kernel or the conv3x3 kernel, by its tail_plan; backward: the
conv3x3 and conv3x3_wgrad kernels) (while torch.export traces the
forward, through the same launches as the custom op of ops.export_ops).
Each trunk's entry conv (Cin != C, :class:`EntryConv`) runs on the same
kernels where Cin is a multiple of the kernel's 16-channel slice
(ops.conv3x3.conv3x3_same: conv3x3 forward, conv3x3_dgrad and conv3x3_wgrad
backward), and on cuDNN where it is not (the stem, Cin 1 or 3). The
ConvTranspose and the 1x1 outconv stay on cuDNN (in parity precision),
through a channels_last NCHW view of the NHWC tensor. The cuDNN layers,
pool, pad, cat and dropout differentiate through autograd.
Weights and biases take the torch-default init (U(-1/sqrt(fan_in),
1/sqrt(fan_in))) from an explicit generator.

With ``batch_norm`` (the JAX blocks' layout: ResidualBlock is relu(x) ->
BN -> [conv -> BN -> ReLU] -> [conv -> BN] -> + relu(x); UpRes's middle
never has BN) a trunk's two residual blocks run unfused, each 3x3 conv
through ops.conv3x3.conv3x3_same (the conv3x3 kernel forward, conv3x3_dgrad
and conv3x3_wgrad backward) and BN as pointwise ATen work; the BN-free
trunks keep ops.residual_tail. :class:`BatchNorm` has flax nn.BatchNorm's
semantics, not torch BatchNorm2d's (see there).

int8 serving (``quant``, the JAX blocks' QuantConv3 / QuantConvT3): the 49
quantized convs (each level's entry conv, the four tail convs of each of
the 9 trunks, the 4 ConvTransposes) carry a non-persistent ``amax`` buffer,
None until calibrated and absent from the state_dict. ``quant="calib"``
runs the ordinary forward (the tail and the routed entry convs on the
conv3x3 kernel) and keeps the running max|input| of each;
``quant="int8"`` runs each of them through
ops.quant (the tail as its four int8 convs with the ReLUs and relu-skips).

A ``dtype`` (the model's compute dtype, torch.bfloat16) runs the JAX
blocks' mixed precision (``nn.Conv(dtype=...)``): every trunk conv casts its
input, weight and bias to it, rounds the conv to it, then adds the bias in
it (:func:`conv_nhwc`), and the ReLUs, skips, pool, pad, concat and dropout
run in it. The JAX blocks run the fused Pallas tail only at ``dtype`` None,
so a bf16 trunk is cuDNN's bf16 convs throughout, the entry conv and the
four tail convs too (:func:`_conv_tail`): the route is picked by the dtype,
and the fp32 kernels of ops.residual_tail and ops.conv3x3 are not called
(they raise for bf16).
BN computes its statistics and normalises in fp32 (:class:`BatchNorm`). The
parameters stay fp32, and their gradients reach them through the casts.

The classic family (UNetP; the JAX blocks' DoubleConv / UpClassic,
reference unet_p.py:96-261) is at the end: :class:`DoubleConv`,
:class:`InConv`, :class:`Down`, :class:`UpClassic`. Its convs, the
ConvTranspose and the bilinear upsample stay on cuDNN / ATen, as the JAX
UNetP computes them with ``nn.Conv`` outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from plastic_unet_tpu_torch.ops.conv3x3 import CK, conv3x3_same
from plastic_unet_tpu_torch.ops.export_ops import entry_conv_forward, residual_tail_forward
from plastic_unet_tpu_torch.ops.quant import qconv3_same, qconvT3_s2_valid
from plastic_unet_tpu_torch.ops.residual_tail import residual_tail, residual_tail_ranges
from plastic_unet_tpu_torch.utils.profiling import count

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


def conv_nhwc(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype | None = None,
              forward=None) -> torch.Tensor:
    """An nn.Conv2d / nn.ConvTranspose2d on NHWC ``x`` through cuDNN's
    channels_last path; returns contiguous NHWC, as the kernels take it.

    ``dtype`` (None: the module's fp32 call, or ``forward`` on the NCHW view
    where given) is flax ``nn.Conv(dtype=...)``:
    the input, the weight and the bias cast to it, the conv without its bias
    rounded to it, then the bias added in it. A conv with a fused bias would
    add the bias before the one rounding (oneDNN does on the CPU)."""
    if dtype is None:
        y = (forward or conv)(dense_strides(x).permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1).contiguous()
    xd, w = dense_strides(x.to(dtype)).permute(0, 3, 1, 2), conv.weight.to(dtype)
    if isinstance(conv, nn.ConvTranspose2d):
        y = F.conv_transpose2d(xd, w, None, conv.stride, conv.padding, conv.output_padding)
    else:
        y = F.conv2d(xd, w, None, conv.stride, conv.padding)
    return (y.permute(0, 2, 3, 1) + conv.bias.to(dtype)).contiguous()


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


def draw_keep(b: int, c: int, rate: float, training: bool, generator: torch.Generator | None,
              device) -> torch.Tensor | None:
    """The keep mask (B, 1, 1, C) of :func:`channel_dropout`, or None where
    it draws nothing (eval mode, rate 0)."""
    if not training or rate == 0.0:
        return None
    if generator is None:
        raise ValueError("channel_dropout: training with dropout needs an explicit torch.Generator "
                         "on the input's device")
    return torch.rand((b, 1, 1, c), device=device, generator=generator) >= rate


def channel_dropout(x: torch.Tensor, rate: float, training: bool,
                    generator: torch.Generator | None = None, keep: torch.Tensor | None = None) -> torch.Tensor:
    """torch Dropout2d on NHWC: one keep/drop draw per (sample, channel),
    survivors scaled by 1/(1-rate). A no-op in eval mode (it draws nothing),
    which is all the serving path runs. The draws come from ``generator``,
    which lives on ``x``'s device; the global generator is never used.
    ``keep`` (from :func:`draw_keep`) is a mask drawn earlier, which then
    takes the place of a draw (remat_trunk's replay)."""
    if keep is None:
        keep = draw_keep(x.shape[0], x.shape[3], rate, training, generator, x.device)
    if keep is None:
        return x
    return x * keep.to(x.dtype) / float(torch.tensor(1.0 - rate, dtype=x.dtype))  # flax: keep_prob in x's dtype


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


def quant_conv_nhwc(conv: nn.Module, x: torch.Tensor, quant: str, int8_fn,
                    dtype: torch.dtype | None = None, forward=None) -> torch.Tensor:
    """:func:`conv_nhwc` of a quantizable conv in mode ``quant`` and compute
    ``dtype`` (``forward`` as there); ``int8_fn`` is its ops.quant form
    (qconv3_same or qconvT3_s2_valid), which quantizes the fp32 weight, as the JAX
    QuantConv3 does, and returns ``dtype``. calib records max|x| of the
    input as it arrives (bf16 activations in a bf16 trunk)."""
    if quant == "int8":
        return int8_fn(x, conv.weight, conv.bias, _calibrated(conv), dtype or torch.float32)
    if quant == "calib":
        _note_range(conv, x.abs().amax().to(torch.float32))
    return conv_nhwc(conv, x, dtype, forward)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm on NHWC (the JAX blocks' BN; flax 0.12.3 defaults):
    statistics over (B, H, W), the variance as E[x^2] - E[x]^2 clipped at 0
    (use_fast_variance), epsilon 1e-5, and running averages
    ``ra = 0.99 * ra + 0.01 * batch`` of the mean and of the biased batch
    variance; y = (x - mean) * (rsqrt(var + eps) * weight) + bias. Train mode
    normalises by the batch and updates the running buffers (what the JAX
    ``apply(..., mutable=["batch_stats"])`` returns); eval mode reads them.
    The keys are BatchNorm2d's (weight = flax scale, bias, running_mean =
    flax mean, running_var = flax var): no reference layout with BN exists."""

    EPS, MOMENTUM = 1e-5, 0.99

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """Statistics and normalisation in fp32, as flax computes them; the
        output in ``dtype``, or fp32 where it is None (flax BN without a
        ``dtype`` promotes a bf16 input with its fp32 parameters)."""
        xf = x.to(torch.float32)
        if self.training:
            mean = xf.mean(dim=(0, 1, 2))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 1, 2)) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * (torch.rsqrt(var + self.EPS) * self.weight) + self.bias
        return y if dtype is None else y.to(dtype)


class ConvModule(nn.Module):
    """The parameters of a conv3x3 [+BN] [+ReLU] (reference conv_module),
    the conv under the reference's key ``conv``, the BN (``batch_norm``)
    beside it as ``bn``; ops.residual_tail, or with BN :func:`_bn_tail`,
    does the math."""

    def __init__(self, features: int, batch_norm: bool = False):
        super().__init__()
        self.conv = quantizable(nn.Conv2d(features, features, 3, padding=1))
        if batch_norm:
            self.bn = BatchNorm(features)


class ResidualBlock(nn.Module):
    """The parameters of ReLU [-> BN] -> conv_module -> conv_module(no act),
    + skip (reference residual_block). The reference's leading
    ``nn.ReLU(inplace=True)`` mutates the block input, so the skip it adds is
    relu(input). A trunk's two blocks run as one ops.residual_tail, forward
    and backward, or with BN as :func:`_bn_tail`; the block has no forward
    of its own. The BN after the leading ReLU is ``bn``."""

    def __init__(self, features: int, batch_norm: bool = False):
        super().__init__()
        # Index 0 is the (parameter-free) ReLU, kept so the keys are conv.1 / conv.2.
        self.conv = nn.ModuleList([nn.ReLU(), ConvModule(features, batch_norm), ConvModule(features, batch_norm)])
        if batch_norm:
            self.bn = BatchNorm(features)

    def convs(self) -> tuple:
        return self.conv[1].conv, self.conv[2].conv

    def tail_params(self) -> tuple:
        c1, c2 = self.convs()
        return c1.weight, c1.bias, c2.weight, c2.bias


class EntryConv(nn.Conv2d):
    """A trunk's entry conv, the reference's ``Conv2d(in, out, 3, padding=1)``
    (same keys and init), called as a module on NHWC ``x`` with the trunk's
    ``quant`` and ``dtype``. Its route is read off the input: in fp32 and
    not int8, with Cin a multiple of the conv3x3 kernel's 16-channel slice
    (ops.conv3x3.CK), ops.conv3x3.conv3x3_same (the plain versions on CPU
    tensors; while torch.export traces, the same launch as the custom op of
    ops.export_ops); else :func:`quant_conv_nhwc` (cuDNN, or ops.quant in
    int8). A narrower Cin would fill the kernel's slice with zeros. Each
    call counts ``kernel.entry.kernel`` or ``kernel.entry.library`` by the
    route it took."""

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, 3, padding=1)
        quantizable(self)

    def forward(self, x: torch.Tensor, quant: str = "", dtype: torch.dtype | None = None) -> torch.Tensor:
        if quant == "int8" or dtype is not None or x.shape[-1] % CK:
            count("kernel.entry.library")
            return quant_conv_nhwc(self, x, quant, qconv3_same, dtype, super().forward)
        count("kernel.entry.kernel")
        if quant == "calib":
            _note_range(self, x.abs().amax().to(torch.float32))
        if torch.compiler.is_exporting():  # the same launch as a custom op torch.export can trace
            return entry_conv_forward(x, self.weight, self.bias)
        return conv3x3_same(x, self.weight, self.bias)


def _trunk(in_features: int, features: int, batch_norm: bool = False) -> nn.ModuleList:
    """Sequential(Conv2d, residual_block, residual_block, ReLU) of down/middle."""
    return nn.ModuleList([
        EntryConv(in_features, features),
        ResidualBlock(features, batch_norm),
        ResidualBlock(features, batch_norm),
        nn.ReLU(),
    ])


def _bn_tail(blocks, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """The two residual blocks with BN, then the trunk's ReLU, unfused (the
    JAX blocks do not fuse a BN tail): each conv one conv3x3_same, or in a
    compute ``dtype`` one cuDNN conv in it. As in the JAX blocks, only the
    block's leading BN returns ``dtype``; the BNs after the convs return
    fp32, so in bf16 the skip sums and the trunk's output are fp32."""
    def conv(c, t):
        return conv3x3_same(t, c.weight, c.bias) if dtype is None else conv_nhwc(c, t, dtype)

    for blk in blocks:
        c1, c2 = blk.conv[1], blk.conv[2]
        h = torch.relu(x)
        y = torch.relu(c1.bn(conv(c1.conv, blk.bn(h, dtype))))
        x = c2.bn(conv(c2.conv, y)) + h
    return torch.relu(x)


def _conv_tail(convs, x0: torch.Tensor, conv) -> torch.Tensor:
    """The residual tail as four calls ``conv(module, x)`` (the int8 convs
    of ops.quant, or cuDNN's in a compute dtype), the ReLUs and the relu-skips."""
    c11, c12, c21, c22 = convs
    h1 = torch.relu(x0)
    x1 = conv(c12, torch.relu(conv(c11, h1))) + h1
    h2 = torch.relu(x1)
    return torch.relu(conv(c22, torch.relu(conv(c21, h2))) + h2)


def _trunk_forward(seq: nn.ModuleList, x: torch.Tensor, quant: str = "",
                   dtype: torch.dtype | None = None) -> torch.Tensor:
    x = seq[0](x, quant, dtype)
    if hasattr(seq[1], "bn"):
        return _bn_tail(seq[1:3], x, dtype)
    convs = seq[1].convs() + seq[2].convs()
    if quant == "int8" or dtype is not None:  # the JAX blocks fuse the tail only in fp32 and without quant
        return _conv_tail(convs, x, lambda c, t: quant_conv_nhwc(c, t, quant, qconv3_same, dtype))
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

    def __init__(self, in_features: int, features: int, batch_norm: bool = False):
        super().__init__()
        self.dconv = _trunk(in_features, features, batch_norm)

    def forward(self, x: torch.Tensor, quant: str = "", dtype: torch.dtype | None = None) -> torch.Tensor:
        return _trunk_forward(self.dconv, x, quant, dtype)


class Middle(nn.Module):
    """The same trunk as DownRes (reference middle)."""

    def __init__(self, in_features: int, features: int, batch_norm: bool = False):
        super().__init__()
        self.mconv = _trunk(in_features, features, batch_norm)

    def forward(self, x: torch.Tensor, quant: str = "", dtype: torch.dtype | None = None) -> torch.Tensor:
        return _trunk_forward(self.mconv, x, quant, dtype)


class UpRes(nn.Module):
    """ConvT(k3, s2, VALID) -> pad/crop to skip -> cat[x, skip] ->
    channel dropout -> middle (reference up; its middle never uses
    batch_norm). ``keep`` is a dropout mask (B, 1, 1, in_features) drawn
    before the call (:func:`draw_keep`), in place of a draw from
    ``generator``."""

    def __init__(self, in_features: int, features: int, dropout_ratio: float):
        super().__init__()
        self.dconv = quantizable(nn.ConvTranspose2d(in_features, features, 3, stride=2))
        # Index 0 is the Dropout2d of the reference's Sequential (no parameters).
        self.uconv = nn.ModuleList([nn.Dropout2d(dropout_ratio), Middle(in_features, features)])
        self.in_features, self.dropout_ratio = in_features, dropout_ratio

    def forward(self, x: torch.Tensor, skip: torch.Tensor, generator: torch.Generator | None = None,
                quant: str = "", keep: torch.Tensor | None = None, dtype: torch.dtype | None = None) -> torch.Tensor:
        x = quant_conv_nhwc(self.dconv, x, quant, qconvT3_s2_valid, dtype)
        x = pad_to_match(x, skip.shape[1], skip.shape[2])
        x = torch.cat([x, skip], dim=-1)
        x = channel_dropout(x, self.dropout_ratio, self.training, generator, keep)
        return self.uconv[1](x, quant, dtype)


# ---------------------------------------------------------------------------
# Classic family (UNetP, reference unet_p.py:96-261)
# ---------------------------------------------------------------------------

class DoubleConv(nn.Module):
    """(conv3 [+BN] ReLU) x2 (reference double_conv). ``conv`` is the
    reference's Sequential: Conv2d, ReLU, Conv2d, ReLU (keys ``conv.0``,
    ``conv.2``), or with ``batch_norm`` Conv2d, BN, ReLU, Conv2d, BN, ReLU
    (``conv.0``, ``conv.1``, ``conv.3``, ``conv.4``); the BN is
    :class:`BatchNorm`, flax semantics, as in the JAX DoubleConv."""

    def __init__(self, in_features: int, features: int, batch_norm: bool = False):
        super().__init__()
        layers = []
        for cin in (in_features, features):
            layers.append(nn.Conv2d(cin, features, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm(features))
            layers.append(nn.ReLU())
        self.conv = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.conv:
            x = conv_nhwc(m, x) if isinstance(m, nn.Conv2d) else m(x)
        return x


class InConv(nn.Module):
    """The first DoubleConv (reference inconv; keys ``conv.conv.*``)."""

    def __init__(self, in_features: int, features: int, batch_norm: bool = False):
        super().__init__()
        self.conv = DoubleConv(in_features, features, batch_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Down(nn.Module):
    """2x2 max-pool -> DoubleConv (reference down: ``mpconv`` is
    Sequential(MaxPool2d, double_conv), keys ``mpconv.1.conv.*``)."""

    def __init__(self, in_features: int, features: int, batch_norm: bool = False):
        super().__init__()
        self.mpconv = nn.ModuleList([nn.MaxPool2d(2), DoubleConv(in_features, features, batch_norm)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mpconv[1](max_pool_2x2(x))


def bilinear_upsample_2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of NHWC ``x`` with align_corners=True (torch
    nn.Upsample, unet_p.py:153); the JAX package computes the same with two
    interpolation matmuls."""
    y = F.interpolate(dense_strides(x).permute(0, 3, 1, 2), scale_factor=2, mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1).contiguous()


class UpClassic(nn.Module):
    """Upsample (bilinear align-corners, or ConvTranspose k2 s2 VALID) ->
    pad/crop the SKIP to the upsampled x (:func:`pad_to_match`, quirk C2
    kept) -> cat[skip, x] -> DoubleConv (reference up, unet_p.py:148-167).
    Unlike :class:`UpRes`, the skip is padded and the concat order is
    [skip, x]. ``up`` is the ConvTranspose2d(in/2, in/2, 2, stride=2), or
    None in the bilinear variant (the reference's nn.Upsample holds no
    parameters)."""

    def __init__(self, in_features: int, features: int, bilinear: bool = True, batch_norm: bool = False):
        super().__init__()
        ch = in_features // 2
        self.up = None if bilinear else nn.ConvTranspose2d(ch, ch, 2, stride=2)
        self.conv = DoubleConv(in_features, features, batch_norm)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = bilinear_upsample_2x_align_corners(x) if self.up is None else conv_nhwc(self.up, x)
        skip = pad_to_match(skip, x.shape[1], x.shape[2])
        return self.conv(torch.cat([skip, x], dim=-1))
