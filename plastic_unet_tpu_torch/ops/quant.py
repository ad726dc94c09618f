"""int8 post-training quantization math for serving (counterpart of
plastic_unet_tpu.ops.quant).

  * activations: per-tensor symmetric int8, scale amax / 127, with amax the
    calibrated max|x| (models.unet_res in ``quant="calib"`` records it);
  * weights: per-output-channel symmetric int8, scale max|w[c]| / 127,
    computed from the fp32 weights at each call (the state_dict is
    unchanged, so one checkpoint serves fp32 and int8);
  * the product in exact int32, then one dequant in the JAX package's
    order: ``acc.float() * (sx * sw) + bias``.

Every scale is an fp32 division of two tensors, ``127 / amax`` and
``amax / 127``, correctly rounded on every device as JAX's are. A Python
number in its place would not be: torch computes ``127.0 / t`` as
``t.reciprocal() * 127.0`` (two roundings: 1 in 4 values an ulp off the
division, here and on the card), and the card computes ``t / 127.0`` as
``t * (1 / 127)``, so the card's scales were an ulp off the CPU's, enough
to move an activation across a rounding step of the next conv. Then
``torch.round`` rounds half to even as ``jnp.round`` does, and the value is
clipped to +-127; no zero point, so SAME zero padding is exact in the
integer domain.

The JAX package leaves the integer product to XLA
(``preferred_element_type=int32``); here it is an im2col of the int8 tensor
and one ``torch._int_mm`` (int8 x int8 -> int32: cuBLASLt on CUDA), a
library product, not a kernel of this package. cuBLASLt takes M > 16 and
K, N multiples of 8, so the operands are zero-padded to that (exact). The
ConvTranspose (k3, s2, VALID) is one product to (M, 9*Cout) and an int32
scatter-add of its 9 taps. :func:`qconv3_same_plain` and
:func:`qconvT3_s2_valid_plain` compute the same in float64 (exact:
|acc| <= 127^2 * 9 * Cin < 2^53) through ``F.conv2d`` /
``F.conv_transpose2d``; they are the references the tests and the chip
run hold the integer path against.

Weights come in torch layout: Conv2d ``(Cout, Cin, 3, 3)``,
ConvTranspose2d ``(Cin, Cout, 3, 3)`` (flax's ``(3, 3, Cout, Cin)`` with
``transpose_kernel=True``); activations are NHWC.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MM_MIN_ROWS, MM_ALIGN = 17, 8  # torch._int_mm on CUDA: M > 16, K and N multiples of 8


def act_qparams(amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(inv_scale, scale) of a per-tensor symmetric int8 range. amax == 0
    gives scale 0: the quantized tensor is all zeros, the output the bias."""
    amax = amax.to(torch.float32)
    zero, q = torch.zeros_like(amax), torch.full_like(amax, 127.0)
    inv = torch.where(amax > 0, q / amax, zero)
    scale = torch.where(amax > 0, amax / q, zero)
    return inv, scale


def quantize_act(x: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x_int8, scale) at the calibrated range; values beyond it saturate at +-127."""
    inv, scale = act_qparams(amax)
    q = torch.clamp(torch.round(x.to(torch.float32) * inv), -127.0, 127.0)
    return q.to(torch.int8), scale


def quantize_weight(kernel: torch.Tensor, cout_axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(w_int8, scale[Cout]) per output channel; an all-zero channel gets scale 0."""
    k = kernel.to(torch.float32)
    axes = tuple(a for a in range(k.dim()) if a != cout_axis)
    wmax = torch.amax(torch.abs(k), dim=axes)
    zero, q = torch.zeros_like(wmax), torch.full_like(wmax, 127.0)
    inv = torch.where(wmax > 0, q / wmax, zero)
    scale = torch.where(wmax > 0, wmax / q, zero)
    shape = [1] * k.dim()
    shape[cout_axis] = -1
    q = torch.clamp(torch.round(k * inv.reshape(shape)), -127.0, 127.0)
    return q.to(torch.int8), scale


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact, through
    ``torch._int_mm``; the operands zero-padded to its shape rules."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(m, MM_MIN_ROWS), _ceil_to(k, MM_ALIGN), _ceil_to(n, MM_ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    acc = torch._int_mm(a.contiguous(), b.contiguous())
    return acc[:m, :n] if (mp, np_) != (m, n) else acc


def _im2col3(q: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, 9*C), the 3x3 SAME taps in (ky, kx, c) order, zero-padded."""
    b, h, w, c = q.shape
    qp = F.pad(q, (0, 0, 1, 1, 1, 1))
    taps = [qp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    return torch.stack(taps, dim=3).reshape(b * h * w, 9 * c)


def _dequant(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return acc.to(torch.float32) * (sx * sw) + bias.to(torch.float32)


def qconv3_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, amax: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """3x3 SAME stride-1 conv in int8 with int32 accumulation.
    x: (B, H, W, Cin); weight: (Cout, Cin, 3, 3); bias: (Cout,); amax: scalar.
    Returns (B, H, W, Cout), dequantized in fp32 and cast to ``out_dtype``
    (a bf16 model's activations, as the JAX ``out_dtype``)."""
    qx, sx = quantize_act(x, amax)
    qw, sw = quantize_weight(weight, cout_axis=0)
    b, h, w, cin = qx.shape
    cout = qw.shape[0]
    acc = int8_matmul(_im2col3(qx), qw.permute(2, 3, 1, 0).reshape(9 * cin, cout))
    return _dequant(acc, sx, sw, bias).reshape(b, h, w, cout).to(out_dtype)


def qconvT3_s2_valid(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, amax: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """ConvTranspose k3/s2/VALID (the UpRes upsampler) in int8 with int32
    accumulation: out[2i+ky, 2j+kx] += x[i, j] @ w[:, :, ky, kx].
    x: (B, H, W, Cin); weight: (Cin, Cout, 3, 3). Returns (B, 2H+1, 2W+1, Cout)
    in ``out_dtype`` (dequantized in fp32)."""
    qx, sx = quantize_act(x, amax)
    qw, sw = quantize_weight(weight, cout_axis=1)
    b, h, w, cin = qx.shape
    cout = qw.shape[1]
    taps = int8_matmul(qx.reshape(b * h * w, cin), qw.permute(0, 2, 3, 1).reshape(cin, 9 * cout))
    taps = taps.reshape(b, h, w, 3, 3, cout)
    acc = torch.zeros((b, 2 * h + 1, 2 * w + 1, cout), dtype=torch.int32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            acc[:, ky:ky + 2 * h:2, kx:kx + 2 * w:2, :] += taps[:, :, :, ky, kx, :]
    return _dequant(acc, sx, sw, bias).to(out_dtype)


def qconv3_same_plain(x, weight, bias, amax):
    """:func:`qconv3_same` with the integer product as a float64 convolution (exact)."""
    qx, sx = quantize_act(x, amax)
    qw, sw = quantize_weight(weight, cout_axis=0)
    acc = F.conv2d(qx.permute(0, 3, 1, 2).double(), qw.double(), padding=1)
    return _dequant(acc.permute(0, 2, 3, 1).to(torch.int32), sx, sw, bias)


def qconvT3_s2_valid_plain(x, weight, bias, amax):
    """:func:`qconvT3_s2_valid` with the integer product as a float64 transposed convolution (exact)."""
    qx, sx = quantize_act(x, amax)
    qw, sw = quantize_weight(weight, cout_axis=1)
    acc = F.conv_transpose2d(qx.permute(0, 3, 1, 2).double(), qw.double(), stride=2)
    return _dequant(acc.permute(0, 2, 3, 1).to(torch.int32), sx, sw, bias)
