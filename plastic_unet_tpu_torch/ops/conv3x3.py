"""3x3 SAME stride-1 convolution on NHWC fp32 as a CUDA kernel (counterpart
of plastic_unet_tpu.ops.pallas_conv; source ``csrc/conv3x3.cu``).

    out = relu_out?( conv(relu_in?(x), w) + bias + relu_res?(residual) )

x: (B, H, W, Cin) contiguous; w_hwio: (3, 3, Cin, Cout), the tap-major
layout the kernel reads (:func:`hwio` makes it from torch's (Cout, Cin, 3, 3));
bias: (Cout,); residual: (B, H, W, Cout) or None. On CUDA tensors
:func:`conv3x3` launches the kernel or raises; on CPU tensors it runs
:func:`conv3x3_plain`, which sums the 9 shifted taps as matmuls, the form
of the TPU kernel's im2col. The kernel has no backward yet: a CUDA call on
tensors that autograd tracks raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from plastic_unet_tpu_torch.ops import _build

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"conv3x3_forward": [_V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _I, _I, _I, _V]}


def hwio(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv2d weight (Cout, Cin, 3, 3) -> contiguous (3, 3, Cin, Cout)."""
    return weight.permute(2, 3, 1, 0).contiguous()


def conv3x3_plain(x, w_hwio, bias, residual=None, *, relu_in=False, relu_res=False, relu_out=False):
    """The plain PyTorch version of the kernel (any device)."""
    if relu_in:
        x = torch.relu(x)
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    y = None
    for ky in range(3):
        for kx in range(3):
            t = torch.matmul(xp[:, ky:ky + h, kx:kx + w, :], w_hwio[ky, kx])
            y = t if y is None else y + t
    y = y + bias
    if residual is not None:
        y = y + (torch.relu(residual) if relu_res else residual)
    return torch.relu(y) if relu_out else y


def _check(x, w_hwio, bias, residual):
    if x.dim() != 4:
        raise ValueError(f"conv3x3: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    if w_hwio.dim() != 4 or tuple(w_hwio.shape[:3]) != (3, 3, cin):
        raise ValueError(f"conv3x3: w_hwio must be (3, 3, {cin}, Cout), got {tuple(w_hwio.shape)}")
    cout = w_hwio.shape[3]
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"conv3x3: bias must be ({cout},), got {tuple(bias.shape)}")
    if residual is not None and tuple(residual.shape) != (b, h, w, cout):
        raise ValueError(f"conv3x3: residual must be {(b, h, w, cout)}, got {tuple(residual.shape)}")
    for t in (x, w_hwio, bias) + (() if residual is None else (residual,)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError("conv3x3: inputs must be contiguous float32 on one CUDA device")
    if b > 65535 or min(b, h, w, cin, cout) < 1:
        raise ValueError(f"conv3x3: unsupported shape {(b, h, w, cin, cout)}")
    return b, h, w, cin, cout


def conv3x3(x, w_hwio, bias, residual=None, *, relu_in=False, relu_res=False, relu_out=False):
    """(B, H, W, Cout) output; see the module docstring."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w_hwio, bias, residual, relu_in=relu_in, relu_res=relu_res, relu_out=relu_out)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3x3: no kernel for device {x.device}")
    _build.require_no_grad("conv3x3", x, w_hwio, bias, residual)
    b, h, w, cin, cout = _check(x, w_hwio, bias, residual)
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    lib = _build.library("conv3x3", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = lib.conv3x3_forward(
            _build.ptr(x), _build.ptr(w_hwio), _build.ptr(bias), _build.ptr(residual), _build.ptr(out),
            b, h, w, cin, cout, int(relu_in), int(relu_res), int(relu_out), _build.stream_of(x),
        )
    _build.check(code, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
