"""Weight and bias gradient of the 3x3 SAME stride-1 convolution on NHWC
fp32 as a CUDA kernel (counterpart of the ``g.dw`` / column-sum lines of
plastic_unet_tpu.ops.pallas_trunk's backward kernel; source
``csrc/conv3x3_wgrad.cu``).

    dW[ky, kx, ci, co] = sum_{b,y,x} act(x)[b, y+ky-1, x+kx-1, ci] * d[b, y, x, co]
    db[co]             = sum_{b,y,x} d[b, y, x, co]

x: (B, H, W, Cin), the conv's input *before* its ReLU when ``relu_in`` (the
kernel applies it on load); d: (B, H, W, Cout), the gradient of the conv's
output. ``layout="hwio"`` returns dW as (3, 3, Cin, Cout), ``"oihw"`` as
torch's (Cout, Cin, 3, 3), written in that layout by the kernel.

The reduction is deterministic: :func:`wgrad_plan` splits the pixel tiles
into chunks, each block writes its partial sums to a workspace and a second
kernel adds them in chunk order (no atomics); with one chunk the first
kernel writes the result itself. On CUDA tensors :func:`conv3x3_wgrad`
launches the kernel or raises; on CPU tensors it runs
:func:`conv3x3_wgrad_plain`, nine shifted ``x^T @ d`` products, the form of
the TPU kernel's ``_Geo.dw``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from plastic_unet_tpu_torch.ops import _build

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"conv3x3_wgrad": [_V] * 6 + [_I] * 9 + [_V]}
LAYOUTS = ("hwio", "oihw")
TILE = 8  # the kernel's pixel tile is TILE x TILE
TARGET_BLOCKS = 528  # four blocks for each of an H100's 132 SMs


def wgrad_plan(b: int, h: int, w: int, cin: int, cout: int) -> tuple[int, int]:
    """(chunks, tiles_per_chunk): how the kernel's grid splits the
    b * ceil(h/8) * ceil(w/8) pixel tiles. The (ci, co) slices already give
    ceil(cin/16) * ceil(cout/co_t) blocks (co_t = 16 for cout <= 16, else 32);
    the tiles are cut into as many chunks as bring the grid to TARGET_BLOCKS."""
    tiles = b * -(-h // TILE) * -(-w // TILE)
    co_t = 16 if cout <= 16 else 32
    slices = -(-cin // 16) * -(-cout // co_t)
    chunks = max(1, min(tiles, -(-TARGET_BLOCKS // slices)))
    per = -(-tiles // chunks)
    return -(-tiles // per), per


def conv3x3_wgrad_plain(x, d, *, relu_in=False, layout="hwio"):
    """The plain PyTorch version of the kernel (any device): (dW, db)."""
    if relu_in:
        x = torch.relu(x)
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    d2 = d.reshape(-1, d.shape[3])
    taps = [torch.matmul(xp[:, ky:ky + h, kx:kx + w, :].reshape(-1, x.shape[3]).t(), d2)
            for ky in range(3) for kx in range(3)]
    dw = torch.stack(taps).reshape(3, 3, x.shape[3], d.shape[3])
    if layout == "oihw":
        dw = dw.permute(3, 2, 0, 1).contiguous()
    return dw, d2.sum(0)


def conv3x3_wgrad(x, d, *, relu_in=False, layout="hwio"):
    """(dW, db); see the module docstring. Outside autograd."""
    if layout not in LAYOUTS:
        raise ValueError(f"conv3x3_wgrad: layout must be one of {LAYOUTS}, got {layout!r}")
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, d, relu_in=relu_in, layout=layout)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3x3_wgrad: no kernel for device {x.device}")
    if x.dim() != 4 or d.dim() != 4 or tuple(x.shape[:3]) != tuple(d.shape[:3]):
        raise ValueError(f"conv3x3_wgrad: x (B,H,W,Cin) and d (B,H,W,Cout) must agree, got "
                         f"{tuple(x.shape)} and {tuple(d.shape)}")
    for t in (x, d):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError("conv3x3_wgrad: inputs must be contiguous float32 on one CUDA device")
    b, h, w, cin = x.shape
    cout = d.shape[3]
    if min(b, h, w, cin, cout) < 1 or 9 * cin * cout + cout >= 2 ** 31:
        raise ValueError(f"conv3x3_wgrad: unsupported shape {(b, h, w, cin, cout)}")
    chunks, per = wgrad_plan(b, h, w, cin, cout)
    dw = torch.empty((3, 3, cin, cout) if layout == "hwio" else (cout, cin, 3, 3), dtype=x.dtype, device=x.device)
    db = torch.empty((cout,), dtype=x.dtype, device=x.device)
    w_part = b_part = None
    if chunks > 1:
        w_part = torch.empty((chunks, 9 * cin * cout), dtype=x.dtype, device=x.device)
        b_part = torch.empty((chunks, cout), dtype=x.dtype, device=x.device)
    lib = _build.library("conv3x3_wgrad", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = lib.conv3x3_wgrad(
            _build.ptr(x), _build.ptr(d), _build.ptr(dw), _build.ptr(db), _build.ptr(w_part), _build.ptr(b_part),
            b, h, w, cin, cout, chunks, per, int(relu_in), int(layout == "oihw"), _build.stream_of(x),
        )
    _build.check(code, "conv3x3_wgrad")
    conv3x3_wgrad.launches += 1
    return dw, db


conv3x3_wgrad.launches = 0
