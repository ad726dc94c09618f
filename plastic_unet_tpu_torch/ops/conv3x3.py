"""3x3 SAME stride-1 convolution on NHWC fp32 as a CUDA kernel (counterpart
of plastic_unet_tpu.ops.pallas_conv; source ``csrc/conv3x3.cu``).

    out = relu_out?( conv(relu_in?(x), w) + bias + relu_res?(residual) )

x: (B, H, W, Cin) contiguous; w_hwio: (3, 3, Cin, Cout), the tap-major
layout the kernel reads (:func:`hwio` makes it from torch's (Cout, Cin, 3, 3));
bias: (Cout,) or None; residual: (B, H, W, Cout) or None. On CUDA tensors
:func:`conv3x3` launches the kernel or raises; on CPU tensors it runs
:func:`conv3x3_plain`, which sums the 9 shifted taps as matmuls, the form
of the TPU kernel's im2col.

The same kernel is the input-gradient pass of the convolution
(:func:`conv3x3_dgrad`; conv^T == conv(flip(W)) for SAME/stride 1, the
``g.conv(d, wf)`` lines of plastic_unet_tpu.ops.pallas_trunk's backward):

    out = (conv(d * (in_gate > 0), flip(w)) + residual) * (gate > 0)

It reads the forward's ``w_hwio`` tap-reversed and transposed in place, so no
flipped copy is made, and returns the masked ``d`` beside ``out`` when
``in_gate`` is given (the kernel writes it once, as it loads it).

:func:`conv3x3_plan` picks the kernel's tiling from the shapes alone:
square pixel tiles of one sample (B=1, and every level of side 50 and
more) or tiles of whole samples (25^2, 12^2 and 6^2 at B=128). Both keep one
order of FMAs for every output, so they give the same bits.

These wrappers are the building blocks of ops.residual_tail and stand
outside autograd, like ops.conv3x3_wgrad: the differentiable entry point is
ops.residual_tail.residual_tail, whose autograd.Function chains them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from plastic_unet_tpu_torch.ops import _build

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"conv3x3_forward": [_V] * 8 + [_I] * 15 + [_V]}
NUM_SMS = 132  # an H100's SMs: a square-tile grid of no more blocks takes K groups
SMEM_MAX = 232448  # the most shared memory a block may use
CK, XCS = 16, 17  # input channels per step; floats of a staged pixel
SAMPLE_PIXELS = 625  # up to this many pixels a sample (25^2), large grids take whole-sample tiles
SAMPLE_THREADS, SAMPLE_TN = 256, 8  # threads of a whole-sample block; output channels a thread
SAMPLE_VARIANTS = ((32, 5), (32, 10))  # (nt, tp) the kernel has: a sample of up to 320 pixels, or of up to 640
FAMILIES = ("tile", "sample")


class Conv3x3Plan(NamedTuple):
    """How the kernel cuts the work. ``family`` "tile": square pixel tiles
    (16x8 with ``nt`` = 16 output channels, or 8x8 with 32) of one sample,
    ``kg`` K groups of 128 threads. "sample": ``samples`` whole samples a
    tile with a one-pixel zero halo, an ``nt``-wide Cout slice a block, 256
    threads of ``tp`` pixels x 8 channels, a two-stage copy ring.
    ``smem``: bytes of dynamic shared memory a block; ``blocks``: the grid's."""

    family: str
    nt: int
    kg: int
    tp: int
    samples: int
    smem: int
    blocks: int


def _tile_plan(b, h, w, cin, cout, flip) -> Conv3x3Plan:
    nt, th, tw = (16, 16, 8) if cout <= 16 else (32, 8, 8)
    blocks = -(-h // th) * -(-w // tw) * -(-cout // nt) * b
    kg = 4 if blocks <= NUM_SMS and cin >= 4 * CK else 2 if blocks <= NUM_SMS and cin >= 2 * CK else 1
    xs = ((th + 2) * (tw + 2) * XCS + 3) // 4 * 4
    return Conv3x3Plan("tile", nt, kg, 0, 1, 4 * kg * (xs + 9 * CK * (nt + 4 if flip else nt)), blocks)


def _sample_stage_floats(h, w, samples, nt, flip) -> int:
    """One stage of the ring: the samples' halo tiles (rows of W + 1 slots, the
    zero column shared by neighbouring rows) and the weight slice."""
    xs = ((samples * (h + 2) * (w + 1) + 1) * XCS + 3) // 4 * 4
    return xs + 9 * CK * (nt + 4 if flip else nt)


def _sample_plan(b, h, w, cin, cout, flip, nt, tp) -> Conv3x3Plan | None:
    cap = SAMPLE_THREADS // (nt // SAMPLE_TN) * tp  # output pixels a block holds
    samples = min(b, cap // (h * w))
    if samples < 1:
        return None
    gate = samples * h * w * CK if flip else 0  # the dgrad's in_gate slice, outside the ring
    smem = 4 * (2 * _sample_stage_floats(h, w, samples, nt, flip) + gate)
    if smem > SMEM_MAX:
        return None
    return Conv3x3Plan("sample", nt, 1, tp, samples, smem, -(-b // samples) * -(-cout // nt))


def conv3x3_plan(b: int, h: int, w: int, cin: int, cout: int, flip: bool = False, *,
                 family: str | None = None, variant: tuple | None = None) -> Conv3x3Plan:
    """The kernel's grid for (B, H, W, Cin, Cout); depends on the shapes only.
    Square tiles (the first design's routing, K groups on grids of at most
    NUM_SMS blocks) everywhere except small samples (H*W <= SAMPLE_PIXELS)
    whose square tiles make a grid larger than the card, which take
    whole-sample tiles if those still give 15/16 of the SMs a block.
    ``family`` and ``variant`` ((nt, tp) of SAMPLE_VARIANTS) override the
    choice; both families give the same bits."""
    tile = _tile_plan(b, h, w, cin, cout, flip)
    if family not in (None,) + FAMILIES:
        raise ValueError(f"conv3x3_plan: family must be one of {FAMILIES}, got {family!r}")
    if family == "tile" or (family is None and (h * w > SAMPLE_PIXELS or tile.blocks <= NUM_SMS)):
        return tile
    # the narrower variant where a sample fits it: more blocks, and two of them on an SM
    plan = next((p for nt, tp in ([variant] if variant else SAMPLE_VARIANTS)
                 if (p := _sample_plan(b, h, w, cin, cout, flip, nt, tp)) is not None), None)
    if family == "sample":
        if plan is None:
            raise ValueError(f"conv3x3_plan: no whole-sample tiling for {(b, h, w, cin, cout)}")
        return plan
    # two ring stages do not fit shared memory, or a grid this small leaves SMs idle: the square tiles
    return tile if plan is None or 16 * plan.blocks < 15 * NUM_SMS else plan


def hwio(weight: torch.Tensor) -> torch.Tensor:
    """torch Conv2d weight (Cout, Cin, 3, 3) -> contiguous (3, 3, Cin, Cout)."""
    return weight.permute(2, 3, 1, 0).contiguous()


def conv3x3_plain(x, w_hwio, bias=None, residual=None, *, relu_in=False, relu_res=False, relu_out=False):
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
    if bias is not None:
        y = y + bias
    if residual is not None:
        y = y + (torch.relu(residual) if relu_res else residual)
    return torch.relu(y) if relu_out else y


def conv3x3_dgrad_plain(d, w_hwio, residual=None, *, gate=None, in_gate=None):
    """The plain PyTorch version of :func:`conv3x3_dgrad` (any device)."""
    masked = None
    if in_gate is not None:
        d = masked = d * (in_gate > 0).to(d.dtype)
    y = conv3x3_plain(d, w_hwio.flip(0, 1).transpose(2, 3), None, residual)
    if gate is not None:
        y = y * (gate > 0).to(y.dtype)
    return y, masked


def _launch(x, w_hwio, bias, residual, *, relu_in=False, relu_res=False, relu_out=False,
            flip=False, gate=None, in_gate=None, plan=None):
    """Check the operands, launch the kernel, return (out, masked input or None)."""
    if x.dim() != 4:
        raise ValueError(f"conv3x3: x must be (B, H, W, Cin), got {tuple(x.shape)}")
    b, h, w, cin = x.shape
    want_w = "(3, 3, Cout, %d)" % cin if flip else "(3, 3, %d, Cout)" % cin
    if w_hwio.dim() != 4 or tuple(w_hwio.shape[:2]) != (3, 3) or w_hwio.shape[3 if flip else 2] != cin:
        raise ValueError(f"conv3x3: w_hwio must be {want_w}, got {tuple(w_hwio.shape)}")
    cout = w_hwio.shape[2 if flip else 3]
    shapes = (("bias", bias, (cout,)), ("residual", residual, (b, h, w, cout)),
              ("gate", gate, (b, h, w, cout)), ("in_gate", in_gate, (b, h, w, cin)))
    for name, t, shape in shapes:
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"conv3x3: {name} must be {shape}, got {tuple(t.shape)}")
    for t in (x, w_hwio) + tuple(t for _, t, _ in shapes if t is not None):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError("conv3x3: inputs must be contiguous float32 on one CUDA device")
    if b > 65535 or min(b, h, w, cin, cout) < 1:
        raise ValueError(f"conv3x3: unsupported shape {(b, h, w, cin, cout)}")
    out = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    masked = None if in_gate is None else torch.empty_like(x)
    p = conv3x3_plan(b, h, w, cin, cout, flip)
    if plan is not None:
        p = conv3x3_plan(b, h, w, cin, cout, flip, family=plan.family,
                         variant=(plan.nt, plan.tp) if plan.family == "sample" else None)
        if plan != p:
            raise ValueError(f"conv3x3: the plan {plan} is not one of these shapes ({p})")
    vec = cout % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (out, bias, residual, gate) if t is not None)
    lib = _build.library("conv3x3", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = lib.conv3x3_forward(
            _build.ptr(x), _build.ptr(in_gate), _build.ptr(w_hwio), _build.ptr(bias), _build.ptr(residual),
            _build.ptr(gate), _build.ptr(out), _build.ptr(masked),
            b, h, w, cin, cout, int(relu_in), int(relu_res), int(relu_out), int(flip),
            FAMILIES.index(p.family), p.nt, p.kg if p.family == "tile" else p.tp, p.samples, p.smem,
            int(vec), _build.stream_of(x),
        )
    _build.check(code, "conv3x3")
    return out, masked


def conv3x3(x, w_hwio, bias=None, residual=None, *, relu_in=False, relu_res=False, relu_out=False, plan=None):
    """(B, H, W, Cout) output; see the module docstring. Outside autograd;
    CUDA tensors launch the kernel or raise, CPU tensors take the plain version.
    ``plan`` (a :func:`conv3x3_plan` of these shapes) overrides the tiling."""
    flags = dict(relu_in=relu_in, relu_res=relu_res, relu_out=relu_out)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w_hwio, bias, residual, **flags)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3x3: no kernel for device {x.device}")
    out, _ = _launch(x, w_hwio, bias, residual, plan=plan, **flags)
    conv3x3.launches += 1
    return out


def conv3x3_dgrad(d, w_hwio, residual=None, *, gate=None, in_gate=None, plan=None):
    """Input gradient of ``conv(., w_hwio)`` at the output gradient ``d``
    (B, H, W, Cout), with the reverse chain's masks fused (module docstring):
    returns ``(out (B, H, W, Cin), d * (in_gate > 0) or None)``. Outside
    autograd; CUDA tensors launch the kernel or raise. ``plan`` as in
    :func:`conv3x3` (with ``flip``)."""
    if d.device.type == "cpu":
        return conv3x3_dgrad_plain(d, w_hwio, residual, gate=gate, in_gate=in_gate)
    if d.device.type != "cuda":
        raise RuntimeError(f"conv3x3_dgrad: no kernel for device {d.device}")
    res = _launch(d, w_hwio, None, residual, flip=True, gate=gate, in_gate=in_gate, plan=plan)
    conv3x3_dgrad.launches += 1
    return res


conv3x3.launches = 0
conv3x3_dgrad.launches = 0
