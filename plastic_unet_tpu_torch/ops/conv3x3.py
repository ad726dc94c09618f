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
square pixel tiles of one sample (the levels of side 50 and more at B=128,
and Cin below 32), tiles of whole samples (25^2, 12^2 and 6^2 at B=128), or,
on grids no larger than the card (B=1), the split family: Cin's 16-channel
slices cut into ranges, one block per (row band, Cout slice, range), the
blocks of a tile one cluster that adds the ranges' partial sums in range
order over distributed shared memory. The first two keep one order of FMAs
for every output and give the same bits; the split family sums in its own
fixed order, so its bits differ from theirs but not from run to run.

These wrappers are the building blocks of ops.residual_tail and stand
outside autograd, like ops.conv3x3_wgrad: the differentiable entry points
are ops.residual_tail.residual_tail, whose autograd.Function chains them,
and :func:`conv3x3_same`, one conv with its bias (forward :func:`conv3x3`,
backward :func:`conv3x3_dgrad` and ops.conv3x3_wgrad), which the
batch-norm trunks of UNetPRes run conv by conv, and every trunk's entry
conv whose Cin is a multiple of :data:`CK` (models.blocks.EntryConv).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from plastic_unet_tpu_torch.ops import _build
from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad
from plastic_unet_tpu_torch.utils.profiling import count, trace

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"conv3x3_forward": [_V] * 8 + [_I] * 17 + [_V]}
NUM_SMS = 132  # an H100's SMs: a square-tile grid of no more blocks splits K where Cin allows
SMEM_MAX = 232448  # the most shared memory a block may use
CK, XCS = 16, 17  # input channels per step; floats of a staged pixel
SAMPLE_PIXELS = 625  # up to this many pixels a sample (25^2), large grids take whole-sample tiles
SAMPLE_THREADS, SAMPLE_TN = 256, 8  # threads of a whole-sample block; output channels a thread
SAMPLE_VARIANTS = ((32, 5), (32, 10))  # (nt, tp) the kernel has: a sample of up to 320 pixels, or of up to 640
SPLIT_THREADS, SPLIT_TP = 256, 4  # threads of a split block; output pixels a computing thread
SPLIT_NT = (16, 32)  # the Cout slices the split kernel has
SPLIT_MIN_CIN = 2 * CK  # from two 16-channel slices on, small grids split K
SPLIT_TARGET, SPLIT_MAX_BLOCKS = 128, 208  # a split grid's blocks: fill the 132 SMs, at most ~1.6 a SM
SPLIT_MAX_KS = 16  # ranges of a tile: the blocks of one cluster, at most 16 on an H100
FAMILIES = ("tile", "sample", "split")


class Conv3x3Plan(NamedTuple):
    """How the kernel cuts the work. ``family`` "tile": square pixel tiles
    (16x8 with ``nt`` = 16 output channels, or 8x8 with 32) of one sample,
    128 threads. "sample": ``samples`` whole samples a
    tile with a one-pixel zero halo, an ``nt``-wide Cout slice a block, 256
    threads of ``tp`` pixels x 8 channels, a two-stage copy ring. "split":
    bands of ``rows`` rows of one sample (the last may be shorter), an
    ``nt``-wide Cout slice, and ``ks`` ranges of Cin's 16-channel slices
    (range k: slices [k*n//ks, (k+1)*n//ks) of n), one block each, the ks
    blocks of a tile one cluster; 256 threads, of which ``tg`` tap groups
    (1..9; group t: taps [9t/tg, 9(t+1)/tg)) of those needed hold ``tp``
    pixels x 8 channels (``tg`` is 1 in the other families).
    ``smem``: bytes of dynamic shared memory a block; ``blocks``: the grid's."""

    family: str
    nt: int
    tg: int
    tp: int
    samples: int
    smem: int
    blocks: int
    rows: int = 0
    ks: int = 1


def _tile_plan(b, h, w, cin, cout, flip) -> Conv3x3Plan:
    nt, th, tw = (16, 16, 8) if cout <= 16 else (32, 8, 8)
    blocks = -(-h // th) * -(-w // tw) * -(-cout // nt) * b
    xs = ((th + 2) * (tw + 2) * XCS + 3) // 4 * 4
    return Conv3x3Plan("tile", nt, 1, 0, 1, 4 * (xs + 9 * CK * (nt + 4 if flip else nt)), blocks)


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


def _split_plan(b, h, w, cin, cout, flip, nt, ks, rows) -> Conv3x3Plan | None:
    nsl, ncs, bands = -(-cin // CK), -(-cout // nt), -(-h // rows)
    cpt = -(-rows * w // SPLIT_TP) * (nt // SAMPLE_TN)  # threads of a tap group
    tg = min(9, SPLIT_THREADS // cpt)  # as many tap groups as the block has threads for
    if not 1 <= ks <= min(nsl, SPLIT_MAX_KS) or tg < 1:
        return None
    stages = min(2, -(-nsl // ks))  # a ring only where a range has two slices
    xs = (((rows + 2) * (w + 1) + 1) * XCS + 3) // 4 * 4  # rows of W + 1 slots, as the whole-sample tiles
    gate = (rows + 2) * w * CK if flip else 0  # the dgrad's in_gate slice of the staged pixels
    # after the K loop, over the staging buffers: the block's partial tile, then the tap groups' sums
    # (later its share of the tile's reduced outputs)
    sums = rows * w * nt + max(tg * SPLIT_TP * SAMPLE_TN * cpt, rows * w * nt)
    weights = 9 * CK * (2 * nt + 4 if flip else nt)  # the dgrad's also as they arrive, before the transpose
    smem = 4 * max(stages * (xs + weights) + gate, sums)
    if smem > SMEM_MAX:
        return None
    return Conv3x3Plan("split", nt, tg, SPLIT_TP, 1, smem, b * bands * ncs * ks, rows, ks)


def _split_choice(b, h, w, cin, cout, flip, target=SPLIT_TARGET, max_blocks=SPLIT_MAX_BLOCKS) -> Conv3x3Plan | None:
    """The split tiling whose grid has target..max_blocks blocks (or comes
    nearest), then the fewest slices a range, the fewest taps a thread, the
    fewest blocks, the least shared memory, the narrower Cout slice.
    ``kernel_ab.py`` times the choice at other windows of blocks."""
    nsl = -(-cin // CK)
    best, best_key = None, None
    for nt in SPLIT_NT:
        for ks in range(1, min(nsl, SPLIT_MAX_KS) + 1):
            for rows in range(1, h + 1):
                p = _split_plan(b, h, w, cin, cout, flip, nt, ks, rows)
                if p is None:
                    continue
                off = max(0, target - p.blocks) + max(0, p.blocks - max_blocks)
                key = (off, -(-nsl // ks), -(-9 // p.tg), p.blocks, p.smem, nt)
                if best_key is None or key < best_key:
                    best, best_key = p, key
    return best


@functools.lru_cache(maxsize=None)  # a pure function of its arguments, asked at every launch
def conv3x3_plan(b: int, h: int, w: int, cin: int, cout: int, flip: bool = False, *,
                 family: str | None = None, variant: tuple | None = None) -> Conv3x3Plan:
    """The kernel's grid for (B, H, W, Cin, Cout); depends on the shapes only.
    Grids of square tiles no larger than the card (NUM_SMS blocks: B=1)
    take the split family where Cin has two slices or more;
    small samples (H*W <= SAMPLE_PIXELS) whose square tiles make a grid
    larger than the card take whole-sample tiles if those still give 15/16
    of the SMs a block; everything else the square tiles. ``family`` and
    ``variant`` ((nt, tp) of SAMPLE_VARIANTS, or (nt, ks, rows) of a split)
    override the choice; "tile" and "sample" give the same bits."""
    tile = _tile_plan(b, h, w, cin, cout, flip)
    if family not in (None,) + FAMILIES:
        raise ValueError(f"conv3x3_plan: family must be one of {FAMILIES}, got {family!r}")
    if family == "split" or (family is None and tile.blocks <= NUM_SMS and cin >= SPLIT_MIN_CIN):
        plan = (_split_plan(b, h, w, cin, cout, flip, *variant) if variant
                else _split_choice(b, h, w, cin, cout, flip))
        if plan is None:
            raise ValueError(f"conv3x3_plan: no split tiling {variant or ''} for {(b, h, w, cin, cout)}")
        return plan
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
        variant = {"sample": (plan.nt, plan.tp), "split": (plan.nt, plan.ks, plan.rows)}.get(plan.family)
        p = conv3x3_plan(b, h, w, cin, cout, flip, family=plan.family, variant=variant)
        if plan != p:
            raise ValueError(f"conv3x3: the plan {plan} is not one of these shapes ({p})")
    vec = cout % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (out, bias, residual, gate) if t is not None)
    lib = _build.library("conv3x3", _SIGNATURES)
    with torch.cuda.device(x.device), trace("port.kernel.conv3x3", b=b, h=h, w=w, cin=cin, cout=cout, flip=flip,
                                            bias=bias is not None, res=residual is not None, gate=gate is not None,
                                            in_gate=in_gate is not None, plan=p, dtype=x.dtype, kernels=1):
        code = lib.conv3x3_forward(
            _build.ptr(x), _build.ptr(in_gate), _build.ptr(w_hwio), _build.ptr(bias), _build.ptr(residual),
            _build.ptr(gate), _build.ptr(out), _build.ptr(masked),
            b, h, w, cin, cout, int(relu_in), int(relu_res), int(relu_out), int(flip),
            FAMILIES.index(p.family), p.nt, p.tp if p.family == "sample" else p.tg, p.samples, p.rows, p.ks, p.smem,
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
    count("kernel.conv3x3.fwd")
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
    count("kernel.conv3x3.dgrad")
    return res


class _Conv3x3Same(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias):
        x, k = x.contiguous(), hwio(weight)
        ctx.save_for_backward(x, k)
        return conv3x3(x, k, bias.contiguous())

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3x3_dgrad(g, k)[0] if ctx.needs_input_grad[0] else None
        dw, db = conv3x3_wgrad(x, g, layout="oihw")
        return dx, dw, db


def conv3x3_same(x, weight, bias):
    """A 3x3 SAME conv of NHWC ``x`` (B, H, W, Cin) with a torch Conv2d
    ``weight`` (Cout, Cin, 3, 3) and ``bias`` (Cout,), differentiable in all
    three: the forward is :func:`conv3x3`, the backward :func:`conv3x3_dgrad`
    (the weights read tap-reversed) and ops.conv3x3_wgrad. CUDA tensors
    launch the kernels or raise; CPU tensors take their plain versions."""
    return _Conv3x3Same.apply(x, weight, bias)
