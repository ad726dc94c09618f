"""The UNetPRes residual tail, forward and backward (counterpart of
plastic_unet_tpu.ops.pallas_trunk, ``_tail_fwd_kernel`` and
``_tail_bwd_kernel``).

Every DownRes / Middle (and the Middle inside every UpRes) ends with two
residual blocks and a ReLU, with the reference's inplace-ReLU skip quirk
(the skip adds relu(input), not input):

    h1 = relu(x0);  x1 = conv(relu(conv(h1))) + h1
    h2 = relu(x1);  x2 = conv(relu(conv(h2))) + h2
    out = relu(x2)

Forward. On CUDA tensors :func:`residual_tail` runs this in one of two
routes, which :func:`tail_plan` picks from the shapes alone. Batches at
101^2 x 16 from 7 samples and 50^2 x 32 from 10 (where conv3x3_plan takes its
square tiles and the batch's pixels fill 35% of the fused kernel's threads
on the card) take one launch of ``csrc/residual_tail.cu``
(:func:`residual_tail_fused`): a thread-block cluster a sample, a band of rows
a block, the intermediates in shared memory and the halo rows passed between
the bands over distributed shared memory. Everything else takes four
launches of the conv3x3 kernel, every ReLU, bias and skip fused into their
loads and epilogues:

    pre11 = conv(relu(x0)) + b11
    x1    = conv(relu(pre11)) + b12 + relu(x0)
    pre21 = conv(relu(x1)) + b21
    out   = relu(conv(relu(pre21)) + b22 + relu(x1))

The fused kernel keeps the square tiles' order of arithmetic for every
output, so the two routes give the same bits. In the four launches pre11, x1
and pre21 go to device memory because the next launch reads them; the fused
kernel writes them only when autograd will save them for the backward
(together with x0 and ``out``) or the int8 calibration reads their ranges.
The TPU kernel saves x2; the port never materialises it (the last conv fuses
the ReLU) and needs only its sign: ``(out > 0) == (x2 > 0)``, so ``out``
stands in. Under ``torch.no_grad()`` or ``inference_mode()`` nothing is kept.

Backward (:func:`residual_tail_backward`). On CUDA tensors one of two
routes, which :func:`tail_bwd_plan` picks from the shapes alone. Batches at
101^2 x 16 from 6 samples and 50^2 x 32 from 9 (where the batch's pixels
fill 30% of the fused kernel's threads on the card, and the dgrad below
takes its square tiles) take one launch of ``csrc/residual_tail_backward.cu``
and one of its sample reduction (:func:`residual_tail_backward_fused`): a
cluster a sample and a band of rows a block, as the forward, the gradients
between the convs in shared memory, each saved tensor read once. Everything
else (B=1, and the 25^2, 12^2 and 6^2 levels) takes the reverse chain as
four launches of the conv3x3 kernel in its input-gradient form
(ops.conv3x3.conv3x3_dgrad) and four of ops.conv3x3_wgrad, every ReLU mask
and skip sum fused (:func:`residual_tail_backward_eight`):

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
The fused kernel keeps the square tiles' order of arithmetic in dx0, so the
two routes give the same dx0 bits; its weight and bias gradients sum in its
own fixed order (pixels, then bands, then samples pairwise; no atomics), the
same bits on every run but not the wgrad launches'.

The TPU layout devices (pack_factor, worth_fusing, 128-lane padding) are not
carried over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from plastic_unet_tpu_torch.ops import _build
from plastic_unet_tpu_torch.ops.conv3x3 import (
    NUM_SMS,
    SMEM_MAX,
    SPLIT_MAX_KS,
    conv3x3,
    conv3x3_dgrad,
    conv3x3_dgrad_plain,
    conv3x3_plain,
    conv3x3_plan,
    hwio,
)
from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad, conv3x3_wgrad_plain
from plastic_unet_tpu_torch.utils.profiling import count, trace

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"residual_tail_forward": [_V] * 13 + [_I] * 9 + [_V]}
_BWD_SIGNATURES = {"residual_tail_backward": [_V] * 20 + [_I] * 9 + [_V]}
# channels -> (pixels a thread, threads a block) of the kernel's tiling for them; a thread's 16 output
# channels and the 16-channel input slices are fixed. Each was the fastest of a sweep at B=128 (PERF.md).
FUSED_TILING = {16: (4, 384), 32: (4, 256)}
TAIL_FAMILIES = ("four", "fused")
# The fused route from a batch whose pixels fill this share of the card's pixel slots on (NUM_SMS blocks,
# one an SM, each holding px * threads // (C // 16) pixels). In chip_smoke.py phase 6's sweep of both routes
# (tail_route_sweep; PERF.md) the four launches were faster up to 0.30 at 101^2 x 16, 50^2 x 32, 50^2 x 16
# and 25^2 x 32, the fused kernel from 0.40 on, but for a nearly empty second wave (1-2%).
FUSED_MIN_FILL = 0.35
BWD_FAMILIES = ("eight", "fused")
# The fused backward from a batch whose pixels fill this share of the card's pixel slots on (measured as the
# forward's). In chip_smoke.py phase 10's sweep of both backward routes (tail_bwd_route_sweep; PERF.md) the
# fused kernel won from 0.302 at 101^2 x 16 (B=6; 0.252 lost), at 50^2 x 16 and 25^2 x 32 from 0.30 or
# below, but at 50^2 x 32 only from 0.44 (B=12; B=9, 0.333, lost by 2.6%): no fill divides every shape, and
# this one loses the least (0.35 would lose 10% at 101^2 x 16 B=6).
BWD_MIN_FILL = 0.30


class TailPlan(NamedTuple):
    """How the forward tail runs. ``family`` "four": four conv3x3 launches
    (each with its own conv3x3_plan; the other fields 0). "fused": one launch
    of ``csrc/residual_tail.cu``, ``bands`` blocks a sample (one cluster, at
    most 16), band k holding rows [k*H//bands, (k+1)*H//bands), at most
    ``rows`` of them; ``threads`` threads of ``px`` pixels x 16 channels;
    ``smem`` bytes of dynamic shared memory a block (two band buffers of
    rows + 2 rows of W + 1 slots of C + 1 floats, and two stages of a
    16-channel weight slice); ``blocks`` the grid's."""

    family: str
    bands: int = 0
    rows: int = 0
    px: int = 0
    threads: int = 0
    smem: int = 0
    blocks: int = 0


def _slots(px: int, threads: int, c: int) -> int:
    """The pixels a fused block's threads hold (each thread px pixels x 16 of the C channels)."""
    return px * threads // (c // 16)


def _fused_plan(b, h, w, c, bands) -> TailPlan | None:
    if c not in FUSED_TILING or not 1 <= bands <= min(h, SPLIT_MAX_KS):
        return None
    px, threads = FUSED_TILING[c]
    rows = -(-h // bands)
    if rows * w > _slots(px, threads, c):  # the band's pixels on the thread grid
        return None
    band = (((rows + 2) * (w + 1) + 1) * (c + 1) + 3) // 4 * 4
    smem = 4 * (2 * band + 2 * 9 * 16 * c)
    if smem > SMEM_MAX:
        return None
    return TailPlan("fused", bands, rows, px, threads, smem, b * bands)


@functools.lru_cache(maxsize=None)  # a pure function of its arguments, asked at every tail
def tail_plan(b: int, h: int, w: int, c: int, *, family: str | None = None) -> TailPlan:
    """The forward tail's route for x0 (B, H, W, C); depends on the shapes
    only. The fused kernel where conv3x3_plan(b, h, w, c, c) takes its
    square tiles, a tiling fits shared memory (the fewest bands whose rows
    fit the thread grid) and the batch's B*H*W pixels fill at least
    FUSED_MIN_FILL of the card's pixel slots: 101^2 x 16 from B=7, 50^2 x 32
    from B=10, 50^2 x 16 from B=29, 25^2 x 32 from B=38; everything else the
    four launches. ``family`` forces a route; both routes give the same
    bits."""
    if family not in (None,) + TAIL_FAMILIES:
        raise ValueError(f"tail_plan: family must be one of {TAIL_FAMILIES}, got {family!r}")
    if family == "four":
        return TailPlan("four")
    fused = next((p for n in range(1, SPLIT_MAX_KS + 1) if (p := _fused_plan(b, h, w, c, n))), None)
    if family == "fused":
        if fused is None:
            raise ValueError(f"tail_plan: no fused tiling for {(b, h, w, c)}")
        return fused
    take = (fused is not None and b * h * w >= FUSED_MIN_FILL * NUM_SMS * _slots(fused.px, fused.threads, c)
            and conv3x3_plan(b, h, w, c, c).family == "tile")
    return fused if take else TailPlan("four")


class TailBwdPlan(NamedTuple):
    """How the tail's backward runs. ``family`` "eight": four conv3x3_dgrad
    and four conv3x3_wgrad launches (the other fields 0). "fused": one launch
    of ``csrc/residual_tail_backward.cu`` and its sample reduction, ``bands``
    blocks a sample (one cluster), ``rows``, ``px`` and ``threads`` as in
    :class:`TailPlan`; ``smem`` bytes a block (two band buffers, one
    16-channel weight slice, the stage's 9C^2 + C sums); ``blocks`` the grid's;
    ``workspace`` floats of the samples' partial sums (B, 4, 9C^2 + C)."""

    family: str
    bands: int = 0
    rows: int = 0
    px: int = 0
    threads: int = 0
    smem: int = 0
    blocks: int = 0
    workspace: int = 0


def _bwd_sums(c: int) -> int:
    """A stage's sums: dW (C, C, 3, 3) and db (C,)."""
    return 9 * c * c + c


def _bwd_fused_plan(b, h, w, c, bands) -> TailBwdPlan | None:
    if c not in FUSED_TILING or not 1 <= bands <= min(h, SPLIT_MAX_KS):
        return None
    px, threads = FUSED_TILING[c]
    rows = -(-h // bands)
    if rows * w > _slots(px, threads, c):
        return None
    band = (((rows + 2) * (w + 1) + 1) * (c + 1) + 3) // 4 * 4
    smem = 4 * (2 * band + 9 * 16 * c + (_bwd_sums(c) + 3) // 4 * 4)
    if smem > SMEM_MAX:
        return None
    return TailBwdPlan("fused", bands, rows, px, threads, smem, b * bands, b * 4 * _bwd_sums(c))


@functools.lru_cache(maxsize=None)  # a pure function of its arguments, asked at every tail's backward
def tail_bwd_plan(b: int, h: int, w: int, c: int, *, family: str | None = None) -> TailBwdPlan:
    """The backward tail's route for a gradient (B, H, W, C); depends on the
    shapes only. The fused kernel where conv3x3_plan(b, h, w, c, c, flip)
    takes its square tiles (whose bits the fused kernel keeps in dx0; where
    it takes whole samples, at 25^2 from B=124, the eight launches were the
    faster), a tiling fits shared memory (the fewest bands whose rows fit
    the thread grid) and the batch's B*H*W pixels fill at least
    BWD_MIN_FILL of the card's pixel slots: 101^2 x 16 from B=6, 50^2 x 32
    from B=9, 50^2 x 16 from B=25, 25^2 x 32 from B=33 to 123; everything
    else the eight launches. ``family`` forces a route (raises where no
    fused tiling fits)."""
    if family not in (None,) + BWD_FAMILIES:
        raise ValueError(f"tail_bwd_plan: family must be one of {BWD_FAMILIES}, got {family!r}")
    if family == "eight":
        return TailBwdPlan("eight")
    fused = next((p for n in range(1, SPLIT_MAX_KS + 1) if (p := _bwd_fused_plan(b, h, w, c, n))), None)
    if family == "fused":
        if fused is None:
            raise ValueError(f"tail_bwd_plan: no fused tiling for {(b, h, w, c)}")
        return fused
    take = (fused is not None and b * h * w >= BWD_MIN_FILL * NUM_SMS * _slots(fused.px, fused.threads, c)
            and conv3x3_plan(b, h, w, c, c, True).family == "tile")
    return fused if take else TailBwdPlan("eight")


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


def residual_tail_backward_eight(g, x0, pre11, x1, pre21, out, k11, k12, k21, k22):
    """The route :func:`tail_bwd_plan` calls "eight": four conv3x3_dgrad and
    four conv3x3_wgrad launches (their plain versions for CPU tensors)."""
    return _backward(g, x0, pre11, x1, pre21, out, k11, k12, k21, k22, conv3x3_dgrad, conv3x3_wgrad)


def _launch_backward(g, x0, pre11, x1, pre21, out, ks):
    """Check the operands, launch the fused backward and its sample reduction."""
    if g.dim() != 4:
        raise ValueError(f"residual_tail_backward_fused: g must be (B, H, W, C), got {tuple(g.shape)}")
    b, h, w, c = g.shape
    acts = (g, out, pre21, x1, pre11, x0)
    for t, shape in [(t, (b, h, w, c)) for t in acts] + [(k, (3, 3, c, c)) for k in ks]:
        if tuple(t.shape) != shape:
            raise ValueError(f"residual_tail_backward_fused: an operand is {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32 or t.device != g.device or not t.is_contiguous():
            raise ValueError("residual_tail_backward_fused: inputs must be contiguous float32 on one CUDA device")
    p = tail_bwd_plan(b, h, w, c, family="fused")
    if b * p.bands > 2 ** 31 - 1:
        raise ValueError(f"residual_tail_backward_fused: unsupported batch {b}")
    dx0 = torch.empty_like(g)
    ws = torch.empty((p.workspace,), dtype=g.dtype, device=g.device)
    grads = [torch.empty(shape, dtype=g.dtype, device=g.device) for _ in range(4) for shape in ((c, c, 3, 3), (c,))]
    lib = _build.library("residual_tail_backward", _BWD_SIGNATURES)
    with torch.cuda.device(g.device), trace("port.kernel.tail_bwd", b=b, h=h, w=w, c=c, plan=p, dtype=g.dtype,
                                            kernels=2):
        code = lib.residual_tail_backward(
            *(_build.ptr(t) for t in acts), *(_build.ptr(k) for k in reversed(ks)), _build.ptr(dx0),
            _build.ptr(ws), *(_build.ptr(t) for t in grads), b, h, w, c, p.bands, p.rows, p.px, p.threads, p.smem,
            _build.stream_of(g),
        )
    _build.check(code, "residual_tail_backward_fused")
    dw22, db22, dw21, db21, dw12, db12, dw11, db11 = grads
    return dx0, dw11, db11, dw12, db12, dw21, db21, dw22, db22


def residual_tail_backward_fused(g, x0, pre11, x1, pre21, out, k11, k12, k21, k22):
    """The route :func:`tail_bwd_plan` calls "fused": one launch of
    ``csrc/residual_tail_backward.cu`` and one of its sample reduction; the
    arguments and results of :func:`residual_tail_backward`. CUDA tensors
    launch the kernel or raise; CPU tensors take the plain chain."""
    if g.device.type == "cpu":
        return _backward(g, x0, pre11, x1, pre21, out, k11, k12, k21, k22, conv3x3_dgrad_plain,
                         conv3x3_wgrad_plain)
    if g.device.type != "cuda":
        raise RuntimeError(f"residual_tail_backward_fused: no kernel for device {g.device}")
    res = _launch_backward(g, x0, pre11, x1, pre21, out, (k11, k12, k21, k22))
    count("kernel.tail_bwd.fused")
    return res


def residual_tail_backward(g, x0, pre11, x1, pre21, out, k11, k12, k21, k22):
    """(dx0, dw11, db11, dw12, db12, dw21, db21, dw22, db22) from the output
    gradient ``g`` and what the forward kept; ``k*`` are the (3, 3, C, C)
    weights the forward read. Weight gradients are (C, C, 3, 3). CUDA tensors
    take the route of :func:`tail_bwd_plan` (one fused launch and its sample
    reduction, or four dgrad and four wgrad launches) or raise; CPU tensors
    the plain versions."""
    args = (g, x0, pre11, x1, pre21, out, k11, k12, k21, k22)
    plan = tail_bwd_plan(*g.shape) if g.dim() == 4 else TailBwdPlan("eight")
    if plan.family == "fused":
        res = residual_tail_backward_fused(*args)
    else:
        res = residual_tail_backward_eight(*args)
    if g.device.type == "cuda":
        count("kernel.tail_bwd.all")
    return res


def _launch_fused(x0, ks, bs, keep):
    """Check the operands, launch the fused kernel, return (out, pre11, x1, pre21)."""
    if x0.dim() != 4:
        raise ValueError(f"residual_tail_fused: x0 must be (B, H, W, C), got {tuple(x0.shape)}")
    b, h, w, c = x0.shape
    for t, shape in [(x0, (b, h, w, c))] + [(k, (3, 3, c, c)) for k in ks] + [(t, (c,)) for t in bs]:
        if tuple(t.shape) != shape:
            raise ValueError(f"residual_tail_fused: an operand is {tuple(t.shape)}, want {shape}")
        if t.dtype != torch.float32 or t.device != x0.device or not t.is_contiguous():
            raise ValueError("residual_tail_fused: inputs must be contiguous float32 on one CUDA device")
    p = tail_plan(b, h, w, c, family="fused")
    if b * p.bands > 2 ** 31 - 1:
        raise ValueError(f"residual_tail_fused: unsupported batch {b}")
    out = torch.empty_like(x0)
    kept = [torch.empty_like(x0) if keep else None for _ in range(3)]
    lib = _build.library("residual_tail", _SIGNATURES)
    with torch.cuda.device(x0.device), trace("port.kernel.tail_fwd", b=b, h=h, w=w, c=c, keep=keep, plan=p,
                                             dtype=x0.dtype, kernels=1):
        code = lib.residual_tail_forward(
            _build.ptr(x0), *(_build.ptr(t) for pair in zip(ks, bs) for t in pair), _build.ptr(out),
            *(_build.ptr(t) for t in kept), b, h, w, c, p.bands, p.rows, p.px, p.threads, p.smem,
            _build.stream_of(x0),
        )
    _build.check(code, "residual_tail_fused")
    return (out, *kept)


def residual_tail_four(x0, k11, b11, k12, b12, k21, b21, k22, b22):
    """(out, pre11, x1, pre21) from four conv3x3 launches, the route
    :func:`tail_plan` calls "four"; ``k*`` are the (3, 3, C, C) weights.
    Outside autograd; CPU tensors take the plain chain."""
    return _forward(x0, k11, b11, k12, b12, k21, b21, k22, b22, conv3x3)


def residual_tail_fused(x0, k11, b11, k12, b12, k21, b21, k22, b22, *, keep=False):
    """(out, pre11, x1, pre21) from one launch of ``csrc/residual_tail.cu``;
    the last three are None unless ``keep``. ``k*`` are the (3, 3, C, C)
    weights. Outside autograd; CUDA tensors launch the kernel or raise, CPU
    tensors take the plain chain."""
    if x0.device.type == "cpu":
        out, pre11, x1, pre21 = _forward(x0, k11, b11, k12, b12, k21, b21, k22, b22, conv3x3_plain)
        return (out, pre11, x1, pre21) if keep else (out, None, None, None)
    if x0.device.type != "cuda":
        raise RuntimeError(f"residual_tail_fused: no kernel for device {x0.device}")
    res = _launch_fused(x0, (k11, k12, k21, k22), (b11, b12, b21, b22), keep)
    count("kernel.tail_fwd.fused")
    return res


def _launch_forward(x0, w11, b11, w12, b12, w21, b21, w22, b22, keep=False):
    """(out, (x0, pre11, x1, pre21), the (3, 3, C, C) weights) by the route of
    :func:`tail_plan`: one fused launch (pre11, x1, pre21 None unless
    ``keep``) or four conv3x3 launches; their plain versions for CPU tensors."""
    x0 = x0.contiguous()
    ks = [hwio(w) for w in (w11, w12, w21, w22)]
    bs = [b.contiguous() for b in (b11, b12, b21, b22)]
    args = (x0, ks[0], bs[0], ks[1], bs[1], ks[2], bs[2], ks[3], bs[3])
    plan = tail_plan(*x0.shape) if x0.dim() == 4 else TailPlan("four")
    if plan.family == "fused":
        out, pre11, x1, pre21 = residual_tail_fused(*args, keep=keep)
    else:
        out, pre11, x1, pre21 = residual_tail_four(*args)
    if x0.device.type == "cuda":
        count("kernel.tail_fwd.all")
    return out, (x0, pre11, x1, pre21), ks


class _ResidualTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, keep, x0, w11, b11, w12, b12, w21, b21, w22, b22):
        out, kept, ks = _launch_forward(x0, w11, b11, w12, b12, w21, b21, w22, b22, keep)
        if keep:
            ctx.save_for_backward(*kept, out, *ks)
        return out

    @staticmethod
    def backward(ctx, g):
        return (None, *residual_tail_backward(g.contiguous(), *ctx.saved_tensors))


def residual_tail(x0, w11, b11, w12, b12, w21, b21, w22, b22):
    """(B, H, W, C) -> (B, H, W, C), differentiable in every argument. CUDA
    inputs take the route of :func:`tail_plan` (and, in the backward, the
    dgrad and wgrad launches) or raise; CPU inputs the plain versions of each.
    The forward keeps what the backward reads only while autograd records."""
    args = (x0, w11, b11, w12, b12, w21, b21, w22, b22)
    keep = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    return _ResidualTail.apply(keep, *args)


def residual_tail_ranges(x0, w11, b11, w12, b12, w21, b21, w22, b22):
    """(out, ranges): :func:`residual_tail`'s forward, outside autograd, and
    the largest value each of its four convs reads, max of relu(x0),
    relu(pre11), relu(x1) and relu(pre21) as a (4,) tensor: the int8
    calibration's ranges, read from what the same launches keep."""
    out, kept, _ = _launch_forward(x0, w11, b11, w12, b12, w21, b21, w22, b22, keep=True)
    return out, torch.stack([t.amax() for t in kept]).clamp_min(0.0)
