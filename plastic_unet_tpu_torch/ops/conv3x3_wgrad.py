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

The reduction is deterministic: :func:`wgrad_plan` cuts the (sample, row)
sequence into tiles of whole rows and the tiles into chunks, only as many
as fill the card; each block writes its partial sums to a workspace and a
second kernel adds them in chunk order (no atomics). With one chunk the
first kernel writes the result itself. On CUDA tensors :func:`conv3x3_wgrad`
launches the kernel or raises; on CPU tensors it runs
:func:`conv3x3_wgrad_plain`, nine shifted ``x^T @ d`` products, the form of
the TPU kernel's ``_Geo.dw``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from plastic_unet_tpu_torch.ops import _build
from plastic_unet_tpu_torch.utils.profiling import count, trace

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"conv3x3_wgrad": [_V] * 6 + [_I] * 15 + [_V]}
LAYOUTS = ("hwio", "oihw")
THREADS = 256  # threads of a block; a thread keeps 2 ci x 4 co x 9 taps = 72 sums
TARGET_BLOCKS = 264  # two blocks (16 warps) on each of an H100's 132 SMs
SMEM_BUDGET = 115712  # bytes of a block that let two (each with 1 KB reserved) share an SM's 228 KB
SMEM_MAX = 232448  # the most a block may use
ONE_CHUNK_PIXELS = 256  # up to this many pixels (B*H*W) a second launch costs more than it saves
SMALL_PIXELS = 4096  # up to this many, a block's serial chain sets the time: more, smaller output tiles
VARIANTS = ((32, 64), (32, 32), (16, 16))  # the kernel's output tiles (ci_t, co_t), widest first


class WgradPlan(NamedTuple):
    """How the kernel cuts the work. Output tiles of ``ci_t`` x ``co_t``
    channels (one block each per chunk); pixel tiles of ``rows`` consecutive
    rows of one sample at full width, or of ``samples`` whole samples
    (rows == H); ``tiles`` of them, in ``chunks`` runs of consecutive tiles
    (chunk k: tiles [k*tiles//chunks, (k+1)*tiles//chunks)); ``smem`` bytes
    of dynamic shared memory per block."""

    ci_t: int
    co_t: int
    rows: int
    samples: int
    tiles: int
    chunks: int
    smem: int


def _stage_bytes(w: int, ci_t: int, co_t: int, rows: int, samples: int) -> int:
    """One stage of the ring: the input rows with their halo, and d."""
    return 4 * samples * ((rows + 2) * (w + 2) * ci_t + rows * w * co_t)


def wgrad_plan(b: int, h: int, w: int, cin: int, cout: int) -> WgradPlan:
    """The kernel's grid for (B, H, W, Cin, Cout); depends on the shapes only,
    so every run of one shape sums in one order."""
    k = 0 if cout > 32 else 1 if cout > 16 else 2  # the widest tile the output channels fill

    def slices(k):
        return -(-cin // VARIANTS[k][0]) * -(-cout // VARIANTS[k][1])

    one_chunk = b * h * w <= ONE_CHUNK_PIXELS
    if b * h * w <= SMALL_PIXELS:  # little work: narrower output tiles make more, shorter blocks
        narrowest = 2 if one_chunk else 1  # (16, 16)'s eight-group sum pays only where it runs once
        while k < narrowest and slices(k) < 64:
            k += 1
    ci_t, co_t = VARIANTS[k]
    want = 1 if one_chunk else max(1, TARGET_BLOCKS // slices(k))

    def fits(rows, samples, budget=SMEM_BUDGET):
        return 2 * _stage_bytes(w, ci_t, co_t, rows, samples) + 16 * THREADS <= budget

    if not fits(1, 1, SMEM_MAX):
        raise ValueError(f"conv3x3_wgrad: rows of width {w} do not fit shared memory")
    rmax = max([r for r in range(1, h + 1) if fits(r, 1)] or [1])
    if rmax == h:  # whole samples: the most that fit among those that least load the fullest chunk
        def fullest(s):
            tiles = -(-b // s)
            return min(b, -(-tiles // min(want, tiles)) * s)

        rows, samples = h, min((s for s in range(1, b + 1) if fits(h, s)), key=lambda s: (fullest(s), -s))
    else:
        rows, samples = max(1, min(rmax, b * h // want)), 1
        rows = -(-h // -(-h // rows))  # as many tiles a sample, with the fewest rows past H
    tiles = -(-b // samples) * -(-h // rows)
    chunks = min(tiles, want)
    # Shared memory: the ring (two stages if a chunk has two tiles), or in its place the groups'
    # sums and then the output tile; after them the bias sums, a float4 per thread.
    groups = THREADS // ((ci_t // 2) * (co_t // 4))
    ring = (2 if tiles > chunks else 1) * _stage_bytes(w, ci_t, co_t, rows, samples)
    sums = 4 * (groups - 1) * 72 * (THREADS // groups)
    out = 4 * 9 * ci_t * (co_t + 1)
    return WgradPlan(ci_t, co_t, rows, samples, tiles, chunks, max(ring, sums, out) + 16 * THREADS)


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
    plan = wgrad_plan(b, h, w, cin, cout)
    dw = torch.empty((3, 3, cin, cout) if layout == "hwio" else (cout, cin, 3, 3), dtype=x.dtype, device=x.device)
    db = torch.empty((cout,), dtype=x.dtype, device=x.device)
    w_part = b_part = None
    if plan.chunks > 1:
        w_part = torch.empty((plan.chunks, 9 * cin * cout), dtype=x.dtype, device=x.device)
        b_part = torch.empty((plan.chunks, cout), dtype=x.dtype, device=x.device)
    vec = cin % 4 == 0 and cout % 4 == 0 and x.data_ptr() % 16 == 0 and d.data_ptr() % 16 == 0
    lib = _build.library("conv3x3_wgrad", _SIGNATURES)
    with torch.cuda.device(x.device), trace("port.kernel.wgrad", b=b, h=h, w=w, cin=cin, cout=cout, relu_in=relu_in,
                                            plan=plan, dtype=x.dtype, kernels=1 + (plan.chunks > 1)):
        code = lib.conv3x3_wgrad(
            _build.ptr(x), _build.ptr(d), _build.ptr(dw), _build.ptr(db), _build.ptr(w_part), _build.ptr(b_part),
            b, h, w, cin, cout, plan.ci_t, plan.co_t, plan.rows, plan.samples, plan.tiles, plan.chunks, plan.smem,
            int(vec), int(relu_in), int(layout == "oihw"), _build.stream_of(x),
        )
    _build.check(code, "conv3x3_wgrad")
    count("kernel.wgrad.all")
    return dw, db
