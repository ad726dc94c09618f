"""The plastic head as one CUDA kernel for all samples (counterpart of
plastic_unet_tpu.ops.pallas_plastic; source ``csrc/plastic_head.cu``).

:func:`plastic_head` takes ``activin`` and ``hebb`` of shape ``(B, nbf, nbf)``
and returns ``(activ, activout, new_hebb)``. On CUDA tensors it launches the
kernel, once for the whole batch; on CPU tensors it runs the plain version,
ops.plasticity.plastic_head_logits, which is also what the kernel is held
against on the card.

:func:`head_plan` picks the kernel's tiling from the shapes alone: one block
per sample ("sample") for large batches, bands of rows x tiles of columns
("spread", about 128 blocks at B=1) for the smallest, and square 32x32 tiles
("tile") between them and where a sample does not fit one block. Every
family sums each output in the same order, so all give the same bits.

Gradient, as in the JAX package (its ``custom_vjp``): the forward launches
the kernel and keeps the primals; the backward is autograd of the plain
version at those primals, a few (nbf, nbf) matrix products that the JAX
package also leaves outside any kernel. It recomputes only what the
cotangents it is given reach: ``activ`` always, ``activout`` when its or the
trace's cotangent is set, the trace update when the trace's is. ``new_hebb``
is an output like the others; a training step that feeds the loss from
``activ`` or ``activout`` alone sends no gradient to ``eta``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from plastic_unet_tpu_torch.ops import _build
from plastic_unet_tpu_torch.ops.plasticity import check_head_args, hebb_update, oja_update, plastic_head_logits
from plastic_unet_tpu_torch.utils.profiling import count, trace

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"plastic_head_forward": [_V] * 8 + [_I] * 11 + [_V]}
NUM_SMS = 132  # an H100's SMs
SMEM_MAX = 232448  # the most shared memory a block may use
MAX_BATCH = 65535  # the grid's z extent
FAMILIES = ("tile", "sample", "spread")
TILE = 32  # "tile": 32x32 outputs a block, 256 threads
SAMPLE_TR, SAMPLE_TC, SAMPLE_MAXT = 8, 4, 512  # rows x columns a thread; the most threads a block
SPREAD_TR, SPREAD_TC, SPREAD_THREADS = 1, 1, 128
SAMPLE_WQ = 8  # "sample": quads of w and of alpha a thread holds in registers
SPREAD_MAX_BATCH, SAMPLE_MIN_BATCH = 8, 33  # the plan's batch ranges of "spread" and "sample"


class HeadPlan(NamedTuple):
    """How the kernel cuts the work: ``grid`` (column tiles, row bands,
    samples) of ``threads``-thread blocks with ``smem`` bytes of dynamic
    shared memory. "sample" and "spread" stage bands of ``br`` rows x tiles
    of ``bc`` columns (a whole sample in "sample"); ``xs`` and ``es`` are the
    strides (floats) of the staged activin (k-major) and of the staged eff.
    The four are 0 in "tile", whose tiles are fixed."""

    family: str
    grid: tuple
    threads: int
    smem: int
    br: int = 0
    bc: int = 0
    xs: int = 0
    es: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _staged_plan(b: int, n: int, family: str, br: int, bc: int) -> HeadPlan | None:
    """The plan of a staged family with bands of ``br`` rows and tiles of
    ``bc`` columns, or None where it does not fit: the layout is the
    kernel's (``plastic_head_staged``)."""
    tr, tc = (SAMPLE_TR, SAMPLE_TC) if family == "sample" else (SPREAD_TR, SPREAD_TC)
    rt, ct = _cdiv(br + (n > br), tr), _cdiv(bc, tc)  # threads over the rows (row 0 extra) and the columns
    xs = rt * tr + (4 - rt * tr % 8) % 8  # >= the rows, xs % 8 == 4: a transposing store spreads over 8 banks
    es = 4 * _cdiv(ct * tc, 4)  # rows of eff 16-byte aligned
    if family == "sample":
        threads = 32 * max(4, _cdiv(rt * ct, 32))
        if threads > SAMPLE_MAXT or _cdiv(n * n, 4) > SAMPLE_WQ * threads:
            return None
    else:
        threads = SPREAD_THREADS
        if rt * ct > threads:
            return None
    smem = 4 * _staged_floats(n, family, br, xs, es)
    if smem > SMEM_MAX:
        return None
    return HeadPlan(family, (_cdiv(n, bc), _cdiv(n, br), b), threads, smem, br, bc, xs, es)


def _staged_floats(n: int, family: str, br: int, xs: int, es: int) -> int:
    """Floats of shared memory a block takes, as the kernel lays them out
    (alpha a matrix): "sample" keeps the flat x (then eff) and hebb (each at
    its misalignment, hence the 3 spare floats), activin k-major, row 0 and
    y0; "spread" activin k-major, the stripes of w (then eff), alpha and
    hebb, row 0's band segment and y0."""
    if family == "sample":
        flat = 4 * _cdiv(n * n + 3, 4)
        return max(n * es, flat) + flat + max(n * xs, n * es) + 4 * _cdiv(n, 4) + es
    return max(n * xs, br * es) + 3 * n * es + br + es


def _spread_choice(b: int, n: int) -> HeadPlan | None:
    """The spread tiling with the most blocks that still fit the card at
    once (NUM_SMS), else the fewest beyond it; then the fewest floats staged
    per k (its rows, row 0 and three column stripes)."""
    best, best_key = None, None
    for br in sorted({_cdiv(n, k) for k in range(1, n + 1)}):
        for bc in sorted({4 * _cdiv(_cdiv(n, k), 4) for k in range(1, _cdiv(n, 4) + 1)}):
            p = _staged_plan(b, n, "spread", br, bc)
            if p is None:
                continue
            blocks = p.grid[0] * p.grid[1] * b
            key = ((0, -blocks) if blocks <= NUM_SMS else (1, blocks)) + (br + 1 + 3 * bc,)
            if best_key is None or key < best_key:
                best, best_key = p, key
    return best


@functools.lru_cache(maxsize=None)  # a pure function of its arguments, asked at every launch
def head_plan(b: int, n: int, *, family: str | None = None) -> HeadPlan:
    """The kernel's tiling for B samples of (n, n); depends on the shapes
    only. Up to SPREAD_MAX_BATCH samples take bands x tiles ("spread"), from
    SAMPLE_MIN_BATCH on one block each ("sample", where a sample fits one
    block: n <= 128), the rest the 32x32 tiles ("tile"): at n=101 each is
    the fastest of the three there (``head_phases.py`` times every family
    over a range of B). ``family`` forces one, and raises where it cannot
    take the shape."""
    if family not in (None,) + FAMILIES:
        raise ValueError(f"head_plan: family must be one of {FAMILIES}, got {family!r}")
    if not (1 <= b <= MAX_BATCH and n >= 1):
        raise ValueError(f"head_plan: unsupported shape B={b}, n={n}")
    if family is None:
        sample = _staged_plan(b, n, "sample", n, n) if b >= SAMPLE_MIN_BATCH else None
        spread = _spread_choice(b, n) if b <= SPREAD_MAX_BATCH else None
        return sample or spread or head_plan(b, n, family="tile")
    if family == "tile":
        t = _cdiv(n, TILE)
        return HeadPlan("tile", (t, t, b), TILE * 8, 0)
    plan = _staged_plan(b, n, "sample", n, n) if family == "sample" else _spread_choice(b, n)
    if plan is None:
        raise ValueError(f"head_plan: the {family} family cannot take B={b}, n={n}")
    return plan


plastic_head_plain = plastic_head_logits  # the kernel's plain PyTorch version (any device)


def _forward(w, alpha, eta, activin, hebb, rule, alfa_type, plan):
    """The head outside autograd: the kernel on CUDA tensors (or an
    exception), the plain version on CPU tensors."""
    if activin.device.type == "cpu":
        return plastic_head_plain(w, alpha, eta, activin, hebb, rule=rule, alfa_type=alfa_type)
    if activin.device.type != "cuda":
        raise RuntimeError(f"plastic_head: no kernel for device {activin.device}")
    if activin.dim() != 3 or activin.shape[1] != activin.shape[2]:
        raise ValueError(f"plastic_head: activin must be (B, nbf, nbf), got {tuple(activin.shape)}")
    b, n, _ = activin.shape
    scalar_alpha = alpha.numel() == 1
    for name, t, shape in (("w", w, (n, n)), ("hebb", hebb, (b, n, n)), ("eta", eta, (1,)),
                           ("alpha", alpha, tuple(alpha.shape) if scalar_alpha else (n, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"plastic_head: {name} must be {shape}, got {tuple(t.shape)}")
    ins = [t.contiguous() for t in (activin, w, alpha, eta, hebb)]
    for t in ins:
        if t.dtype != torch.float32 or t.device != activin.device:
            raise ValueError("plastic_head: every input must be float32 on the same CUDA device")
    p = head_plan(b, n)  # raises beyond the grid's MAX_BATCH samples
    if plan is not None:
        p = head_plan(b, n, family=plan.family)
        if plan != p:
            raise ValueError(f"plastic_head: the plan {plan} is not one of these shapes ({p})")
    x, w_, a_, e_, h_ = ins
    activ, activout, new_hebb = (torch.empty_like(x) for _ in range(3))
    lib = _build.library("plastic_head", _SIGNATURES)
    with torch.cuda.device(x.device), trace("port.kernel.head", b=b, n=n, rule=rule, scalar_alpha=scalar_alpha, plan=p,
                                            dtype=x.dtype, kernels=1):
        code = lib.plastic_head_forward(
            _build.ptr(x), _build.ptr(w_), _build.ptr(a_), _build.ptr(e_), _build.ptr(h_),
            _build.ptr(activ), _build.ptr(activout), _build.ptr(new_hebb),
            b, n, int(rule == "oja"), int(scalar_alpha), FAMILIES.index(p.family), p.br, p.bc, p.xs, p.es,
            p.threads, p.smem, _build.stream_of(x),
        )
    _build.check(code, "plastic_head")
    count("kernel.head.all")
    return activ, activout, new_hebb


def _recompute(w, alpha, eta, activin, hebb, rule, need_out, need_hebb):
    """The plain head's outputs that the backward needs: activ, then
    activout and the new trace only where asked (None otherwise)."""
    activ = torch.matmul(activin, w + alpha * hebb)
    activout = torch.sigmoid(activ) if need_out or need_hebb else None
    update = hebb_update if rule == "hebb" else oja_update
    return activ, activout, update(hebb, activin, activout, eta) if need_hebb else None


class _PlasticHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, alpha, eta, activin, hebb, rule, alfa_type, plan):
        ctx.rule = rule
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(w, alpha, eta, activin, hebb)
        return _forward(w, alpha, eta, activin, hebb, rule, alfa_type, plan)

    @staticmethod
    def backward(ctx, *cts):
        primals = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        used = [(i, ct) for i, ct in enumerate(cts) if ct is not None]
        wanted = [p for p in primals if p.requires_grad]
        grads = iter(())
        if used and wanted:
            with torch.enable_grad():
                outs = _recompute(*primals, ctx.rule, cts[1] is not None, cts[2] is not None)
                grads = iter(torch.autograd.grad([outs[i] for i, _ in used], wanted, [ct for _, ct in used],
                                                 allow_unused=True))
        return tuple(next(grads, None) if p.requires_grad else None for p in primals) + (None, None, None)


def plastic_head(w, alpha, eta, activin, hebb, *, rule: str = "hebb", alfa_type: str = "free",
                 plan: HeadPlan | None = None):
    """(activ, activout, new_hebb), each ``(B, nbf, nbf)``; differentiable.

    w: (nbf, nbf); alpha: (nbf, nbf), or one element for a yoked scalar;
    eta: (1,); activin, hebb: (B, nbf, nbf). A CUDA input launches the
    kernel or raises; only CPU inputs take the plain version. ``plan`` (a
    :func:`head_plan` of these shapes) forces a tile family."""
    check_head_args(rule, alfa_type)
    return _PlasticHead.apply(w, alpha, eta, activin, hebb, rule, alfa_type, plan)
