"""The plastic head as one CUDA kernel for all samples (counterpart of
plastic_unet_tpu.ops.pallas_plastic; source ``csrc/plastic_head.cu``).

:func:`plastic_head` takes ``activin`` and ``hebb`` of shape ``(B, nbf, nbf)``
and returns ``(activ, activout, new_hebb)``. On CUDA tensors it launches the
kernel, once for the whole batch; on CPU tensors it runs the plain version,
ops.plasticity.plastic_head_logits, which is also what the kernel is held
against on the card.

Gradient, as in the JAX package (its ``custom_vjp``): the forward launches
the kernel and keeps the primals; the backward is autograd of the plain
version at those primals, a few (nbf, nbf) matrix products that the JAX
package also leaves outside any kernel. ``new_hebb`` is an output like the
others; a training step that feeds the loss from ``activ`` or ``activout``
alone sends no gradient to ``eta``.
"""

from __future__ import annotations

import ctypes

import torch

from plastic_unet_tpu_torch.ops import _build
from plastic_unet_tpu_torch.ops.plasticity import check_head_args, plastic_head_logits

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"plastic_head_forward": [_V, _V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _V]}


plastic_head_plain = plastic_head_logits  # the kernel's plain PyTorch version (any device)


def _forward(w, alpha, eta, activin, hebb, rule, alfa_type):
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
    if b > 65535:
        raise ValueError(f"plastic_head: batch {b} exceeds the grid limit 65535")
    x, w_, a_, e_, h_ = ins
    activ, activout, new_hebb = (torch.empty_like(x) for _ in range(3))
    lib = _build.library("plastic_head", _SIGNATURES)
    with torch.cuda.device(x.device):
        code = lib.plastic_head_forward(
            _build.ptr(x), _build.ptr(w_), _build.ptr(a_), _build.ptr(e_), _build.ptr(h_),
            _build.ptr(activ), _build.ptr(activout), _build.ptr(new_hebb),
            b, n, int(rule == "oja"), int(scalar_alpha), _build.stream_of(x),
        )
    _build.check(code, "plastic_head")
    plastic_head.launches += 1
    return activ, activout, new_hebb


class _PlasticHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, alpha, eta, activin, hebb, rule, alfa_type):
        ctx.rule, ctx.alfa_type = rule, alfa_type
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(w, alpha, eta, activin, hebb)
        return _forward(w, alpha, eta, activin, hebb, rule, alfa_type)

    @staticmethod
    def backward(ctx, *cts):
        primals = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        used = [(i, ct) for i, ct in enumerate(cts) if ct is not None]
        wanted = [p for p in primals if p.requires_grad]
        grads = iter(())
        if used and wanted:
            with torch.enable_grad():
                outs = plastic_head_plain(*primals, rule=ctx.rule, alfa_type=ctx.alfa_type)
                grads = iter(torch.autograd.grad([outs[i] for i, _ in used], wanted, [ct for _, ct in used],
                                                 allow_unused=True))
        return tuple(next(grads, None) if p.requires_grad else None for p in primals) + (None, None)


def plastic_head(w, alpha, eta, activin, hebb, *, rule: str = "hebb", alfa_type: str = "free"):
    """(activ, activout, new_hebb), each ``(B, nbf, nbf)``; differentiable.

    w: (nbf, nbf); alpha: (nbf, nbf), or one element for a yoked scalar;
    eta: (1,); activin, hebb: (B, nbf, nbf). A CUDA input launches the
    kernel or raises; only CPU inputs take the plain version."""
    check_head_args(rule, alfa_type)
    return _PlasticHead.apply(w, alpha, eta, activin, hebb, rule, alfa_type)


plastic_head.launches = 0
