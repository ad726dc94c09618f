"""The plastic head as one CUDA kernel for all samples (counterpart of
plastic_unet_tpu.ops.pallas_plastic; source ``csrc/plastic_head.cu``).

:func:`plastic_head` takes ``activin`` and ``hebb`` of shape ``(B, nbf, nbf)``
and returns ``(activ, activout, new_hebb)``. On CUDA tensors it launches the
kernel, once for the whole batch; on CPU tensors it runs the plain version,
ops.plasticity.plastic_head_logits, which is also what the kernel is held
against on the card. The forward has no autograd: serving needs none, and
the JAX package's backward of this head is itself not a kernel; a CUDA
call on tensors that autograd tracks raises.
"""

from __future__ import annotations

import ctypes

import torch

from plastic_unet_tpu_torch.ops import _build
from plastic_unet_tpu_torch.ops.plasticity import check_head_args, plastic_head_logits

_V, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"plastic_head_forward": [_V, _V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _V]}


plastic_head_plain = plastic_head_logits  # the kernel's plain PyTorch version (any device)


def plastic_head(w, alpha, eta, activin, hebb, *, rule: str = "hebb", alfa_type: str = "free"):
    """(activ, activout, new_hebb), each ``(B, nbf, nbf)``.

    w: (nbf, nbf); alpha: (nbf, nbf), or one element for a yoked scalar;
    eta: (1,); activin, hebb: (B, nbf, nbf). A CUDA input launches the
    kernel or raises; only CPU inputs take the plain version."""
    check_head_args(rule, alfa_type)
    if activin.device.type == "cpu":
        return plastic_head_plain(w, alpha, eta, activin, hebb, rule=rule, alfa_type=alfa_type)
    if activin.device.type != "cuda":
        raise RuntimeError(f"plastic_head: no kernel for device {activin.device}")
    _build.require_no_grad("plastic_head", w, alpha, eta, activin, hebb)
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


plastic_head.launches = 0
