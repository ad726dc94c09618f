"""Float32 precision policy (counterpart of plastic_unet_tpu.utils.precision).

  * ``"parity"`` -> true fp32: TF32 off for both cuBLAS matmuls
    (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
    (``torch.backends.cudnn.allow_tf32``, which PyTorch turns ON by default).
  * ``"perf"``   -> TF32 allowed for both.

The policy in force is the innermost :func:`matmul_precision` block's, and
"parity" outside every block (:func:`current_policy`), so a library caller
that opens none gets true fp32. The JAX CLIs and ``TrainConfig`` default to
"perf", as the JAX package's do; their blocks reach the training step, the
validation and the serving chunks through :func:`training_numerics` and
:func:`serving_numerics`, which apply the policy in force.

The hand-written kernels of this package accumulate in plain fp32 FMAs in
either mode; the policy governs only what is left to cuBLAS and cuDNN (the
entry convs, the ConvTransposes, the 1x1 outconv, and with a bfloat16
``compute_dtype`` the whole trunk, whose bf16 convs TF32 does not touch).

:func:`training_numerics` is what the training step runs under: the policy
in force plus ``torch.backends.cudnn.deterministic``. Without the latter
cuDNN may pick backward algorithms that add with atomics, and two runs of
the same step on the same card differ in the last bits of the entry convs'
and transposed convs' gradients; with it (and the package's own
deterministic kernels) a step, eager or replayed from a CUDA graph, gives
the same bits every time under either policy, which exact resume depends
on. A CUDA graph keeps the algorithms of the policy in force at its capture.

:func:`serving_numerics` is the same for the serving forward: without
deterministic cuDNN the ConvTranspose of the deepest UpRes (6x6x256 ->
13x13x128 at a 128-tile chunk) takes an algorithm whose sums do not repeat
from run to run, and a chunk's masks differ in the last bits between runs,
between one pass a TTA view and the views folded into the batch, and
between an exported program and the live path (ROADMAP.md, C5).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

POLICIES = ("parity", "perf")

_POLICY = contextvars.ContextVar("matmul_precision", default="parity")


def current_policy() -> str:
    """The policy of the innermost :func:`matmul_precision` block, "parity" outside every block."""
    return _POLICY.get()


@contextlib.contextmanager
def matmul_precision(policy: str):
    """Apply the named policy for the duration of the block, then restore."""
    if policy not in POLICIES:
        raise ValueError(f"precision policy must be one of {POLICIES}, got {policy!r}")
    allow = policy == "perf"
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    token = _POLICY.set(policy)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        _POLICY.reset(token)


@contextlib.contextmanager
def training_numerics():
    """The policy in force plus deterministic cuDNN algorithms, restored on exit."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with matmul_precision(current_policy()):
            yield
    finally:
        torch.backends.cudnn.deterministic = prev


serving_numerics = training_numerics  # the serving forward's policy: the same, for the same reason (C5)
