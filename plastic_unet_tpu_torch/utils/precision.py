"""Float32 precision policy (counterpart of plastic_unet_tpu.utils.precision).

  * ``"parity"`` -> true fp32: TF32 off for both cuBLAS matmuls
    (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
    (``torch.backends.cudnn.allow_tf32``, which PyTorch turns ON by default).
    The serving path runs in this mode.
  * ``"perf"``   -> TF32 allowed for both.

The hand-written kernels of this package accumulate in plain fp32 FMAs in
either mode; the policy governs only what is left to cuBLAS and cuDNN.

:func:`training_numerics` is what the training step runs under: "parity"
plus ``torch.backends.cudnn.deterministic``. Without it cuDNN may pick
backward algorithms that add with atomics, and two runs of the same step on
the same card differ in the last bits of the entry convs' and transposed
convs' gradients; with it (and the package's own deterministic kernels) a
step, eager or replayed from a CUDA graph, gives the same bits every time,
which exact resume depends on.

:func:`serving_numerics` is the same policy for the serving forward: without
deterministic cuDNN the ConvTranspose of the deepest UpRes (6x6x256 ->
13x13x128 at a 128-tile chunk) takes an algorithm whose sums do not repeat
from run to run, and a chunk's masks differ in the last bits between runs,
between one pass a TTA view and the views folded into the batch, and
between an exported program and the live path (ROADMAP.md, C5).
"""

from __future__ import annotations

import contextlib

import torch

POLICIES = ("parity", "perf")


@contextlib.contextmanager
def matmul_precision(policy: str):
    """Apply the named policy for the duration of the block, then restore."""
    if policy not in POLICIES:
        raise ValueError(f"precision policy must be one of {POLICIES}, got {policy!r}")
    allow = policy == "perf"
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def training_numerics():
    """True fp32 ("parity") plus deterministic cuDNN algorithms, restored on exit."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with matmul_precision("parity"):
            yield
    finally:
        torch.backends.cudnn.deterministic = prev


serving_numerics = training_numerics  # the serving forward's policy: the same, for the same reason (C5)
