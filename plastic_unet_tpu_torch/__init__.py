"""plastic_unet_tpu_torch — the PyTorch/CUDA port of ``plastic_unet_tpu``.

The JAX package stays the reference; this package re-implements its serving
path (UNetPRes forward with a zero trace, the best-threshold search on
validation, masks, RLE strings and ``submission.csv``; the dihedral TTA
views, the single-image inference, the PNG mask dump, the HTTP endpoint
and int8 post-training quantization, the exported serving artifacts), its
reference-parity training step (the B=1 lifetime loop with the detached
trace, BCE, Adam and a per-sample StepLR; lanes for B>1) and the training
entry point around it (the driver, checkpoints, data staging and the
train/eval/infer/tuned_run CLIs) in PyTorch, with
the TPU's Pallas kernels, forward and backward, replaced by CUDA kernels
written for Hopper (``csrc/``, built with ``nvcc`` for ``sm_90a`` on first
use).

Module paths mirror the JAX package, so each module has its counterpart:

  - models.unet_res.UNetPRes      <-> plastic_unet_tpu.models.unet_res
  - models.blocks                 <-> plastic_unet_tpu.models.blocks (residual family)
  - ops.plasticity                <-> plastic_unet_tpu.ops.plasticity
  - ops.plastic_head (csrc/plastic_head.cu) <-> ops.pallas_plastic
  - ops.conv3x3 (csrc/conv3x3.cu) <-> ops.pallas_conv, and the input-gradient
    passes of ops.pallas_trunk's backward
  - ops.conv3x3_wgrad (csrc/conv3x3_wgrad.cu) <-> the weight- and
    bias-gradient passes of ops.pallas_trunk's backward
  - ops.residual_tail (csrc/residual_tail.cu, and the conv3x3 kernels)
    <-> ops.pallas_trunk (forward and backward)
  - train.loop, train.optimizer   <-> plastic_unet_tpu.train.loop, .optimizer
  - train.driver, train.checkpoint, config, cli.{train,eval,infer,tuned_run}
    <-> their namesakes (the resume-state file replaces the Orbax state)
  - data.dataset, data.images, data.hdf5_io, ops.augment <-> their namesakes
    (no pandas or sklearn; PIL and h5py imported where used)
  - eval.evaluate, ops.iou, ops.losses, ops.rle, ops.quant, submit.inference,
    submit.server, submit.quant, submit.http_server, data.synthetic,
    utils.torch_interop, utils.precision
  - submit.export, cli.export_model <-> their namesakes (torch.export
    programs in place of jax.export's StableHLO; ops.export_ops makes the
    serving kernels custom ops a program can call)

Layout: images are NHWC ``(N, H, W, C)`` and masks ``(N, nbf, nbf)``, as in
the JAX package; activations inside the model are contiguous NHWC tensors.

Device rule: the entry points take ``device=None``, which means CUDA. On a
host without CUDA they raise unless the caller passes ``device="cpu"``;
there is no silent fallback to the CPU.

Tests on the CPU: ``python -m pytest tests/test_torch_*.py -q`` (port
against JAX, the training trajectory included). On the card:
``python3 chip_smoke.py`` (phases 7-10 are the training step, phase 11
the training entry point, phase 12 the serving features, phase 13 the
exported serving artifacts).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when that is a CUDA device and CUDA is not
    available; the CPU is used only when the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "plastic_unet_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return dev
