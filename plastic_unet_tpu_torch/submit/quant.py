"""int8 serving: calibration and packaging (counterpart of
plastic_unet_tpu.submit.quant). ops.quant holds the numerics and
models.blocks the quantized convs.

    qmodel = quantize_for_serving(model, X_calib)          # a calibrated copy, quant="int8"
    preds = predict_masks(qmodel, X_test)                  # eval.evaluate
    preds = predict_masks_tta(qmodel, X_test, transforms=...)  # submit.inference

The weights are unchanged (they quantize at each forward), so one
checkpoint serves fp32 and int8; the 49 ranges are ``qmodel.quant_ranges()``.
"""

from __future__ import annotations

import copy

import torch

from plastic_unet_tpu_torch import resolve_device
from plastic_unet_tpu_torch.eval.evaluate import _as_tensor
from plastic_unet_tpu_torch.utils.precision import serving_numerics


def _with_quant(model, mode: str, device):
    if not hasattr(model, "quant_ranges"):  # UNetP: the JAX module has no quant field either
        raise ValueError(f"int8 serving is a UNetPRes mode; {type(model).__name__} has no quantized convs")
    q = copy.deepcopy(model).to(device).eval()
    q.quant = mode
    return q


def calibrate(model, X_calib, *, chunk: int = 128, device=None) -> dict:
    """The activation range (amax = max|input| seen) of each quantized conv,
    over ``X_calib`` (N, H, W, C), as ``{module prefix: 0-d tensor}``. The
    forward is the model's own (fp32 on CUDA: the kernels; a bf16 model's
    bf16 trunk, whose bf16 activations the ranges then record, as the JAX
    calib mode does under a bf16 model), so the ranges are those of the
    served distribution. ``model`` is not changed.

    Chunks are not zero-padded, unlike predict_masks: all-zero samples would
    push bias-only activations through the net and widen the ranges of the
    deeper convs. The last chunk runs at its own size."""
    dev = resolve_device(device)
    X = _as_tensor(X_calib, dev)
    if X.shape[0] == 0:
        raise ValueError("calibration set is empty")
    cmodel = _with_quant(model, "calib", dev)
    for conv in (m for m in cmodel.modules() if "amax" in m._buffers):
        conv.amax = None
    with torch.inference_mode(), serving_numerics():
        for lo in range(0, X.shape[0], chunk):
            x = X[lo:lo + chunk]
            cmodel(x, cmodel.initial_zero_hebb(x.shape[0], device=dev))
    return {name: amax.clone() for name, amax in cmodel.quant_ranges().items()}


def quantize_for_serving(model, X_calib, *, chunk: int = 128, device=None):
    """Calibrate on ``X_calib`` and return a copy of ``model`` in
    ``quant="int8"`` holding the ranges, on ``device``, for every serving
    entry point (predict_masks, predict_masks_tta, predict, MaskPredictor)."""
    dev = resolve_device(device)
    qmodel = _with_quant(model, "int8", dev)
    qmodel.load_quant_ranges(calibrate(model, X_calib, chunk=chunk, device=dev))
    return qmodel
