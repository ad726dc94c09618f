"""IoU metrics for TGS-Salt (counterpart of plastic_unet_tpu.ops.iou).

The numpy metrics are copies of the JAX package's closed forms of the
reference's iou_metric / iou_metric_batch / get_iou_vector /
fast_iou_metric. :func:`threshold_sweep` is the torch counterpart of
``threshold_sweep_jit``: the Kaggle batch IoU for every threshold of the
best-threshold search, on the predictions' device.
"""

from __future__ import annotations

import numpy as np
import torch

# Kaggle TGS precision thresholds 0.5:0.05:0.95 (reference iou_metric.py:67).
KAGGLE_THRESHOLDS = np.arange(0.5, 1.0, 0.05)


def iou_metric(y_true_in, y_pred_in) -> float:
    """Kaggle TGS mean-precision-over-thresholds for a single mask pair."""
    t = np.asarray(y_true_in) >= 0.5
    p = np.asarray(y_pred_in) >= 0.5
    inter = float(np.count_nonzero(t & p))
    union = float(np.count_nonzero(t)) + float(np.count_nonzero(p)) - inter
    if inter == 0.0:
        inter = 1e-9
    if union == 0.0:
        union = 1e-9
    return float((inter / union > KAGGLE_THRESHOLDS).mean())


def iou_metric_batch(y_true_in, y_pred_in) -> np.ndarray:
    """Mean of :func:`iou_metric` over the leading batch axis."""
    t = np.asarray(y_true_in) >= 0.5
    p = np.asarray(y_pred_in) >= 0.5
    n = t.shape[0]
    t = t.reshape(n, -1)
    p = p.reshape(n, -1)
    inter = (t & p).sum(axis=1).astype(np.float64)
    union = t.sum(axis=1) + p.sum(axis=1) - inter
    inter = np.where(inter == 0, 1e-9, inter)
    union = np.where(union == 0, 1e-9, union)
    prec = ((inter / union)[:, None] > KAGGLE_THRESHOLDS[None, :]).mean(axis=1)
    return np.array(prec.mean(), dtype=np.float32)


def get_iou_vector(A, B) -> float:
    """Binary-IoU-vs-thresholds metric, reduced per element of axis 0."""
    t = np.asarray(A) > 0
    p = np.asarray(B) > 0
    n = t.shape[0]
    t = t.reshape(n, -1)
    p = p.reshape(n, -1)
    inter = np.logical_and(t, p).sum(axis=1).astype(np.float64)
    union = np.logical_or(t, p).sum(axis=1).astype(np.float64)
    iou = (inter + 1e-10) / (union + 1e-10)
    return float((iou[:, None] > KAGGLE_THRESHOLDS[None, :]).mean(axis=1).mean())


def fast_iou_metric(y_true_in, y_pred_in) -> float:
    """Training-time validation accuracy (reference iou_metric.py:22-24)."""
    return get_iou_vector(y_true_in, np.asarray(y_pred_in) > 0.5)


def threshold_sweep(y_true: torch.Tensor, preds: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """(T,) float32 Kaggle batch IoU, one per threshold, for ``preds > thr``.

    y_true: (N, ...) ground truth (>= 0.5 is salt); preds: (N, ...) raw
    predictions. As in the JAX package the IoU is float32 and compared with
    float32 Kaggle thresholds; the mean over images and thresholds is taken
    from the exact count of passed thresholds, so equal scores tie exactly."""
    n = y_true.shape[0]
    t = (y_true >= 0.5).reshape(n, -1)
    pv = preds.reshape(n, -1)
    t_sum = t.sum(dim=1).to(torch.float32)
    kt = torch.as_tensor(KAGGLE_THRESHOLDS, dtype=torch.float32, device=pv.device)
    out = []
    for thr in thresholds.to(device=pv.device, dtype=pv.dtype):
        p = pv > thr
        inter = (t & p).sum(dim=1).to(torch.float32)
        union = t_sum + p.sum(dim=1).to(torch.float32) - inter
        inter = torch.where(inter == 0, torch.full_like(inter, 1e-9), inter)
        union = torch.where(union == 0, torch.full_like(union, 1e-9), union)
        passed = (inter / union)[:, None] > kt[None, :]
        out.append(passed.sum().to(torch.float64) / passed.numel())
    return torch.stack(out).to(torch.float32)
