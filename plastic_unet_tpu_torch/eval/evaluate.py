"""Evaluation: zero-trace validation and the best-IoU threshold search
(counterpart of plastic_unet_tpu.eval.evaluate; reference eval.py:20-103).

Every sample is evaluated with a zero hebb trace and the returned traces
are discarded. The forward runs in chunks of ``chunk`` samples, the last one
zero-padded to the full chunk, under the precision policy in force ("parity"
outside a matmul_precision block) with deterministic cuDNN
(utils.precision.serving_numerics), in the model's compute dtype; the masks
are fp32 either way. The best-threshold search sweeps the
reference's 31 thresholds logit(linspace(0.3, 0.7, 31)) against the sigmoid
outputs (a preserved quirk: logit-space values compared with probabilities)
and keeps the first argmax.

The entry points take ``device=None`` (CUDA; see
plastic_unet_tpu_torch.resolve_device) and move the model there.
:func:`predict_masks` also takes a data-parallel ``mesh``
(parallel.mesh.make_mesh): each chunk's batch is split over the ranks,
each rank runs its share, and an all-gather returns every mask to every
rank (zero-trace inference needs no other collective).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from plastic_unet_tpu_torch import resolve_device
from plastic_unet_tpu_torch.ops.iou import threshold_sweep
from plastic_unet_tpu_torch.ops.losses import bce_probs
from plastic_unet_tpu_torch.utils.precision import serving_numerics


def _as_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


def _padded(x: torch.Tensor, chunk: int) -> torch.Tensor:
    if x.shape[0] == chunk:
        return x
    return torch.cat([x, x.new_zeros((chunk - x.shape[0],) + tuple(x.shape[1:]))])


def predict_masks(model, X, *, chunk: int = 128, device=None, mesh=None) -> torch.Tensor:
    """Sigmoid masks ``(N, nbf, nbf)`` for NHWC images ``X (N, H, W, C)``,
    with zero traces, on ``device``. With a ``mesh`` every rank passes the
    same ``X``; rank r runs samples ``[r*c, (r+1)*c)`` of each chunk, c =
    chunk / world (``chunk % world`` must be 0), and every rank gets all
    ``N`` masks."""
    dev = resolve_device(device)
    world = 1 if mesh is None else mesh.size()
    if chunk % world:
        raise ValueError(f"chunk ({chunk}) must be divisible by mesh size ({world})")
    share = chunk // world
    mine = slice(0, chunk) if mesh is None else slice(dist.get_rank() * share, (dist.get_rank() + 1) * share)
    model = model.to(dev).eval()
    X = _as_tensor(X, dev)
    n = X.shape[0]
    out = torch.empty((n, model.nbf, model.nbf), device=dev)
    with torch.inference_mode(), serving_numerics():
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            hebb = model.initial_zero_hebb(share, device=dev)
            pred = model(_padded(X[lo:hi], chunk)[mine], hebb).activout
            if mesh is not None:
                parts = [torch.empty_like(pred) for _ in range(world)]
                dist.all_gather(parts, pred)
                pred = torch.cat(parts)
            out[lo:hi] = pred[: hi - lo]
    return out


def eval_net(model, X_val, y_val, *, chunk: int = 128, device=None):
    """Validation pass -> (accuracy, loss) like the reference eval_net:
    accuracy is the per-pixel agreement of (pred > 0.5) with (true > 0),
    the loss the mean per-sample BCE. Leaves the model in eval mode."""
    dev = resolve_device(device)
    pred = predict_masks(model, X_val, chunk=chunk, device=dev)
    n = pred.shape[0]
    pred = pred.reshape(n, -1)
    tgt = _as_tensor(y_val, dev).reshape(n, -1)
    losses = torch.stack([bce_probs(p, t) for p, t in zip(pred, tgt)])
    accs = ((pred > 0.5) == (tgt > 0)).to(torch.float32).mean(dim=1)
    return float(accs.mean()), float(losses.mean())


def threshold_grid() -> np.ndarray:
    """The reference's 31 logit-space thresholds (eval.py:48-50)."""
    t = np.linspace(0.3, 0.7, 31)
    return np.log(t / (1 - t))


def score_model_best_iou(model, X_valid, y_valid, *, chunk: int = 128, device=None, debug: bool = False):
    """Best-threshold search on validation -> (threshold_best, iou_best)."""
    dev = resolve_device(device)
    preds = predict_masks(model, X_valid, chunk=chunk, device=dev)
    thresholds = torch.as_tensor(threshold_grid(), dtype=torch.float32)
    ious = threshold_sweep(_as_tensor(y_valid, dev), preds, thresholds).cpu().numpy()
    if debug:
        print(ious)
    best = int(np.argmax(ious))
    return float(thresholds[best]), float(ious[best])
