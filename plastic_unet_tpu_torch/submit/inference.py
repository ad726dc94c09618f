"""Inference and the Kaggle submission (counterpart of
plastic_unet_tpu.submit.inference; reference infer.py).

  * :func:`inference`: one image (HW, HWC or CHW) to one mask, zero trace.
  * :func:`predict_masks_tta`: chunked zero-trace masks averaged over the
    dihedral TTA views (ops.augment), one full pass a view or, with
    ``batch_views``, the views folded into the batch of one pass.
  * :func:`predict`: the test tiles' masks, binarized at
    ``pred > threshold`` (float64-exact, see :func:`threshold_as_f32`),
    RLE-encoded, written as ``submission.csv`` (``id,rle_mask``) with the
    bytes the JAX package's pandas writer gives; optionally each mask as
    ``out_dir/masks/<id>.png`` and, with ``visualize``, one
    viz.plots.plot_image_mask figure a tile (matplotlib).
  * :func:`start_inference`: best-threshold search on validation, then
    :func:`predict`.
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from plastic_unet_tpu_torch import resolve_device
from plastic_unet_tpu_torch.data.images import save_mask_png
from plastic_unet_tpu_torch.eval.evaluate import _as_tensor, predict_masks, score_model_best_iou
from plastic_unet_tpu_torch.ops.augment import TTA_TRANSFORMS, tta_batched_apply, tta_merge
from plastic_unet_tpu_torch.ops.rle import encode_batch


def inference(model, img_data, *, device=None) -> np.ndarray:
    """The mask (nbf, nbf) of one image, HW, HWC or CHW (a leading axis of 1
    or 3 read as channels unless the last axis is 1 or 3), zero trace."""
    img = np.asarray(img_data, dtype=np.float32)
    if img.ndim == 2:
        img = img[..., None]
    elif img.ndim == 3 and img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = np.transpose(img, (1, 2, 0))
    return predict_masks(model, img[None], chunk=1, device=device)[0].cpu().numpy()


def predict_masks_tta(model, X, *, transforms: Sequence[str] = ("identity",), chunk: int = 128,
                      batch_views: bool = False, device=None, mesh=None) -> torch.Tensor:
    """Chunked zero-trace masks ``(N, nbf, nbf)`` of NHWC images ``X``,
    averaged over the TTA views ``transforms`` after each view's inverse.
    One full chunked pass a view, or with ``batch_views`` the T views folded
    into the batch of one pass of T*N samples. Eval-mode math does not
    depend on a sample's place in its chunk, and every layer repeats its
    bits (serving_numerics, models.blocks.dense_strides: ROADMAP.md, C5),
    so both give the same masks. Each view is made contiguous before the
    forward. ``mesh``: each chunk split over the ranks (eval.evaluate.predict_masks)."""
    if tuple(transforms) == ("identity",):
        return predict_masks(model, X, chunk=chunk, device=device, mesh=mesh)
    dev = resolve_device(device)
    X = _as_tensor(X, dev)
    if batch_views:
        return tta_batched_apply(lambda allv: predict_masks(model, allv, chunk=chunk, device=dev, mesh=mesh), X,
                                 transforms)
    views = [predict_masks(model, TTA_TRANSFORMS[t][0](X, True).contiguous(), chunk=chunk, device=dev, mesh=mesh)
             for t in transforms]
    return tta_merge(torch.stack(views, dim=0), transforms, channels_last=False)


def threshold_as_f32(t: float) -> np.float32:
    """The f32 threshold whose compare ``p > t32`` equals the float64
    compare ``p > t`` for every f32 prediction p: the largest f32 <= t (no
    f32 lies in (t32, t]). Thresholds from score_model_best_iou are exact
    f32 already and pass through unchanged."""
    t32 = np.float32(t)
    if float(t32) > float(t):
        t32 = np.nextafter(t32, np.float32(-np.inf))
    return t32


def binarize(preds: torch.Tensor, threshold: float) -> np.ndarray:
    """uint8 masks ``preds > threshold`` (float64-exact), fetched to the host."""
    t32 = torch.tensor(float(threshold_as_f32(threshold)), dtype=preds.dtype, device=preds.device)
    return (preds > t32).to(torch.uint8).cpu().numpy()


def write_submission(path: str, ids: Sequence, rles: Sequence[str]) -> None:
    """``id,rle_mask`` CSV, byte-equal to pandas' ``DataFrame.to_csv``."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["id", "rle_mask"])
        for i, r in zip(ids, rles):
            w.writerow([i, r])


def predict(model, ids: Sequence, images, run_params: dict, *, visualize: bool = False, save_masks: bool = False,
            tta: Sequence[str] = ("identity",), chunk: int = 128, device=None, mesh=None) -> str:
    """Predict all test masks and write the RLE submission CSV.

    ids: the tile ids, in the order of ``images``; images: the test tiles,
    reshaped to (N, img_height, img_width, img_chan). run_params carries the
    geometry, ``mask_threshold``, ``out_dir`` and ``subm_file``; ``tta``
    the views; ``save_masks`` also writes each binarized mask as
    ``out_dir/masks/<id>.png``; ``visualize`` draws each tile beside its
    mask (viz.plots.plot_image_mask of the image stacked x3, as the JAX
    package does), closing each figure after its ``show``; it raises
    ImportError before any prediction where matplotlib is not installed.
    Returns the CSV's path. ``mesh``: each chunk split over the ranks; rank 0
    writes the files and draws while the others wait."""
    if visualize:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise ImportError("predict(visualize=True) draws with matplotlib, which is not installed") from e
    X = np.asarray(images, dtype=np.float32).reshape(
        -1, run_params["img_height"], run_params["img_width"], run_params["img_chan"]
    )
    if len(ids) != X.shape[0]:
        raise ValueError(f"{len(ids)} ids for {X.shape[0]} images")
    preds = predict_masks_tta(model, X, transforms=tta, chunk=chunk, device=device, mesh=mesh)
    masks = binarize(preds, run_params["mask_threshold"])
    subm_file = os.path.join(run_params["out_dir"], run_params["subm_file"])
    if mesh is None or dist.get_rank() == 0:
        if visualize:
            from plastic_unet_tpu_torch.viz.plots import _plt, plot_image_mask

            plt = _plt()
            for x, mask in zip(X, masks):
                image = x.squeeze()
                plt.close(plot_image_mask(np.dstack((image, image, image)), mask))
        if save_masks:
            mask_dir = os.path.join(run_params["out_dir"], "masks")
            os.makedirs(mask_dir, exist_ok=True)
            for idx, m in zip(ids, masks):
                save_mask_png(os.path.join(mask_dir, f"{idx}.png"), m.astype(bool))
        write_submission(subm_file, ids, encode_batch(masks))
    if mesh is not None:
        dist.barrier()
    return subm_file


def start_inference(model, ids: Sequence, images, X_valid, y_valid, out_dir: str, img_width: int,
                    img_height: int, img_chan: int, subm_file: str = "submission.csv", *, visualize: bool = False,
                    save_masks: bool = False, tta: Sequence[str] = ("identity",), chunk: int = 128, device=None,
                    debug: bool = False, mesh=None) -> str:
    """Best-threshold search on validation, then the test prediction.
    X_valid arrives NCHW (the reference data contract) and is transposed
    to NHWC here. ``mesh`` shards the test prediction, as in JAX (the search
    runs whole on every rank)."""
    xv = np.transpose(np.asarray(X_valid, dtype=np.float32), (0, 2, 3, 1))
    threshold_best, iou_best = score_model_best_iou(model, xv, np.asarray(y_valid), chunk=chunk,
                                                    device=device, debug=debug)
    print("Best threshold: %f, best IoU: %f" % (threshold_best, iou_best))
    run_params = {
        "out_dir": out_dir,
        "img_width": img_width,
        "img_height": img_height,
        "img_chan": img_chan,
        "mask_threshold": threshold_best,
        "subm_file": subm_file,
    }
    os.makedirs(out_dir, exist_ok=True)
    return predict(model, ids, images, run_params, visualize=visualize, save_masks=save_masks, tta=tta, chunk=chunk,
                   device=device, mesh=mesh)
