"""Inference and the Kaggle submission (counterpart of
plastic_unet_tpu.submit.inference; reference infer.py).

  * :func:`predict`: chunked zero-trace masks for the test tiles,
    binarized at ``pred > threshold`` (float64-exact, see
    :func:`threshold_as_f32`), RLE-encoded, written as ``submission.csv``
    (``id,rle_mask``), with the bytes the JAX package's pandas writer gives.
  * :func:`start_inference`: best-threshold search on validation, then
    :func:`predict`.

Test-time augmentation other than the identity view, the PNG mask dump and
the visual spot checks are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np
import torch

from plastic_unet_tpu_torch.eval.evaluate import predict_masks, score_model_best_iou
from plastic_unet_tpu_torch.ops.rle import encode_batch


def predict_masks_tta(model, X, *, transforms: Sequence[str] = ("identity",), chunk: int = 128,
                      device=None) -> torch.Tensor:
    """Chunked zero-trace prediction merged over TTA views; only the
    identity view is ported so far."""
    if tuple(transforms) != ("identity",):
        raise NotImplementedError(
            f"TTA views {tuple(transforms)} are not ported yet; only ('identity',) is "
            "(see ROADMAP.md, serving features left out of the first slice)"
        )
    return predict_masks(model, X, chunk=chunk, device=device)


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


def predict(model, ids: Sequence, images, run_params: dict, *, chunk: int = 128, device=None) -> str:
    """Predict all test masks and write the RLE submission CSV.

    ids: the tile ids, in the order of ``images``; images: the test tiles,
    reshaped to (N, img_height, img_width, img_chan). run_params carries the
    geometry, ``mask_threshold``, ``out_dir`` and ``subm_file``. Returns the
    CSV's path."""
    X = np.asarray(images, dtype=np.float32).reshape(
        -1, run_params["img_height"], run_params["img_width"], run_params["img_chan"]
    )
    if len(ids) != X.shape[0]:
        raise ValueError(f"{len(ids)} ids for {X.shape[0]} images")
    preds = predict_masks_tta(model, X, chunk=chunk, device=device)
    masks = binarize(preds, run_params["mask_threshold"])
    subm_file = os.path.join(run_params["out_dir"], run_params["subm_file"])
    write_submission(subm_file, ids, encode_batch(masks))
    return subm_file


def start_inference(model, ids: Sequence, images, X_valid, y_valid, out_dir: str, img_width: int,
                    img_height: int, img_chan: int, subm_file: str = "submission.csv", *,
                    chunk: int = 128, device=None, debug: bool = False) -> str:
    """Best-threshold search on validation, then the test prediction.
    X_valid arrives NCHW (the reference data contract) and is transposed
    to NHWC here."""
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
    return predict(model, ids, images, run_params, chunk=chunk, device=device)
