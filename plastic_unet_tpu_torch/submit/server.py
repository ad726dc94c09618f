"""Serving API (counterpart of plastic_unet_tpu.submit.server): a warm
predictor that loads UNetPRes weights once and answers numpy batches."""

from __future__ import annotations

import numpy as np
import torch

from plastic_unet_tpu_torch import resolve_device
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops.rle import encode_batch
from plastic_unet_tpu_torch.submit.inference import binarize, predict_masks_tta
from plastic_unet_tpu_torch.utils.torch_interop import load_pth


class MaskPredictor:
    """Batched mask predictor for UNetPRes. ``device=None`` means CUDA;
    it raises on a host without CUDA unless ``device="cpu"`` is passed."""

    def __init__(self, model: torch.nn.Module, *, chunk: int = 128, threshold: float | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.chunk = chunk
        self.threshold = threshold

    @classmethod
    def from_pth(cls, path: str, *, nbf: int = 101, neurons: int = 16, rule: str = "hebb",
                 key: str | None = None, device=None, **kw) -> "MaskPredictor":
        """Load a reference-format UNetPRes ``.pth``; ``key`` picks the
        state_dict inside a training checkpoint (e.g. ``"model"``)."""
        dev = resolve_device(device)
        model = UNetPRes(n_channels=1, n_classes=1, nbf=nbf, neurons=neurons, rule=rule)
        model.load_state_dict(load_pth(path, key), strict=True)
        return cls(model, device=dev, **kw)

    def warmup(self) -> "MaskPredictor":
        """Build the kernels and run one chunk ahead of the first request."""
        self.predict(np.zeros((1, self.model.nbf, self.model.nbf), np.float32))
        return self

    def predict_probs(self, images: np.ndarray) -> torch.Tensor:
        """(N, H, W) or (N, H, W, 1) float -> (N, nbf, nbf) sigmoid masks on the device."""
        x = np.asarray(images, np.float32)
        if x.ndim == 3:
            x = x[..., None]
        return predict_masks_tta(self.model, x, chunk=self.chunk, device=self.device)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Sigmoid masks as numpy, or boolean masks if a threshold is set."""
        preds = self.predict_probs(images)
        if self.threshold is not None:
            return binarize(preds, self.threshold).astype(bool)
        return preds.cpu().numpy()

    def predict_rle(self, images: np.ndarray, threshold: float | None = None) -> list[str]:
        """Predict and RLE-encode (submission-format strings). A predictor
        with a threshold binarizes at its own; ``threshold`` is then ignored,
        a reference quirk kept on purpose."""
        thr = self.threshold if threshold is None else threshold
        if thr is None:
            raise ValueError("predict_rle requires a threshold")
        # As the JAX predictor: with a threshold of its own, predict() has already
        # binarized at self.threshold and the argument is not read.
        if self.threshold is not None:
            return encode_batch(self.predict(images).astype(np.uint8))
        return encode_batch(binarize(self.predict_probs(images), thr))
