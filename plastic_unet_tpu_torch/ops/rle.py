"""Run-length encoding for Kaggle TGS-Salt submissions (counterpart of
plastic_unet_tpu.ops.rle): column-major (Fortran) order,
1-based starts, ``"start len start len ..."`` strings. :func:`encode_batch`
takes the native C++ batch encoder (ops.native) where the library loaded.
"""

from __future__ import annotations

import numpy as np

from plastic_unet_tpu_torch.ops import native


def encode(im: np.ndarray) -> str:
    """RLE-encode one binary mask as a submission string."""
    pixels = np.asarray(im).flatten(order="F")
    pixels = np.concatenate([[0], pixels, [0]])
    runs = np.where(pixels[1:] != pixels[:-1])[0] + 1
    runs[1::2] -= runs[::2]
    return " ".join(str(x) for x in runs)


def rle_decode(rle: str, shape: tuple[int, int]) -> np.ndarray:
    """Inverse of :func:`encode`."""
    mask = np.zeros(shape[0] * shape[1], dtype=np.uint8)
    if rle:
        vals = np.array(rle.split(), dtype=np.int64)
        for s, n in zip(vals[0::2] - 1, vals[1::2]):
            mask[s : s + n] = 1
    return mask.reshape(shape, order="F")


def encode_batch(masks: np.ndarray) -> list[str]:
    """Encode a batch of binary masks ``(N, H, W)``: the native threaded
    encoder where the library loaded, else :func:`encode` per mask
    (ops.native's fallback rule)."""
    masks = np.asarray(masks)
    if native.load() is None:
        return [encode(m) for m in masks]
    return native.rle_encode_batch_native(masks)
