"""Run-length encoding for Kaggle TGS-Salt submissions (counterpart of
plastic_unet_tpu.ops.rle), numpy only: column-major (Fortran) order,
1-based starts, ``"start len start len ..."`` strings. The JAX package's
native C++ batch encoder has no counterpart here yet.
"""

from __future__ import annotations

import numpy as np


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
    """Encode a batch of binary masks ``(N, H, W)``."""
    return [encode(m) for m in np.asarray(masks)]
