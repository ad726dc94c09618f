"""Image IO (a numpy copy of plastic_unet_tpu.data.images): the reference's
skimage loader (src/utils/img_utils.py:16-24) rebuilt on PIL, which is
imported inside the functions that need it.

skimage semantics being matched:
  * ``imread(as_grey=True)`` leaves single-channel images in their native
    integer range (8-bit -> 0..255, 16-bit -> 0..65535; the TGS masks are
    16-bit, hence the /65535 in data.dataset) and converts multichannel
    images with the ITU-R 601-2 luma transform to float [0, 1].
  * ``resize(..., mode='constant', preserve_range=True)`` keeps the value
    range; bilinear interpolation.
"""

from __future__ import annotations

import numpy as np

_LUMA = np.array([0.2125, 0.7154, 0.0721])  # skimage rgb2gray coefficients


def _resize_bilinear(img: np.ndarray, out_shape: tuple[int, int]) -> np.ndarray:
    """Bilinear resize (half-pixel centers, like skimage resize default)."""
    h_in, w_in = img.shape[:2]
    h_out, w_out = out_shape

    def axis_coords(n_in, n_out):
        return (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5

    ys = np.clip(axis_coords(h_in, h_out), 0, h_in - 1)
    xs = np.clip(axis_coords(w_in, w_out), 0, w_in - 1)
    y0 = np.clip(np.floor(ys).astype(int), 0, h_in - 1)
    y1 = np.clip(y0 + 1, 0, h_in - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w_in - 1)
    x1 = np.clip(x0 + 1, 0, w_in - 1)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[None, :]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + c * fy * (1 - fx) + d * fy * fx


def load_image(path: str, output_shape: tuple[int, int]) -> np.ndarray:
    """Load a PNG as grayscale float64, resized to output_shape if needed.
    Single-channel sources keep their native integer range; RGB sources are
    luma-converted to [0, 1]."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 3:
        rgb = arr[..., :3].astype(np.float64)
        maxv = 65535.0 if arr.dtype == np.uint16 else 255.0
        img = (rgb / maxv) @ _LUMA
    else:
        img = arr.astype(np.float64)
    if img.shape != tuple(output_shape):
        img = _resize_bilinear(img, tuple(output_shape))
    return img


def hwc_to_chw(img: np.ndarray) -> np.ndarray:
    """Transpose HWC -> CHW (reference img_utils.py:71-72)."""
    return np.transpose(img, axes=[2, 0, 1])


def chw_to_hwc(img: np.ndarray) -> np.ndarray:
    return np.transpose(img, axes=[1, 2, 0])


def save_mask_png(path: str, mask: np.ndarray) -> None:
    """Save a binary mask as an RGB PNG (the reference dumps np.dstack((m, m, m)))."""
    from PIL import Image

    m = (np.squeeze(mask) > 0).astype(np.uint8) * 255
    Image.fromarray(np.dstack((m, m, m))).save(path)
