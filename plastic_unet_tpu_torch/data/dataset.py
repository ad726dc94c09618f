"""TGS-Salt dataset loading with the reference's split (counterpart of
plastic_unet_tpu.data.dataset; reference src/utils/data_set.py), without
sklearn.

  * train: train.csv's ids in file order (the ``csv`` module), the
    grayscale PNGs resized to (H, W), masks divided by 65535 (16-bit), salt
    coverage -> decile class, and the stratified 80/20 split of sklearn's
    ``train_test_split(random_state=42)`` rebuilt in numpy
    (:func:`train_test_split`), index for index -> NCHW float arrays.
  * test: the tile ids of test/images in ``os.walk`` order, optionally
    truncated, and their images.
  * the EDA frames (``return_frames``) and, with ``debug``, the coverage and
    depth plots (viz.plots): pandas DataFrames joined with depths.csv, as
    the JAX loader builds them; pandas is imported only for them.

PNGs load through the native threaded loader (ops.native) where the library
loaded, else through PIL (data.images.load_image), one file at a time.
"""

from __future__ import annotations

import csv
import math
import os

import numpy as np

from plastic_unet_tpu_torch.data.images import load_image
from plastic_unet_tpu_torch.ops import native


def cov_to_class(val: float) -> int:
    """Salt-coverage decile class (reference data_set.py:13-16)."""
    for i in range(0, 11):
        if val * 10 <= i:
            return i


def read_train_index(data_dir: str) -> list[str]:
    """train.csv's ids in file order."""
    with open(os.path.join(data_dir, "train.csv"), newline="") as f:
        return [row[0] for row in list(csv.reader(f))[1:] if row]


def _load_batch(paths: list[str], h: int, w: int) -> np.ndarray:
    """Grayscale PNGs (N, h, w) float64: the native loader where the library
    loaded, else PIL (ops.native's fallback rule)."""
    if native.load() is None:
        return np.stack([load_image(p, (h, w)) for p in paths])
    return native.load_png_gray_batch_native(paths, h, w)


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng: np.random.RandomState) -> np.ndarray:
    """Draws per class that sum to n_draws: the floor of each class's share,
    then one more for the largest remainders, ties broken by rng (the
    draw sklearn's stratified split makes)."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        for value in np.sort(np.unique(remainder))[::-1]:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            floored[rng.choice(inds, size=add_now, replace=False)] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def stratified_split_indices(n_samples: int, stratify, test_size: float = 0.2, random_state: int = 42):
    """(train, test) index arrays of sklearn's ``train_test_split(...,
    test_size, stratify, random_state)`` for ``n_samples`` rows, a 1-D
    sequence of class labels ``stratify`` and a fraction ``test_size``: the
    same sizes (n_test = ceil(test_size * n)),
    the same draws from ``RandomState(random_state)`` in the same order, the
    same errors."""
    if not 0 < test_size < 1:  # a fraction (sklearn also takes a count; no caller here does)
        raise ValueError(f"test_size={test_size} should be either positive and smaller than the number of "
                         f"samples {n_samples} or a float in the (0, 1) range")
    n_test = math.ceil(test_size * n_samples)
    n_train = n_samples - n_test
    if n_train == 0:
        raise ValueError(f"With n_samples={n_samples}, test_size={test_size} and train_size=None, the resulting "
                         "train set will be empty. Adjust any of the aforementioned parameters.")
    y = np.asarray(stratify)
    if y.shape[0] != n_samples:
        raise ValueError(f"Found input variables with inconsistent numbers of samples: [{n_samples}, {y.shape[0]}]")
    classes, y_indices, class_counts = np.unique(y, return_inverse=True, return_counts=True)
    if np.min(class_counts) < 2:
        raise ValueError("The least populated classes in y have only 1 member, which is too few. The minimum "
                         "number of groups for any class cannot be less than 2. Classes with too few members are: "
                         f"{classes[class_counts < 2].tolist()}")
    n_classes = classes.shape[0]
    if n_train < n_classes:
        raise ValueError(f"The train_size = {n_train} should be greater or equal to the number of classes = {n_classes}")
    if n_test < n_classes:
        raise ValueError(f"The test_size = {n_test} should be greater or equal to the number of classes = {n_classes}")
    class_indices = np.split(np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(random_state)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(n_classes):
        members = class_indices[i].take(rng.permutation(class_counts[i]), mode="clip")
        train.extend(members[: n_i[i]])
        test.extend(members[n_i[i] : n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def train_test_split(*arrays, test_size: float = 0.2, stratify=None, random_state: int = 42) -> list:
    """[a_train, a_test for each array], split as sklearn's stratified
    ``train_test_split`` splits them."""
    if stratify is None:
        raise ValueError("train_test_split: only the stratified split is ported; pass stratify=")
    train, test = stratified_split_indices(len(arrays[0]), stratify, test_size, random_state)
    return [part for a in arrays for part in (a[train], a[test])]


def load_train_dataset(data_dir: str, img_width: int, img_height: int, img_chan: int, val_ratio: float = 0.2,
                       debug: bool = False, return_frames: bool = False, show_plots: bool = True):
    """Load and split the train set: (x_train, x_valid, y_train, y_valid),
    NCHW float arrays; with ``return_frames=True`` also (train_df, test_df),
    the EDA frames of the JAX loader (:func:`eda_frames`).

    ``debug=True`` prints the reference's mask spot-check (data_set.py:51,
    positional row 10) and draws viz.plots.plot_coverage and plot_depth
    (``show=show_plots``). Where matplotlib, seaborn or pandas is not
    installed (the card's host) the plots are not drawn and a line says
    so: ``debug`` is the CLIs' spot check, not a request for figures."""
    ids = read_train_index(data_dir)
    images = _load_batch([f"{data_dir}/train/images/{idx}.png" for idx in ids], img_height, img_width)
    masks = _load_batch([f"{data_dir}/train/masks/{idx}.png" for idx in ids], img_height, img_width) / 65535
    coverage = masks.sum(axis=(1, 2)) / (img_height * img_width)
    strata = [cov_to_class(c) for c in coverage]
    if debug and len(ids) > 10:
        print(masks[10])
    plot = debug and _can_plot()
    if debug and not plot:
        print("matplotlib, seaborn or pandas is not installed: the coverage and depth plots were not drawn")
    frames = eda_frames(data_dir, masks, coverage, strata) if return_frames or plot else None
    if plot:
        from plastic_unet_tpu_torch.viz.plots import plot_coverage, plot_depth

        plot_coverage(frames[0], show=show_plots)
        plot_depth(*frames, show=show_plots)
    x = np.array(images).reshape(-1, img_chan, img_height, img_width)
    y = np.array(masks).reshape(-1, 1, img_height, img_width)
    split = tuple(train_test_split(x, y, test_size=val_ratio, stratify=strata, random_state=42))
    return split + frames if return_frames else split


def _can_plot() -> bool:
    try:
        import matplotlib  # noqa: F401
        import pandas  # noqa: F401
        import seaborn  # noqa: F401
    except ImportError:
        return False
    return True


def eda_frames(data_dir: str, masks: np.ndarray, coverage: np.ndarray, strata: list) -> tuple:
    """(train_df, test_df) as the JAX loader builds them (data_set.py:37-48):
    train.csv's ids (index ``id``) joined with depths.csv (``z``), then the
    ``masks``, ``coverage`` and ``coverage_class`` columns; test_df is the
    depths rows whose ids are not in train.csv."""
    import pandas as pd

    train_df = pd.read_csv(os.path.join(data_dir, "train.csv"), index_col="id", usecols=[0])
    depths_df = pd.read_csv(os.path.join(data_dir, "depths.csv"), index_col="id")
    train_df = train_df.join(depths_df)
    test_df = depths_df[~depths_df.index.isin(train_df.index)]
    train_df["masks"] = list(masks)
    train_df["coverage"] = coverage
    train_df["coverage_class"] = strata
    return train_df, test_df


def load_test_dataset(data_dir: str, img_width: int, img_height: int, img_chan: int, partial: bool = False,
                      part_size: int = 100, debug: bool = False):
    """The test set as ``(ids, images)``: the tile ids in ``os.walk`` order
    (truncated to ``part_size`` when ``partial``) and their images
    (N, img_height, img_width), the pair ``submit.inference.start_inference``
    takes."""
    ids = [name[:-4] for name in next(os.walk(os.path.join(data_dir, "test/images")))[2]]
    if partial:
        ids = ids[:part_size]
    if not ids:
        return ids, np.zeros((0, img_height, img_width))
    return ids, _load_batch([f"{data_dir}/test/images/{idx}.png" for idx in ids], img_height, img_width)
