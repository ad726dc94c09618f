"""Plots of training curves, data and masks (counterpart of
plastic_unet_tpu.viz.plots; reference src/utils/data_visualization.py,
keras_history_visualization.py and img_utils.py:74-100), with the JAX
functions' arguments, defaults, layouts, titles, labels and data:

  * render_data / moving_average: training curves from the checkpoint HDF5
    that train.checkpoint.save_reference_artifacts writes;
  * plot_best_iou / plot_coverage / plot_depth: the threshold curve and the
    EDA plots of data.dataset.load_train_dataset's frames;
  * plot_history: the pickled history of train.coord_trainer (Keras keys);
  * plot_train_check / plot_test_check / plot_image_mask: spot checks of
    tiles and masks (the first two draw their index from Python's global
    ``random``, as the reference does).

matplotlib, seaborn and h5py are imported inside the functions (the card's
host has none of them); the backend is Agg when no display is set.
``show=False`` returns the figure without ``plt.show()``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def _plt():
    import matplotlib

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def load_train_history(hdf5_file: str) -> dict:
    """Read the checkpoint HDF5 (the reference's schema, as
    train.checkpoint.save_reference_artifacts writes it)."""
    import h5py

    with h5py.File(hdf5_file, "r") as f:
        hist = {
            "all_losses": f["train/all_losses"][()],
            "val_train_losses": f["validation/train_losses"][()],
            "val_test_losses": f["validation/test_losses"][()],
            "val_accuracies": f["validation/accuracies"][()],
        }
        # plastic-head params are absent for vanilla (plastic=False) runs
        for key in ("w", "alpha", "eta"):
            if f"net/{key}" in f:
                hist[key] = f[f"net/{key}"][()]
        return hist


def moving_average(data, window_size: int):
    """Same-length moving average (reference data_visualization.py:127-135)."""
    window = np.ones(int(window_size)) / float(window_size)
    return np.convolve(data, window, "same")


def render_data(hdf5_file: str, runs_per_epoch: int, window_size: int = 1000, show: bool = True):
    """Training-curve dashboard (reference render_data,
    data_visualization.py:59-119): validation train/test loss + accuracy
    (twin axis) and the raw per-run loss with moving average."""
    plt = _plt()
    hist = load_train_history(hdf5_file)
    all_losses = hist["all_losses"]
    val_train = hist["val_train_losses"]

    n_runs = all_losses.shape[0]
    n_val_points = val_train.shape[0]
    print(
        "Total number of runs: %d, number of validation points: %d, runs per epoch: %d, window: %d"
        % (n_runs, n_val_points, runs_per_epoch, window_size)
    )

    ncols = int(n_val_points > 0) + int(n_runs > 0)
    fig, axes = plt.subplots(ncols=max(ncols, 1))
    if ncols == 1:
        axes = [axes]

    col = 0
    if n_val_points > 0:
        ax = axes[col]
        xs = np.arange(n_val_points)
        ax.plot(xs, val_train, "b", label="Train Loss")
        ax.plot(xs, hist["val_test_losses"], "g", label="Test Loss")
        ax.set_xlim([0, n_val_points])
        ax.set_ylabel("loss")
        ax.set_xlabel("epochs")
        ax.set_title("Validation Data")
        ax2 = ax.twinx()
        ax2.plot(xs, hist["val_accuracies"], "r", label="Accuracy")
        ax2.set_ylabel("accuracy")
        ax.legend(loc="upper left")
        col += 1

    if n_runs > 0:
        ax = axes[col]
        x = np.arange(n_runs)
        ax.plot(x, all_losses, "r", alpha=0.5)
        ax.plot(x, moving_average(all_losses, window_size), "r", label="Train Loss")
        ax.set_xlim(runs_per_epoch if runs_per_epoch > 0 else 0, n_runs)
        ax.set_xlabel("runs")
        ax.set_ylabel("loss")
        ax.set_title("Training Costs")

    plt.tight_layout()
    if show:
        plt.show()
    return fig


def plot_best_iou(thresholds, ious, show: bool = True):
    """Threshold-vs-IoU curve with the best point marked
    (reference data_visualization.py:13-28)."""
    plt = _plt()
    best = int(np.argmax(ious))
    fig = plt.figure()
    plt.plot(thresholds, ious)
    plt.plot(thresholds[best], ious[best], "xr", label="Best threshold")
    plt.xlabel("Threshold")
    plt.ylabel("IoU")
    plt.title("Threshold vs IoU ({}, {})".format(thresholds[best], ious[best]))
    plt.legend()
    if show:
        plt.show()
    return fig


def plot_coverage(train_df, show: bool = True):
    """Salt coverage distributions (reference data_visualization.py:30-43)."""
    plt = _plt()
    import seaborn as sns

    fig, axs = plt.subplots(1, 2, figsize=(15, 5))
    sns.histplot(train_df.coverage, kde=False, ax=axs[0])
    sns.histplot(train_df.coverage_class, bins=10, kde=False, ax=axs[1])
    plt.suptitle("Salt coverage")
    axs[0].set_xlabel("Coverage")
    axs[1].set_xlabel("Coverage class")
    if show:
        plt.show()
    return fig


def plot_depth(train_df, test_df, show: bool = True):
    """Depth distributions (reference data_visualization.py:45-57)."""
    plt = _plt()
    import seaborn as sns

    fig = plt.figure()
    sns.kdeplot(train_df.z, label="Train", fill=True)
    sns.kdeplot(test_df.z, label="Test", fill=True)
    plt.legend()
    plt.title("Depth distribution")
    if show:
        plt.show()
    return fig


def plot_history(hist_file: str, show: bool = True):
    """Keras-history plots: mean_iou/val_mean_iou and loss/val_loss
    (reference keras_history_visualization.py:8-41), or accuracy/val_accuracy
    where there is no mean_iou; train.coord_trainer pickles such a dict."""
    plt = _plt()
    with open(hist_file, "rb") as fo:
        history = pickle.load(fo)
    print(history.keys())

    fig, axes = plt.subplots(ncols=2)
    acc_key = "mean_iou" if "mean_iou" in history else "accuracy"
    axes[0].plot(history[acc_key])
    axes[0].plot(history["val_" + acc_key])
    axes[0].set_title("model accuracy")
    axes[0].set_ylabel("accuracy")
    axes[0].set_xlabel("epoch")
    axes[0].legend(["train", "test"], loc="upper left")

    axes[1].plot(history["loss"])
    axes[1].plot(history["val_loss"])
    axes[1].set_title("model loss")
    axes[1].set_ylabel("loss")
    axes[1].set_xlabel("epoch")
    axes[1].legend(["train", "test"], loc="upper left")

    plt.tight_layout()
    if show:
        plt.show()
    return fig


def plot_train_check(X_train, Y_train, show: bool = True):
    """Random sample+mask spot check (reference img_utils.py:74-84)."""
    plt = _plt()
    import random

    ix = random.randint(0, len(X_train) - 1)
    fig = plt.figure()
    a = fig.add_subplot(1, 2, 1)
    plt.imshow(np.squeeze(X_train[ix]))
    a.set_title("Image")
    a = fig.add_subplot(1, 2, 2)
    tmp = np.squeeze(Y_train[ix]).astype(np.float32)
    plt.imshow(np.dstack((tmp, tmp, tmp)))
    a.set_title("Mask")
    if show:
        plt.show()
    return fig


def plot_test_check(X_test, show: bool = True):
    """Random test image spot check (reference img_utils.py:86-89)."""
    plt = _plt()
    import random

    ix = random.randint(0, len(X_test) - 1)
    fig = plt.figure()
    plt.imshow(np.squeeze(X_test[ix]))
    if show:
        plt.show()
    return fig


def plot_image_mask(image, mask, show: bool = True):
    """Side-by-side image/mask (reference img_utils.py:91-100)."""
    plt = _plt()
    fig = plt.figure()
    a = fig.add_subplot(1, 2, 1)
    plt.imshow(image)
    a.set_title("Image")
    a = fig.add_subplot(1, 2, 2)
    tmp = np.squeeze(mask).astype(np.float32)
    plt.imshow(np.dstack((tmp, tmp, tmp)))
    a.set_title("Mask")
    if show:
        plt.show()
    return fig
