"""Offline HDF5 dataset build (counterpart of plastic_unet_tpu.data.hdf5_io;
reference create_hdf5_data_set, src/utils/img_utils.py:26-69): walk
train/images and train/masks, resize to (H, W, C) and write gzip/shuffle/
fletcher32 datasets 'train/images' and 'train/masks'; ``show_check_plot``
draws viz.plots.plot_train_check of the loaded arrays first. h5py (and
matplotlib for the plot) is imported inside the functions.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from plastic_unet_tpu_torch.data.images import load_image

H5_OPTS = dict(compression="gzip", shuffle=True, fletcher32=True)


def create_hdf5_data_set(data_dir: str, out_file: str = "dataset.hdf5", im_width: int = 128, im_height: int = 128,
                         im_chan: int = 3, show_check_plot: bool = False) -> str:
    import h5py

    print("Getting and resizing train images and masks ... ")
    sys.stdout.flush()

    train_ids = next(os.walk(os.path.join(data_dir, "train/images")))[2]
    X = np.zeros((len(train_ids), im_height, im_width, im_chan), dtype=np.float64)
    Y = np.zeros((len(train_ids), im_height, im_width, 1), dtype=bool)
    for n, id_ in enumerate(train_ids):
        img = load_image(f"{data_dir}/train/images/{id_}", (im_height, im_width))
        X[n] = np.repeat(img[..., None], im_chan, axis=-1)
        mask = load_image(f"{data_dir}/train/masks/{id_}", (im_height, im_width))
        Y[n, ..., 0] = mask > 0
    print("Done!")

    if show_check_plot:
        from plastic_unet_tpu_torch.viz.plots import plot_train_check

        plot_train_check(X, Y)

    out_path = os.path.join(data_dir, out_file)
    print("Creation of HDF5 dataset file at: %s" % out_path)
    with h5py.File(out_path, "w") as f:
        f.create_dataset("train/images", data=X, **H5_OPTS)
        f.create_dataset("train/masks", data=Y, **H5_OPTS)
        f.flush()
    print("Done!")
    return out_path


def load_hdf5_data_set(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        return f["train/images"][()], f["train/masks"][()]
