"""Dataset-build CLI (counterpart of plastic_unet_tpu.cli.build_dataset;
reference img_utils CLI, src/utils/img_utils.py:102-121): the resized
train images and masks of a TGS directory as ``<dir>/dataset.hdf5``
(data.hdf5_io.create_hdf5_data_set). Needs h5py, and matplotlib for
``--check-plot``.

    python -m plastic_unet_tpu_torch.cli.build_dataset --data TGS_DIR [--check-plot]
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Build the resized-image HDF5 dataset")
    p.add_argument("--action", dest="action", default="create_dataset", type=str, help="the action to be performed")
    p.add_argument("-i", "--data", dest="data_dir", type=str, required=True, help="the directory with input data")
    p.add_argument("--check-plot", action="store_true", default=False,
                   help="show the random sample/mask spot-check plot (blocking, as in the reference)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.action == "create_dataset":
        from plastic_unet_tpu_torch.data.hdf5_io import create_hdf5_data_set

        return create_hdf5_data_set(data_dir=args.data_dir, show_check_plot=args.check_plot)
    raise ValueError("Usuported action requested: %s" % args.action)


if __name__ == "__main__":
    main()
