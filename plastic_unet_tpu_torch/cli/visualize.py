"""Training-data visualization CLI (counterpart of plastic_unet_tpu.cli.visualize;
reference src/utils/data_visualization.py:137-157): the training curves of
the checkpoint HDF5 that cli.train writes (viz.plots.render_data). Needs
h5py and matplotlib.

    python -m plastic_unet_tpu_torch.cli.visualize -f OUT/train_data.hdf5 -r 3200 [-w 100]
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visualize collected train data points from HDF5")
    p.add_argument("--data-file", "-f", default="train_data.hdf5", help="the path to the data file")
    p.add_argument("--runs-per-epoch", "-r", type=int, default=-1, help="runs per epoch (train samples count)")
    p.add_argument("--avg-window-size", "-w", default=1, type=int, help="the window size for moving average")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from plastic_unet_tpu_torch.viz.plots import render_data

    render_data(hdf5_file=args.data_file, runs_per_epoch=args.runs_per_epoch, window_size=args.avg_window_size)


if __name__ == "__main__":
    main()
