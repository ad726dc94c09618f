"""History-plot CLI (counterpart of plastic_unet_tpu.cli.keras_history;
reference src/utils/keras_history_visualization.py:43-57): accuracy and
loss curves of a pickled history, such as the ``*_final_history.pickle``
that cli.coord_conv writes (viz.plots.plot_history). Needs matplotlib.

    python -m plastic_unet_tpu_torch.cli.keras_history -f model_history.pickle
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visualize a pickled training history")
    p.add_argument("--data-file", "-f", required=True, help="the path to the data file")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from plastic_unet_tpu_torch.viz.plots import plot_history

    plot_history(hist_file=args.data_file)


if __name__ == "__main__":
    main()
