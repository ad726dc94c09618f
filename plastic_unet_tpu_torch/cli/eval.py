"""Evaluation CLI (counterpart of plastic_unet_tpu.cli.eval; reference
src/eval.py:106-124): load a model, find the best threshold and IoU on the
validation split. The JAX parser's flags plus ``--device`` (default CUDA).

    python -m plastic_unet_tpu_torch.cli.eval -m MODEL.pth -i TGS_DIR [--device cpu]
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Score the model and find the best IoU threshold")
    p.add_argument("--model", "-m", default="MODEL.pth", help="file in which the model is stored (default: 'MODEL.pth')")
    p.add_argument("-i", "--data", dest="data_dir", type=str, help="the directory with input test data")
    p.add_argument("-g", "--gpu", action="store_true", dest="gpu", default=False,
                   help="accepted for reference compatibility; the device is --device")
    p.add_argument("-v", "--debug", action="store_true", dest="debug", default=False, help="show debug information")
    p.add_argument("--arch", default="unet_res", choices=["unet_res", "unet"],
                   help="model family (unet: the classic UNetP, 128-px geometry)")
    p.add_argument("--neurons", default=16, type=int)
    p.add_argument("--prule", default="hebb")
    p.add_argument("--precision", default="perf",
                   help="precision policy of cuBLAS/cuDNN calls: perf (TF32 allowed) | parity (true fp32)")
    p.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p


def load_model(path: str, cfg, device=None):
    """The configured model (train.driver.build_model) with the weights of a reference-format .pth, on ``device``."""
    from plastic_unet_tpu_torch import resolve_device
    from plastic_unet_tpu_torch.train.driver import build_model, load_reference_weights

    dev = resolve_device(device)
    model = build_model(cfg)
    print("Loading model %s" % path)
    load_reference_weights(model, path, cfg)
    return model.to(dev)


def main(argv=None):
    args = build_parser().parse_args(argv)
    img_width = img_height = 101
    img_chan = 1

    import numpy as np

    from plastic_unet_tpu_torch.config import TrainConfig
    from plastic_unet_tpu_torch.data.dataset import load_train_dataset
    from plastic_unet_tpu_torch.eval.evaluate import score_model_best_iou
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    cfg = TrainConfig(arch=args.arch, neurons=args.neurons, prule=args.prule,
                      im_width=img_width, im_height=img_height, im_chan=img_chan)

    with matmul_precision(args.precision):
        model = load_model(args.model, cfg, args.device)

        print("Loading data set")
        x_train, x_valid, y_train, y_valid = load_train_dataset(
            data_dir=args.data_dir, img_width=img_width, img_height=img_height,
            img_chan=img_chan, debug=args.debug,
        )
        print("Calculating best thershold value")
        xv = np.transpose(np.asarray(x_valid, np.float32), (0, 2, 3, 1))
        threshold_best, iou_best = score_model_best_iou(model, xv, y_valid, debug=args.debug, device=args.device)
        print("Best thershold:", threshold_best)
        print("Best IoU", iou_best)
        return threshold_best, iou_best


if __name__ == "__main__":
    main()
