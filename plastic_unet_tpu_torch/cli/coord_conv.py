"""CoordConv U-Net pipeline CLI (counterpart of plastic_unet_tpu.cli.coord_conv;
the reference's one-page Keras script, src/coord_conv_script.py:341-406).
The JAX parser's flags and defaults, plus ``--device`` (default CUDA;
``--device cpu`` runs on the CPU).

    python -m plastic_unet_tpu_torch.cli.coord_conv --data TGS_DIR --train --inference [--short-run] [--device cpu]

The model files are ``torch.save`` state_dicts (train.coord_trainer), at
the JAX CLI's paths: ``OUT/model-tgs-salt-6.ckpt`` (best val_loss),
``..._final`` and ``..._final_history.pickle``; the submission is
``OUT/submission-6.csv``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CoordConv U-Net train/predict (Keras-path capabilities)")
    # defaults from coord_conv_script.py:344-360
    p.add_argument("--data", dest="data_dir", type=str, required=True, help="dataset root (train/, test/)")
    p.add_argument("--im-size", default=128, type=int, help="resize target (128 in the reference)")
    p.add_argument("--model-file", default="model-tgs-salt-6.ckpt")
    p.add_argument("--with-r", action="store_true", default=False, help="add the radius coord channel")
    p.add_argument("--epochs", default=50000, type=int)
    p.add_argument("--max-train-time", default=7200, type=int)
    p.add_argument("--batch-size", default=8, type=int)
    p.add_argument("--train", dest="do_train", action="store_true", default=False)
    p.add_argument("--inference", dest="do_inference", action="store_true", default=False)
    p.add_argument("--short-run", action="store_true", default=False, help="truncate to 100 tiles (debug)")
    p.add_argument("--subm-file", default="submission-6.csv")
    p.add_argument("--out", dest="out_dir", default="./out")
    p.add_argument("--verbose", default=0, type=int)
    p.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs on the CPU)")
    return p


def _load_split(ids, path, im_size, with_masks: bool):
    """Green-channel images (the reference reads channel 1 of the RGB PNG)
    resized to im_size, in the uint8 range."""
    from plastic_unet_tpu_torch.data.images import load_image

    X = np.zeros((len(ids), im_size, im_size, 1), dtype=np.float32)
    Y = np.zeros((len(ids), im_size, im_size, 1), dtype=np.float32) if with_masks else None
    sizes = []
    for n, id_ in enumerate(ids):
        img = load_image(os.path.join(path, "images", id_), (im_size, im_size))
        sizes.append([101, 101])
        X[n, ..., 0] = img if img.max() > 1.5 else img * 255.0  # uint8 range (the model divides by 255)
        if with_masks:
            mask = load_image(os.path.join(path, "masks", id_), (im_size, im_size))
            Y[n, ..., 0] = (mask > mask.max() / 2).astype(np.float32) if mask.max() > 0 else 0.0
    return X, Y, sizes


def main(argv=None):
    args = build_parser().parse_args(argv)
    from plastic_unet_tpu_torch import resolve_device
    from plastic_unet_tpu_torch.train.coord_trainer import (construct_model, do_training, load_coord_model,
                                                            start_prediction)

    dev = resolve_device(args.device)
    path_train = os.path.join(args.data_dir, "train")
    path_test = os.path.join(args.data_dir, "test")
    train_ids = next(os.walk(os.path.join(path_train, "images")))[2]
    test_ids = next(os.walk(os.path.join(path_test, "images")))[2]
    if args.short_run:
        train_ids = train_ids[:100]
        test_ids = test_ids[:100]

    os.makedirs(args.out_dir, exist_ok=True)
    model_file = os.path.join(args.out_dir, args.model_file)
    subm = None

    if args.do_train:
        print("Start training")
        print("Getting and resizing train images and masks ... ", len(train_ids))
        sys.stdout.flush()
        X, Y, _ = _load_split(train_ids, path_train, args.im_size, with_masks=True)
        print("Done!")
        model = construct_model(args.im_size, args.im_size, 1, with_r=args.with_r)
        do_training(model, X, Y, epochs=args.epochs, max_train_time=args.max_train_time, model_file=model_file,
                    batch_size=args.batch_size, verbose=args.verbose, device=dev)

    if args.do_inference:
        print("Starting inference with model:", model_file)
        X, _, sizes = _load_split(test_ids, path_test, args.im_size, with_masks=False)
        model = load_coord_model(model_file + "_final", args.im_size, args.im_size, 1, with_r=args.with_r)
        predicted = start_prediction(model, X, sizes, verbose=args.verbose, device=dev)

        import pandas as pd

        from plastic_unet_tpu_torch.ops.rle import encode_batch

        rles = encode_batch(np.stack([np.round(p) for p in predicted]).astype(np.uint8))
        pred_dict = {fn[:-4]: rles[i] for i, fn in enumerate(test_ids)}
        sub = pd.DataFrame.from_dict(pred_dict, orient="index")
        sub.index.names = ["id"]
        sub.columns = ["rle_mask"]
        subm = os.path.join(args.out_dir, args.subm_file)
        sub.to_csv(subm)
        print("Submission written to:", subm)
    return subm


if __name__ == "__main__":
    main()
