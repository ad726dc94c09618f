"""One-command tuned run (counterpart of plastic_unet_tpu.cli.tuned_run;
the reference's one-page script src/unet_p_res_script.py, whose config
block :1036-1062 is the most tuned configuration: start_neurons=8,
epochs=250, lr=3e-4, step_lr=1e4, rule=hebb, max_train_time=5h), then the
threshold search, inference and ``submission.csv``. The JAX parser's flags
plus ``--device`` (default CUDA).

    python -m plastic_unet_tpu_torch.cli.tuned_run (--data TGS_DIR | --synthetic N) [--out OUT] [--device cpu]
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="End-to-end tuned plastic U-Net run (train + infer + submission)")
    p.add_argument("--data", dest="data_dir", type=str, help="dataset root; omit with --synthetic")
    p.add_argument("--out", dest="out_dir", default="./out")
    # tuned config defaults (unet_p_res_script.py:1036-1062)
    p.add_argument("--epochs", default=250, type=int)
    p.add_argument("--learning-rate", dest="lr", default=3e-4, type=float)
    p.add_argument("--step-lr", dest="steplr", default=1e4, type=float)
    p.add_argument("--max-train-time", default=5 * 3600, type=int)
    p.add_argument("--prule", default="hebb")
    p.add_argument("--neurons", default=8, type=int)  # start_neurons=8 (:30)
    p.add_argument("--validate_every", default=5, type=int)
    p.add_argument("--save_every", default=25, type=int)
    p.add_argument("--short-run", action="store_true", default=False,
                   help="truncate to 100 train tiles (unet_p_res_script.py:1061-1079 debug mode)")
    p.add_argument("--synthetic", default=0, type=int, metavar="N", help="use N synthetic tiles")
    p.add_argument("--lanes", default=1, type=int)
    p.add_argument("--epochs-per-dispatch", type=int, default=None, metavar="K",
                   help="fold up to K epochs per dispatch (default: val_every with --short-run, else 1; "
                        "bit-identical either way)")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="trunk compute dtype (head/loss stay fp32)")
    p.add_argument("--tta", default="identity",
                   help="TTA views for inference: preset tta2/tta4/tta8 or a comma list (see cli.infer)")
    p.add_argument("--debug", action="store_true", default=True)
    p.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    w = h = 101

    if args.synthetic:
        from plastic_unet_tpu_torch.data.synthetic import synthetic_split, synthetic_tiles

        n_val = max(args.synthetic // 5, 1)
        x_train, x_valid, y_train, y_valid = synthetic_split(args.synthetic - n_val, n_val, size=w)
        timgs, _ = synthetic_tiles(max(args.synthetic // 2, 1), size=w, seed=99)
        ids, images = [f"syn{i}" for i in range(len(timgs))], timgs[:, 0]
    else:
        from plastic_unet_tpu_torch.data.dataset import load_test_dataset, load_train_dataset

        x_train, x_valid, y_train, y_valid = load_train_dataset(args.data_dir, w, h, 1)
        if args.short_run:
            x_train, y_train = x_train[:100], y_train[:100]
        ids, images = load_test_dataset(args.data_dir, w, h, 1, partial=args.short_run, part_size=100)

    from plastic_unet_tpu_torch.config import TrainConfig
    from plastic_unet_tpu_torch.ops.augment import parse_tta
    from plastic_unet_tpu_torch.submit.inference import start_inference
    from plastic_unet_tpu_torch.train.driver import start_train

    tta = parse_tta(args.tta)
    cfg = TrainConfig(
        out_dir=args.out_dir,
        epochs=args.epochs,
        lr=args.lr,
        steplr=args.steplr,
        max_train_time=args.max_train_time,
        val_every=args.validate_every,
        save_every=args.save_every,
        prule=args.prule,
        neurons=args.neurons,
        im_width=w,
        im_height=h,
        im_chan=1,
        debug=args.debug,
        lanes=args.lanes,
        compute_dtype=args.compute_dtype,
        epochs_per_dispatch=(
            args.epochs_per_dispatch
            if args.epochs_per_dispatch is not None
            else (args.validate_every if args.short_run else 1)
        ),
    )
    result = start_train(x_train, x_valid, y_train, y_valid, cfg, device=args.device)
    return start_inference(result.model, ids, images, x_valid, y_valid, out_dir=args.out_dir, img_width=w,
                           img_height=h, img_chan=1, tta=tta, device=args.device)


if __name__ == "__main__":
    main()
