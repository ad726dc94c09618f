"""Training CLI (counterpart of plastic_unet_tpu.cli.train): the JAX
parser's flags, names, short forms and defaults (reference
src/train.py:316-358), plus ``--device``.

    python -m plastic_unet_tpu_torch.cli.train -o OUT (-d TGS_DIR | -i DATASET.hdf5 | --synthetic N) [...]

``--device`` defaults to CUDA and raises on a host without it; ``--device
cpu`` runs the plain PyTorch versions on the CPU. ``--devices N`` trains
data parallel on N ranks, one process each, under torchrun (NCCL on CUDA,
Gloo with ``--device cpu``; ``--trace-mode`` picks the trace's coherence):

    python -m torch.distributed.run --nproc-per-node N -m plastic_unet_tpu_torch.cli.train --devices N [...]

``--trunk-pad``,
``--remat-trunk`` and ``--compute-dtype bfloat16`` (the bf16 trunk) reach
the model; ``--precision`` (perf by default, as in the JAX CLI: TF32 for
cuDNN and cuBLAS; parity: true fp32) reaches the training step and the
validation; ``--fast-dw``, ``--patch-conv``, ``--use-pallas``,
``--pallas-trunk`` and ``--rng-impl`` are accepted and change nothing. A
flag for an option the port does not have yet raises
(train.driver.build_model).
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the plastic U-Net (PyTorch/CUDA port)")
    # reference flags (names/defaults from train.py:316-358)
    p.add_argument("-e", "--epochs", dest="epochs", default=5, type=int, help="number of epochs")
    p.add_argument("-l", "--learning-rate", dest="lr", default=3e-5, type=float, help="learning rate")
    p.add_argument("-s", "--step-lr", dest="steplr", default=1e6, type=float, help="the learning rate annealing step")
    p.add_argument("-g", "--gpu", action="store_true", dest="gpu", default=False,
                   help="accepted for reference compatibility; the device is --device")
    p.add_argument("--prule", "-p", default="hebb", help="the plastic rule to use when training")
    p.add_argument("-c", "--load", dest="load", default=False, action="store_true", help="load file model")
    p.add_argument("--model", "-m", default="MODEL.pth", help="file in which the model is stored")
    p.add_argument("--max-train-time", dest="max_train_time", default=-1, type=int,
                   help="max training time limit in seconds [-1 = no limit]")
    p.add_argument("--save_every", dest="save_every", default=100, type=int, help="save results per # epochs")
    p.add_argument("--validate_every", dest="validate_every", default=50, type=int, help="validate per # epochs")
    p.add_argument("--rollout_every", dest="rollout_every", default=50000, type=int, help="rollout filenames per # epochs")
    p.add_argument("-d", "--data", dest="data_dir", type=str, help="the directory with input data")
    p.add_argument("-i", "--dataset", dest="dataset_file", type=str, help="path to an HDF5 dataset file")
    p.add_argument("-o", "--out", dest="out_dir", type=str, required=True, help="output directory")
    p.add_argument("-v", "--debug", action="store_true", dest="debug", default=False, help="show debug information")
    # extensions of the JAX package (those the port lacks raise)
    p.add_argument("--arch", default="unet_res", choices=["unet_res", "unet"],
                   help="model family (unet: the classic UNetP, 128-px geometry)")
    p.add_argument("--neurons", default=16, type=int, help="first-layer width (tuned script uses 8)")
    p.add_argument("--dropout", default=0.5, type=float, help="dropout ratio")
    p.add_argument("--alfa-type", default="free", choices=["free", "yoked"])
    p.add_argument("--lanes", default=1, type=int, help="parallel lifetime streams (1 = reference semantics)")
    p.add_argument("--devices", default=1, type=int,
                   help="data-parallel devices, one rank each (launch with torchrun --nproc-per-node N)")
    p.add_argument("--trace-mode", default="per_device", choices=["per_device", "pmean"],
                   help="hebb-trace coherence across data-parallel devices")
    p.add_argument("--precision", default="perf", help="precision policy of cuBLAS/cuDNN calls: perf (TF32 allowed) | parity "
                   "(true fp32); the CUDA kernels are plain fp32 under either")
    p.add_argument("--use-pallas", action="store_true", default=False,
                   help="accepted; the CUDA plastic head is the only path")
    p.add_argument("--pallas-trunk", action="store_true", default=False,
                   help="accepted; the CUDA residual tails are the only path")
    p.add_argument("--fast-dw", action="store_true", default=False,
                   help="accepted; a TPU lowering of the same conv (the CUDA kernels are the only path)")
    p.add_argument("--patch-conv", type=int, default=0, metavar="MAX_C",
                   help="accepted; a TPU lowering of the same conv (the CUDA kernels are the only path)")
    p.add_argument("--remat-trunk", action="store_true", default=False,
                   help="checkpoint the 9 trunk blocks: the backward recomputes their activations "
                        "(the same bits, less memory)")
    p.add_argument("--trunk-pad", type=int, default=0, metavar="SIZE",
                   help="pad inputs to SIZExSIZE (e.g. 128) and crop the logits back (0 = off)")
    p.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="trunk compute dtype (head/loss stay fp32)")
    p.add_argument("--epochs-per-dispatch", type=int, default=1, metavar="K",
                   help="fold up to K epochs into one dispatch (1 = the reference's cadence; bit-identical either way)")
    p.add_argument("--augment", action="store_true", default=False, help="random flip/rotate augmentation")
    p.add_argument("--shuffle", action="store_true", default=False, help="per-epoch stream shuffle")
    p.add_argument("--no-plastic", action="store_true", default=False,
                   help="vanilla U-Net head (sigmoid on trunk logits, no plasticity)")
    p.add_argument("--rng-impl", default="threefry", choices=["threefry", "rbg", "unsafe_rbg"],
                   help="accepted; the port draws from torch generators whichever is named")
    p.add_argument("--loss-space", default="logits", choices=["logits", "probs"])
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--synthetic", default=0, type=int, metavar="N",
                   help="train on N synthetic tiles instead of --data (smoke runs)")
    p.add_argument("--resume", dest="resume_state", default="", metavar="PATH",
                   help="resume exactly from a resume-state file (<out>/train_state.pt of an earlier run)")
    p.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p


def load_training_data(args, size: int = 101):
    """(x_train, x_valid, y_train, y_valid), NCHW, from --dataset, --synthetic or --data."""
    if args.dataset_file:
        import numpy as np

        from plastic_unet_tpu_torch.data.dataset import cov_to_class, train_test_split
        from plastic_unet_tpu_torch.data.hdf5_io import load_hdf5_data_set

        imgs, masks = load_hdf5_data_set(args.dataset_file)
        x = imgs[..., :1].transpose(0, 3, 1, 2).astype(np.float32)
        y = masks.transpose(0, 3, 1, 2).astype(np.float32)
        strata = [cov_to_class(c) for c in y.mean(axis=(1, 2, 3))]
        return tuple(train_test_split(x, y, test_size=0.2, stratify=strata, random_state=42))
    if args.synthetic:
        from plastic_unet_tpu_torch.data.synthetic import synthetic_split

        n_val = max(args.synthetic // 5, 1)
        return synthetic_split(args.synthetic - n_val, n_val, size=size)
    if args.data_dir is not None:
        print("Getting train images and masks from data directory %s" % args.data_dir)
        sys.stdout.flush()
        from plastic_unet_tpu_torch.data.dataset import load_train_dataset

        out = load_train_dataset(data_dir=args.data_dir, img_width=size, img_height=size, img_chan=1,
                                 debug=args.debug)
        print("Done!")
        return out
    raise ValueError("The input data directory or dataset file not specified")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.devices <= 1:
        return _train(args, args.device)
    import torch.distributed as dist

    from plastic_unet_tpu_torch.parallel.mesh import init_distributed

    dev = init_distributed(args.device)  # raises, naming torchrun, outside its environment
    try:
        return _train(args, dev)
    finally:
        dist.destroy_process_group()


def _train(args, device):
    os.makedirs(args.out_dir, exist_ok=True)
    print(args)

    x_train, x_valid, y_train, y_valid = load_training_data(args)
    size = x_train.shape[-1]

    from plastic_unet_tpu_torch.config import TrainConfig
    from plastic_unet_tpu_torch.train.driver import start_train

    cfg = TrainConfig(
        out_dir=args.out_dir,
        epochs=args.epochs,
        lr=args.lr,
        steplr=args.steplr,
        max_train_time=args.max_train_time,
        save_every=args.save_every,
        val_every=args.validate_every,
        rollout=args.rollout_every,
        prule=args.prule,
        debug=args.debug,
        load=bool(args.load),
        model_path=args.model,
        im_width=size,
        im_height=x_train.shape[-2],
        im_chan=1,
        arch=args.arch,
        neurons=args.neurons,
        dropout_ratio=args.dropout,
        alfa_type=args.alfa_type,
        lanes=args.lanes,
        devices=args.devices,
        trace_mode=args.trace_mode,
        loss_space=args.loss_space,
        matmul_precision=args.precision,
        use_pallas=args.use_pallas,
        pallas_trunk=args.pallas_trunk,
        fast_dw=args.fast_dw,
        remat_trunk=args.remat_trunk,
        patch_conv=args.patch_conv,
        trunk_pad=args.trunk_pad,
        compute_dtype=args.compute_dtype,
        epochs_per_dispatch=args.epochs_per_dispatch,
        augment=args.augment,
        shuffle=args.shuffle,
        plastic=not args.no_plastic,
        rng_impl=args.rng_impl,
        seed=args.seed,
        resume_orbax=args.resume_state,
    )
    return start_train(x_train, x_valid, y_train, y_valid, cfg, device=device)


if __name__ == "__main__":
    main()
