"""Inference CLI (counterpart of plastic_unet_tpu.cli.infer; reference
src/infer.py:181-213): best threshold on the validation split (or a fixed
one), then the test tiles' masks as an RLE ``submission.csv``, with TTA
views (``--tta``), the PNG mask dump (``--save``) and int8 serving
(``--quant int8``: calibrated on the first ``--quant-calib`` validation
tiles; the threshold search and the test prediction then run on the int8
model). The JAX parser's flags plus ``--device`` (default CUDA).

    python -m plastic_unet_tpu_torch.cli.infer -m MODEL.pth -i TGS_DIR -o OUT [--tta tta4] [--save] \
        [--quant int8] [--device cpu]

``--trunk-pad`` must match how the model was trained. ``--devices N``
shards the test prediction's chunks over N ranks under torchrun
(``python -m torch.distributed.run --nproc-per-node N -m
plastic_unet_tpu_torch.cli.infer --devices N ...``; rank 0 writes).
``--visualize`` draws each test tile beside its mask (matplotlib; see
submit.inference.predict).
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Infer test masks and write the RLE submission")
    p.add_argument("--model", "-m", default="MODEL.pth", help="file in which the model is stored")
    p.add_argument("-i", "--data", dest="data_dir", type=str, help="the directory with input test data")
    p.add_argument("--out", "-o", dest="out_dir", default="./out", help="directory for output images")
    p.add_argument("-g", "--gpu", action="store_true", dest="gpu", default=False,
                   help="accepted for reference compatibility; the device is --device")
    p.add_argument("--visualize", "-v", action="store_true", default=False,
                   help="visualize the images as they are processed")
    p.add_argument("--save", "-s", action="store_true", default=False,
                   help="save the output masks as OUT/masks/<id>.png")
    p.add_argument("--mask-threshold", "-t", dest="mask_threshold", type=float,
                   help="accepted for reference compatibility; like the reference, the threshold "
                        "actually used comes from the best-IoU validation search (infer.py:156-171). "
                        "Use --fixed-threshold to bypass the search.")
    p.add_argument("--partial", "-p", action="store_true", default=False, help="run on a partial dataset")
    p.add_argument("--partial-size", "-d", dest="partial_size", default=100, type=int, help="partial dataset size")
    p.add_argument("--arch", default="unet_res", choices=["unet_res", "unet"],
                   help="model family (unet: the classic UNetP, 128-px geometry)")
    p.add_argument("--neurons", default=16, type=int)
    p.add_argument("--prule", default="hebb")
    p.add_argument("--tta", default="identity",
                   help="TTA views: preset tta2/tta4/tta8 or a comma list of identity,hflip,vflip,rot90,rot180,"
                        "rot270,transpose,anti_transpose. tta4 is the quality-safe preset for anisotropic "
                        "(seismic-like) data (QUALITY.md TTA study)")
    p.add_argument("--fixed-threshold", dest="fixed_threshold", type=float, default=None,
                   help="skip the validation threshold search and use this value")
    p.add_argument("--precision", default="perf",
                   help="precision policy of cuBLAS/cuDNN calls: perf (TF32 allowed) | parity (true fp32)")
    p.add_argument("--use-pallas", action="store_true", default=False,
                   help="accepted; the CUDA plastic head is the only path")
    p.add_argument("--trunk-pad", type=int, default=0, metavar="SIZE",
                   help="padded trunk (must match how the model was trained; 0 = off)")
    p.add_argument("--devices", type=int, default=1,
                   help="devices to shard inference over, one rank each (launch with torchrun --nproc-per-node N)")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8 serving: calibrate activation ranges on validation images, then run the conv "
                        "trunk as int8 convs with int32 accumulation; the threshold search runs on the "
                        "quantized model (see submit/quant.py)")
    p.add_argument("--quant-calib", dest="quant_calib", type=int, default=256,
                   help="number of validation images used for int8 calibration")
    p.add_argument("--device", default=None, help="torch device (default: cuda; 'cpu' runs the plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.devices <= 1:
        return _infer(args, args.device, None)
    import torch.distributed as dist

    from plastic_unet_tpu_torch.parallel.mesh import init_distributed, make_mesh

    dev = init_distributed(args.device)  # raises, naming torchrun, outside its environment
    try:
        return _infer(args, dev, make_mesh(args.devices, device=dev))
    finally:
        dist.destroy_process_group()


def _infer(args, device, mesh):
    os.makedirs(args.out_dir, exist_ok=True)

    from plastic_unet_tpu_torch.ops.augment import parse_tta

    tta = parse_tta(args.tta)
    t_img_width, t_img_height, t_img_chan = 101, 101, 1

    if args.data_dir is None:
        raise ValueError("The input data directory or dataset file not specified")

    from plastic_unet_tpu_torch.data.dataset import load_test_dataset, load_train_dataset

    print("Getting and resizing test images... ")
    ids, images = load_test_dataset(data_dir=args.data_dir, img_width=t_img_width, img_height=t_img_height,
                                    img_chan=t_img_chan, partial=args.partial, part_size=args.partial_size)
    x_train, x_valid, y_train, y_valid = load_train_dataset(
        data_dir=args.data_dir, img_width=t_img_width, img_height=t_img_height, img_chan=t_img_chan, debug=True
    )
    if args.partial:
        x_valid = x_valid[: args.partial_size]
        y_valid = y_valid[: args.partial_size]
    print("Done!")

    from plastic_unet_tpu_torch.cli.eval import load_model
    from plastic_unet_tpu_torch.config import TrainConfig
    from plastic_unet_tpu_torch.submit.inference import predict, start_inference
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    cfg = TrainConfig(arch=args.arch, neurons=args.neurons, prule=args.prule, im_width=t_img_width,
                      im_height=t_img_height, im_chan=t_img_chan, use_pallas=args.use_pallas,
                      trunk_pad=args.trunk_pad)
    with matmul_precision(args.precision):
        model = load_model(args.model, cfg, device)
        if args.quant == "int8":
            import numpy as np

            from plastic_unet_tpu_torch.submit.quant import quantize_for_serving

            xv_nhwc = np.transpose(np.asarray(x_valid, dtype=np.float32), (0, 2, 3, 1))
            n_cal = max(1, min(args.quant_calib, len(xv_nhwc)))
            print("Calibrating int8 serving on %d validation images" % n_cal)
            model = quantize_for_serving(model, xv_nhwc[:n_cal], device=device)
        if args.fixed_threshold is not None:
            run_params = {
                "out_dir": args.out_dir,
                "img_width": t_img_width,
                "img_height": t_img_height,
                "img_chan": t_img_chan,
                "mask_threshold": args.fixed_threshold,
                "subm_file": "submission.csv",
            }
            return predict(model, ids, images, run_params, visualize=args.visualize, save_masks=args.save, tta=tta,
                           device=device, mesh=mesh)
        return start_inference(model, ids, images, x_valid, y_valid, out_dir=args.out_dir, img_width=t_img_width,
                               img_height=t_img_height, img_chan=t_img_chan, visualize=args.visualize,
                               save_masks=args.save, tta=tta, debug=True, device=device, mesh=mesh)


if __name__ == "__main__":
    main()
