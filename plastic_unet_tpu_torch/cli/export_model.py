"""Serving-artifact export CLI (counterpart of plastic_unet_tpu.cli.export_model).

Writes a reference-format ``.pth``'s serving forward (zero trace, eval mode,
TTA views folded into the batch, an optional baked threshold) as a
``torch.export`` artifact directory (submit.export): one ``.pt2`` program per
platform and a ``meta.json``. The JAX parser's flags; ``--platforms``
defaults to ``cpu,cuda`` (``cuda`` needs a CUDA device where it runs).

    python -m plastic_unet_tpu_torch.cli.export_model -m out/train_net.pth -o out/artifact --tta tta4 \\
        --threshold 0.5 [--platforms cpu]

Serve it:

    python -m plastic_unet_tpu_torch.submit.http_server --artifact out/artifact [--device cpu]

``--arch unet`` exports the classic UNetP (``--nbf 128``; ``--neurons``
is not read). ``--data-devices N`` writes the per-rank program of a
``chunk / N`` batch, served by N ranks under torchrun (submit.export).
``--compute-dtype bfloat16`` exports UNetPRes's mixed-precision forward (the
trunk in bf16, the head in fp32); UNetP refuses it before any work
(MaskPredictor.from_pth, as in the JAX CLI).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Export a serving artifact (torch.export programs)")
    p.add_argument("--model", "-m", required=True, help=".pth checkpoint (reference format)")
    p.add_argument("--out", "-o", required=True, help="output artifact directory")
    p.add_argument("--arch", default="unet_res", choices=("unet_res", "unet"),
                   help="model family (unet: the classic UNetP, 128-px geometry)")
    p.add_argument("--nbf", default=101, type=int)
    p.add_argument("--neurons", default=16, type=int)
    p.add_argument("--prule", default="hebb", choices=("hebb", "oja"))
    p.add_argument("--tta", default="identity", help="preset tta2/tta4/tta8 or comma list of dihedral views")
    p.add_argument("--threshold", type=float, default=None,
                   help="bake a binarization threshold (the artifact emits uint8 masks)")
    p.add_argument("--chunk", default=128, type=int, help="static serving batch size")
    p.add_argument("--platforms", default="cpu,cuda", help="comma list of cpu, cuda: one program each")
    p.add_argument("--compute-dtype", default="float32", choices=("float32", "bfloat16"),
                   help="trunk compute dtype of the exported graph (head stays fp32; unet_res only)")
    p.add_argument("--data-devices", default=1, type=int, metavar="N",
                   help="export the per-rank program of a chunk/N batch, served by N ranks (torchrun)")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)

    from plastic_unet_tpu_torch.ops.augment import parse_tta
    from plastic_unet_tpu_torch.submit.export import check_supported, export_predictor
    from plastic_unet_tpu_torch.submit.server import MaskPredictor

    check_supported(arch=args.arch, data_devices=args.data_devices, chunk=args.chunk)
    pred = MaskPredictor.from_pth(args.model, arch=args.arch, nbf=args.nbf, neurons=args.neurons, rule=args.prule,
                                  compute_dtype=args.compute_dtype, device="cpu")
    path = export_predictor(pred.model, args.out, chunk=args.chunk, tta=parse_tta(args.tta),
                            threshold=args.threshold, data_devices=args.data_devices,
                            platforms=tuple(s.strip() for s in args.platforms.split(",") if s.strip()))
    print("Exported serving artifact to:", path)
    return path


if __name__ == "__main__":
    main()
