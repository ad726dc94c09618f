"""Serving artifacts through ``torch.export`` (counterpart of
plastic_unet_tpu.submit.export, which serializes StableHLO with
``jax.export``).

:func:`export_predictor` traces the zero-trace serving forward once and
writes a directory:

  forward.<platform>.pt2   one ``torch.export.save`` program per platform
                           ("cpu", "cuda")
  meta.json                the JAX artifact's manifest keys

The exported function is the serving step of eval.evaluate.predict_masks
for one static chunk (default 128): the zero trace, the dihedral TTA views
folded into the batch of one forward (ops.augment.tta_batched_apply; tta8
at chunk 128 is a forward of 1024 samples), and an optional baked threshold
(uint8 masks from the float64-exact compare of
submit.inference.threshold_as_f32). The parameters and the int8 model's
activation ranges (its non-persistent ``amax`` buffers) are part of the
program. The port's models carry their parameters, so the JAX function's
``params`` argument is gone.

One program per platform: the forward makes device tensors (the zero trace,
on the input's device) that the trace records with their device, and a
program's constants stay where they were traced. So each requested platform
is traced on its own device, and the loader runs the program of the device
it is given.

The serving forward's kernels (the plastic head and the residual tail: one
launch of the fused tail kernel or four ``conv3x3`` launches, by the tail's
``tail_plan``) reach the program as the
custom ops of ops.export_ops: a program calls them by name, so the loader
needs ``torch``, numpy and this package, whose import registers them, while
the JAX artifact needs only jax. A loaded CUDA program launches the same
kernels, and counts on the same counters, as the eager path.

APIs used (torch 2.11 on the card's host, 2.13 here): ``torch.export.export``
(non-strict) on a module in eval mode under ``torch.no_grad()``,
``torch.export.save`` / ``torch.export.load`` (the ``.pt2`` archive),
``torch.library.custom_op`` with ``register_fake``, and
``torch.compiler.is_exporting()``. A program is loaded by the torch that
made it; another version may refuse the archive.

Not ported (each raises and names its ROADMAP.md queue item): sharded
export (``data_devices > 1``, A6), bfloat16 graphs (A4d), the classic
``unet`` architecture (A5).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Sequence

import numpy as np
import torch
from torch import nn

from plastic_unet_tpu_torch import resolve_device
from plastic_unet_tpu_torch.ops import export_ops  # noqa: F401 -- registers the ops a program calls
from plastic_unet_tpu_torch.ops.augment import TTA_TRANSFORMS, tta_batched_apply
from plastic_unet_tpu_torch.ops.rle import encode_batch
from plastic_unet_tpu_torch.submit.inference import threshold_as_f32
from plastic_unet_tpu_torch.utils.precision import serving_numerics

ARTIFACT_META = "meta.json"
JAX_ARTIFACT = "forward.jaxexp"
FORMAT_VERSION = 1
PLATFORMS = ("cpu", "cuda")


def program_file(platform: str) -> str:
    return f"forward.{platform}.pt2"


def check_supported(*, arch: str = "unet_res", compute_dtype=None, data_devices: int = 1) -> None:
    """Raise for what the port does not export yet, naming its queue item."""
    if data_devices < 1:
        raise ValueError(f"data_devices must be >= 1, got {data_devices}")
    if data_devices > 1:
        raise ValueError(f"data_devices={data_devices}: sharded export is not ported "
                         "(ROADMAP.md, queue A item A6)")
    if compute_dtype not in (None, torch.float32, "float32"):
        raise ValueError(f"compute_dtype={compute_dtype!r}: the port exports fp32 only "
                         "(ROADMAP.md, queue A item A4d)")
    if arch != "unet_res":
        raise ValueError(f"arch={arch!r}: the port has UNetPRes only (ROADMAP.md, queue A item A5)")


class _ServingForward(nn.Module):
    """(chunk, H, W, C) f32 -> (chunk, nbf, nbf) sigmoid masks, or uint8
    masks when a threshold is baked: what the program computes."""

    def __init__(self, model: nn.Module, transforms: tuple, threshold: float | None):
        super().__init__()
        self.model = model
        self.transforms = transforms
        self.t32 = None if threshold is None else float(threshold_as_f32(float(threshold)))

    def _masks(self, x: torch.Tensor) -> torch.Tensor:
        return self.model(x, self.model.initial_zero_hebb(x.shape[0], device=x.device)).activout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transforms == ("identity",):
            pred = self._masks(x)
        else:
            pred = tta_batched_apply(self._masks, x, self.transforms)
        if self.t32 is not None:
            return (pred > self.t32).to(torch.uint8)
        return pred


def export_predictor(model: nn.Module, path: str, *, chunk: int = 128, tta: Sequence[str] = ("identity",),
                     threshold: float | None = None, platforms: Sequence[str] = PLATFORMS,
                     data_devices: int = 1) -> str:
    """Write the serving forward of ``model`` (a UNetPRes, fp32 or the int8
    model of submit.quant.quantize_for_serving) as an artifact directory at
    ``path``; returns ``path``.

    chunk: the static batch of the program (the loader pads partial chunks).
    tta: dihedral view names (ops.augment.TTA_TRANSFORMS) folded into the
    batch. threshold: if set, the program emits uint8 masks ``p > t`` with
    the float64-exact compare. platforms: "cpu" and/or "cuda", one program
    each; "cuda" needs a CUDA device here (it raises without one).
    data_devices: 1 (sharded export is not ported)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    check_supported(data_devices=data_devices)
    transforms = tuple(tta)
    unknown = [t for t in transforms if t not in TTA_TRANSFORMS]
    if unknown or not transforms:
        raise ValueError(f"unknown TTA view(s) {unknown or transforms}; valid: {sorted(TTA_TRANSFORMS)}")
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f"platforms must be among {PLATFORMS}, got {platforms}")
    if model.quant not in ("", "int8"):
        raise ValueError(f"quant={model.quant!r}: export an fp32 or a calibrated int8 model")
    devices = [resolve_device(p) for p in platforms]  # "cuda" raises here when CUDA is absent
    h = w = model.nbf
    os.makedirs(path, exist_ok=True)
    for platform, dev in zip(platforms, devices):
        fwd = _ServingForward(copy.deepcopy(model).to(dev).eval(), transforms, threshold).eval()
        example = torch.zeros((chunk, h, w, model.n_channels), device=dev)
        with torch.no_grad():
            program = torch.export.export(fwd, (example,))
        torch.export.save(program, os.path.join(path, program_file(platform)))
    meta = {
        "format_version": FORMAT_VERSION,
        "chunk": int(chunk),
        "height": int(h),
        "width": int(w),
        "channels": int(model.n_channels),
        "tta": list(transforms),
        "threshold": None if threshold is None else float(threshold),
        "output_dtype": "uint8" if threshold is not None else "float32",
        "platforms": list(platforms),
        "data_devices": int(data_devices),
        "model": type(model).__name__,
        "compute_dtype": "float32",
        "rule": model.rule,
        "neurons": int(model.neurons),
        "nbf": int(model.nbf),
    }
    with open(os.path.join(path, ARTIFACT_META), "w") as f:
        json.dump(meta, f, indent=1)
    return path


class ExportedPredictor:
    """A loaded artifact: chunked mask prediction on one device.

    As eval.evaluate.predict_masks: pads the batch to a multiple of the
    chunk, runs the program chunk by chunk, drops the padding. Each chunk's
    masks go back to the host as soon as it is done (device memory stays
    O(chunk)), with one chunk in flight: the host issues chunk i+1 (its
    copy in, the program, its copy out, all asynchronous from pinned
    memory) before it waits for chunk i, so the card is not idle while the
    host issues."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program = program
        self.meta = meta
        self.chunk = int(meta["chunk"])
        self.threshold = meta.get("threshold")
        self.device = device
        self._call = program.module()

    def warmup(self) -> "ExportedPredictor":
        """Build the kernels and run one chunk ahead of the first request."""
        m = self.meta
        self.predict(np.zeros((1, m["height"], m["width"], m["channels"]), np.float32))
        return self

    def predict(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W) or (N, H, W, C) float -> (N, nbf, nbf) sigmoid
        masks (float32), or binary masks (uint8) for thresholded artifacts."""
        x = np.asarray(images, np.float32)
        if x.ndim == 3:
            x = x[..., None]
        expect = (self.meta["height"], self.meta["width"], self.meta["channels"])
        if x.ndim != 4 or x.shape[1:] != expect:
            raise ValueError(f"expected (N, {expect[0]}, {expect[1]}, {expect[2]}) images, got {x.shape}")
        n = x.shape[0]
        pad = (-n) % self.chunk
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], np.float32)], axis=0)
        cuda = self.device.type == "cuda"
        outs, issued = [], None
        with torch.inference_mode(), serving_numerics():
            for i in range(0, x.shape[0], self.chunk):
                # A fresh host tensor with the strides the program was traced with (models.blocks.dense_strides),
                # pinned so that neither copy makes the host wait for the card.
                c = torch.empty((self.chunk,) + x.shape[1:], pin_memory=cuda).copy_(torch.from_numpy(x[i:i + self.chunk]))
                outs.append(self._call(c.to(self.device, non_blocking=True)).to("cpu", non_blocking=True))
                if cuda:
                    if issued is not None:
                        issued.synchronize()  # the chunk before this one is back on the host
                    issued = torch.cuda.Event()
                    issued.record()
            if issued is not None:
                issued.synchronize()
        outs = [o.numpy() for o in outs]
        return np.concatenate(outs, axis=0)[:n]

    def predict_rle(self, images: np.ndarray, threshold: float | None = None) -> list:
        """Predict and RLE-encode (submission-format strings). Thresholded
        artifacts emit binary masks already; probability artifacts binarize
        at ``threshold``, else at the manifest's threshold."""
        preds = self.predict(images)
        if preds.dtype == np.uint8:
            return encode_batch(preds)
        thr = self.threshold if threshold is None else threshold
        if thr is None:
            raise ValueError("predict_rle requires a threshold")
        return encode_batch((preds > threshold_as_f32(float(thr))).astype(np.uint8))


def load_predictor(path: str, device=None) -> ExportedPredictor:
    """Load an :func:`export_predictor` artifact directory onto ``device``
    (None means CUDA, and raises without it unless ``device="cpu"``). Raises
    when the artifact has no program for that device, for another
    ``format_version``, and for a JAX artifact (``forward.jaxexp``)."""
    programs = [p for p in PLATFORMS if os.path.exists(os.path.join(path, program_file(p)))]
    if not programs and os.path.exists(os.path.join(path, JAX_ARTIFACT)):
        raise ValueError(f"{path} is a JAX artifact ({JAX_ARTIFACT}): load it with "
                         "plastic_unet_tpu.submit.export.load_predictor")
    if not os.path.exists(os.path.join(path, ARTIFACT_META)):
        raise ValueError(f"{path}: no {ARTIFACT_META}; not a serving artifact of export_predictor")
    with open(os.path.join(path, ARTIFACT_META)) as f:
        meta = json.load(f)
    if meta.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"unsupported artifact format_version {meta.get('format_version')!r}")
    dev = resolve_device(device)
    if dev.type not in programs:
        raise ValueError(f"{path} has no program for {dev.type} (it has {programs}); "
                         f"export it with platforms including {dev.type!r}")
    program = torch.export.load(os.path.join(path, program_file(dev.type)))
    return ExportedPredictor(program, meta, dev)
