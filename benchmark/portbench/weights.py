"""The models of a cell: the weights made from the seed, once, on the device,
in the published state_dict layout, and the port's model and the plain
reference built from them.

Initialisation is torch's default for the published modules: every conv and
transposed conv weight and bias uniform in (-1/sqrt(fan_in), 1/sqrt(fan_in))
with fan_in = weight.shape[1] * kh * kw; the head's w = 0.01 * N(0, 1),
alpha = 0.01 * U(0, 1), eta = 0.01. Two draws make all of it.
"""

from __future__ import annotations

import importlib
import math

import torch
from torch import nn

from portbench.tiles import make_generator

WEIGHT_STREAM = 1
REFERENCES = {"unet_res": ("reference.unet_res", "UNetPRes"), "unet": ("reference.unet_classic", "UNetP")}


def reference_class(arch: str):
    mod, cls = REFERENCES[arch]
    return getattr(importlib.import_module(mod), cls)


def build_reference(config: dict, state_dict: dict, device) -> nn.Module:
    """The plain reference of ``config`` on ``device``, holding ``state_dict``."""
    ref = reference_class(config["arch"])(**config["model"]).to(device)
    ref.load_state_dict(state_dict, strict=True)
    return ref


def make_state_dict(config: dict, seed: int, device) -> dict:
    """{key: tensor} in the published layout, on ``device``, from ``seed``."""
    with torch.device("meta"):
        shell = reference_class(config["arch"])(**config["model"])
    conv_keys, bounds, counts = [], [], []
    for prefix, m in shell.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            bound = 1.0 / math.sqrt(w.shape[1] * w.shape[2] * w.shape[3])
            for leaf in ("weight", "bias"):
                p = getattr(m, leaf)
                conv_keys.append((f"{prefix}.{leaf}", tuple(p.shape)))
                bounds.append(bound)
                counts.append(p.numel())
    nbf = shell.nbf
    g = make_generator(seed, WEIGHT_STREAM, device)
    u = torch.rand(sum(counts) + nbf * nbf, generator=g, device=device)
    scale = torch.repeat_interleave(torch.tensor(bounds, device=device), torch.tensor(counts, device=device))
    conv_vals = (2 * u[: sum(counts)] - 1) * scale
    sd = {key: part.view(shape) for (key, shape), part in zip(conv_keys, torch.split(conv_vals, counts))}
    sd["alpha"] = (0.01 * u[sum(counts):]).view(nbf, nbf)
    sd["w"] = 0.01 * torch.randn((nbf, nbf), generator=g, device=device)
    sd["eta"] = torch.full((1,), 0.01, device=device)
    missing = set(shell.state_dict()) - set(sd)
    if missing:
        raise KeyError(f"weights: no rule for {sorted(missing)}")
    return sd


def build_port_model(config: dict, state_dict: dict, device) -> nn.Module:
    """The port's model of ``config`` on ``device``, holding ``state_dict``.
    The constructor's own draws (on the host) are overwritten; it is built
    on the host because under the meta device its initialisation takes
    seconds."""
    if config["arch"] == "unet_res":
        from plastic_unet_tpu_torch.models.unet_res import UNetPRes as cls
    elif config["arch"] == "unet":
        from plastic_unet_tpu_torch.models.unet_classic import UNetP as cls
    else:
        raise ValueError(f"unknown arch {config['arch']!r}")
    model = cls(**config["model"]).to(device)
    model.load_state_dict(state_dict, strict=True)
    return model
