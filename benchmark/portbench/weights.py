"""The models of a cell: the weights made from the seed, once, on the device,
in the published state_dict layout, and the port's model and the plain
reference built from them.

All that is particular to an architecture is in its file,
``reference/<arch>.py`` (see ``reference/__init__.py``): the reference, the
port's model class, the model's initial state and the weights' rule.
"""

from __future__ import annotations

import functools
import importlib

import torch
from torch import nn

from portbench import spec
from portbench.tiles import make_generator

WEIGHT_STREAM = 1


@functools.cache
def arch_file(arch: str):
    """The module ``reference/<arch>.py`` of this benchmark."""
    path = spec.BENCH_DIR / "reference" / f"{arch}.py"
    if not path.is_file():
        raise FileNotFoundError(f"arch {arch!r} has no reference: {path} is missing")
    return spec.load_file(path, "portbench_arch_" + arch.replace(".", "_").replace("-", "_"))


def reference_class(arch: str):
    return arch_file(arch).Reference


def port_class(arch: str):
    """The port's model class that the arch file names, imported."""
    module, _, name = arch_file(arch).PORT.partition(":")
    return getattr(importlib.import_module(module), name)


def build_reference(config: dict, state_dict: dict, device) -> nn.Module:
    """The plain reference of ``config`` on ``device``, holding ``state_dict``."""
    ref = reference_class(config["arch"])(**config["model"]).to(device)
    ref.load_state_dict(state_dict, strict=True)
    return ref


def make_state_dict(config: dict, seed: int, device) -> dict:
    """{key: tensor} in the published layout, on ``device``, from ``seed``."""
    arch = arch_file(config["arch"])
    with torch.device("meta"):
        shell = arch.Reference(**config["model"])
    sd = arch.init_weights(shell, make_generator(seed, WEIGHT_STREAM, device))
    missing = set(shell.state_dict()) - set(sd)
    if missing:
        raise KeyError(f"weights: no rule for {sorted(missing)}")
    return sd


def build_port_model(config: dict, state_dict: dict, device) -> nn.Module:
    """The port's model of ``config`` on ``device``, holding ``state_dict``.
    The constructor's own draws (on the host) are overwritten; it is built
    on the host because under the meta device its initialisation takes
    seconds."""
    model = port_class(config["arch"])(**config["model"]).to(device)
    model.load_state_dict(state_dict, strict=True)
    return model
