"""Reference-layout weights for the port (counterpart of
plastic_unet_tpu.utils.torch_interop).

The port's modules carry the reference's state_dict names (``w``, ``alpha``,
``eta``, ``conv1.dconv.0.weight``, ..., ``outc.conv.bias``), so a reference
``.pth`` loads with ``load_state_dict(strict=True)``. The JAX package's
params reach the port through :func:`state_dict_from_jax_params`, which
undoes the HWIO layout of its conv kernels:

  Conv2d          torch (O,I,kh,kw)  <- flax (kh,kw,I,O)
  ConvTranspose2d torch (I,O,kh,kw)  <- flax (kh,kw,O,I)  (transpose_kernel=True)

Both are the flax kernel transposed by the inverse of ``(2, 3, 1, 0)``.
The JAX int8 serving mode's ``quant`` collection (one ``amax`` beside each
quantized conv's kernel) reaches the port through :func:`quant_ranges_from_jax`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_KERNEL_PERM = (2, 3, 1, 0)  # torch layout -> flax layout, for Conv and ConvTranspose


def _conv_entry(flax_path: tuple, torch_prefix: str) -> dict:
    return {
        flax_path + ("kernel",): (torch_prefix + ".weight", _KERNEL_PERM),
        flax_path + ("bias",): (torch_prefix + ".bias", None),
    }


def _res_block(flax_path: tuple, torch_prefix: str) -> dict:
    """residual_block: conv.1 / conv.2 are conv_modules whose Conv2d is ``.conv``."""
    m = {}
    m.update(_conv_entry(flax_path + ("ConvModule_0", "Conv_0"), torch_prefix + ".conv.1.conv"))
    m.update(_conv_entry(flax_path + ("ConvModule_1", "Conv_0"), torch_prefix + ".conv.2.conv"))
    return m


def _down_or_middle(flax_path: tuple, torch_prefix: str, seq: str) -> dict:
    """down / middle: Sequential(Conv2d, residual_block, residual_block, ReLU)."""
    m = {}
    m.update(_conv_entry(flax_path + ("Conv_0",), f"{torch_prefix}.{seq}.0"))
    m.update(_res_block(flax_path + ("ResidualBlock_0",), f"{torch_prefix}.{seq}.1"))
    m.update(_res_block(flax_path + ("ResidualBlock_1",), f"{torch_prefix}.{seq}.2"))
    return m


def unetp_res_name_map() -> dict:
    """flax param path -> (torch state_dict key, flax transpose) for UNetPRes."""
    m = {
        ("w",): ("w", None),
        ("alpha",): ("alpha", None),
        ("eta",): ("eta", None),
    }
    for i in range(4):
        m.update(_down_or_middle((f"DownRes_{i}",), f"conv{i + 1}", "dconv"))
    m.update(_down_or_middle(("Middle_0",), "mid", "mconv"))
    for i, t in enumerate(["uconv4", "uconv3", "uconv2", "uconv1"]):
        m.update(_conv_entry((f"UpRes_{i}", "ConvTranspose_0"), f"{t}.dconv"))
        m.update(_down_or_middle((f"UpRes_{i}", "Middle_0"), f"{t}.uconv.1", "mconv"))
    m.update(_conv_entry(("Conv_0",), "outc.conv"))
    return m


def state_dict_from_jax_params(params: Mapping, name_map: dict | None = None) -> dict:
    """A torch state_dict from the JAX package's params tree (arrays of any
    kind numpy can read). ``name_map`` defaults to :func:`unetp_res_name_map`;
    the entries of a plastic=False model (no ``w``/``alpha``/``eta``) are
    skipped when the tree lacks them."""
    name_map = unetp_res_name_map() if name_map is None else name_map
    out = {}
    for flax_path, (torch_key, perm) in name_map.items():
        node = params
        try:
            for p in flax_path:
                node = node[p]
        except KeyError:
            if len(flax_path) == 1 and flax_path[0] in ("w", "alpha", "eta"):
                continue
            raise
        arr = np.asarray(node, dtype=np.float32)
        if perm is not None:
            arr = np.transpose(arr, np.argsort(perm))
        out[torch_key] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return out


def quant_ranges_from_jax(quant: Mapping, name_map: dict | None = None) -> dict:
    """The port's int8 ranges (``UNetPRes.load_quant_ranges``: torch module
    prefix -> 0-d float32 tensor) from the JAX ``variables["quant"]`` tree,
    whose ``amax`` sits at the path of each quantized conv's kernel. Names
    come from ``name_map`` (default :func:`unetp_res_name_map`); convs the
    tree has no range for (the 1x1 outconv) are skipped."""
    name_map = unetp_res_name_map() if name_map is None else name_map
    out = {}
    for flax_path, (torch_key, _) in name_map.items():
        if flax_path[-1] != "kernel":
            continue
        node = quant
        try:
            for p in flax_path[:-1] + ("amax",):
                node = node[p]
        except KeyError:
            continue
        out[torch_key[: -len(".weight")]] = torch.tensor(float(np.asarray(node, dtype=np.float32)),
                                                         dtype=torch.float32)
    return out


def trace_from_jax(hebb) -> torch.Tensor:
    """The JAX package's trace ``(B, nbf, nbf)`` (any array numpy can read)
    as a float32 tensor on the CPU, for a TrainState's ``hebb``."""
    arr = np.array(hebb, dtype=np.float32, copy=True, order="C")
    if arr.ndim != 3 or arr.shape[1] != arr.shape[2]:
        raise ValueError(f"trace_from_jax: the trace must be (B, nbf, nbf), got {arr.shape}")
    return torch.from_numpy(arr)


def load_pth(path: str, key: str | None = None) -> dict:
    """Read a reference ``.pth`` onto the CPU. ``key`` picks one entry of a
    training checkpoint (e.g. ``"model"``) instead of a bare state_dict."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj[key] if key is not None else obj
