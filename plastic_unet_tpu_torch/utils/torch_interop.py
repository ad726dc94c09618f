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

A ``batch_norm`` model's BN (flax ``.../BatchNorm_0``: ``scale`` and
``bias`` in ``params``, ``mean`` and ``var`` in ``batch_stats``) maps to
``bn.weight``, ``bn.bias``, ``bn.running_mean`` and ``bn.running_var``
beside what each BN follows: ``<block>.bn`` after a residual block's
leading ReLU, ``<block>.conv.<i>.bn`` after its conv ``<block>.conv.<i>.conv``
(:func:`unetp_res_name_map` with ``batch_norm=True``,
:func:`unetp_res_batch_stats_map`). No reference-format ``.pth`` with BN
exists, so the names are BatchNorm2d's; a BN-free ``.pth`` loads strictly
as before.

The classic UNetP (:func:`unetp_name_map`, the JAX map's entries) has the
reference's keys (``inc.conv.conv.0``, ``down1.mpconv.1.conv.0``,
``up1.up``, ``outc.conv``); with ``batch_norm`` its DoubleConv is the
reference's Sequential with BN (``conv.0``, BN ``conv.1``, ``conv.3``, BN
``conv.4``), the JAX ``DoubleConv_*/BatchNorm_0|1`` beside each conv
(:func:`unetp_batch_stats_map` for the statistics). The CoordConv U-Net
(:func:`coord_conv_name_map`) maps the flax tree's ``Conv_i`` and
``ConvTranspose_j`` to ``convs.i`` and ``upconvs.j``; a flax
ConvTranspose with SAME padding does not flip its kernel and torch's does,
so those four kernels are carried flipped (:data:`FLIPPED_CONVT`).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_KERNEL_PERM = (2, 3, 1, 0)  # torch layout -> flax layout, for Conv and ConvTranspose
# flax ConvTranspose(padding="SAME", transpose_kernel=False) kernel (kh, kw, in, out) <- torch (in, out, kh, kw)
# transposed by (2, 3, 0, 1) and flipped in kh and kw
FLIPPED_CONVT = "flipped_convT"


def _conv_entry(flax_path: tuple, torch_prefix: str) -> dict:
    return {
        flax_path + ("kernel",): (torch_prefix + ".weight", _KERNEL_PERM),
        flax_path + ("bias",): (torch_prefix + ".bias", None),
    }


# flax BatchNorm variable -> BatchNorm2d-style key, for params and for batch_stats
_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _bn_paths(flax_path: tuple, torch_prefix: str) -> list:
    """(flax path of a BatchNorm_0, torch prefix of its ``bn``) of one residual block's three BNs."""
    return [(flax_path + ("BatchNorm_0",), torch_prefix + ".bn")] + [
        (flax_path + (f"ConvModule_{i}", "BatchNorm_0"), f"{torch_prefix}.conv.{i + 1}.bn") for i in range(2)]


def _res_block(flax_path: tuple, torch_prefix: str, batch_norm: bool = False) -> dict:
    """residual_block: conv.1 / conv.2 are conv_modules whose Conv2d is ``.conv``."""
    m = {}
    m.update(_conv_entry(flax_path + ("ConvModule_0", "Conv_0"), torch_prefix + ".conv.1.conv"))
    m.update(_conv_entry(flax_path + ("ConvModule_1", "Conv_0"), torch_prefix + ".conv.2.conv"))
    if batch_norm:
        for bn_path, bn_prefix in _bn_paths(flax_path, torch_prefix):
            m.update({bn_path + (f,): (f"{bn_prefix}.{t}", None) for f, t in _BN_PARAMS.items()})
    return m


def _trunks() -> list:
    """(flax path, torch prefix, Sequential name, has BN when the model does) of the 9 trunks."""
    out = [((f"DownRes_{i}",), f"conv{i + 1}", "dconv", True) for i in range(4)]
    out.append((("Middle_0",), "mid", "mconv", True))
    out += [((f"UpRes_{i}", "Middle_0"), f"{t}.uconv.1", "mconv", False)  # UpRes's middle never has BN
            for i, t in enumerate(["uconv4", "uconv3", "uconv2", "uconv1"])]
    return out


def _down_or_middle(flax_path: tuple, torch_prefix: str, seq: str, batch_norm: bool = False) -> dict:
    """down / middle: Sequential(Conv2d, residual_block, residual_block, ReLU)."""
    m = {}
    m.update(_conv_entry(flax_path + ("Conv_0",), f"{torch_prefix}.{seq}.0"))
    m.update(_res_block(flax_path + ("ResidualBlock_0",), f"{torch_prefix}.{seq}.1", batch_norm))
    m.update(_res_block(flax_path + ("ResidualBlock_1",), f"{torch_prefix}.{seq}.2", batch_norm))
    return m


def unetp_res_name_map(batch_norm: bool = False) -> dict:
    """flax param path -> (torch state_dict key, flax transpose) for UNetPRes;
    ``batch_norm`` adds the BN scales and biases (the module docstring)."""
    m = {
        ("w",): ("w", None),
        ("alpha",): ("alpha", None),
        ("eta",): ("eta", None),
    }
    for i, (path, prefix, seq, bn) in enumerate(_trunks()):
        if i >= 5:  # UpRes: its ConvTranspose, then its middle
            m.update(_conv_entry((path[0], "ConvTranspose_0"), prefix[: -len(".uconv.1")] + ".dconv"))
        m.update(_down_or_middle(path, prefix, seq, batch_norm and bn))
    m.update(_conv_entry(("Conv_0",), "outc.conv"))
    return m


def unetp_res_batch_stats_map() -> dict:
    """flax batch_stats path (``.../BatchNorm_0/mean`` and ``var``) -> torch
    buffer key (``....bn.running_mean`` and ``running_var``) for UNetPRes
    with ``batch_norm``."""
    m = {}
    for path, prefix, seq, bn in _trunks():
        if bn:
            for blk in range(2):
                for bn_path, bn_prefix in _bn_paths(path + (f"ResidualBlock_{blk}",), f"{prefix}.{seq}.{blk + 1}"):
                    m.update({bn_path + (f,): f"{bn_prefix}.{t}" for f, t in _BN_STATS.items()})
    return m


def _double_conv(flax_path: tuple, torch_prefix: str, batch_norm: bool = False) -> dict:
    """double_conv: the reference's Sequential, Conv2d at 0 and 2, or with BN at 0 and 3 (BN at 1 and 4)."""
    m = {}
    for i, idx in enumerate((0, 3) if batch_norm else (0, 2)):
        m.update(_conv_entry(flax_path + (f"Conv_{i}",), f"{torch_prefix}.{idx}"))
        if batch_norm:
            m.update({flax_path + (f"BatchNorm_{i}", f): (f"{torch_prefix}.{idx + 1}.{t}", None)
                      for f, t in _BN_PARAMS.items()})
    return m


def _double_convs(bilinear_upsample: bool = False) -> list:
    """(flax path, torch prefix of the Sequential) of UNetP's 9 DoubleConvs, and its 4 ConvTransposes."""
    dcs = [(("DoubleConv_0",), "inc.conv.conv")]
    dcs += [((f"DoubleConv_{i + 1}",), f"down{i + 1}.mpconv.1.conv") for i in range(4)]
    dcs += [((f"UpClassic_{i}", "DoubleConv_0"), f"up{i + 1}.conv.conv") for i in range(4)]
    ups = [] if bilinear_upsample else [((f"UpClassic_{i}", "ConvTranspose_0"), f"up{i + 1}.up") for i in range(4)]
    return dcs, ups


def unetp_name_map(bilinear_upsample: bool = False, batch_norm: bool = False) -> dict:
    """flax param path -> (torch key, flax transpose) for UNetP (the JAX
    map's entries); ``batch_norm`` adds the BN scales and biases (the module
    docstring)."""
    m = {
        ("w",): ("w", None),
        ("alpha",): ("alpha", None),
        ("eta",): ("eta", None),
    }
    dcs, ups = _double_convs(bilinear_upsample)
    for path, prefix in dcs[:5]:
        m.update(_double_conv(path, prefix, batch_norm))
    for i, (path, prefix) in enumerate(dcs[5:]):
        if ups:  # each UpClassic: its ConvTranspose, then its DoubleConv
            m.update(_conv_entry(*ups[i]))
        m.update(_double_conv(path, prefix, batch_norm))
    m.update(_conv_entry(("Conv_0",), "outc.conv"))
    return m


def unetp_batch_stats_map() -> dict:
    """flax batch_stats path -> torch buffer key for UNetP with ``batch_norm``."""
    m = {}
    for path, prefix in _double_convs()[0]:
        for i, idx in enumerate((1, 4)):
            m.update({path + (f"BatchNorm_{i}", f): f"{prefix}.{idx}.{t}" for f, t in _BN_STATS.items()})
    return m


def coord_conv_name_map() -> dict:
    """flax param path -> (torch key, flax transpose) for the CoordConv
    U-Net: ``Conv_i`` -> ``convs.i``, ``ConvTranspose_j`` -> ``upconvs.j``
    (kernel flipped, :data:`FLIPPED_CONVT`)."""
    m = {}
    for i in range(20):
        m.update(_conv_entry((f"Conv_{i}",), f"convs.{i}"))
    for j in range(4):
        m.update({(f"ConvTranspose_{j}", "kernel"): (f"upconvs.{j}.weight", FLIPPED_CONVT),
                  (f"ConvTranspose_{j}", "bias"): (f"upconvs.{j}.bias", None)})
    return m


def state_dict_from_jax_params(params: Mapping, name_map: dict | None = None,
                               batch_stats: Mapping | None = None, stats_map: dict | None = None) -> dict:
    """A torch state_dict from the JAX package's params tree (arrays of any
    kind numpy can read). ``name_map`` defaults to :func:`unetp_res_name_map`
    (with the BN entries when ``batch_stats``, the JAX ``batch_stats``
    collection, is given: its running means and variances join the
    state_dict, named by ``stats_map``, default
    :func:`unetp_res_batch_stats_map`); the entries of a plastic=False model
    (no ``w``/``alpha``/``eta``) are skipped when the tree lacks them."""
    if name_map is None:
        name_map = unetp_res_name_map(batch_norm=batch_stats is not None)
    if batch_stats is not None:
        stats_map = unetp_res_batch_stats_map() if stats_map is None else stats_map
        name_map = dict(name_map)
        name_map.update({("batch_stats",) + path: (key, None) for path, key in stats_map.items()})
        params = {**params, "batch_stats": batch_stats}
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
        if perm == FLIPPED_CONVT:
            arr = np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
        elif perm is not None:
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
