"""UNetPRes — the residual plastic U-Net (counterpart of
plastic_unet_tpu.models.unet_res; reference unet_p_res.py:9-140).

Encoder 4x (DownRes, 2x2 max-pool, channel dropout), Middle, decoder 4x
UpRes with skip concats, 1x1 outconv, then the plastic head on the
(nbf, nbf) logits. Widths are neurons x {1, 2, 4, 8, 16}; the 101-px track
is 101 -> 50 -> 25 -> 12 -> 6 -> (up) -> 101; the first pool drops at half
the rate. Inputs are NHWC ``(B, H, W, C)`` and the trace is ``(B, nbf, nbf)``,
one independent stream per batch element.

``quant`` is the int8 serving mode of the JAX module ('' off, 'calib'
records each quantized conv's range, 'int8' serves from them; see
models.blocks and submit.quant). The ranges live in non-persistent buffers
(:meth:`UNetPRes.quant_ranges`), so a reference ``.pth`` loads strictly
either way; the 1x1 outconv and the head stay fp32.

The constructor takes every field of the JAX module. ``trunk_pad``
reflect-pads the input to (trunk_pad, trunk_pad) (101 -> 128: the trunk then
runs at 128/64/32/16/8) and crops the trunk's logits back to (nbf, nbf)
before the head; ``coord_conv`` appends the xx/yy channels (ops.coords)
after the pad, so the stem takes n_channels + 2; ``remat_trunk`` runs each
of the 9 trunk modules under torch.utils.checkpoint (non-reentrant), the
backward recomputing what they would have kept, with the same kernels and
so the same bits: UpRes's dropout mask is drawn before its checkpoint and
passed in, so the recompute reads the same mask (checkpoint's RNG stash
never sees an explicit generator); ``batch_norm`` puts flax-semantics BN
in the DownRes and Middle trunks (models.blocks), which then run unfused.
The TPU lowerings of the same math are accepted and change nothing:
``fold_hires`` (space-to-depth, exact up to reassociation; the same
parameters), ``patch_conv``, ``fast_dw``, ``use_pallas``, ``pallas_trunk``;
``bilinear_upsample`` is ignored, as in the JAX module.

``compute_dtype`` bfloat16 is the JAX module's mixed precision: the
parameters stay fp32; the input is cast after the pad and the coords, the
trunk runs in bf16 on cuDNN (models.blocks: every conv, ReLU, skip, pool,
concat and dropout; the fused tail kernel is fp32-only, as the JAX fused
tail is), the outconv's output goes back to fp32 before the crop, and the
head (its kernel on the card), the sigmoid and the loss stay fp32. It
composes with every option above and with int8 (the dequantized convs
return bf16). The model keeps it as ``compute_dtype`` (None for fp32).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from plastic_unet_tpu_torch.models.blocks import (
    QUANT_MODES,
    DownRes,
    Middle,
    UpRes,
    channel_dropout,
    conv_nhwc,
    draw_keep,
    init_conv_,
    max_pool_2x2,
)
from plastic_unet_tpu_torch.ops.augment import crop_from, pad_to
from plastic_unet_tpu_torch.ops.coords import add_coords
from plastic_unet_tpu_torch.ops.export_ops import plastic_head_forward
from plastic_unet_tpu_torch.ops.plastic_head import plastic_head
from plastic_unet_tpu_torch.ops.plasticity import check_head_args


COMPUTE_DTYPES = {None: None, "float32": None, torch.float32: None,
                  "bfloat16": torch.bfloat16, torch.bfloat16: torch.bfloat16}


def resolve_compute_dtype(compute_dtype) -> torch.dtype | None:
    """None for fp32 (None, "float32", torch.float32), torch.bfloat16 for
    "bfloat16" or torch.bfloat16; anything else raises."""
    try:
        return COMPUTE_DTYPES[compute_dtype]
    except (KeyError, TypeError):
        raise ValueError(f"compute_dtype must be float32 or bfloat16 (a name or a torch dtype), "
                         f"got {compute_dtype!r}") from None


class PlasticOutput(NamedTuple):
    activ: torch.Tensor  # pre-sigmoid logits of the head (B, nbf, nbf)
    activout: torch.Tensor  # sigmoid probabilities == predicted mask (B, nbf, nbf)
    hebb: torch.Tensor  # updated trace (B, nbf, nbf)


class OutConv(nn.Module):
    """1x1 conv (reference outconv; key ``outc.conv``)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_features, out_features, 1)


class PlasticHeadNet(nn.Module):
    """The plastic head's one owner, shared by UNetPRes and UNetP: its
    parameters ``w``, ``alpha``, ``eta`` at the module's top level (the
    reference's keys), their initialisation, the zero trace, and the launch:
    ops.plastic_head (csrc/plastic_head.cu on the card), or under
    torch.export the same launch as the custom op of ops.export_ops."""

    nbf: int
    rule: str
    alfa_type: str

    def add_head(self, nbf: int) -> None:
        self.w = nn.Parameter(torch.empty(nbf, nbf))
        self.alpha = nn.Parameter(torch.empty(nbf, nbf))
        self.eta = nn.Parameter(torch.empty(1))

    def reset_head(self, generator: torch.Generator | None = None) -> None:
        """w ~ 0.01*randn, alpha ~ 0.01*rand, eta = 0.01 (under no_grad)."""
        self.w.copy_(0.01 * torch.randn(self.w.shape, generator=generator))
        self.alpha.copy_(0.01 * torch.rand(self.alpha.shape, generator=generator))
        self.eta.fill_(0.01)

    def initial_zero_hebb(self, batch: int = 1, device=None) -> torch.Tensor:
        """Batched zero trace (reference initialZeroHebb)."""
        return torch.zeros((batch, self.nbf, self.nbf), device=device)

    def head(self, activin: torch.Tensor, hebb: torch.Tensor) -> PlasticOutput:
        if torch.compiler.is_exporting():  # the same launch as a custom op torch.export can trace
            activ, activout, new_hebb = plastic_head_forward(
                self.w, self.alpha, self.eta, activin, hebb, self.rule, self.alfa_type)
        else:
            activ, activout, new_hebb = plastic_head(
                self.w, self.alpha, self.eta, activin, hebb, rule=self.rule, alfa_type=self.alfa_type
            )
        return PlasticOutput(activ=activ, activout=activout, hebb=new_hebb)


class UNetPRes(PlasticHeadNet):
    """Residual plastic U-Net; arguments mirror the JAX module's, in its
    order, and ``generator``.

    ``generator`` seeds the initial weights (torch-default conv init,
    w ~ 0.01*randn, alpha ~ 0.01*rand, eta = 0.01; BN scale 1, bias 0);
    None draws from the global generator. alpha is an (nbf, nbf) matrix for
    either alfa_type, as in the JAX module, where alfa_type only selects the
    head's contract."""

    def __init__(self, n_channels: int = 1, n_classes: int = 1, neurons: int = 16,
                 dropout_ratio: float = 0.5, alfa_type: str = "free", rule: str = "hebb",
                 nbf: int = 128, batch_norm: bool = False, bilinear_upsample: bool = False,
                 use_pallas: bool = False, compute_dtype=None, fold_hires: bool = False,
                 pallas_trunk: bool = False, fast_dw: bool = False, patch_conv: int = 0,
                 plastic: bool = True, coord_conv: bool = False, remat_trunk: bool = False,
                 quant: str = "", trunk_pad: int = 0, generator: torch.Generator | None = None):
        super().__init__()
        check_head_args(rule, alfa_type)
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        if fold_hires and batch_norm:  # the JAX module's folded ConvModule refuses BN
            raise NotImplementedError("batch_norm is not supported in folded mode")
        n = neurons
        self.n_channels, self.neurons = n_channels, neurons
        self.nbf, self.rule, self.alfa_type, self.plastic, self.quant = nbf, rule, alfa_type, plastic, quant
        self.dropout_ratio = dropout_ratio
        self.batch_norm, self.coord_conv, self.remat_trunk, self.trunk_pad = batch_norm, coord_conv, remat_trunk, trunk_pad
        # TPU lowerings of the same math (and bilinear_upsample, unused as in the JAX module):
        # kept for the quant check and the record, read by nothing else
        self.fold_hires, self.pallas_trunk, self.fast_dw, self.patch_conv = fold_hires, pallas_trunk, fast_dw, patch_conv
        self.use_pallas, self.bilinear_upsample = use_pallas, bilinear_upsample
        if plastic:
            self.add_head(nbf)
        bn = batch_norm
        self.conv1 = DownRes(n_channels + 2 if coord_conv else n_channels, n, bn)
        self.conv2 = DownRes(n, n * 2, bn)
        self.conv3 = DownRes(n * 2, n * 4, bn)
        self.conv4 = DownRes(n * 4, n * 8, bn)
        self.mid = Middle(n * 8, n * 16, bn)
        self.uconv4 = UpRes(n * 16, n * 8, dropout_ratio)
        self.uconv3 = UpRes(n * 8, n * 4, dropout_ratio)
        self.uconv2 = UpRes(n * 4, n * 2, dropout_ratio)
        self.uconv1 = UpRes(n * 2, n, dropout_ratio)
        self.outc = OutConv(n, n_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    init_conv_(m, generator)
            if self.plastic:
                self.reset_head(generator)

    def quant_ranges(self) -> dict:
        """torch module prefix (``conv1.dconv.0``, ``uconv4.dconv``, ...) ->
        calibrated amax, for each quantized conv that has one."""
        return {name[: -len(".amax")]: b for name, b in self.named_buffers() if name.endswith(".amax")}

    def load_quant_ranges(self, ranges: Mapping) -> None:
        """Set every quantized conv's amax from ``ranges`` (prefix -> scalar),
        on the conv's device; the prefixes must be exactly the 49 convs'."""
        convs = {name: m for name, m in self.named_modules() if "amax" in m._buffers}
        if set(ranges) != set(convs):
            raise KeyError(f"quant ranges: missing {sorted(set(convs) - set(ranges))}, "
                           f"unknown {sorted(set(ranges) - set(convs))}")
        for name, v in ranges.items():
            conv = convs[name]
            conv.amax = torch.as_tensor(v, dtype=torch.float32).to(conv.weight.device).reshape(())

    def _pad(self, x: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(x reflect-padded to (trunk_pad, trunk_pad), the size to crop the
        logits back to, 0 for none), with the JAX module's checks."""
        tp, h0, w0 = self.trunk_pad, x.shape[1], x.shape[2]
        if not tp:
            return x, 0
        if h0 > tp or w0 > tp:
            raise ValueError(f"trunk_pad={tp} smaller than input {h0}x{w0}")
        if h0 != w0:  # the crop restores a square (nbf, nbf) geometry
            raise ValueError(f"trunk_pad requires square inputs, got {h0}x{w0}")
        if h0 == tp:
            return x, 0
        if tp > 3 * h0 - 2:  # reflect padding needs each side's pad, at most ceil((tp - h0) / 2), below h0
            raise ValueError(f"trunk_pad={tp} too large for {h0}x{w0} input: reflect padding supports at most "
                             f"{3 * h0 - 2}")
        return pad_to(x, tp), h0

    def forward(self, x: torch.Tensor, hebb: torch.Tensor,
                generator: torch.Generator | None = None) -> PlasticOutput:
        """``generator`` (on ``x``'s device) feeds the channel dropout in
        train mode; eval mode draws nothing and needs none. A training
        caller passes the trace detached (train.loop does)."""
        if x.dim() == 3:  # unbatched convenience input
            x = x[None]
            hebb = hebb[None] if hebb.dim() == 2 else hebb
        if self.quant not in QUANT_MODES:
            raise ValueError(f"quant must be '', 'calib' or 'int8', got {self.quant!r}")
        if self.quant:
            bad = [k for k in ("fold_hires", "pallas_trunk", "fast_dw", "patch_conv", "batch_norm", "trunk_pad",
                               "remat_trunk") if getattr(self, k)]
            if bad:
                raise ValueError(f"quant={self.quant!r} is a plain serving mode; incompatible with {bad}")
        x, pad_crop = self._pad(x.contiguous())
        if self.coord_conv:
            x = add_coords(x)
        dt = self.compute_dtype
        if dt is not None:  # after the pad and the coords, as the JAX module casts
            x = x.to(dt)
        tr, r, g, q = self.training, self.dropout_ratio, generator, self.quant
        remat = self.remat_trunk and torch.is_grad_enabled()

        def trunk(m, *args):
            if remat:
                return checkpoint(m, *args, use_reentrant=False, preserve_rng_state=False)
            return m(*args)

        def up(m, x, skip):
            if remat:  # the mask drawn here, once: the recompute reads this tensor
                keep = draw_keep(x.shape[0], m.in_features, r, tr, g, x.device)
                return checkpoint(m, x, skip, None, q, keep, dt, use_reentrant=False, preserve_rng_state=False)
            return m(x, skip, g, q, None, dt)

        xc1 = trunk(self.conv1, x, q, dt)
        x1 = channel_dropout(max_pool_2x2(xc1), r / 2, tr, g)
        xc2 = trunk(self.conv2, x1, q, dt)
        x2 = channel_dropout(max_pool_2x2(xc2), r, tr, g)
        xc3 = trunk(self.conv3, x2, q, dt)
        x3 = channel_dropout(max_pool_2x2(xc3), r, tr, g)
        xc4 = trunk(self.conv4, x3, q, dt)
        x4 = channel_dropout(max_pool_2x2(xc4), r, tr, g)
        x5 = trunk(self.mid, x4, q, dt)
        u = up(self.uconv4, x5, xc4)
        u = up(self.uconv3, u, xc3)
        u = up(self.uconv2, u, xc2)
        u = up(self.uconv1, u, xc1)
        out = conv_nhwc(self.outc.conv, u, dt)  # (B, H, W, n_classes)
        if dt is not None:
            out = out.to(torch.float32)  # the head, the sigmoid and the loss stay fp32
        if pad_crop:
            out = crop_from(out, pad_crop)  # back to the (nbf, nbf) head geometry

        b = out.shape[0]
        if out.numel() != b * self.nbf * self.nbf:
            raise ValueError(
                "U-Net output (%s) cannot be reshaped to (B, nbf=%d, nbf); nbf must equal "
                "the image width (reference sets nbf=img_width, train.py:285-288)"
                % (tuple(out.shape), self.nbf)
            )
        activin = out.reshape(b, self.nbf, self.nbf)
        if not self.plastic:
            # vanilla U-Net: sigmoid on the trunk logits; the trace passes through
            return PlasticOutput(activ=activin, activout=torch.sigmoid(activin), hebb=hebb)
        return self.head(activin, hebb)
