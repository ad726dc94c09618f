"""Device-side augmentation and the dihedral TTA views (counterpart of
plastic_unet_tpu.ops.augment).

Random train-time augmentation applies an h-flip, then a v-flip, then a
rotation by k x 90 degrees, chosen per sample, to the image and its mask
alike. The JAX package draws the choices from a PRNG key inside the
transform; torch's generators cannot redraw JAX's stream, so here the
choices come in as an ``(N, 3)`` integer tensor (h-flip bit, v-flip bit,
k in 0..3) that :func:`draw_augment_choices` draws on the device, or a
caller derives from JAX's keys to hold the two packages against each other.
The selection runs on the device with ``torch.where``: nothing is read back.

Test-time augmentation: :data:`TTA_TRANSFORMS` maps each of the 8 views of
the dihedral group D4 to its forward on the image and its inverse on the
mask; :func:`tta_expand`, :func:`tta_merge` and :func:`tta_batched_apply`
stack, undo and average them. ``torch.flip``, ``torch.rot90`` and
``transpose`` return copies or strided views: whatever feeds a kernel
wrapper (contiguous NHWC) is made contiguous first.

:func:`pad_to` and :func:`crop_from` pad a tile up to a square canvas and
crop it back (UNetPRes's ``trunk_pad``: 101 -> 128 and back).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def _spatial_axes(x: torch.Tensor, channels_last: bool) -> tuple[int, int]:
    return (x.dim() - 3, x.dim() - 2) if channels_last else (x.dim() - 2, x.dim() - 1)


def flip_h(x: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    return torch.flip(x, dims=(_spatial_axes(x, channels_last)[1],))


def flip_v(x: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    return torch.flip(x, dims=(_spatial_axes(x, channels_last)[0],))


def rot90k(x: torch.Tensor, k: int, channels_last: bool = True) -> torch.Tensor:
    return torch.rot90(x, k, dims=_spatial_axes(x, channels_last))


def transpose_hw(x: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    """Reflection over the main diagonal: out[i, j] = in[j, i] (square
    tiles). Self-inverse."""
    return torch.transpose(x, *_spatial_axes(x, channels_last))


def anti_transpose_hw(x: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    """Reflection over the anti-diagonal: out[i, j] = in[n-1-j, n-1-i].
    Self-inverse (rot180 of the transpose)."""
    return rot90k(transpose_hw(x, channels_last), 2, channels_last)


# name -> (forward on the image, inverse on the mask): the dihedral group D4,
# 4 rotations and 4 reflections, in the JAX registry's order. The rotations'
# inverses turn the other way; the reflections are their own. The transposes
# swap H and W, so they keep the shape only on square tiles (TGS: 101x101).
TTA_TRANSFORMS = {
    "identity": (lambda x, cl=True: x, lambda m, cl=True: m),
    "hflip": (flip_h, flip_h),
    "vflip": (flip_v, flip_v),
    "rot90": (lambda x, cl=True: rot90k(x, 1, cl), lambda m, cl=True: rot90k(m, 3, cl)),
    "rot180": (lambda x, cl=True: rot90k(x, 2, cl), lambda m, cl=True: rot90k(m, 2, cl)),
    "rot270": (lambda x, cl=True: rot90k(x, 3, cl), lambda m, cl=True: rot90k(m, 1, cl)),
    "transpose": (transpose_hw, transpose_hw),
    "anti_transpose": (anti_transpose_hw, anti_transpose_hw),
}
TTA_VIEWS_2 = ("identity", "hflip")
TTA_VIEWS_4 = ("identity", "hflip", "vflip", "rot180")
TTA_VIEWS_8 = tuple(TTA_TRANSFORMS)


def parse_tta(spec: str) -> tuple[str, ...]:
    """Parse a --tta CLI spec: a preset ('tta2'/'tta4'/'tta8'/'all') or a
    comma-separated list of view names from TTA_TRANSFORMS."""
    presets = {"tta2": TTA_VIEWS_2, "tta4": TTA_VIEWS_4, "tta8": TTA_VIEWS_8, "all": TTA_VIEWS_8}
    s = spec.strip().lower()
    if s in presets:
        return presets[s]
    views = tuple(v.strip() for v in s.split(",") if v.strip())
    if not views:
        raise ValueError(
            f"empty TTA spec {spec!r}; valid: {sorted(TTA_TRANSFORMS)} or presets {sorted(presets)}"
        )
    unknown = [v for v in views if v not in TTA_TRANSFORMS]
    if unknown:
        raise ValueError(f"unknown TTA view(s) {unknown}; valid: {sorted(TTA_TRANSFORMS)} or presets {sorted(presets)}")
    return views


def tta_expand(x: torch.Tensor, transforms: Sequence[str] = ("identity", "hflip"),
               channels_last: bool = True) -> torch.Tensor:
    """The views stacked: (B, ...) -> (T, B, ...)."""
    return torch.stack([TTA_TRANSFORMS[t][0](x, channels_last) for t in transforms], dim=0)


def tta_merge(preds: torch.Tensor, transforms: Sequence[str] = ("identity", "hflip"),
              channels_last: bool = False) -> torch.Tensor:
    """Each view's geometry undone, then the mean: (T, B, H, W) -> (B, H, W).
    channels_last=False because the head's masks are (B, nbf, nbf)."""
    undone = [TTA_TRANSFORMS[t][1](preds[i], channels_last) for i, t in enumerate(transforms)]
    return torch.mean(torch.stack(undone, dim=0), dim=0)


def tta_batched_apply(forward, x: torch.Tensor, transforms: Sequence[str]) -> torch.Tensor:
    """The T views folded into the batch axis of one forward, then merged.

    forward: (T*B, H, W, C) NHWC -> (T*B, nbf, nbf) masks. Equal to T
    passes, one a view, wherever the forward's per-sample math does not
    depend on a sample's place in the batch (eval mode: no dropout, no
    reduction across the batch, and kernel plans chosen from shapes)."""
    n = x.shape[0]
    allv = torch.cat([TTA_TRANSFORMS[t][0](x, True) for t in transforms], dim=0)
    preds = forward(allv)
    return tta_merge(preds.reshape((len(transforms), n) + tuple(preds.shape[1:])), transforms, channels_last=False)


def draw_augment_choices(n: int, generator: torch.Generator) -> torch.Tensor:
    """(n, 3) int64 choices on the generator's device: an h-flip bit, a
    v-flip bit and a rotation k in 0..3 per sample."""
    dev = generator.device
    flips = torch.randint(0, 2, (n, 2), generator=generator, device=dev)
    k = torch.randint(0, 4, (n, 1), generator=generator, device=dev)
    return torch.cat([flips, k], dim=1)


def _apply(x: torch.Tensor, choices: torch.Tensor, channels_last: bool) -> torch.Tensor:
    """x (N, ...) transformed per sample by choices (N, 3): every candidate
    computed for the whole stream and selected per sample (square tiles)."""
    per_sample = (x.shape[0],) + (1,) * (x.dim() - 1)
    do_h, do_v, k = (choices[:, i].reshape(per_sample) for i in range(3))
    x = torch.where(do_h != 0, flip_h(x, channels_last), x)
    x = torch.where(do_v != 0, flip_v(x, channels_last), x)
    out = x
    for r in (1, 2, 3):
        out = torch.where(k == r, rot90k(x, r, channels_last), out)
    return out


def augment_stream(X: torch.Tensor, Y: torch.Tensor, choices: torch.Tensor, channels_last: bool = True):
    """Each sample of a stream (N, ...) flipped and rotated by its row of
    ``choices`` (N, 3), the image X and its mask Y alike (square tiles). A
    mask with one fewer dimension than the image has no channel axis: its
    spatial axes are the trailing two."""
    if choices.shape != (X.shape[0], 3) or Y.shape[0] != X.shape[0]:
        raise ValueError(f"augment_stream: choices {tuple(choices.shape)} for X {tuple(X.shape)}, Y {tuple(Y.shape)}")
    mask_cl = channels_last and Y.dim() == X.dim()
    return _apply(X, choices, channels_last), _apply(Y, choices, mask_cl)


def random_flip_rotate(choice: torch.Tensor, img: torch.Tensor, mask: torch.Tensor, channels_last: bool = True):
    """One choice (3,) applied to (img, mask) alike; img (H, W, C) or
    batched, mask (H, W) or batched, as the JAX function takes them."""
    xa, ya = augment_stream(img[None], mask[None], choice.reshape(1, 3), channels_last)
    return xa[0], ya[0]


def pad_to(x: torch.Tensor, size: int, channels_last: bool = True) -> torch.Tensor:
    """Reflect-pad the spatial dims up to (size, size), the extra pixel of an
    odd difference on the right and bottom (e.g. 101 -> 128: 13 before, 14
    after); each side's pad must be smaller than the dim (torch reflects
    once). The JAX function's ``mode="reflect"``, the one its callers use.
    Returns a contiguous tensor."""
    h_ax, w_ax = _spatial_axes(x, channels_last)
    dh, dw = size - x.shape[h_ax], size - x.shape[w_ax]
    if dh < 0 or dw < 0:
        raise ValueError(f"pad_to: {tuple(x.shape)} is larger than ({size}, {size}) in its spatial dims")
    if channels_last:  # F.pad pads the trailing dims: put H, W last
        x = x.movedim(-1, -3)
    lead = x.shape[:-3]
    y = F.pad(x.reshape((-1,) + tuple(x.shape[-3:])), (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2),
              mode="reflect")
    y = y.reshape(lead + tuple(y.shape[-3:]))
    return (y.movedim(-3, -1) if channels_last else y).contiguous()


def crop_from(x: torch.Tensor, size: int, channels_last: bool = True) -> torch.Tensor:
    """The inverse of :func:`pad_to`: the centre (size, size) of the spatial
    dims, the odd pixel dropped on the right and bottom. A strided view."""
    h_ax, w_ax = _spatial_axes(x, channels_last)
    dh, dw = x.shape[h_ax] - size, x.shape[w_ax] - size
    return x.narrow(h_ax, dh // 2, size).narrow(w_ax, dw // 2, size)
