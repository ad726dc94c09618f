"""Device-side augmentation and the TTA view names (counterpart of
plastic_unet_tpu.ops.augment).

Random train-time augmentation applies an h-flip, then a v-flip, then a
rotation by k x 90 degrees, chosen per sample, to the image and its mask
alike. The JAX package draws the choices from a PRNG key inside the
transform; torch's generators cannot redraw JAX's stream, so here the
choices come in as an ``(N, 3)`` integer tensor (h-flip bit, v-flip bit,
k in 0..3) that :func:`draw_augment_choices` draws on the device, or a
caller derives from JAX's keys to hold the two packages against each other.
The selection runs on the device with ``torch.where``: nothing is read back.

TTA inference is not ported yet (``submit.inference.predict_masks_tta``
raises for any view but the identity); :func:`parse_tta` is, so that the
CLIs take ``--tta`` as the JAX ones do.
"""

from __future__ import annotations

import torch


def _spatial_axes(x: torch.Tensor, channels_last: bool) -> tuple[int, int]:
    return (x.dim() - 3, x.dim() - 2) if channels_last else (x.dim() - 2, x.dim() - 1)


def flip_h(x: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    return torch.flip(x, dims=(_spatial_axes(x, channels_last)[1],))


def flip_v(x: torch.Tensor, channels_last: bool = True) -> torch.Tensor:
    return torch.flip(x, dims=(_spatial_axes(x, channels_last)[0],))


def rot90k(x: torch.Tensor, k: int, channels_last: bool = True) -> torch.Tensor:
    return torch.rot90(x, k, dims=_spatial_axes(x, channels_last))


# The view names of the JAX package's TTA registry (the dihedral group D4) and its presets.
TTA_VIEW_NAMES = ("identity", "hflip", "vflip", "rot90", "rot180", "rot270", "transpose", "anti_transpose")
TTA_VIEWS_2 = ("identity", "hflip")
TTA_VIEWS_4 = ("identity", "hflip", "vflip", "rot180")
TTA_VIEWS_8 = TTA_VIEW_NAMES


def parse_tta(spec: str) -> tuple[str, ...]:
    """Parse a --tta CLI spec: a preset ('tta2'/'tta4'/'tta8'/'all') or a
    comma-separated list of view names from TTA_VIEW_NAMES."""
    presets = {"tta2": TTA_VIEWS_2, "tta4": TTA_VIEWS_4, "tta8": TTA_VIEWS_8, "all": TTA_VIEWS_8}
    s = spec.strip().lower()
    if s in presets:
        return presets[s]
    views = tuple(v.strip() for v in s.split(",") if v.strip())
    if not views:
        raise ValueError(
            f"empty TTA spec {spec!r}; valid: {sorted(TTA_VIEW_NAMES)} or presets {sorted(presets)}"
        )
    unknown = [v for v in views if v not in TTA_VIEW_NAMES]
    if unknown:
        raise ValueError(f"unknown TTA view(s) {unknown}; valid: {sorted(TTA_VIEW_NAMES)} or presets {sorted(presets)}")
    return views


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
