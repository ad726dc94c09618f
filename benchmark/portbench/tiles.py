"""Seeded TGS-like tiles, made in bulk on the device.

The same generator as the port's ``data/synthetic.py::synthetic_tiles``
(default regime), vectorised: each tile holds up to three salt ellipses
(count uniform in 0..3, centres uniform in the tile, radii uniform in
[0.08, 0.38] of the width, angle uniform in [0, pi)), over a Gaussian
texture (mean 0.5, sd 0.15) with a brightness bump of 0.25 on salt and a
fixed stripe pattern, clipped to [0, 1]. The draws come from one
``torch.Generator`` seeded from the run's seed, so a seed gives the same
tiles on the same device, and the values are not the port's numpy draws.
"""

from __future__ import annotations

import math

import torch

MAX_ELLIPSES = 3
R_LO, R_HI = 0.08, 0.38
BLOCK = 512  # tiles made at once


def make_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one named use of the run's seed; any
    whole number of the run, large ones too, and the streams differ."""
    return torch.Generator(device=device).manual_seed((int(seed) * 16 + stream) % (2 ** 63))


def synthetic_tiles(n: int, size: int, generator: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(images, masks), each (n, size, size) float32 on ``device``: images in
    [0, 1], masks in {0, 1}."""
    grid = torch.arange(size, device=device, dtype=torch.float32) / size
    yy, xx = grid[:, None], grid[None, :]
    stripes = 0.1 * torch.sin(8 * math.pi * (yy + 0.3 * xx))
    images = torch.empty((n, size, size), device=device)
    masks = torch.empty((n, size, size), device=device)
    g = generator
    for lo in range(0, n, BLOCK):
        b = min(BLOCK, n - lo)
        count = torch.randint(0, MAX_ELLIPSES + 1, (b, 1, 1, 1), generator=g, device=device)
        centre = torch.rand((b, MAX_ELLIPSES, 2), generator=g, device=device)
        radii = R_LO + (R_HI - R_LO) * torch.rand((b, MAX_ELLIPSES, 2), generator=g, device=device)
        theta = math.pi * torch.rand((b, MAX_ELLIPSES), generator=g, device=device)
        tex = 0.5 + 0.15 * torch.randn((b, size, size), generator=g, device=device)
        cx, cy = centre[..., 0, None, None], centre[..., 1, None, None]
        rx, ry = radii[..., 0, None, None], radii[..., 1, None, None]
        c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
        dx, dy = xx - cx, yy - cy  # (b, E, size, size)
        u, v = dx * c + dy * s, -dx * s + dy * c
        inside = (u / rx) ** 2 + (v / ry) ** 2 < 1
        live = torch.arange(MAX_ELLIPSES, device=device)[None, :, None, None] < count.reshape(b, 1, 1, 1)
        m = (inside & live).any(dim=1).to(torch.float32)
        images[lo:lo + b] = torch.clamp(tex + 0.25 * m + stripes, 0.0, 1.0)
        masks[lo:lo + b] = m
    return images, masks
