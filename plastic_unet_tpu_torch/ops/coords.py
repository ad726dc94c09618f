"""CoordConv coordinate channels (counterpart of plastic_unet_tpu.ops.coords;
the reference Keras AddCoords layer, src/coord_conv_script.py:61-102).

Appends xx (varies along the width) and yy (along the height) normalised to
[-1, 1], and optionally r = sqrt((xx - .5)^2 + (yy - .5)^2): the -0.5
offsets on channels already in [-1, 1] are the reference's quirk, kept.
"""

from __future__ import annotations

import torch


def add_coords(x: torch.Tensor, with_r: bool = False) -> torch.Tensor:
    """NHWC (or HWC) ``x`` with the coordinate channels appended last."""
    h, w = x.shape[-3], x.shape[-2]
    xx = (torch.arange(w, dtype=torch.float32, device=x.device) / (w - 1) * 2.0 - 1.0).expand(h, w)
    yy = (torch.arange(h, dtype=torch.float32, device=x.device) / (h - 1) * 2.0 - 1.0)[:, None].expand(h, w)
    chans = [xx, yy]
    if with_r:
        chans.append(torch.sqrt(torch.square(xx - 0.5) + torch.square(yy - 0.5)))
    coords = torch.stack(chans, dim=-1).to(x.dtype)  # (H, W, 2|3)
    coords = coords.expand(tuple(x.shape[:-1]) + (coords.shape[-1],))
    return torch.cat([x, coords], dim=-1)
