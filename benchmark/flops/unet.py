"""Operations and bytes of UNetP (the classic plastic U-Net), counted from
its shapes as ``unet_res.py`` counts: 2 x 9 x H x W x Cin x Cout a 3x3
conv, 2 x 4 x Hin x Win x Cin x Cout a 2x2 transposed conv of stride 2,
2 x H x W x C the 1x1 outconv, 2 x nbf^3 the head. It has no residual
tail, so no tail work."""

from __future__ import annotations

ENC = [(1, 8), (8, 16), (16, 32), (32, 64), (64, 64)]  # double convs, at size / 2**i
DEC = [(128, 32), (64, 16), (32, 8), (16, 8)]  # double convs after each up, from the deepest


def forward_flops(config: dict) -> float:
    s0, m = config["image_size"], config["model"]
    f = 0
    for i, (cin, c) in enumerate(ENC):
        cin = m["n_channels"] if i == 0 else cin
        s = s0 // 2 ** i
        f += 2 * 9 * s * s * (cin * c + c * c)
    for j, (cin, c) in enumerate(DEC):
        s_in, s = s0 // 2 ** (4 - j), s0 // 2 ** (3 - j)
        f += 2 * 4 * s_in * s_in * (cin // 2) ** 2  # ConvTranspose2d(cin/2, cin/2, 2, stride 2)
        f += 2 * 9 * s * s * (cin * c + c * c)
    return float(f + 2 * 8 * s0 * s0 * m["n_classes"] + 2 * m["nbf"] ** 3)


def backward_flops(config: dict) -> float:
    s0, m = config["image_size"], config["model"]
    return 2 * forward_flops(config) - 2 * 9 * s0 * s0 * m["n_channels"] * 8


def train_flops(config: dict) -> float:
    return forward_flops(config) + backward_flops(config)


def tail_work(config: dict, batch: int, train: bool) -> tuple[float, float]:
    return 0.0, 0.0
