"""Operations and bytes of UNetPRes, counted from its shapes.

Every conv counts 2 x 9 x H x W x Cin x Cout operations (multiply-adds
x 2) at its output size; a 3x3 transposed conv of stride 2 counts 9 taps
per input pixel; the 1x1 outconv 2 x H x W x C; the head's (nbf, nbf) @
(nbf, nbf) 2 x nbf^3. A training step's backward is an input gradient
and a weight gradient of each conv's forward size, except that the image
takes no gradient, and two head products for the forward's one.

A residual tail (two residual blocks: four 3x3 convs at C -> C) is counted
the same whatever kernel carries it. Its bytes count each input read once
and each output written once: forward x0 in, out out (in training also the
three intermediates and x0's saved form the backward reads: pre11, x1,
pre21); backward g and the five saved tensors in, dx0 out; the four
weights and biases are read by the forward, read by the backward and
their gradients written, once a launch.
"""

from __future__ import annotations

F32 = 4


def levels(config: dict) -> tuple[list, list]:
    """(sizes, widths) of the five levels: 101 -> 50 -> 25 -> 12 -> 6 at 101 px."""
    m = config["model"]
    sizes = [config["image_size"]]
    for _ in range(4):
        sizes.append(sizes[-1] // 2)
    return sizes, [m["neurons"] * 2 ** i for i in range(5)]


def tails(config: dict) -> list:
    """(size, width) of the nine residual tails: the four DownRes, the Middle
    and the four UpRes middles."""
    sizes, ch = levels(config)
    return [(sizes[i], ch[i]) for i in range(5)] + [(sizes[k], ch[k]) for k in range(4)]


def forward_flops(config: dict) -> float:
    """One tile's forward (``chip_smoke.py::forward_flops``, copied)."""
    sizes, ch = levels(config)
    n_in, nbf = config["model"]["n_channels"], config["model"]["nbf"]

    def trunk(cin, c, s):  # entry conv + the four convs of the residual tail
        return 2 * 9 * s * s * (cin * c + 4 * c * c)

    f = sum(trunk(n_in if i == 0 else ch[i - 1], ch[i], sizes[i]) for i in range(5))
    for k in range(4):  # UpRes from level k+1 to level k
        f += 2 * 9 * sizes[k + 1] ** 2 * ch[k + 1] * ch[k] + trunk(2 * ch[k], ch[k], sizes[k])
    return float(f + 2 * ch[0] * sizes[0] ** 2 * config["model"]["n_classes"] + 2 * nbf ** 3)


def backward_flops(config: dict) -> float:
    """One tile's backward (``chip_smoke.py::backward_flops``, copied)."""
    sizes, ch = levels(config)
    n_in = config["model"]["n_channels"]
    return 2 * forward_flops(config) - 2 * 9 * sizes[0] ** 2 * n_in * ch[0]


def train_flops(config: dict) -> float:
    """One sample's training step: forward and backward (Adam and the loss not counted)."""
    return forward_flops(config) + backward_flops(config)


def tail_work(config: dict, batch: int, train: bool) -> tuple[float, float]:
    """(operations, bytes) of the nine tails over a launch of ``batch`` samples."""
    ops = nbytes = 0.0
    for s, c in tails(config):
        conv = 2 * 9 * s * s * c * c
        act = s * s * c * F32 * batch  # one activation tensor of the tail
        wts = 4 * (9 * c * c + c) * F32
        if train:
            ops += 3 * 4 * conv * batch
            nbytes += 5 * act + 7 * act + 3 * wts  # fwd: x0 in, 4 out; bwd: 6 in, dx0 out
        else:
            ops += 4 * conv * batch
            nbytes += 2 * act + wts
    return ops, nbytes
