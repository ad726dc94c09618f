"""The fused residual tail's route and band geometry (ops.residual_tail):
tail_plan's table of routes at the level shapes, its tilings against the
kernel's limits, the kernel's bands, halo rows and zero borders in plain
PyTorch (residual_tail_banded_plain) against the JAX package's Pallas tail
in interpret mode, and CPU tensors launching nothing on either route."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plastic_unet_tpu.ops.pallas_trunk import residual_tail_apply
from plastic_unet_tpu_torch.ops.conv3x3 import NUM_SMS, SMEM_MAX, SPLIT_MAX_KS, conv3x3_plain, conv3x3_plan, hwio
from plastic_unet_tpu_torch.ops.residual_tail import (
    FUSED_MIN_FILL,
    FUSED_TILING,
    _forward,
    _fused_plan,
    _slots,
    residual_tail,
    residual_tail_fused,
    residual_tail_plain,
    residual_tail_ranges,
    tail_plan,
)
from plastic_unet_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

LEVELS = {101: 16, 50: 32, 25: 64, 12: 128, 6: 256}
# (B, H) -> the route: the fused kernel at 101^2 x 16 and 50^2 x 32 on large batches, four launches elsewhere
ROUTES = {(b, hw): "fused" if hw in (101, 50) and b >= 37 else "four" for b in (1, 3, 37, 128, 1024) for hw in LEVELS}


@pytest.mark.parametrize("b,hw", sorted(ROUTES))
def test_tail_plan_routes(b, hw):
    c = LEVELS[hw]
    p = tail_plan(b, hw, hw, c)
    assert p.family == ROUTES[(b, hw)]
    if p.family == "four":
        assert tuple(p)[1:] == (0,) * 6
        return
    assert conv3x3_plan(b, hw, hw, c, c).family == "tile" and p.blocks == b * p.bands
    assert b * hw * hw >= FUSED_MIN_FILL * NUM_SMS * _slots(p.px, p.threads, c)
    assert (p.px, p.threads) == FUSED_TILING[c]
    # the fewest bands whose rows fit the thread grid and whose buffers fit shared memory
    assert p == tail_plan(b, hw, hw, c, family="fused") == _fused_plan(b, hw, hw, c, p.bands)
    assert all(_fused_plan(b, hw, hw, c, fewer) is None for fewer in range(1, p.bands))


@pytest.mark.parametrize("hw,c,first", [(101, 16, 7), (50, 32, 10), (50, 16, 29), (25, 32, 38)])
def test_tail_plan_fused_from_a_fill(hw, c, first):
    """The fused route starts where the batch's pixels fill FUSED_MIN_FILL of
    the card's pixel slots (between the four launches' last win and the
    fused kernel's first in chip_smoke.py's phase-6 sweep) and holds on."""
    assert tail_plan(first - 1, hw, hw, c).family == "four"
    assert all(tail_plan(b, hw, hw, c).family == "fused" for b in (first, first + 1, 3 * first // 2))
    p = tail_plan(first, hw, hw, c)
    fill = [b * hw * hw / (NUM_SMS * _slots(p.px, p.threads, c)) for b in (first - 1, first)]
    assert fill[0] < FUSED_MIN_FILL <= fill[1] and 0.302 < FUSED_MIN_FILL < 0.395  # inside the sweep's gap


def _check_fused(p, b, h, w, c):
    """A fused plan against the kernel's limits and its band geometry."""
    assert p.family == "fused" and 1 <= p.bands <= min(h, SPLIT_MAX_KS)  # one cluster a sample, at most 16 blocks
    assert p.smem <= SMEM_MAX and p.blocks == b * p.bands
    edges = [k * h // p.bands for k in range(p.bands + 1)]
    rows = np.diff(edges)
    assert edges[0] == 0 and edges[-1] == h and rows.min() >= 1 and rows.max() == p.rows == -(-h // p.bands)
    assert p.rows * w <= p.px * p.threads // (c // 16)  # every pixel of a band has a thread
    band = (((p.rows + 2) * (w + 1) + 1) * (c + 1) + 3) // 4 * 4
    assert p.smem == 4 * (2 * band + 2 * 9 * 16 * c)


@pytest.mark.parametrize("b,h,w,c", [(128, 101, 101, 16), (128, 50, 50, 32), (1024, 101, 101, 16), (1, 101, 101, 16),
                                     (3, 50, 50, 32), (2, 13, 13, 16), (2, 10, 11, 32), (5, 37, 5, 32)])
def test_fused_plans_fit_the_kernel(b, h, w, c):
    """Every band count a shape can take: limits and geometry hold."""
    plans = [p for n in range(0, SPLIT_MAX_KS + 2) if (p := _fused_plan(b, h, w, c, n))]
    for p in plans:
        _check_fused(p, b, h, w, c)
    assert plans and plans[0] == tail_plan(b, h, w, c, family="fused")


def test_tail_plan_forcing():
    assert tail_plan(128, 101, 101, 16, family="four").family == "four"
    assert tail_plan(1, 101, 101, 16, family="fused").family == "fused"  # the plan takes four launches there
    assert tail_plan(1, 101, 101, 16).family == "four"
    with pytest.raises(ValueError):
        tail_plan(128, 101, 101, 16, family="tile")
    assert _fused_plan(128, 101, 101, 16, 0) is None and _fused_plan(128, 101, 101, 16, SPLIT_MAX_KS + 1) is None
    with pytest.raises(ValueError):  # no tiling for the widths the kernel does not have
        tail_plan(128, 25, 25, 64, family="fused")


NAMES = ("11", "12", "21", "22")


def residual_tail_banded_plain(x0, w11, b11, w12, b12, w21, b21, w22, b22, bands):
    """The fused kernel's band geometry in plain PyTorch: (out, pre11, x1,
    pre21), each conv computed band by band (rows [k*H//bands,
    (k+1)*H//bands)) from the band and one halo row above and below taken
    from the previous conv's bands, zero outside the image, and the ReLU of
    what it reads (the buffers' contents). Weights are torch Conv2d weights
    (C, C, 3, 3)."""
    b, h, w, c = x0.shape
    edges = [k * h // bands for k in range(bands + 1)]
    ks = [hwio(t) for t in (w11, w12, w21, w22)]

    def conv_bands(src, k, bias, skip=None):
        """Conv k over ``src`` (the ReLU'd input, as the buffers hold it), band by band."""
        out = []
        for y0, y1 in zip(edges, edges[1:]):
            slab = src.new_zeros((b, y1 - y0 + 2, w + 2, c))
            lo, hi = max(y0 - 1, 0), min(y1 + 1, h)
            slab[:, lo - y0 + 1:hi - y0 + 1, 1:w + 1] = src[:, lo:hi]
            v = sum(torch.matmul(slab[:, ky:ky + y1 - y0, kx:kx + w], ks[k][ky, kx])
                    for ky in range(3) for kx in range(3)) + bias
            out.append(v if skip is None else v + skip[:, y0:y1])
        return torch.cat(out, dim=1)

    a = torch.relu(x0)
    pre11 = conv_bands(a, 0, b11)
    x1 = conv_bands(torch.relu(pre11), 1, b12, a)
    pre21 = conv_bands(torch.relu(x1), 2, b21)
    out = torch.relu(conv_bands(torch.relu(pre21), 3, b22, torch.relu(x1)))
    return out, pre11, x1, pre21


def _make(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    p = {}
    for name in NAMES:
        p["w" + name] = (rng.standard_normal((3, 3, c, c)) * (0.5 / (3 * np.sqrt(c)))).astype(np.float32)
        p["b" + name] = (rng.standard_normal(c) * 0.1).astype(np.float32)
    args = []
    for name in NAMES:
        args.append(torch.from_numpy(np.ascontiguousarray(np.transpose(p["w" + name], (3, 2, 0, 1)))))
        args.append(torch.from_numpy(p["b" + name]))
    return x0, p, args


@pytest.mark.parametrize("h,w,c,bands", [(13, 13, 16, 4), (13, 13, 16, 5), (13, 13, 16, 13), (10, 11, 32, 3),
                                         (10, 11, 32, 4), (10, 11, 32, 1)])
def test_banded_plain_matches_pallas(h, w, c, bands):
    """The kernel's bands (not dividing H but for one band), halo rows and zero
    borders in plain PyTorch, against the JAX package's fused Pallas tail."""
    x0, p, args = _make(2, h, w, c, seed=h * w + c + bands)
    assert _fused_plan(2, h, w, c, bands) is not None  # a tiling the kernel has
    out, pre11, x1, pre21 = residual_tail_banded_plain(torch.from_numpy(x0), *args, bands)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for i in range(2):
        ref = np.asarray(residual_tail_apply(jnp.asarray(x0[i]), jp, h, w, c))
        np.testing.assert_allclose(out[i].numpy(), ref, atol=2e-5)
    ks = [hwio(t) for t in args[0::2]]
    chain = _forward(torch.from_numpy(x0), ks[0], args[1], ks[1], args[3], ks[2], args[5], ks[3], args[7], conv3x3_plain)
    for name, got, want in zip(("out", "pre11", "x1", "pre21"), (out, pre11, x1, pre21), chain):
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5, msg=name)


def test_cpu_tensors_launch_nothing():
    """At a shape the plan routes to the fused kernel, CPU tensors take the
    plain versions on every entry: no counter moves, and the results are
    the plain chain's."""
    b, hw, c = 27, 50, 32
    assert tail_plan(b, hw, hw, c).family == "fused"
    x0, _, args = _make(b, hw, hw, c, seed=3)
    x = torch.from_numpy(x0)
    names = ("kernel.tail_fwd.all", "kernel.tail_fwd.fused", "kernel.conv3x3.fwd")
    before = [counters().get(k, 0) for k in names]
    ref = residual_tail_plain(x, *args)
    with torch.no_grad():
        out = residual_tail(x, *args)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
    leaves = [t.clone().requires_grad_() for t in args]
    out = residual_tail(x, *leaves)
    out.sum().backward()
    assert all(t.grad is not None for t in leaves)
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=2e-5)
    got, ranges = residual_tail_ranges(x, *args)
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-5)
    assert ranges.shape == (4,) and bool((ranges >= 0).all())
    ks = [hwio(t) for t in args[0::2]]
    fused = residual_tail_fused(x, ks[0], args[1], ks[1], args[3], ks[2], args[5], ks[3], args[7])
    assert fused[1:] == (None, None, None)
    torch.testing.assert_close(fused[0], ref, rtol=0, atol=2e-5)
    kept = residual_tail_fused(x, ks[0], args[1], ks[1], args[3], ks[2], args[5], ks[3], args[7], keep=True)
    assert all(t is not None and t.shape == x.shape for t in kept[1:])
    assert [counters().get(k, 0) for k in names] == before == [0, 0, 0]
