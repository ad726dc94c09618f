"""The port's 3x3 conv (plain version, as a CPU tensor takes it), with every
fused flag, against the JAX package's Pallas conv3x3_flat in interpret mode;
its input-gradient form and its weight gradient against jax.vjp of
lax.conv_general_dilated."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.ops.pallas_conv import conv3x3_flat, flatten_hw, pack_weights, unflatten_hw
from plastic_unet_tpu_torch.ops.conv3x3 import (NUM_SMS, SAMPLE_THREADS, SAMPLE_TN, SMEM_MAX, SPLIT_MAX_KS,
                                                SPLIT_THREADS, SPLIT_TP, XCS, _sample_stage_floats, conv3x3,
                                                conv3x3_dgrad, conv3x3_plan, hwio)
from plastic_unet_tpu_torch.ops.conv3x3_wgrad import (ONE_CHUNK_PIXELS, TARGET_BLOCKS, _stage_bytes, conv3x3_wgrad,
                                                       wgrad_plan)
from plastic_unet_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

SHAPES = [(13, 16, 16), (25, 8, 16), (101, 16, 16), (12, 32, 8)]  # (hw, cin, cout)
# (relu_in, residual: None | "plain" | "relu", relu_out)
FLAGS = [(False, None, False), (True, None, False), (False, None, True),
         (True, "plain", False), (False, "relu", True), (True, "relu", True)]


def _jax_ref(x, w_oihw, b, res, relu_in, res_mode, relu_out):
    """One sample through conv3x3_flat, the other flags composed around it."""
    hw = x.shape[0]
    xin = np.maximum(x, 0) if relu_in else x
    w = jnp.asarray(np.transpose(w_oihw, (2, 3, 1, 0)))
    y = unflatten_hw(conv3x3_flat(flatten_hw(jnp.asarray(xin)), pack_weights(w), jnp.asarray(b), hw, hw), hw, hw)
    y = np.asarray(y)
    if res_mode == "plain":
        y = y + res
    elif res_mode == "relu":
        y = y + np.maximum(res, 0)
    return np.maximum(y, 0) if relu_out else y


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("hw,cin,cout", SHAPES)
def test_conv3x3_matches_pallas(hw, cin, cout, flags):
    relu_in, res_mode, relu_out = flags
    rng = np.random.default_rng(hw * 100 + cin + cout)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 3)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    res = rng.standard_normal((2, hw, hw, cout)).astype(np.float32)
    launches = counters().get("kernel.conv3x3.fwd", 0)
    got = conv3x3(torch.from_numpy(x), hwio(torch.from_numpy(w)), torch.from_numpy(b),
                  None if res_mode is None else torch.from_numpy(res),
                  relu_in=relu_in, relu_res=res_mode == "relu", relu_out=relu_out).numpy()
    assert counters().get("kernel.conv3x3.fwd", 0) == launches  # CPU tensors never launch the kernel
    for i in range(2):
        ref = _jax_ref(x[i], w, b, res[i], relu_in, res_mode, relu_out)
        np.testing.assert_allclose(got[i], ref, atol=1e-5)


def test_hwio_layout():
    w = torch.arange(2 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 3)
    k = hwio(w)
    assert k.shape == (3, 3, 3, 2) and k.is_contiguous()
    assert k[1, 2, 0, 1] == w[1, 0, 1, 2]


def _jax_conv_vjp(x, w_hwio, d):
    """(dx, dw, db) of the batched SAME conv + bias at the output gradient d."""
    def conv(x, w, b):
        dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
        return jax.lax.conv_general_dilated(x, w, (1, 1), "SAME", dimension_numbers=dn) + b

    b = jnp.zeros((w_hwio.shape[3],), jnp.float32)
    _, vjp = jax.vjp(conv, jnp.asarray(x), jnp.asarray(w_hwio), b)
    return [np.asarray(t) for t in vjp(jnp.asarray(d))]


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, atol=3e-5 * max(1.0, float(np.abs(ref).max())), err_msg=what)


GRAD_SHAPES = [(13, 16, 16), (9, 8, 24), (25, 32, 32), (6, 40, 16)]  # (hw, cin, cout)
# (in_gate, residual, gate): the four lines of the tail's reverse chain, and none
DGRAD_FLAGS = [(False, False, False), (True, False, True), (False, True, True), (False, False, True),
               (True, True, True)]


@pytest.mark.parametrize("flags", DGRAD_FLAGS)
@pytest.mark.parametrize("hw,cin,cout", GRAD_SHAPES)
def test_dgrad_matches_jax_vjp(hw, cin, cout, flags):
    use_in_gate, use_res, use_gate = flags
    rng = np.random.default_rng(hw + cin * 7 + cout)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    d = rng.standard_normal((2, hw, hw, cout)).astype(np.float32)
    in_gate = rng.standard_normal(d.shape).astype(np.float32)
    res = rng.standard_normal(x.shape).astype(np.float32)
    gate = rng.standard_normal(x.shape).astype(np.float32)
    launches = counters().get("kernel.conv3x3.dgrad", 0)
    got, masked = conv3x3_dgrad(
        torch.from_numpy(d), torch.from_numpy(w), torch.from_numpy(res) if use_res else None,
        gate=torch.from_numpy(gate) if use_gate else None, in_gate=torch.from_numpy(in_gate) if use_in_gate else None)
    assert counters().get("kernel.conv3x3.dgrad", 0) == launches  # CPU tensors never launch the kernel
    d_eff = d * (in_gate > 0) if use_in_gate else d
    ref = _jax_conv_vjp(x, w, d_eff)[0]
    if use_res:
        ref = ref + res
    if use_gate:
        ref = ref * (gate > 0)
    _close(got.numpy(), ref, "dx")
    if use_in_gate:
        np.testing.assert_array_equal(masked.numpy(), d_eff)
    else:
        assert masked is None


@pytest.mark.parametrize("relu_in", [False, True])
@pytest.mark.parametrize("layout", ["hwio", "oihw"])
@pytest.mark.parametrize("hw,cin,cout", GRAD_SHAPES)
def test_wgrad_matches_jax_vjp(hw, cin, cout, layout, relu_in):
    rng = np.random.default_rng(hw * 3 + cin + cout)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32)
    d = rng.standard_normal((2, hw, hw, cout)).astype(np.float32)
    launches = counters().get("kernel.wgrad.all", 0)
    dw, db = conv3x3_wgrad(torch.from_numpy(x), torch.from_numpy(d), relu_in=relu_in, layout=layout)
    assert counters().get("kernel.wgrad.all", 0) == launches
    _, dw_ref, db_ref = _jax_conv_vjp(np.maximum(x, 0) if relu_in else x, w, d)
    if layout == "oihw":
        dw_ref = np.transpose(dw_ref, (3, 2, 0, 1))
    _close(dw.numpy(), dw_ref, "dw")
    _close(db.numpy(), db_ref, "db")


@pytest.mark.parametrize("relu_out", [False, True])
@pytest.mark.parametrize("relu_in", [False, True])
def test_dgrad_and_wgrad_compose_to_the_conv_gradient(relu_in, relu_out):
    """One dgrad and one wgrad, with the ReLU masks as gates the way the
    residual tail's reverse chain passes them, against jax.grad of
    relu?(conv(relu?(x)) + b)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 9, 8)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 8, 16)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    ct = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)

    def jloss(x, w, b):
        dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
        y = jax.lax.conv_general_dilated(jax.nn.relu(x) if relu_in else x, w, (1, 1), "SAME",
                                         dimension_numbers=dn) + b
        return jnp.sum((jax.nn.relu(y) if relu_out else y) * ct)

    refs = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, b)))
    tx, tw, tb, tct = (torch.from_numpy(a) for a in (x, w, b, ct))
    out = conv3x3(tx, tw, tb, relu_in=relu_in, relu_out=relu_out)
    dx, dy = conv3x3_dgrad(tct, tw, gate=tx if relu_in else None, in_gate=out if relu_out else None)
    dw, db = conv3x3_wgrad(tx, tct if dy is None else dy, relu_in=relu_in)
    for name, got, ref in zip(("x", "w", "b"), (dx, dw, db), refs):
        _close(got.numpy(), np.asarray(ref), name)


@pytest.mark.parametrize("b,h,w,cin,cout", [(1, 101, 101, 16, 16), (128, 101, 101, 16, 16), (1, 6, 6, 256, 256),
                                            (128, 6, 6, 256, 256), (1, 12, 12, 128, 128), (3, 25, 25, 64, 64),
                                            (5, 6, 6, 256, 256), (8, 101, 101, 16, 16), (2, 101, 101, 16, 16),
                                            (3, 13, 7, 40, 24), (128, 12, 12, 128, 128), (40, 6, 6, 64, 64)])
def test_wgrad_plan_covers_every_tile(b, h, w, cin, cout):
    """The kernel's tiles, decoded as the kernel decodes them, cover every
    (sample, row) once; chunks are runs of whole tiles, none empty; the grid
    fills the card as far as the work allows; a block fits shared memory."""
    p = wgrad_plan(b, h, w, cin, cout)
    assert p.samples == 1 or p.rows == h  # several samples per tile only whole
    tps = -(-h // p.rows)
    assert p.tiles == -(-b // p.samples) * tps
    seen = np.zeros((b, h), int)
    for t in range(p.tiles):
        b0, y0 = (t // tps) * p.samples, (t % tps) * p.rows
        seen[b0:b0 + p.samples, y0:y0 + p.rows] += 1
    assert (seen == 1).all()
    bounds = [k * p.tiles // p.chunks for k in range(p.chunks + 1)]
    assert 1 <= p.chunks <= p.tiles and all(hi > lo for lo, hi in zip(bounds, bounds[1:]))
    slices = -(-cin // p.ci_t) * -(-cout // p.co_t)
    if b * h * w <= ONE_CHUNK_PIXELS:
        assert p.chunks == 1  # one launch
    else:
        assert p.chunks == min(p.tiles, max(1, TARGET_BLOCKS // slices))
        assert p.chunks * slices <= max(TARGET_BLOCKS, slices)
    stages = 2 if p.tiles > p.chunks else 1
    assert stages * _stage_bytes(w, p.ci_t, p.co_t, p.rows, p.samples) <= p.smem <= 232448


def _split_blocks(p, b, h, w, cout, k):
    """The flat output indices the threads of range k's blocks sum, decoded
    from the plan as the split kernel decodes blockIdx and threadIdx (tap
    group 0, which holds the block's partial sums)."""
    bands, ngr = -(-h // p.rows), p.nt // SAMPLE_TN
    tid = np.arange(SPLIT_THREADS)
    ng, pg = tid % ngr, tid // ngr
    got = []
    for bx in range(b * bands):
        bb, y0 = bx // bands, (bx % bands) * p.rows
        npix = min(p.rows, h - y0) * w
        pgs = -(-npix // SPLIT_TP)
        assert pgs * ngr <= SPLIT_THREADS  # enough threads for the band's pixels
        for by in range(-(-cout // p.nt)):
            pix = pg[:, None, None] + np.arange(SPLIT_TP)[None, :, None] * pgs
            n = by * p.nt + (ng * SAMPLE_TN)[:, None, None] + np.arange(SAMPLE_TN)
            pix, n, pgb = np.broadcast_arrays(pix, n, pg[:, None, None])
            ok = (pgb < pgs) & (pix < npix) & (n < cout)
            got.append((((bb * h + y0) * w + pix) * cout + n)[ok].ravel())
    return np.concatenate(got)


def _split_stores(p, b, h, w, cout):
    """The flat output indices the split kernel stores: block k of a tile's
    cluster stores the k-th of ks shares of the tile's four-channel elements."""
    bands, q = -(-h // p.rows), p.nt // 4
    got = []
    for bx in range(b * bands):
        bb, y0 = bx // bands, (bx % bands) * p.rows
        nel = min(p.rows, h - y0) * w * q
        for by in range(-(-cout // p.nt)):
            for k in range(p.ks):
                e = np.arange(k * nel // p.ks, (k + 1) * nel // p.ks)
                n = by * p.nt + 4 * (e % q)[:, None] + np.arange(4)
                flat = ((bb * h + y0) * w + (e // q)[:, None]) * cout + n
                got.append(flat[n < cout])
    return np.concatenate(got)


def _written(p, b, h, w, cout):
    """How often the kernel's threads write each (b, y, x, co), decoded from
    the plan as the kernel decodes blockIdx and threadIdx."""
    if p.family == "split":
        return np.bincount(_split_stores(p, b, h, w, cout), minlength=b * h * w * cout)
    if p.family == "tile":
        th, tw = (16, 8) if p.nt == 16 else (8, 8)
        ngr = p.nt // 4
        tid = np.arange(128)
        ng, pg = tid % ngr, tid // ngr
        py, px = pg // (tw // 4), (pg % (tw // 4)) * 4
        tiles_w = -(-w // tw)
        bx, by, bz = np.meshgrid(np.arange(tiles_w * -(-h // th)), np.arange(-(-cout // p.nt)), np.arange(b),
                                 indexing="ij")
        oy = (bx // tiles_w * th)[..., None, None, None] + py[:, None, None]
        ox = (bx % tiles_w * tw)[..., None, None, None] + px[:, None, None] + np.arange(4)[None, :, None]
        n = (by * p.nt)[..., None, None, None] + (ng * 4)[:, None, None] + np.arange(4)[None, None, :]
        bb, oy, ox, n = np.broadcast_arrays(bz[..., None, None, None], oy, ox, n)
        ok = (oy < h) & (ox < w) & (n < cout)
        flat = ((bb * h + oy) * w + ox) * cout + n
    else:
        ngr = p.nt // SAMPLE_TN
        tid = np.arange(SAMPLE_THREADS)
        ng, pg = tid % ngr, tid // ngr
        bx, by = np.meshgrid(np.arange(-(-b // p.samples)), np.arange(-(-cout // p.nt)), indexing="ij")
        b0 = (bx * p.samples)[..., None, None, None]
        npix = np.minimum(p.samples, b - b0) * h * w
        pix = pg[:, None, None] + np.arange(p.tp)[None, :, None] * (SAMPLE_THREADS // ngr)
        n = (by * p.nt)[..., None, None, None] + (ng * SAMPLE_TN)[:, None, None] + np.arange(SAMPLE_TN)
        b0, npix, pix, n = np.broadcast_arrays(b0, npix, pix, n)
        ok = (pix < npix) & (n < cout)
        flat = (b0 * h * w + pix) * cout + n
    return np.bincount(flat[ok].ravel(), minlength=b * h * w * cout)


_LEVEL_CASES = [(bb, hw, hw, c, c) for bb in (1, 128) for hw, c in
                [(101, 16), (50, 32), (25, 64), (12, 128), (6, 256)]]


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("b,h,w,cin,cout", _LEVEL_CASES + [(5, 6, 6, 256, 256), (3, 13, 7, 40, 24),
                                                           (2, 9, 9, 6, 10)])
def test_conv3x3_plan_covers_every_output(b, h, w, cin, cout, flip):
    """Every output is written exactly once by the plan's grid; grids of
    square tiles no larger than the card split K where Cin has two slices,
    and the rest keep the first design's routing at B=1 and the levels of
    side 50 and more; a block fits shared memory. Cases the rule gives the
    square tiles are also decoded in the whole-sample family, which the chip
    run holds at them too."""
    p = conv3x3_plan(b, h, w, cin, cout, flip)
    if p.family == "split":
        blocks = -(-h // (16 if cout <= 16 else 8)) * -(-w // 8) * -(-cout // (16 if cout <= 16 else 32)) * b
        assert blocks <= NUM_SMS and cin >= 32
    elif b == 1 or h >= 50:
        nt = 16 if cout <= 16 else 32
        blocks = -(-h // (16 if nt == 16 else 8)) * -(-w // 8) * -(-cout // nt) * b
        assert blocks > NUM_SMS or cin < 32
        assert (p.family, p.nt, p.tg) == ("tile", nt, 1)
    elif b == 128:
        assert p.family == "sample"  # 25^2, 12^2, 6^2 at B=128
    plans = [p] if p.family == "sample" or h * w > 625 else [p, conv3x3_plan(b, h, w, cin, cout, flip, family="sample")]
    for q in plans:
        assert (_written(q, b, h, w, cout) == 1).all()
        assert q.smem <= SMEM_MAX
        if q.family == "sample":
            gate = q.samples * h * w * 16 if flip else 0
            assert q.smem == 4 * (2 * _sample_stage_floats(h, w, q.samples, q.nt, flip) + gate)
            cap = SAMPLE_THREADS // (q.nt // SAMPLE_TN) * q.tp
            assert 1 <= q.samples * h * w <= cap


# The parent's plans at the ten level shapes (family, nt, kg, tp, samples, smem, blocks), forward and dgrad:
# every launch that does not split K keeps them.
_PARENT_PLANS = {
    (1, 101, False): ("tile", 16, 1, 0, 1, 21456, 91), (1, 50, False): ("tile", 32, 2, 0, 1, 50464, 49),
    (1, 25, False): ("tile", 32, 4, 0, 1, 100928, 32), (1, 12, False): ("tile", 32, 4, 0, 1, 100928, 16),
    (1, 6, False): ("tile", 32, 4, 0, 1, 100928, 8), (128, 101, False): ("tile", 16, 1, 0, 1, 21456, 11648),
    (128, 50, False): ("tile", 32, 1, 0, 1, 25232, 6272), (128, 25, False): ("sample", 32, 1, 10, 1, 132480, 256),
    (128, 12, False): ("sample", 32, 1, 5, 2, 86528, 256), (128, 6, False): ("sample", 32, 1, 5, 8, 97952, 128),
    (1, 101, True): ("tile", 16, 1, 0, 1, 23760, 91), (1, 50, True): ("tile", 32, 2, 0, 1, 55072, 49),
    (1, 25, True): ("tile", 32, 4, 0, 1, 110144, 32), (1, 12, True): ("tile", 32, 4, 0, 1, 110144, 16),
    (1, 6, True): ("tile", 32, 4, 0, 1, 110144, 8), (128, 101, True): ("tile", 16, 1, 0, 1, 23760, 11648),
    (128, 50, True): ("tile", 32, 1, 0, 1, 27536, 6272), (128, 25, True): ("sample", 32, 1, 10, 1, 177088, 256),
    (128, 12, True): ("sample", 32, 1, 5, 2, 109568, 256), (128, 6, True): ("sample", 32, 1, 5, 8, 120992, 128),
}
_LEVEL_C = {101: 16, 50: 32, 25: 64, 12: 128, 6: 256}


@pytest.mark.parametrize("b,hw,flip", sorted(_PARENT_PLANS))
def test_conv3x3_plan_keeps_the_parent_plan(b, hw, flip):
    """Every B=128 level and every Cin below 32 get exactly the parent's
    plan; the B=1 levels with two slices or more of Cin split K on a grid
    of at least 128 blocks, where the parent's square tiles had at most 49."""
    c = _LEVEL_C[hw]
    p = conv3x3_plan(b, hw, hw, c, c, flip)
    parent = _PARENT_PLANS[(b, hw, flip)]
    if b == 128 or c < 32:
        assert tuple(p) == parent + (0, 1)
    else:
        assert parent[6] <= NUM_SMS and p.family == "split" and p.blocks >= 128


@pytest.mark.parametrize("b,h,w,cin,cout", [(128, 12, 12, 128, 128), (40, 25, 25, 64, 64), (8, 101, 101, 16, 16),
                                            (2, 101, 101, 16, 16), (1, 101, 101, 16, 16), (1, 30, 30, 16, 16),
                                            (9, 50, 50, 32, 32), (37, 6, 6, 256, 256)])
def test_conv3x3_plan_splits_only_small_grids(b, h, w, cin, cout):
    """Grids of more than NUM_SMS square tiles, and Cin of one slice, never
    take the split family; "tile" and "sample" keep their forced plans."""
    for flip in (False, True):
        p = conv3x3_plan(b, h, w, cin, cout, flip)
        tile = conv3x3_plan(b, h, w, cin, cout, flip, family="tile")
        assert p.family != "split" and (p.rows, p.ks) == (0, 1)
        assert tile.blocks > NUM_SMS or cin < 32
        assert p == tile or p.family == "sample"


@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("b,h,w,cin,cout", [(1, hw, hw, c, c) for hw, c in _LEVEL_C.items()]
                         + [(1, 13, 7, 40, 24), (1, 9, 9, 48, 10), (2, 6, 6, 256, 256)])
def test_split_plan_covers_every_output(b, h, w, cin, cout, flip):
    """The split family, forced where the plan would not take it: every
    output is summed exactly once in every range and written once; every
    16-channel slice of Cin lies in exactly one range, ascending within it;
    a tile's ranges fit one cluster, and a block's staging, partial tile and
    tap-group sums fit shared memory."""
    p = conv3x3_plan(b, h, w, cin, cout, flip, family="split")
    assert p.family == "split" and p.tp == SPLIT_TP
    for k in range(p.ks):
        assert (np.bincount(_split_blocks(p, b, h, w, cout, k), minlength=b * h * w * cout) == 1).all()
    assert (_written(p, b, h, w, cout) == 1).all()
    nsl = -(-cin // 16)
    ranges = [list(range(k * nsl // p.ks, (k + 1) * nsl // p.ks)) for k in range(p.ks)]
    assert sorted(s for r in ranges for s in r) == list(range(nsl)) and all(r for r in ranges)
    bands, ncs = -(-h // p.rows), -(-cout // p.nt)
    assert p.blocks == b * bands * ncs * p.ks and p.ks <= SPLIT_MAX_KS
    stages = min(2, max(map(len, ranges)))
    xs = (((p.rows + 2) * (w + 1) + 1) * XCS + 3) // 4 * 4
    gate = (p.rows + 2) * w * 16 if flip else 0
    cpt = -(-p.rows * w // SPLIT_TP) * (p.nt // SAMPLE_TN)  # threads of a tap group
    assert p.tg == min(9, SPLIT_THREADS // cpt) >= 1  # tap groups: as many as the threads allow
    taps = [list(range(9 * t // p.tg, 9 * (t + 1) // p.tg)) for t in range(p.tg)]
    assert sum(taps, []) == list(range(9)) and all(taps)
    staged = stages * (xs + 9 * 16 * (2 * p.nt + 4 if flip else p.nt)) + gate
    sums = p.rows * w * p.nt + max(p.tg * SPLIT_TP * SAMPLE_TN * cpt, p.rows * w * p.nt)
    assert p.smem == 4 * max(staged, sums) <= SMEM_MAX
    assert conv3x3_plan(b, h, w, cin, cout, flip, family="split", variant=(p.nt, p.ks, p.rows)) == p
