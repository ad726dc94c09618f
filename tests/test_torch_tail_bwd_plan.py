"""The fused residual-tail backward's route (ops.residual_tail.tail_bwd_plan):
its table of routes at the level shapes, the crossover in B, the forced
families, its tilings against the kernel's limits, the workspace, CPU tensors
launching nothing on either route, and residual_tail under autograd at
batches the fused route takes, against the JAX package's Pallas backward in
interpret mode."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.ops.pallas_trunk import residual_tail_apply
from plastic_unet_tpu_torch.ops.conv3x3 import NUM_SMS, SMEM_MAX, SPLIT_MAX_KS, conv3x3_plain, conv3x3_plan, hwio
from plastic_unet_tpu_torch.ops.residual_tail import (
    BWD_MIN_FILL,
    FUSED_TILING,
    _bwd_fused_plan,
    _slots,
    residual_tail,
    residual_tail_backward,
    residual_tail_backward_eight,
    residual_tail_backward_fused,
    residual_tail_backward_plain,
    tail_bwd_plan,
)
from plastic_unet_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

LEVELS = {101: 16, 50: 32, 25: 64, 12: 128, 6: 256}
FIRST = {101: 6, 50: 9}  # the first batch the fused route takes: the batch's pixels fill BWD_MIN_FILL of the card
ROUTES = {(b, hw): "fused" if hw in FIRST and b >= FIRST[hw] else "eight"
          for hw in LEVELS for b in (1, 5, 6, 8, 9, 37, 128)}


@pytest.mark.parametrize("b,hw", sorted(ROUTES))
def test_tail_bwd_plan_routes(b, hw):
    """The fused kernel at 101^2 x 16 and 50^2 x 32 from the crossover on
    (B=1 never), the eight launches at 25^2, 12^2 and 6^2."""
    c = LEVELS[hw]
    p = tail_bwd_plan(b, hw, hw, c)
    assert p.family == ROUTES[(b, hw)]
    if p.family == "eight":
        assert tuple(p)[1:] == (0,) * 7
        return
    assert conv3x3_plan(b, hw, hw, c, c, True).family == "tile" and p.blocks == b * p.bands
    assert (p.px, p.threads) == FUSED_TILING[c]
    assert p == tail_bwd_plan(b, hw, hw, c, family="fused") == _bwd_fused_plan(b, hw, hw, c, p.bands)
    assert all(_bwd_fused_plan(b, hw, hw, c, fewer) is None for fewer in range(1, p.bands))


@pytest.mark.parametrize("hw,c,first,last", [(101, 16, 6, 1024), (50, 32, 9, 1024), (50, 16, 25, 1024),
                                             (25, 32, 33, 123)])
def test_tail_bwd_plan_fused_from_a_fill(hw, c, first, last):
    """The fused backward starts where the batch's pixels fill BWD_MIN_FILL
    of the card's pixel slots (at 101^2 x 16 the fused kernel's first win in
    chip_smoke.py's sweep of both routes was 0.302, the eight launches' last
    at 50^2 x 32 B=8 0.296) and holds on while the eight launches' dgrad
    takes square tiles (at 25^2 x 32 whole samples from B=124, where the
    eight launches won)."""
    assert tail_bwd_plan(first - 1, hw, hw, c).family == "eight"
    assert all(tail_bwd_plan(b, hw, hw, c).family == "fused" for b in (first, first + 1, 3 * first // 2, last))
    assert tail_bwd_plan(last + 1, hw, hw, c).family == ("eight" if last < 1024 else "fused")
    p = tail_bwd_plan(first, hw, hw, c)
    fill = [b * hw * hw / (NUM_SMS * _slots(p.px, p.threads, c)) for b in (first - 1, first)]
    assert fill[0] < BWD_MIN_FILL <= fill[1] and 0.296 < BWD_MIN_FILL <= 0.302


def test_tail_bwd_plan_at_the_levels():
    """101^2 x 16 in 8 bands of <= 13 rows and 50^2 x 32 in 5 of <= 10 (clusters
    of 8 and 5, the sizes the card runs most of at once), one weight slice a
    stage, the workspace one partial a sample and stage."""
    p, q = tail_bwd_plan(128, 101, 101, 16), tail_bwd_plan(128, 50, 50, 32)
    assert (p.bands, p.rows, p.threads, q.bands, q.rows, q.threads) == (8, 13, 384, 5, 10, 256)
    assert p.workspace == 128 * 4 * (9 * 16 * 16 + 16) and q.workspace == 128 * 4 * (9 * 32 * 32 + 32)


def _check_fused(p, b, h, w, c):
    assert p.family == "fused" and 1 <= p.bands <= min(h, SPLIT_MAX_KS)  # one cluster a sample, at most 16 blocks
    assert p.smem <= SMEM_MAX and p.blocks == b * p.bands
    edges = [k * h // p.bands for k in range(p.bands + 1)]
    rows = np.diff(edges)
    assert edges[0] == 0 and edges[-1] == h and rows.min() >= 1 and rows.max() == p.rows == -(-h // p.bands)
    assert p.rows * w <= p.px * p.threads // (c // 16)  # every pixel of a band has a thread
    band = (((p.rows + 2) * (w + 1) + 1) * (c + 1) + 3) // 4 * 4
    sums = 9 * c * c + c
    assert p.smem == 4 * (2 * band + 9 * 16 * c + (sums + 3) // 4 * 4)  # two band buffers, a weight slice, the sums
    assert p.workspace == b * 4 * sums


@pytest.mark.parametrize("b,h,w,c", [(128, 101, 101, 16), (128, 50, 50, 32), (1024, 101, 101, 16), (1, 101, 101, 16),
                                     (3, 50, 50, 32), (2, 13, 13, 16), (2, 10, 11, 32), (5, 37, 5, 32),
                                     (128, 50, 50, 16), (128, 25, 25, 32)])
def test_bwd_fused_plans_fit_the_kernel(b, h, w, c):
    """Every band count a shape can take: shared memory, thread grid, bands, workspace."""
    plans = [p for n in range(0, SPLIT_MAX_KS + 2) if (p := _bwd_fused_plan(b, h, w, c, n))]
    for p in plans:
        _check_fused(p, b, h, w, c)
    assert plans and plans[0] == tail_bwd_plan(b, h, w, c, family="fused")


def test_tail_bwd_plan_forcing():
    assert tail_bwd_plan(128, 101, 101, 16, family="eight").family == "eight"
    assert tail_bwd_plan(1, 101, 101, 16, family="fused").family == "fused"  # the plan takes eight launches there
    assert tail_bwd_plan(1, 101, 101, 16).family == "eight"
    with pytest.raises(ValueError):
        tail_bwd_plan(128, 101, 101, 16, family="four")
    for shape in [(128, 25, 25, 64), (128, 12, 12, 128), (128, 6, 6, 256), (128, 101, 101, 8)]:
        with pytest.raises(ValueError):  # no tiling for the widths the kernel does not have
            tail_bwd_plan(*shape, family="fused")
        assert tail_bwd_plan(*shape).family == "eight"
    assert _bwd_fused_plan(128, 101, 101, 16, 0) is None and _bwd_fused_plan(128, 101, 101, 16, SPLIT_MAX_KS + 1) is None


NAMES = ("11", "12", "21", "22")


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


def _saved(x0, args):
    """What the forward keeps, from the plain convs: x0, pre11, x1, pre21, out."""
    w11, b11, w12, b12, w21, b21, w22, b22 = args
    pre11 = conv3x3_plain(x0, hwio(w11), b11, relu_in=True)
    x1 = conv3x3_plain(pre11, hwio(w12), b12, x0, relu_in=True, relu_res=True)
    pre21 = conv3x3_plain(x1, hwio(w21), b21, relu_in=True)
    out = conv3x3_plain(pre21, hwio(w22), b22, x1, relu_in=True, relu_res=True, relu_out=True)
    return x0, pre11, x1, pre21, out


def test_cpu_tensors_launch_nothing_on_either_route():
    """At a shape the plan routes to the fused kernel, CPU tensors take the
    plain chain on every entry: each route's results are the plain chain's,
    bit for bit, and no counter moves."""
    b, hw, c = 9, 50, 32
    assert tail_bwd_plan(b, hw, hw, c).family == "fused"
    x0, _, args = _make(b, hw, hw, c, seed=4)
    saved = _saved(torch.from_numpy(x0), args)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(x0.shape).astype(np.float32))
    ws = args[0::2]
    ks = [hwio(t) for t in ws]
    names = ("kernel.tail_bwd.all", "kernel.tail_bwd.fused", "kernel.conv3x3.dgrad", "kernel.wgrad.all")
    before = [counters().get(k, 0) for k in names]
    ref = residual_tail_backward_plain(g, *saved, *ws)
    for fn in (residual_tail_backward, residual_tail_backward_fused, residual_tail_backward_eight):
        got = fn(g, *saved, *ks)
        assert len(got) == 9 and all(torch.equal(a, r) for a, r in zip(got, ref))
    assert [counters().get(k, 0) for k in names] == before


def _jax_grads(x0, p, ct, h, w, c):
    """jax.grad through the Pallas forward and backward kernels, one sample."""
    def loss(x0, p):
        return jnp.sum(residual_tail_apply(x0, p, h, w, c) * ct)

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x0), {k: jnp.asarray(v) for k, v in p.items()})
    return np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, atol=3e-5 * max(1.0, float(np.abs(ref).max())), err_msg=what)


@pytest.mark.parametrize("b,h,w,c", [(6, 101, 101, 16), (9, 50, 50, 32)])
def test_fused_route_grads_match_pallas(b, h, w, c):
    """residual_tail under autograd at the first batch the fused backward
    takes (CPU tensors: the plain chain by that route) against jax.grad
    through the JAX package's fused Pallas tail, sample by sample; the
    parameter gradients summed over the batch."""
    assert tail_bwd_plan(b, h, w, c).family == "fused"
    x0, p, args = _make(b, h, w, c, seed=h + c)
    ct = np.random.default_rng(9).standard_normal(x0.shape).astype(np.float32)
    refs = [_jax_grads(x0[i], p, ct[i], h, w, c) for i in range(b)]
    tx = torch.from_numpy(x0).requires_grad_()
    leaves = [t.requires_grad_() for t in args]
    counts = tuple(counters().get(k, 0) for k in ("kernel.tail_bwd.all", "kernel.tail_bwd.fused"))
    out = residual_tail(tx, *leaves)
    (out * torch.from_numpy(ct)).sum().backward()
    assert tuple(counters().get(k, 0) for k in ("kernel.tail_bwd.all", "kernel.tail_bwd.fused")) == counts
    for i in range(b):
        _close(tx.grad[i].numpy(), refs[i][0], f"dx0[{i}]")
    for k, name in enumerate(NAMES):
        dw = sum(r[1]["w" + name] for r in refs)
        db = sum(r[1]["b" + name] for r in refs)
        _close(np.transpose(leaves[2 * k].grad.numpy(), (2, 3, 1, 0)), dw, "w" + name)
        _close(leaves[2 * k + 1].grad.numpy(), db, "b" + name)
