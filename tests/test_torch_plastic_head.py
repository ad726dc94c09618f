"""The port's plastic head (plain version, as a CPU tensor takes it) against
the JAX package's Pallas head in interpret mode and its XLA head."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.ops import PlasticParams, plastic_head_logits
from plastic_unet_tpu.ops.pallas_plastic import fused_plastic_head
from plastic_unet_tpu_torch.ops import plasticity as tplast
from plastic_unet_tpu_torch.ops import plastic_head as head_mod
from plastic_unet_tpu_torch.ops.plastic_head import HeadPlan, head_plan, plastic_head
from plastic_unet_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)


def _inputs(nbf, b, alfa_type, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((nbf, nbf)) * 0.01).astype(np.float32)
    if alfa_type == "yoked":
        alpha = np.array([0.02], np.float32)
    else:
        alpha = (rng.random((nbf, nbf)) * 0.01).astype(np.float32)
    eta = np.array([0.01], np.float32)
    x = rng.standard_normal((b, nbf, nbf)).astype(np.float32)
    hebb = (rng.standard_normal((b, nbf, nbf)) * 0.1).astype(np.float32)
    return x, w, alpha, eta, hebb


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("nbf", [16, 101])
@pytest.mark.parametrize("alfa_type", ["free", "yoked"])
@pytest.mark.parametrize("rule", ["hebb", "oja"])
def test_head_matches_jax(rule, alfa_type, nbf, b):
    x, w, alpha, eta, hebb = _inputs(nbf, b, alfa_type, seed=nbf * 10 + b)
    launches = counters().get("kernel.head.all", 0)
    got = plastic_head(*map(torch.from_numpy, (w, alpha, eta, x, hebb)), rule=rule, alfa_type=alfa_type)
    assert counters().get("kernel.head.all", 0) == launches  # CPU tensors never launch the kernel
    params = PlasticParams(w=jnp.asarray(w), alpha=jnp.asarray(alpha), eta=jnp.asarray(eta))
    for i in range(b):
        fused = fused_plastic_head(jnp.asarray(x[i]), params.w, params.alpha, params.eta,
                                   jnp.asarray(hebb[i]), rule, alfa_type)
        xla = plastic_head_logits(params, jnp.asarray(x[i]), jnp.asarray(hebb[i]), rule=rule, alfa_type=alfa_type)
        for ref in (fused, xla):
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g[i].numpy(), np.asarray(r), atol=1e-5)


def test_row_zero_is_per_sample():
    """The trace update reads row 0 of EACH sample, not batch element 0."""
    x, w, alpha, eta, hebb = map(torch.from_numpy, _inputs(8, 2, "free", seed=1))
    _, y, h = plastic_head(w, alpha, eta, x, hebb, rule="hebb")
    for i in range(2):
        want = (1 - eta) * hebb[i] + eta * torch.outer(x[i, 0], y[i, 0])
        torch.testing.assert_close(h[i], want)


def test_head_rejects_unknown_rule():
    x, w, alpha, eta, hebb = map(torch.from_numpy, _inputs(4, 1, "free", seed=2))
    with pytest.raises(ValueError, match="learning rule"):
        plastic_head(w, alpha, eta, x, hebb, rule="bcm")
    with pytest.raises(ValueError, match="coefficient type"):
        tplast.plastic_head_logits(w, alpha, eta, x, hebb, alfa_type="shared")


@pytest.mark.parametrize("through_trace", [False, True])
@pytest.mark.parametrize("alfa_type", ["free", "yoked"])
@pytest.mark.parametrize("rule", ["hebb", "oja"])
def test_head_grads_match_jax(rule, alfa_type, through_trace):
    """Gradients of w, alpha, activin (and eta, hebb when the loss reads the
    new trace) through the port's autograd.Function against jax.grad through
    the Pallas head's custom_vjp."""
    nbf, b = 16, 2
    x, w, alpha, eta, hebb = _inputs(nbf, b, alfa_type, seed=7)
    rng = np.random.default_rng(8)
    cts = [rng.standard_normal((b, nbf, nbf)).astype(np.float32) for _ in range(3)]
    if not through_trace:
        cts[2] = None

    def jloss(w, alpha, eta, x, hebb):
        total = 0.0
        for i in range(b):
            outs = fused_plastic_head(x[i], w, alpha, eta, hebb[i], rule, alfa_type)
            total = total + sum(jnp.sum(o * ct[i]) for o, ct in zip(outs, cts) if ct is not None)
        return total

    refs = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (w, alpha, eta, x, hebb)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (w, alpha, eta, x, hebb)]
    outs = plastic_head(*ts, rule=rule, alfa_type=alfa_type)
    assert all(o.grad_fn is not None for o in outs)
    sum((o * torch.from_numpy(ct)).sum() for o, ct in zip(outs, cts) if ct is not None).backward()
    for name, t, r in zip(("w", "alpha", "eta", "activin", "hebb"), ts, refs):
        if name == "eta" and not through_trace:
            # no path from activ / activout to eta: absent here, zero in JAX
            assert t.grad is None and float(np.abs(np.asarray(r)).max()) == 0.0
            continue
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-5, err_msg=name)


def test_head_without_grad_tracks_nothing():
    ts = [torch.from_numpy(a) for a in _inputs(8, 1, "free", seed=3)]
    x, w, alpha, eta, hebb = ts
    w.requires_grad_()
    with torch.no_grad():
        outs = plastic_head(w, alpha, eta, x, hebb)
    assert all(o.grad_fn is None for o in outs)


@pytest.mark.parametrize("cotangents", range(1, 8))  # bit i set: output i (activ, activout, new_hebb) has one
@pytest.mark.parametrize("alfa_type", ["free", "yoked"])
@pytest.mark.parametrize("rule", ["hebb", "oja"])
def test_head_backward_recomputes_only_what_it_needs(rule, alfa_type, cotangents):
    """The backward recomputes activ, and activout and the trace only where a
    cotangent reaches them; its gradients equal, bit for bit, those of the
    whole plain head recomputed under autograd."""
    nbf, b = 16, 2
    arrays = _inputs(nbf, b, alfa_type, seed=11)
    rng = np.random.default_rng(12)
    cts = [torch.from_numpy(rng.standard_normal((b, nbf, nbf)).astype(np.float32)) if cotangents >> i & 1 else None
           for i in range(3)]
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays[1:4]] + [torch.from_numpy(arrays[0]).requires_grad_(),
                                                                        torch.from_numpy(arrays[4]).requires_grad_()]
    outs = plastic_head(*ts, rule=rule, alfa_type=alfa_type)
    used = [i for i in range(3) if cts[i] is not None]
    got = torch.autograd.grad([outs[i] for i in used], ts, [cts[i] for i in used], allow_unused=True)
    ps = [t.detach().requires_grad_() for t in ts]
    full = tplast.plastic_head_logits(*ps, rule=rule, alfa_type=alfa_type)
    want = torch.autograd.grad([full[i] for i in used], ps, [cts[i] for i in used], allow_unused=True)
    for name, g, w_ in zip(("w", "alpha", "eta", "activin", "hebb"), got, want):
        assert (g is None) == (w_ is None), name
        assert g is None or torch.equal(g, w_), name


# head_plan: the kernel's tiling, decoded here as csrc/plastic_head.cu decodes it.
PLAN_NS = [1, 2, 16, 31, 32, 33, 101, 128, 200]
PLAN_BS = [1, 2, 3, 127, 128, 129]


def _sample_limit():
    """The largest n whose whole sample fits one block."""
    n = 1
    while True:
        try:
            head_plan(1, n + 1, family="sample")
        except ValueError:
            return n
        n += 1


def _plans(b, n):
    """The plan the kernel would be given, and every family forced where it applies."""
    out = [head_plan(b, n)]
    for family in head_mod.FAMILIES:
        try:
            out.append(head_plan(b, n, family=family))
        except ValueError:
            assert family == "sample"  # the only family with a size limit below these shapes
    return out


def _check_limits(plan):
    gx, gy, gz = plan.grid
    assert gx <= 2 ** 31 - 1 and gy <= 65535 and gz <= 65535
    assert plan.threads % 32 == 0 and plan.threads <= 1024 and plan.smem <= head_mod.SMEM_MAX
    if plan.family == "sample":
        assert plan.threads <= head_mod.SAMPLE_MAXT
    if plan.family == "spread":
        assert plan.threads == head_mod.SPREAD_THREADS


def _writes(plan, n):
    """How often each output (r, c) of one sample is written, block by block
    and, in the staged families, thread by thread (the band's activ staged by
    its thread tiles, row 0's y0 by the thread that holds row 0)."""
    gx, gy, _ = plan.grid
    count = np.zeros((n, n), np.int64)
    if plan.family == "tile":
        t = head_mod.TILE
        assert (gx, gy, plan.threads, plan.smem) == (-(-n // t), -(-n // t), 256, 0)
        for by in range(gy):
            for bx in range(gx):  # 32 x 8 threads, rows ty + 8 i (i < 4), column tx; masked at n
                rows = (by * t + np.arange(8)[:, None] + 8 * np.arange(4)[None, :]).ravel()
                cols = bx * t + np.arange(t)
                rows, cols = rows[rows < n], cols[cols < n]
                np.add.at(count, (rows[:, None], cols[None, :]), 1)
        return count
    tr, tc = ((head_mod.SAMPLE_TR, head_mod.SAMPLE_TC) if plan.family == "sample"
              else (head_mod.SPREAD_TR, head_mod.SPREAD_TC))
    br, bc, xs, es = plan.br, plan.bc, plan.xs, plan.es
    assert (gx, gy) == (-(-n // bc), -(-n // br))
    ct, rt = -(-bc // tc), -(-(br + (n > br)) // tr)
    tid = np.arange(plan.threads)
    computes = tid < rt * ct
    lr0, lc0 = (tid // ct) * tr, (tid % ct) * tc
    assert xs % 8 == 4 and xs >= rt * tr and es % 4 == 0 and es >= ct * tc  # float4 reads stay in the row
    if plan.family == "sample":  # flat x (then eff) and hebb, activin k-major (then activ), row 0, y0
        flat = -(-(n * n + 3) // 4) * 4
        assert (br, bc) == (n, n) and -(-n * n // 4) <= head_mod.SAMPLE_WQ * plan.threads
        assert plan.smem == 4 * (max(n * es, flat) + flat + max(n * xs, n * es) + -(-n // 4) * 4 + es)
    else:
        assert plan.smem == 4 * (max(n * xs, br * es) + 3 * n * es + br + es)
    shape = (int(computes.sum()), tr, tc)  # every (row, column) a computing thread holds
    rows = np.broadcast_to(lr0[computes, None, None] + np.arange(tr)[None, :, None], shape).ravel()
    cols = np.broadcast_to(lc0[computes, None, None] + np.arange(tc)[None, None, :], shape).ravel()
    checked = set()
    for by in range(gy):
        for bx in range(gx):
            r0, c0 = by * br, bx * bc
            nb, nc = min(br, n - r0), min(bc, n - c0)
            if (nb, nc, r0 > 0) not in checked:  # the blocks of one shape decode alike
                checked.add((nb, nc, r0 > 0))
                lz = 0 if r0 == 0 else nb
                stage = np.zeros((nb, es), np.int64)
                np.add.at(stage, (rows[rows < nb], cols[rows < nb]), 1)
                y0 = np.zeros(es, np.int64)
                np.add.at(y0, cols[(rows == lz) & (cols < nc)], 1)
                assert (y0[:nc] == 1).all() and (stage[:, :nc] == 1).all()
            count[r0:r0 + nb, c0:c0 + nc] += 1  # the epilogue: flat over the band's outputs
    return count


@pytest.mark.parametrize("b", PLAN_BS)
def test_head_plan_covers_every_output(b):
    lim = _sample_limit()
    for n in PLAN_NS + [lim, lim + 1]:
        for plan in _plans(b, n):
            _check_limits(plan)
            assert plan.grid[2] == b
            assert (_writes(plan, n) == 1).all(), (b, n, plan)


@pytest.mark.parametrize("n", PLAN_NS + ["limit", "limit+1"])
def test_head_plan_limits_at_the_largest_batch(n):
    lim = _sample_limit()
    n = {"limit": lim, "limit+1": lim + 1}.get(n, n)
    for plan in _plans(head_mod.MAX_BATCH, n):
        _check_limits(plan)
        assert plan.grid[2] == head_mod.MAX_BATCH


def test_head_plan_keeps_the_chosen_families():
    """The serving chunk and lanes=128 take one block a sample; the B=1
    training step bands x column tiles filling the card; batches between
    them the 32x32 tiles."""
    assert head_plan(128, 101) == HeadPlan("sample", (1, 1, 128), 352, 127296, 101, 101, 108, 104)
    assert head_plan(1, 101) == HeadPlan("spread", (26, 5, 1), 128, 16260, 21, 4, 28, 4)
    assert head_plan(1, 101, family="tile") == HeadPlan("tile", (4, 4, 1), 256, 0)
    assert [head_plan(b, 101).family for b in (8, 9, 32, 33)] == ["spread", "tile", "tile", "sample"]
    assert _sample_limit() == 128 and head_plan(128, 129).family == "tile"


def test_head_plan_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="sample family cannot take"):
        head_plan(128, _sample_limit() + 1, family="sample")
    with pytest.raises(ValueError, match="spread family cannot take"):
        head_plan(1, 4000, family="spread")
    with pytest.raises(ValueError, match="family must be one of"):
        head_plan(1, 101, family="square")
    for b, n in ((0, 101), (head_mod.MAX_BATCH + 1, 101), (1, 0)):
        with pytest.raises(ValueError, match="unsupported shape"):
            head_plan(b, n)
