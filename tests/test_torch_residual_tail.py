"""The port's residual tail (plain versions, as a CPU tensor takes them)
against the JAX package's fused Pallas tail in interpret mode: the forward,
batched B=2 against B=1 per sample; the autograd.Function's gradients and the
step-by-step reverse chain against jax.grad through the Pallas backward."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.ops.pallas_trunk import residual_tail_apply
from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_plain, hwio
from plastic_unet_tpu_torch.ops.residual_tail import (
    residual_tail,
    residual_tail_backward,
    residual_tail_backward_plain,
    residual_tail_plain,
)
from plastic_unet_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

NAMES = ("11", "12", "21", "22")


def _make(h, w, c, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((2, h, w, c)).astype(np.float32)
    p = {}
    for name in NAMES:
        p["w" + name] = (rng.standard_normal((3, 3, c, c)) * (0.5 / (3 * np.sqrt(c)))).astype(np.float32)
        p["b" + name] = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x0, p


def _torch_args(p):
    args = []
    for name in NAMES:
        args.append(torch.from_numpy(np.ascontiguousarray(np.transpose(p["w" + name], (3, 2, 0, 1)))))
        args.append(torch.from_numpy(p["b" + name]))
    return args


@pytest.mark.parametrize("h,w,c", [(13, 13, 16), (10, 11, 32), (5, 5, 128)])
def test_tail_matches_pallas(h, w, c):
    x0, p = _make(h, w, c, seed=h * w + c)
    launches = tuple(counters().get(k, 0) for k in ("kernel.tail_fwd.all", "kernel.conv3x3.fwd"))
    got = residual_tail(torch.from_numpy(x0), *_torch_args(p)).numpy()
    assert tuple(counters().get(k, 0) for k in ("kernel.tail_fwd.all", "kernel.conv3x3.fwd")) == launches
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for i in range(2):
        ref = np.asarray(residual_tail_apply(jnp.asarray(x0[i]), jp, h, w, c))
        np.testing.assert_allclose(got[i], ref, atol=2e-5)
        single = residual_tail(torch.from_numpy(x0[i : i + 1]), *_torch_args(p)).numpy()
        np.testing.assert_allclose(got[i], single[0], atol=2e-5)


VJP_SHAPES = [(13, 13, 16), (10, 11, 32), (5, 5, 128), (4, 4, 256), (21, 19, 8)]


def _jax_grads(x0, p, ct, h, w, c):
    """jax.grad through the Pallas forward and backward kernels, one sample."""
    def loss(x0, p):
        return jnp.sum(residual_tail_apply(x0, p, h, w, c) * ct)

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x0), {k: jnp.asarray(v) for k, v in p.items()})
    return np.asarray(gx), {k: np.asarray(v) for k, v in gp.items()}


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, atol=3e-5 * max(1.0, float(np.abs(ref).max())), err_msg=what)


def _check_param_grads(grads, gp_ref):
    """grads: dw11, db11, ..., db22 in torch layout, summed over the batch."""
    for i, name in enumerate(NAMES):
        _close(np.transpose(grads[2 * i].numpy(), (2, 3, 1, 0)), gp_ref["w" + name], "w" + name)
        _close(grads[2 * i + 1].numpy(), gp_ref["b" + name], "b" + name)


@pytest.mark.parametrize("h,w,c", VJP_SHAPES)
def test_tail_function_grads_match_pallas(h, w, c):
    x0, p = _make(h, w, c, seed=h + w + c)
    ct = np.random.default_rng(9).standard_normal(x0.shape).astype(np.float32)
    refs = [_jax_grads(x0[i], p, ct[i], h, w, c) for i in range(2)]
    gp_ref = {k: refs[0][1][k] + refs[1][1][k] for k in refs[0][1]}
    tx = torch.from_numpy(x0).requires_grad_()
    args = [t.requires_grad_() for t in _torch_args(p)]
    counts = tuple(counters().get(k, 0) for k in ("kernel.tail_bwd.all", "kernel.conv3x3.dgrad", "kernel.wgrad.all"))
    out = residual_tail(tx, *args)
    assert out.grad_fn is not None
    (out * torch.from_numpy(ct)).sum().backward()
    assert tuple(counters().get(k, 0) for k in ("kernel.tail_bwd.all", "kernel.conv3x3.dgrad", "kernel.wgrad.all")) == counts
    for i in range(2):
        _close(tx.grad[i].numpy(), refs[i][0], "dx0")
    _check_param_grads([a.grad for a in args], gp_ref)


@pytest.mark.parametrize("h,w,c", VJP_SHAPES)
def test_tail_backward_plain_matches_pallas_and_autograd(h, w, c):
    """The reverse chain written out from the saved activations, against
    jax.grad through the Pallas kernels and torch.autograd of the unfused
    plain forward."""
    x0, p = _make(h, w, c, seed=3 * h + c)
    ct = np.random.default_rng(4).standard_normal(x0.shape).astype(np.float32)
    refs = [_jax_grads(x0[i], p, ct[i], h, w, c) for i in range(2)]
    gp_ref = {k: refs[0][1][k] + refs[1][1][k] for k in refs[0][1]}
    tx, g = torch.from_numpy(x0), torch.from_numpy(ct)
    ws = _torch_args(p)
    (w11, b11, w12, b12, w21, b21, w22, b22) = ws
    h1 = torch.relu(tx)
    pre11 = conv3x3_plain(h1, hwio(w11), b11)
    x1 = conv3x3_plain(torch.relu(pre11), hwio(w12), b12) + h1
    pre21 = conv3x3_plain(torch.relu(x1), hwio(w21), b21)
    out = torch.relu(conv3x3_plain(torch.relu(pre21), hwio(w22), b22) + torch.relu(x1))
    got = residual_tail_backward_plain(g, tx, pre11, x1, pre21, out, w11, w12, w21, w22)
    for i in range(2):
        _close(got[0][i].numpy(), refs[i][0], "dx0")
    _check_param_grads(got[1:], gp_ref)

    leaves = [tx.clone().requires_grad_()] + [t.clone().requires_grad_() for t in ws]
    auto = torch.autograd.grad((residual_tail_plain(*leaves) * g).sum(), leaves)
    for name, a, b in zip(["dx0"] + ["d" + n for n in "w11 b11 w12 b12 w21 b21 w22 b22".split()], got, auto):
        _close(a.numpy(), b.numpy(), name)
    # the wrapper takes the same plain chain for CPU tensors, (3,3,C,C) weights
    same = residual_tail_backward(g, tx, pre11, x1, pre21, out, *(hwio(t) for t in (w11, w12, w21, w22)))
    for a, b in zip(got, same):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tail_saves_nothing_without_grad():
    x0, p = _make(7, 7, 8, seed=1)
    args = [t.requires_grad_() for t in _torch_args(p)]
    with torch.no_grad():
        out = residual_tail(torch.from_numpy(x0), *args)
    assert out.grad_fn is None and not out.requires_grad
    ref = residual_tail_plain(torch.from_numpy(x0), *[a.detach() for a in args])
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-6)
