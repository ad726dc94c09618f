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
from plastic_unet_tpu_torch.ops.plastic_head import plastic_head

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
    launches = plastic_head.launches
    got = plastic_head(*map(torch.from_numpy, (w, alpha, eta, x, hebb)), rule=rule, alfa_type=alfa_type)
    assert plastic_head.launches == launches  # CPU tensors never launch the kernel
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
