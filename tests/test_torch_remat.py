"""remat_trunk in the port (torch.utils.checkpoint around each of the 9
trunk modules, UpRes's dropout mask drawn before its checkpoint): the same
parameters, forward and gradients bit for bit as the plain model with
dropout on (tests/test_remat.py holds the JAX module so), the same eager
trajectory, and the trajectory against the JAX make_epoch_fn with
remat_trunk (CPU, plain versions of every kernel)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.train import loop as jloop
from plastic_unet_tpu.train.optimizer import adam_step_lr as jax_adam_step_lr
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.train.loop import create_train_state, make_epoch_fn
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params, trace_from_jax

torch.set_num_threads(2)

SIZE, NEURONS = 32, 4


def _model(remat, dropout=0.5, **kw):
    return UNetPRes(nbf=SIZE, neurons=NEURONS, dropout_ratio=dropout, remat_trunk=remat,
                    generator=torch.Generator().manual_seed(0), **kw)


def test_remat_state_dict_is_the_plain_models():
    a, b = _model(False).state_dict(), _model(True).state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("opts", [dict(), dict(trunk_pad=40, coord_conv=True)], ids=["plain", "pad_coord"])
def test_remat_forward_and_grads_bit_identical_with_dropout(opts):
    """Train mode, dropout 0.5 from an explicit generator: the recompute reads
    the masks drawn in the forward, so activ, the trace and every gradient
    are the plain model's bits."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32))
    tgt = torch.from_numpy((rng.random((2, SIZE, SIZE)) > 0.5).astype(np.float32))
    runs = []
    for remat in (False, True):
        m = _model(remat, **opts).train()
        out = m(x, m.initial_zero_hebb(2), generator=torch.Generator().manual_seed(7))
        ((out.activout - tgt) ** 2).mean().backward()
        runs.append((out, [p.grad for p in m.parameters()]))
    (o1, g1), (o2, g2) = runs
    for a, b in zip(o1, o2):
        assert torch.equal(a.detach(), b.detach())
    assert len(g1) == len(g2) and all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g1, g2))
    assert sum(bool((g != 0).any()) for g in g1 if g is not None) > 40


def test_remat_runs_the_trunks_under_checkpoint():
    """The backward recomputes each trunk: its modules start twice a step (the
    recompute stops where it has what the backward needs, so a forward hook
    would not see it end)."""
    calls = []
    for remat in (False, True):
        m = _model(remat, dropout=0.0).train()
        hooks = [mod.register_forward_pre_hook(lambda *a: calls.append(remat))
                 for mod in (m.conv1, m.conv2, m.conv3, m.conv4, m.mid, m.uconv4, m.uconv3, m.uconv2, m.uconv1)]
        out = m(torch.randn(1, SIZE, SIZE, 1), m.initial_zero_hebb(1))
        out.activ.sum().backward()
        for h in hooks:
            h.remove()
    assert calls.count(False) == 9 and calls.count(True) == 18
    m = _model(True).eval()
    with torch.no_grad():  # nothing to recompute: the plain forward
        m(torch.randn(1, SIZE, SIZE, 1), m.initial_zero_hebb(1))


def test_remat_trajectory_bit_identical_with_dropout():
    """4 eager steps of make_epoch_fn at lanes=2, dropout 0.5 from one generator
    seed: losses, parameters, trace and the generator's state alike."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy((rng.standard_normal((4, 2, SIZE, SIZE, 1)) * 0.5).astype(np.float32))
    Y = torch.from_numpy((rng.random((4, 2, SIZE, SIZE)) > 0.5).astype(np.float32))
    runs = []
    for remat in (False, True):
        state = create_train_state(_model(remat), 1e-3, 0.5, 3, lanes=2,
                                   generator=torch.Generator().manual_seed(5), device="cpu")
        runs.append(make_epoch_fn()(state, X, Y))
    (s1, l1), (s2, l2) = runs
    assert torch.equal(l1, l2) and torch.equal(s1.hebb, s2.hebb)
    assert all(torch.equal(a, b) for a, b in zip(s1.model.parameters(), s2.model.parameters()))
    assert torch.equal(s1.generator.get_state(), s2.generator.get_state())


def test_remat_trajectory_matches_jax_remat_epoch():
    """8 steps at B=1, dropout 0, against the JAX epoch with remat_trunk,
    within the training slice's tolerances (tests/test_torch_train_loop.py)."""
    size, steps = 16, 8
    rng = np.random.default_rng(11)
    X = (rng.standard_normal((steps, 1, size, size, 1)) * 0.5).astype(np.float32)
    Y = (rng.random((steps, 1, size, size)) > 0.5).astype(np.float32)
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=size, remat_trunk=True)
    tx = jax_adam_step_lr(1e-3, 0.5, 3)
    jstate = jloop.create_train_state(jm, tx, jax.random.PRNGKey(3), (size, size, 1), lanes=1)
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    final, jl = jloop.make_epoch_fn(jm, tx, lanes=1, donate=False)(jstate, jnp.asarray(X), jnp.asarray(Y),
                                                                    jax.random.PRNGKey(0))
    model = UNetPRes(neurons=2, dropout_ratio=0.0, nbf=size, remat_trunk=True)
    model.load_state_dict(state_dict_from_jax_params(params0), strict=True)
    state = create_train_state(model, 1e-3, 0.5, 3, device="cpu")
    state, losses = make_epoch_fn()(state, torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), atol=5e-5)
    want, got = state_dict_from_jax_params(final.params), state.model.state_dict()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-4, err_msg=k)
    np.testing.assert_allclose(state.hebb.numpy(), trace_from_jax(final.hebb).numpy(), atol=1e-4)
