"""Multi-epoch dispatch of the port (train.loop.make_multi_epoch_fn): one
K-epoch call equals K one-epoch calls bit for bit (losses, parameters, Adam
state, trace, step, generator state), with dropout, shuffle and
augmentation on; its trajectory with shuffle and augmentation matches the
JAX make_multi_epoch_fn fed the same permutations and choices; and
driver.chunk_epochs equals the JAX one."""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.train import loop as jloop
from plastic_unet_tpu.train.driver import chunk_epochs as jax_chunk_epochs
from plastic_unet_tpu.train.optimizer import adam_step_lr as jax_adam_step_lr
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops.augment import augment_stream, draw_augment_choices
from plastic_unet_tpu_torch.train.driver import chunk_epochs
from plastic_unet_tpu_torch.train.loop import create_train_state, make_epoch_fn, make_multi_epoch_fn
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params, trace_from_jax
from test_torch_augment import jax_choices

torch.set_num_threads(2)

SIZE, NEURONS, S, K = 16, 2, 4, 3
LR, GAMMA, STEPLR = 1e-3, 0.5, 5


def _stream(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((S, 1, SIZE, SIZE, 1)) * 0.5).astype(np.float32)
    y = (rng.random((S, 1, SIZE, SIZE)) > 0.5).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


def _state(dropout, rule="hebb", params=None):
    model = UNetPRes(neurons=NEURONS, nbf=SIZE, dropout_ratio=dropout, rule=rule,
                     generator=torch.Generator().manual_seed(1))
    if params is not None:
        model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return create_train_state(model, LR, GAMMA, STEPLR, generator=torch.Generator().manual_seed(2), device="cpu")


def _adam_tensors(state):
    return [v for per in state.optimizer.state.values() for v in per.values()]


def test_k_epochs_in_one_call_equal_k_one_epoch_calls():
    X, Y = _stream(3)
    n = S
    g = torch.Generator().manual_seed(4)
    perms = torch.stack([torch.randperm(n, generator=g) for _ in range(K)])
    choices = torch.stack([draw_augment_choices(n, g) for _ in range(K)])

    a = _state(0.5)
    a, la = make_multi_epoch_fn(shuffle=True, augment=True)(a, X, Y, perms, choices, epochs=K)
    assert la.shape == (K, S)

    b = _state(0.5)
    epoch = make_epoch_fn()
    rows = []
    for j in range(K):  # the one-epoch path: permute, augment, fresh trace, one epoch
        xe, ye = X.reshape(n, SIZE, SIZE, 1)[perms[j]], Y.reshape(n, SIZE, SIZE)[perms[j]]
        xe, ye = augment_stream(xe, ye, choices[j])
        b.hebb.zero_()
        b, lb = epoch(b, xe.reshape(X.shape), ye.reshape(Y.shape))
        rows.append(lb)
    assert torch.equal(la, torch.stack(rows))
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    adam_a, adam_b = _adam_tensors(a), _adam_tensors(b)
    assert len(adam_a) == len(adam_b) > 0 and all(torch.equal(p, q) for p, q in zip(adam_a, adam_b))
    assert torch.equal(a.hebb, b.hebb) and float(a.hebb.abs().max()) > 0
    assert a.step == b.step == K * S and a.scheduler.last_epoch == b.scheduler.last_epoch
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert not torch.equal(a.generator.get_state(), torch.Generator().manual_seed(2).get_state())


def test_multi_epoch_without_draws_needs_epochs():
    X, Y = _stream(5)
    st = _state(0.0)
    run = make_multi_epoch_fn()
    with pytest.raises(TypeError, match="epochs"):
        run(st, X, Y)
    st, losses = run(st, X, Y, epochs=2)
    assert losses.shape == (2, S) and st.step == 2 * S
    with pytest.raises(ValueError, match="perms"):
        make_multi_epoch_fn(shuffle=True)(st, X, Y, torch.zeros((2, S + 1), dtype=torch.int64), epochs=2)
    with pytest.raises(ValueError, match="choices"):
        make_multi_epoch_fn(augment=True)(st, X, Y, None, torch.zeros((3, S, 3), dtype=torch.int64), epochs=2)


@pytest.mark.parametrize("rule", ["hebb", "oja"])
def test_shuffled_augmented_trajectory_matches_jax(rule):
    """K=3 epochs of S=4 steps, dropout 0: the JAX dispatch draws its
    permutations and choices from keys; the port is given the same ones."""
    X, Y = _stream(8)
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=NEURONS, dropout_ratio=0.0, nbf=SIZE, rule=rule)
    tx = jax_adam_step_lr(LR, GAMMA, STEPLR)
    jstate = jloop.create_train_state(jm, tx, jax.random.PRNGKey(3), (SIZE, SIZE, 1))
    params0 = jax.tree_util.tree_map(np.asarray, jstate.params)
    erngs = jnp.stack([jax.random.PRNGKey(100 + j) for j in range(K)])
    pkeys = jnp.stack([jax.random.PRNGKey(200 + j) for j in range(K)])
    akeys = jnp.stack([jax.random.PRNGKey(300 + j) for j in range(K)])
    run = jloop.make_multi_epoch_fn(jm, tx, shuffle=True, augment=True, donate=False)
    final, jl = run(jstate, jnp.asarray(X.numpy()), jnp.asarray(Y.numpy()), erngs, pkeys, akeys)

    perms = torch.tensor(np.stack([np.asarray(jax.random.permutation(k, S)) for k in pkeys]), dtype=torch.int64)
    choices = torch.tensor(np.stack([jax_choices(k, S) for k in akeys]), dtype=torch.int64)
    assert not torch.equal(perms[0], torch.arange(S)) and int(choices[:, :, 2].max()) > 0
    st = _state(0.0, rule, params0)
    st, losses = make_multi_epoch_fn(shuffle=True, augment=True)(st, X, Y, perms, choices, epochs=K)

    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), atol=5e-5)
    want = state_dict_from_jax_params(final.params)
    got = st.model.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-4, err_msg=k)
    assert float(st.model.eta.detach()) == float(np.float32(0.01))
    np.testing.assert_allclose(st.hebb.numpy(), trace_from_jax(final.hebb).numpy(), atol=1e-4)
    assert st.step == int(final.step) == K * S


def test_chunk_epochs_matches_jax():
    grid = itertools.product(range(0, 12), (1, 7, 12), (1, 2, 3, 8), [(50, 100, 50000), (2, 4, 50000), (3, 5, 7),
                                                                     (0, 0, 0), (1, 1, 1), (4, 0, 6)])
    n = 0
    for e, total, max_chunk, periods in grid:
        if e < total:
            assert chunk_epochs(e, total, max_chunk, periods) == jax_chunk_epochs(e, total, max_chunk, periods)
            n += 1
    assert n > 300
