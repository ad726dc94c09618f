"""The training slice as a whole: the port's lifetime loop (CPU, plain
versions of every kernel) against plastic_unet_tpu.train.loop.make_epoch_fn
from the same initial weights, step for step; the optimizer schedule, the
lane layout, bce_logits and the dropout contract."""

import os

os.environ["PLASTIC_UNET_FUSE_MIN_PIXELS"] = "0"  # read when the JAX model is traced: fuse the Pallas tail at toy sizes

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.ops import losses as jlosses
from plastic_unet_tpu.train import loop as jloop
from plastic_unet_tpu.train.optimizer import adam_step_lr as jax_adam_step_lr
from plastic_unet_tpu.train.optimizer import step_lr_schedule
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops.losses import bce_logits, bce_probs
from plastic_unet_tpu_torch.train.loop import (
    TrainState,
    create_train_state,
    make_epoch_fn,
    make_train_step,
    reshape_stream,
)
from plastic_unet_tpu_torch.train.optimizer import StepLR, adam_step_lr
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params, trace_from_jax

torch.set_num_threads(2)

SIZE, NBF, NEURONS, STEPS = 16, 16, 2, 8
LR, GAMMA, STEPLR = 1e-3, 0.5, 3


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, SIZE, SIZE, 1)) * 0.5).astype(np.float32)
    y = (rng.random((n, SIZE, SIZE)) > 0.5).astype(np.float32)
    return x, y


def _jax_run(rule, loss_space, lanes, X, Y, pallas):
    """One epoch of the JAX package; returns (initial params, final state, losses)."""
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=NEURONS, dropout_ratio=0.0, nbf=NBF, rule=rule,
                     pallas_trunk=pallas, use_pallas=pallas)
    tx = jax_adam_step_lr(LR, GAMMA, STEPLR)
    state = jloop.create_train_state(jm, tx, jax.random.PRNGKey(3), (SIZE, SIZE, 1), lanes=lanes)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    epoch = jloop.make_epoch_fn(jm, tx, loss_space=loss_space, lanes=lanes, donate=False)
    final, losses = epoch(state, jnp.asarray(X), jnp.asarray(Y), jax.random.PRNGKey(0))
    return params0, final, np.asarray(losses)


def _port_run(rule, loss_space, lanes, X, Y, params0):
    model = UNetPRes(n_channels=1, n_classes=1, neurons=NEURONS, dropout_ratio=0.0, nbf=NBF, rule=rule)
    model.load_state_dict(state_dict_from_jax_params(params0), strict=True)
    state = create_train_state(model, LR, GAMMA, STEPLR, lanes=lanes, device="cpu")
    state, losses = make_epoch_fn(loss_space=loss_space)(state, torch.from_numpy(X), torch.from_numpy(Y))
    return state, losses


def _compare(final, jlosses_, state, losses, steps, lanes):
    assert isinstance(losses, torch.Tensor) and tuple(losses.shape) == (steps,)
    np.testing.assert_allclose(losses.numpy(), jlosses_, atol=5e-5)
    want = state_dict_from_jax_params(final.params)
    got = state.model.state_dict()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-4, err_msg=k)
    # eta must remain exactly .01 (it receives no gradient)
    assert float(state.model.eta.detach()) == float(np.float32(0.01))
    np.testing.assert_array_equal(np.asarray(final.params["eta"]), np.array([0.01], np.float32))
    trace = trace_from_jax(final.hebb)
    assert tuple(state.hebb.shape) == (lanes, NBF, NBF) and float(state.hebb.abs().max()) > 0.0
    np.testing.assert_allclose(state.hebb.numpy(), trace.numpy(), atol=1e-4)
    assert state.step == steps == int(final.step) and not state.hebb.requires_grad


@pytest.mark.parametrize("loss_space", ["probs", "logits"])
@pytest.mark.parametrize("rule", ["hebb", "oja"])
def test_trajectory_matches_jax_epoch(rule, loss_space):
    """8 steps at B=1 against the JAX epoch with its Pallas tail and head."""
    X, Y = _stream(STEPS, seed=11)
    X, Y = X[:, None], Y[:, None]  # (S, B=1, ...)
    params0, final, jl = _jax_run(rule, loss_space, 1, X, Y, pallas=True)
    state, losses = _port_run(rule, loss_space, 1, X, Y, params0)
    _compare(final, jl, state, losses, STEPS, 1)


def test_lanes_match_jax_epoch():
    """lanes=2: 9 samples -> 4 steps of 2 lanes, one dropped; lane-mean loss."""
    x, y = _stream(9, seed=14)
    Xl, Yl = reshape_stream(torch.from_numpy(x), torch.from_numpy(y), lanes=2)
    assert tuple(Xl.shape) == (4, 2, SIZE, SIZE, 1) and tuple(Yl.shape) == (4, 2, SIZE, SIZE)
    jX, jY = jloop.reshape_stream(jnp.asarray(x), jnp.asarray(y), lanes=2)
    np.testing.assert_array_equal(Xl.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(Yl.numpy(), np.asarray(jY))
    np.testing.assert_array_equal(Xl[:, 1].numpy(), x[4:8])  # lane 1 is the contiguous chunk [S, 2S)
    params0, final, jl = _jax_run("hebb", "logits", 2, np.asarray(jX), np.asarray(jY), pallas=False)
    state, losses = _port_run("hebb", "logits", 2, Xl.numpy(), Yl.numpy(), params0)
    _compare(final, jl, state, losses, 4, 2)


def test_reshape_stream_b1_keeps_all():
    x, y = _stream(5, seed=1)
    Xl, Yl = reshape_stream(torch.from_numpy(x), torch.from_numpy(y), lanes=1)
    assert tuple(Xl.shape) == (5, 1, SIZE, SIZE, 1) and tuple(Yl.shape) == (5, 1, SIZE, SIZE)
    np.testing.assert_array_equal(Xl[:, 0].numpy(), x)


def test_step_lr_matches_jax_schedule_and_torch():
    lin = torch.nn.Linear(2, 2)
    opt, sched = adam_step_lr(lin.parameters(), LR, GAMMA, STEPLR)
    assert isinstance(opt, torch.optim.Adam) and isinstance(sched, StepLR)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    ref_opt = torch.optim.Adam(torch.nn.Linear(2, 2).parameters(), lr=LR)
    ref_sched = torch.optim.lr_scheduler.StepLR(ref_opt, gamma=GAMMA, step_size=STEPLR)
    mine = step_lr_schedule(LR, GAMMA, STEPLR)
    for k in range(12):
        assert group["lr"] == pytest.approx(float(mine(k)), rel=1e-6), k
        assert group["lr"] == pytest.approx(ref_opt.param_groups[0]["lr"], rel=1e-12), k
        ref_opt.step()
        ref_sched.step()
        sched.step()
    _, clamped = adam_step_lr(lin.parameters(), LR, GAMMA, 0.2)  # step_size clamps to 1
    clamped.step()
    assert clamped.get_last_lr() == pytest.approx(LR * GAMMA)


def test_step_lr_writes_a_tensor_rate_in_place():
    """The card's optimizer holds its rate as a tensor (capturable Adam); the
    scheduler must fill it, not rebind it."""
    lin = torch.nn.Linear(2, 2)
    opt = torch.optim.Adam(lin.parameters(), lr=torch.tensor(LR))
    rate = opt.param_groups[0]["lr"]
    sched = StepLR(opt, LR, GAMMA, 2)
    for _ in range(4):
        sched.step()
    assert opt.param_groups[0]["lr"] is rate and float(rate) == pytest.approx(LR * GAMMA ** 2)


@pytest.mark.parametrize("scale", [1.0, 60.0])
def test_bce_logits_matches_jax(scale):
    """Value and gradient, incl. saturated logits (|x| up to ~200)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 9, 9)) * scale).astype(np.float32)
    y = (rng.random((2, 9, 9)) > 0.5).astype(np.float32)
    ref, gref = jax.value_and_grad(jlosses.bce_logits)(jnp.asarray(x), jnp.asarray(y))
    tx = torch.from_numpy(x).requires_grad_()
    loss = bce_logits(tx, torch.from_numpy(y))
    loss.backward()
    loss = loss.detach()
    assert np.isfinite(float(loss)) and bool(torch.isfinite(tx.grad).all())
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gref), atol=1e-7)
    if scale == 1.0:  # away from saturation the two loss spaces agree
        probs = bce_probs(torch.sigmoid(torch.from_numpy(x)), torch.from_numpy(y))
        np.testing.assert_allclose(float(probs), float(loss), atol=1e-6)


def test_bce_probs_gradient_matches_jax():
    rng = np.random.default_rng(3)
    p = rng.random((2, 7, 7)).astype(np.float32)
    p.flat[:3] = [0.0, 1.0, 1e-30]  # saturated: torch clamps the denominator, the JAX custom_vjp copies it
    y = (rng.random((2, 7, 7)) > 0.5).astype(np.float32)
    ref, gref = jax.value_and_grad(jlosses.bce_probs)(jnp.asarray(p), jnp.asarray(y))
    tp = torch.from_numpy(p).requires_grad_()
    loss = bce_probs(tp, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(gref), rtol=1e-5, atol=1e-7)


def test_dropout_contract_in_the_model():
    """Train mode: one draw per (sample, channel), survivors scaled by
    1/(1-rate), the first pool at half the rate; the same generator seed
    gives the same masks; eval mode draws nothing."""
    model = UNetPRes(neurons=8, nbf=NBF, dropout_ratio=0.5, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_stream(3, seed=5)[0])
    hebb = model.initial_zero_hebb(3)

    def run(seed):
        seen = {}
        hooks = [m.register_forward_pre_hook(lambda mod, args, k=k: seen.__setitem__(k, args[0].detach().clone()))
                 for k, m in (("conv2", model.conv2), ("conv3", model.conv3), ("up4", model.uconv4.uconv[1]))]
        gen = torch.Generator().manual_seed(seed)
        out = model.train()(x, hebb, generator=gen)
        for h in hooks:
            h.remove()
        return seen, out, gen

    seen, out, gen = run(1)
    for key, rate in (("conv2", 0.25), ("conv3", 0.5), ("up4", 0.5)):
        t = seen[key]  # (B, H, W, C): a dropped plane is all zero, and whole planes drop
        planes = t.permute(0, 3, 1, 2).reshape(t.shape[0] * t.shape[3], -1)
        dropped = (planes == 0).all(dim=1)
        assert 0 < int(dropped.sum()) < planes.shape[0], key
        frac = float(dropped.float().mean())
        assert abs(frac - rate) < 0.25, (key, frac)
    # the first pool's survivors are scaled by 1/(1 - rate/2)
    with torch.no_grad():
        pooled = torch.nn.functional.max_pool2d(model.conv1(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    alive = seen["conv2"] != 0
    torch.testing.assert_close(seen["conv2"][alive], (pooled / 0.75)[alive])
    seen_b, out_b, _ = run(1)
    for k in seen:
        torch.testing.assert_close(seen[k], seen_b[k], rtol=0, atol=0)
    torch.testing.assert_close(out.activout, out_b.activout, rtol=0, atol=0)
    seen_c, _, _ = run(2)
    assert any(not torch.equal(seen[k] == 0, seen_c[k] == 0) for k in seen)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        model.train()(x, hebb)
    state = gen.get_state()
    with torch.no_grad():
        a = model.eval()(x, hebb, generator=gen)
        b = model(x, hebb)
    assert torch.equal(gen.get_state(), state)
    torch.testing.assert_close(a.activout, b.activout, rtol=0, atol=0)


def test_training_with_dropout_runs_and_is_reproducible():
    X, Y = _stream(4, seed=6)
    X, Y = torch.from_numpy(X[:, None]), torch.from_numpy(Y[:, None])

    def run():
        model = UNetPRes(neurons=NEURONS, nbf=NBF, dropout_ratio=0.5, generator=torch.Generator().manual_seed(0))
        state = create_train_state(model, LR, GAMMA, STEPLR, generator=torch.Generator().manual_seed(9),
                                   device="cpu")
        return make_epoch_fn()(state, X, Y)

    (s1, l1), (s2, l2) = run(), run()
    assert bool(torch.isfinite(l1).all()) and s1.step == 4
    torch.testing.assert_close(l1, l2, rtol=0, atol=0)
    for a, b in zip(s1.model.parameters(), s2.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_step_updates_state_in_place():
    X, Y = _stream(2, seed=7)
    model = UNetPRes(neurons=NEURONS, nbf=NBF, dropout_ratio=0.0, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, LR, device="cpu")
    assert isinstance(state, TrainState) and state.model.training and state.step == 0
    before = [p.detach().clone() for p in model.parameters()]
    trace = state.hebb
    step = make_train_step(loss_space="probs")
    same, loss = step(state, (torch.from_numpy(X[:1]), torch.from_numpy(Y[:1])))
    assert same is state and state.hebb is trace and state.step == 1
    assert loss.dim() == 0 and not loss.requires_grad and float(trace.abs().max()) > 0
    assert any(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
    with pytest.raises(ValueError, match="loss_space"):
        make_train_step(loss_space="mse")


def test_entry_points_need_cuda_unless_told():
    """device=None means CUDA: no silent fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal shows only without one")
    model = UNetPRes(neurons=NEURONS, nbf=NBF, dropout_ratio=0.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model, LR)
    state = create_train_state(model, LR, device="cpu")
    X, Y = _stream(1, seed=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_epoch_fn(graph=True)(state, torch.from_numpy(X[:, None]), torch.from_numpy(Y[:, None]))
