"""batch_norm in the port's UNetPRes (CPU, plain versions) against the JAX
module, which runs BN only at the module level: apply with ``batch_stats``
and ``mutable=["batch_stats"]`` in train mode (outputs, the updated running
statistics, and gradients), apply with the statistics in eval mode; the
differentiable single conv the BN trunks run on (ops.conv3x3.conv3x3_same)
against autograd of the plain conv; the BN keys; the fold_hires error."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu_torch.models import blocks as tblocks
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, conv3x3_same, hwio
from plastic_unet_tpu_torch.utils.torch_interop import (
    state_dict_from_jax_params,
    unetp_res_batch_stats_map,
    unetp_res_name_map,
)

torch.set_num_threads(2)

SIZE, B = 32, 3


def _setup(seed=0, rule="hebb"):
    """JAX module and variables after one train-mode apply (so the running
    statistics are not the initial ones), the port's model with them, inputs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, SIZE, SIZE, 1)).astype(np.float32)
    hebb = (rng.standard_normal((B, SIZE, SIZE)) * 0.1).astype(np.float32)
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=SIZE, rule=rule, batch_norm=True)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(hebb))
    warm = rng.standard_normal((B, SIZE, SIZE, 1)).astype(np.float32) * 2 + 0.5
    _, upd = _train_apply(jm)(v, jnp.asarray(warm), jnp.asarray(hebb))
    v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    tm = UNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=SIZE, rule=rule, batch_norm=True)
    tm.load_state_dict(state_dict_from_jax_params(v["params"], batch_stats=v["batch_stats"]), strict=True)
    return jm, v, tm, x, hebb


def _train_apply(jm):
    return jax.jit(lambda v, x, h: jm.apply(v, x, h, train=True, mutable=["batch_stats"]))


def _stats(tm):
    return {k: t for k, t in tm.state_dict().items() if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("rule", ["hebb", "oja"])
def test_train_mode_matches_jax_mutable_batch_stats(rule):
    jm, v, tm, x, hebb = _setup(rule=rule)
    ref, upd = _train_apply(jm)(v, jnp.asarray(x), jnp.asarray(hebb))
    out = tm.train()(torch.from_numpy(x), torch.from_numpy(hebb))
    for name, got, want in zip(("activ", "activout", "hebb"), out, ref):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, err_msg=name)
    want = state_dict_from_jax_params(v["params"], batch_stats=upd["batch_stats"])
    got = _stats(tm)
    assert len(got) == 60
    for k, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), atol=1e-6, rtol=1e-5, err_msg=k)


def test_eval_mode_matches_jax_running_average():
    jm, v, tm, x, hebb = _setup(seed=1)
    before = {k: t.clone() for k, t in _stats(tm).items()}
    ref = jax.jit(lambda v, x, h: jm.apply(v, x, h, train=False))(v, jnp.asarray(x), jnp.asarray(hebb))
    with torch.no_grad():
        out = tm.eval()(torch.from_numpy(x), torch.from_numpy(hebb))
    for name, got, want in zip(("activ", "activout", "hebb"), out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, err_msg=name)
    assert all(torch.equal(t, before[k]) for k, t in _stats(tm).items())  # eval reads, never writes


def test_train_mode_gradients_match_jax():
    jm, v, tm, x, hebb = _setup(seed=2)
    tgt = (np.random.default_rng(9).random((B, SIZE, SIZE)) > 0.5).astype(np.float32)

    def loss(params):
        out, _ = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, jnp.asarray(x), jnp.asarray(hebb),
                          train=True, mutable=["batch_stats"])
        return jnp.mean((out.activout - tgt) ** 2)

    want = state_dict_from_jax_params(jax.jit(jax.grad(loss))(v["params"]), unetp_res_name_map(batch_norm=True))
    out = tm.train()(torch.from_numpy(x), torch.from_numpy(hebb))
    ((out.activout - torch.from_numpy(tgt)) ** 2).mean().backward()
    grads = dict(tm.named_parameters())
    assert set(want) == set(grads)
    for k, g in want.items():
        got = grads[k].grad if grads[k].grad is not None else torch.zeros_like(g)  # eta takes no gradient
        np.testing.assert_allclose(got.numpy(), g.numpy(), atol=1e-4 * max(1.0, float(g.abs().max())), err_msg=k)


def test_bn_trunks_run_unfused_and_the_others_keep_the_tail(monkeypatch):
    """conv3x3_same takes the 4 convs of each of the 5 BN trunks (DownRes,
    Middle) and, at neurons=2, the 3 entry convs whose Cin is a multiple of
    16 (16, 32, 16); the 4 UpRes middles, BN-free, keep ops.residual_tail."""
    seen = {"same": 0, "tail": 0}
    real_same, real_tail = tblocks.conv3x3_same, tblocks.residual_tail

    def same(*a):
        seen["same"] += 1
        return real_same(*a)

    def tail(*a):
        seen["tail"] += 1
        return real_tail(*a)

    monkeypatch.setattr(tblocks, "conv3x3_same", same)
    monkeypatch.setattr(tblocks, "residual_tail", tail)
    m = UNetPRes(neurons=2, nbf=SIZE, batch_norm=True, dropout_ratio=0.0).train()
    m(torch.randn(2, SIZE, SIZE, 1), m.initial_zero_hebb(2)).activ.sum().backward()
    assert seen == {"same": 20 + 3, "tail": 4}


@pytest.mark.parametrize("shape", [(2, 9, 7, 5, 6), (1, 16, 16, 2, 2), (3, 5, 5, 8, 3)])
def test_conv3x3_same_plain_gradients_match_autograd_of_the_plain_conv(shape):
    b, h, w, cin, cout = shape
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(b, h, w, cin, generator=g)
    wt, bias = torch.randn(cout, cin, 3, 3, generator=g) / 3, torch.randn(cout, generator=g)
    gout = torch.randn(b, h, w, cout, generator=g)
    leaves = [t.clone().requires_grad_() for t in (x, wt, bias)]
    out = conv3x3_same(*leaves)
    assert torch.equal(out.detach(), conv3x3(x, hwio(wt), bias))
    got = torch.autograd.grad(out, leaves, gout)
    ref_leaves = [t.clone().requires_grad_() for t in (x, wt, bias)]
    ref = torch.autograd.grad(conv3x3_plain(ref_leaves[0], hwio(ref_leaves[1]), ref_leaves[2]), ref_leaves, gout)
    for name, a, r in zip(("dx", "dW", "db"), got, ref):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5, msg=name)


def test_bn_keys_sit_beside_the_convs():
    sd = UNetPRes(neurons=2, nbf=SIZE, batch_norm=True).state_dict()
    plain = UNetPRes(neurons=2, nbf=SIZE).state_dict()
    extra = [k for k in sd if k not in plain]
    assert all(k in sd for k in plain) and len(extra) == 120
    assert "conv1.dconv.1.bn.weight" in sd and "mid.mconv.2.conv.2.bn.running_var" in sd
    assert not any(k.startswith("uconv") for k in extra)  # UpRes's middle never has BN
    assert set(unetp_res_batch_stats_map().values()) == {k for k in extra if "running" in k}
    assert {k for k, _ in unetp_res_name_map(batch_norm=True).values()} | set(unetp_res_batch_stats_map().values()) \
        == set(sd)


def test_fold_hires_with_batch_norm_raises_as_in_jax():
    with pytest.raises(NotImplementedError, match="folded mode"):
        UNetPRes(neurons=2, nbf=SIZE, fold_hires=True, batch_norm=True)
    jm = JaxUNetPRes(neurons=2, nbf=SIZE, fold_hires=True, batch_norm=True)
    with pytest.raises(NotImplementedError, match="folded mode"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), jm.initial_zero_hebb(1))
