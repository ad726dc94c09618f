"""The port's residual blocks and UNetPRes (CPU, plain versions) against the
JAX package's flax modules, with the weights carried by
state_dict_from_jax_params."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.models import blocks as jblocks
from plastic_unet_tpu.utils.torch_interop import state_dict_to_flax_params, unetp_res_name_map
from plastic_unet_tpu_torch.models import blocks as tblocks
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.utils.torch_interop import load_pth, state_dict_from_jax_params

torch.set_num_threads(2)

CKPT = "results/showdown_r5/sd_torch_oja_250h.json.ckpt.pth"


def _sub_map(flax_head, torch_prefix):
    """The UNetPRes name map restricted to one block, with paths and keys
    relative to it."""
    cut = len(torch_prefix) + 1
    return {path[len(flax_head):]: (key[cut:], perm)
            for path, (key, perm) in unetp_res_name_map().items()
            if path[: len(flax_head)] == flax_head}


def _nhwc(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dh", [-3, -1, 0, 1, 3])
@pytest.mark.parametrize("dw", [-1, 0, 3])
def test_pad_to_match(dh, dw):
    x = _nhwc(np.random.default_rng(0), 2, 7, 8, 3)
    got = tblocks.pad_to_match(torch.from_numpy(x), 7 + dh, 8 + dw).numpy()
    ref = np.asarray(jblocks.pad_to_match(jnp.asarray(x), 7 + dh, 8 + dw))
    # odd positive diffs fall one short of the target, as in the reference
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_max_pool_floor():
    x = _nhwc(np.random.default_rng(1), 2, 7, 5, 3)
    got = tblocks.max_pool_2x2(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jblocks.max_pool_2x2(jnp.asarray(x))))


BLOCKS = {
    # name: (jax module, port module, flax head, torch prefix, input shapes)
    "down": (lambda: jblocks.DownRes(3, 8), lambda: tblocks.DownRes(3, 8),
             ("DownRes_0",), "conv1", [(2, 11, 11, 3)]),
    "middle": (lambda: jblocks.Middle(8, 16), lambda: tblocks.Middle(8, 16),
               ("Middle_0",), "mid", [(2, 6, 6, 8)]),
    "up_crop": (lambda: jblocks.UpRes(16, 8, 0.5), lambda: tblocks.UpRes(16, 8, 0.5),
                ("UpRes_0",), "uconv4", [(2, 6, 6, 16), (2, 12, 12, 8)]),
    "up_pad": (lambda: jblocks.UpRes(16, 8, 0.5), lambda: tblocks.UpRes(16, 8, 0.5),
               ("UpRes_0",), "uconv4", [(2, 6, 6, 16), (2, 15, 15, 8)]),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_forward(name):
    make_j, make_t, head, prefix, shapes = BLOCKS[name]
    rng = np.random.default_rng(len(name))
    xs = [_nhwc(rng, *s) for s in shapes]
    jmod = make_j()
    variables = jmod.init(jax.random.PRNGKey(3), *map(jnp.asarray, xs))
    ref = np.asarray(jmod.apply(variables, *map(jnp.asarray, xs)))
    tmod = make_t().eval()
    tmod.load_state_dict(state_dict_from_jax_params(variables["params"], _sub_map(head, prefix)), strict=True)
    with torch.no_grad():
        got = tmod(*map(torch.from_numpy, xs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_residual_block_holds_the_reference_keys():
    """A residual block is a holder of parameters under the reference's keys
    (its math runs in ops.residual_tail); tail_params gives them in the
    order the tail takes them."""
    blk = tblocks.ResidualBlock(8)
    assert list(blk.state_dict()) == ["conv.1.conv.weight", "conv.1.conv.bias", "conv.2.conv.weight",
                                      "conv.2.conv.bias"]
    w1, b1, w2, b2 = blk.tail_params()
    assert w1 is blk.conv[1].conv.weight and b1 is blk.conv[1].conv.bias
    assert w2 is blk.conv[2].conv.weight and b2 is blk.conv[2].conv.bias
    assert tuple(w1.shape) == (8, 8, 3, 3) and tuple(b2.shape) == (8,)


def _jax_model_and_params(rule, alfa_type, plastic, seed):
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, nbf=16, rule=rule, alfa_type=alfa_type, plastic=plastic)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 1)), jm.initial_zero_hebb(1))["params"]
    return jm, params


@pytest.mark.parametrize("rule,alfa_type,plastic", [
    ("hebb", "free", True), ("oja", "free", True), ("hebb", "yoked", True), ("oja", "yoked", True),
    ("hebb", "free", False),
])
def test_unet_res_16px_matches_jax(rule, alfa_type, plastic):
    jm, params = _jax_model_and_params(rule, alfa_type, plastic, seed=5)
    rng = np.random.default_rng(7)
    x = rng.random((3, 16, 16, 1)).astype(np.float32)
    hebb = (rng.standard_normal((3, 16, 16)) * 0.1).astype(np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(hebb), train=False)
    tm = UNetPRes(n_channels=1, n_classes=1, neurons=2, nbf=16, rule=rule, alfa_type=alfa_type, plastic=plastic)
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(hebb))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_state_dict_keys_and_param_count():
    fixture = load_pth(CKPT, "model")
    tm = UNetPRes(neurons=8, nbf=101, rule="oja")
    assert list(tm.state_dict()) == list(fixture)
    assert len(fixture) == 103
    assert all(tuple(tm.state_dict()[k].shape) == tuple(v.shape) for k, v in fixture.items())
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=8, nbf=101, rule="oja")
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 101, 101, 1)), jm.initial_zero_hebb(1))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n_jax


def test_seeded_init_is_reproducible_and_torch_default():
    a = UNetPRes(neurons=2, nbf=16, generator=torch.Generator().manual_seed(1))
    b = UNetPRes(neurons=2, nbf=16, generator=torch.Generator().manual_seed(1))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    w = a.conv2.dconv[0].weight
    bound = 1 / np.sqrt(w.shape[1] * 9)
    assert float(w.detach().abs().max()) <= bound
    assert float(a.eta.detach()) == pytest.approx(0.01)


def test_checkpoint_101px_matches_jax():
    sd = load_pth(CKPT, "model")
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=8, nbf=101, rule="oja")
    params = state_dict_to_flax_params(sd, unetp_res_name_map())
    rng = np.random.default_rng(11)
    x = rng.random((2, 101, 101, 1)).astype(np.float32)
    hebb = (rng.standard_normal((2, 101, 101)) * 0.05).astype(np.float32)
    ref = jax.jit(lambda p, a, h: jm.apply({"params": p}, a, h, train=False))(params, jnp.asarray(x), jnp.asarray(hebb))
    tm = UNetPRes(neurons=8, nbf=101, rule="oja")
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(hebb))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_channel_dropout_contract():
    """Dropout2d: whole (sample, channel) planes dropped, survivors scaled
    by 1/(1-rate); eval mode and rate 0 are the identity and draw nothing;
    the draws come from an explicit generator, never the global one."""
    x = torch.ones(4, 5, 5, 64)
    gen = torch.Generator().manual_seed(0)
    y = tblocks.channel_dropout(x, 0.5, training=True, generator=gen)
    planes = y.permute(0, 3, 1, 2).reshape(4 * 64, 25)
    assert all(bool((r == r[0]).all()) for r in planes)
    assert set(planes[:, 0].tolist()) == {0.0, 2.0}
    again = tblocks.channel_dropout(x, 0.5, training=True, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(y, again, rtol=0, atol=0)
    state = gen.get_state()
    assert tblocks.channel_dropout(x, 0.5, training=False, generator=gen) is x
    assert tblocks.channel_dropout(x, 0.0, training=True, generator=gen) is x
    assert torch.equal(gen.get_state(), state)
    with pytest.raises(ValueError, match="explicit torch.Generator"):
        tblocks.channel_dropout(x, 0.5, training=True)


@pytest.mark.parametrize("cin", [1, 3])
def test_conv_nhwc_reads_values_not_strides(cin):
    """The same images with the stride numpy's newaxis leaves on a size-1
    channel dim (0) and with a copy's (1) give the same entry-conv bits: a
    cuDNN or oneDNN layer picks its algorithm from the strides
    (ROADMAP.md, C5), so conv_nhwc hands it the strides of a fresh tensor,
    without a copy."""
    rng = np.random.default_rng(4)
    imgs = rng.random((4, 1, 101, 101), dtype=np.float32)
    if cin == 1:
        x = torch.from_numpy(np.ascontiguousarray(imgs[:, 0, :, :, None]))  # the channel's stride is 0
    else:
        x = torch.from_numpy(rng.random((4, 101, 101, cin), dtype=np.float32))
    fresh = x.clone(memory_format=torch.contiguous_format)
    assert fresh.stride() == torch.empty(x.shape).stride()
    conv = torch.nn.Conv2d(cin, 16, 3, padding=1)
    with torch.no_grad():
        assert torch.equal(tblocks.conv_nhwc(conv, x), tblocks.conv_nhwc(conv, fresh))
    d = tblocks.dense_strides(x)
    assert d.stride() == fresh.stride() and d.data_ptr() == x.data_ptr() and torch.equal(d, x)
