"""The port's UNetPRes options (CPU, plain versions) against the JAX module
with the same option and the same weights: trunk_pad (a padded trunk, and
pad == input as a no-op), coord_conv, fold_hires, patch_conv and fast_dw
(TPU lowerings of the same math; the port computes the plain math), the
ops they rest on (pad_to, crop_from, add_coords), the geometry and quant
errors, and a padded run through the port's start_train."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.ops import augment as jaugment
from plastic_unet_tpu.ops import coords as jcoords
from plastic_unet_tpu_torch.config import TrainConfig
from plastic_unet_tpu_torch.data.synthetic import synthetic_split
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops import augment as taugment
from plastic_unet_tpu_torch.ops import coords as tcoords
from plastic_unet_tpu_torch.train.driver import start_train
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params

torch.set_num_threads(2)

SIZE = 16


def _pair(b=2, seed=0, **opts):
    """(JAX module, its params, the port's model with them, x, hebb)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, SIZE, SIZE, 1)).astype(np.float32)
    hebb = (rng.standard_normal((b, SIZE, SIZE)) * 0.1).astype(np.float32)
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=SIZE, **opts)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(hebb))["params"]
    tm = UNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=SIZE, **opts).eval()
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, tm, x, hebb


def _outputs(jm, params, tm, x, hebb):
    ref = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(hebb))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(hebb))
    return [(name, g.numpy(), np.asarray(r)) for name, g, r in zip(("activ", "activout", "hebb"), got, ref)]


@pytest.mark.parametrize("opts", [dict(trunk_pad=32), dict(trunk_pad=SIZE), dict(coord_conv=True),
                                  dict(coord_conv=True, trunk_pad=32), dict(trunk_pad=24, rule="oja")],
                         ids=["pad32", "pad_noop", "coord", "coord_pad32", "pad24_oja"])
def test_geometry_options_match_jax(opts):
    jm, params, tm, x, hebb = _pair(**opts)
    for name, got, ref in _outputs(jm, params, tm, x, hebb):
        assert got.shape == ref.shape == (2, SIZE, SIZE), name
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)


def test_pad_equal_to_input_is_the_plain_model():
    _, _, padded, x, hebb = _pair(trunk_pad=SIZE)
    plain = UNetPRes(neurons=2, nbf=SIZE, dropout_ratio=0.0).eval()
    plain.load_state_dict(padded.state_dict(), strict=True)
    with torch.no_grad():
        for a, b in zip(padded(torch.from_numpy(x), torch.from_numpy(hebb)),
                        plain(torch.from_numpy(x), torch.from_numpy(hebb))):
            assert torch.equal(a, b)


def test_fold_hires_matches_jax_fold_hires():
    """The JAX module folds the two high-res levels into space-to-depth (exact
    up to reassociation); the port computes the unfolded math on the same
    parameters. The JAX test's tolerances (tests/test_fold_hires.py)."""
    jm, params, tm, x, hebb = _pair(fold_hires=True)
    tol = {"activ": 5e-5, "activout": 1e-5, "hebb": 1e-5}
    for name, got, ref in _outputs(jm, params, tm, x, hebb):
        np.testing.assert_allclose(got, ref, atol=tol[name], err_msg=name)


@pytest.mark.parametrize("opts", [dict(patch_conv=32), dict(patch_conv=10_000), dict(fast_dw=True)],
                         ids=["patch32", "patch_all", "fast_dw"])
def test_conv_lowerings_match_jax(opts):
    jm, params, tm, x, hebb = _pair(**opts)
    for name, got, ref in _outputs(jm, params, tm, x, hebb):
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("opts", [dict(fold_hires=True), dict(patch_conv=32), dict(fast_dw=True),
                                  dict(use_pallas=True, pallas_trunk=True), dict(bilinear_upsample=True)])
def test_lowerings_give_the_default_models_bits(opts):
    """Accepted and computing nothing else: the default model's bits, forward
    and gradients, in train mode with dropout from one generator."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32))
    outs = []
    for kw in ({}, opts):
        m = UNetPRes(neurons=2, nbf=SIZE, dropout_ratio=0.5, generator=torch.Generator().manual_seed(1), **kw)
        o = m.train()(x, m.initial_zero_hebb(2), generator=torch.Generator().manual_seed(2))
        o.activ.square().mean().backward()
        outs.append([o.activ.detach()] + [p.grad for p in m.parameters() if p.grad is not None])
    assert len(outs[0]) == len(outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.parametrize("shape,size", [((2, SIZE, SIZE, 1), 32), ((3, 101, 101, 2), 128), ((16, 16, 3), 40),
                                         ((2, 7, 7, 1), 7), ((1, 5, 6, 2), 8), ((2, 9, 9, 1), 25)])
def test_pad_to_and_crop_from_match_jax(shape, size):
    x = np.random.default_rng(size).standard_normal(shape).astype(np.float32)
    got = taugment.pad_to(torch.from_numpy(x), size)
    ref = np.asarray(jaugment.pad_to(jnp.asarray(x), size, "reflect"))
    np.testing.assert_array_equal(got.numpy(), ref)
    back = taugment.crop_from(got, shape[-2])
    np.testing.assert_array_equal(back.numpy(), np.asarray(jaugment.crop_from(jnp.asarray(ref), shape[-2])))
    if shape[-3] == shape[-2]:
        np.testing.assert_array_equal(back.numpy(), x)


def test_pad_to_channels_first_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 5, 7)).astype(np.float32)
    got = taugment.pad_to(torch.from_numpy(x), 9, channels_last=False).numpy()
    np.testing.assert_array_equal(got, np.asarray(jaugment.pad_to(jnp.asarray(x), 9, channels_last=False)))


@pytest.mark.parametrize("with_r", [False, True])
@pytest.mark.parametrize("shape", [(2, SIZE, SIZE, 1), (3, 101, 101, 2), (9, 5, 3)])
def test_add_coords_matches_jax(shape, with_r):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    got = tcoords.add_coords(torch.from_numpy(x), with_r=with_r).numpy()
    ref = np.asarray(jcoords.add_coords(jnp.asarray(x), with_r=with_r))
    assert got.shape == ref.shape == shape[:-1] + (shape[-1] + (3 if with_r else 2),)
    np.testing.assert_array_equal(got[..., : shape[-1] + 2], ref[..., : shape[-1] + 2])
    # r: XLA's sqrt of the sum differs from torch's in the last place at some pixels
    np.testing.assert_allclose(got, ref, rtol=0, atol=2.5e-7)


def test_coord_conv_stem_takes_two_more_channels():
    m = UNetPRes(n_channels=1, neurons=2, nbf=SIZE, coord_conv=True)
    assert tuple(m.conv1.dconv[0].weight.shape) == (2, 3, 3, 3)
    assert list(m.state_dict()) == list(UNetPRes(neurons=2, nbf=SIZE).state_dict())


@pytest.mark.parametrize("tp,shape,match", [(8, (1, SIZE, SIZE, 1), "smaller than input"),
                                            (32, (1, SIZE, 12, 1), "requires square inputs"),
                                            (128, (1, SIZE, SIZE, 1), "too large"),
                                            (47, (1, SIZE, SIZE, 1), "at most 46")])
def test_trunk_pad_geometry_errors(tp, shape, match):
    m = UNetPRes(neurons=2, nbf=SIZE, trunk_pad=tp)
    with pytest.raises(ValueError, match=match):
        m(torch.zeros(shape), m.initial_zero_hebb(1))
    jm = JaxUNetPRes(neurons=2, nbf=SIZE, trunk_pad=tp)
    with pytest.raises(ValueError, match=match):
        jm.init(jax.random.PRNGKey(0), jnp.zeros(shape), jm.initial_zero_hebb(1))


def test_trunk_pad_at_the_reflect_limit_runs():
    m = UNetPRes(neurons=2, nbf=SIZE, trunk_pad=3 * SIZE - 2).eval()
    with torch.no_grad():
        out = m(torch.randn(1, SIZE, SIZE, 1), m.initial_zero_hebb(1))
    assert tuple(out.activout.shape) == (1, SIZE, SIZE) and bool(torch.isfinite(out.activout).all())


@pytest.mark.parametrize("option", [dict(fold_hires=True), dict(pallas_trunk=True), dict(fast_dw=True),
                                    dict(patch_conv=32), dict(batch_norm=True), dict(trunk_pad=32),
                                    dict(remat_trunk=True)])
@pytest.mark.parametrize("quant", ["calib", "int8"])
def test_quant_incompatible_options_raise(option, quant):
    (name, _), = option.items()
    m = UNetPRes(neurons=2, nbf=SIZE, quant=quant, **option).eval()
    with pytest.raises(ValueError, match=f"incompatible with \\['{name}'\\]"):
        m(torch.zeros(1, SIZE, SIZE, 1), m.initial_zero_hebb(1))


def test_unsupported_constructor_options_raise():
    with pytest.raises(NotImplementedError, match="folded mode"):
        UNetPRes(neurons=2, nbf=SIZE, fold_hires=True, batch_norm=True)
    # compute_dtype bfloat16 raised until the bf16 trunk was ported (tests/test_torch_bf16.py holds it to JAX)
    m = UNetPRes(neurons=2, nbf=SIZE, compute_dtype="bfloat16").eval()
    with torch.no_grad():
        out = m(torch.zeros(1, SIZE, SIZE, 1), m.initial_zero_hebb(1))
    assert m.compute_dtype == torch.bfloat16 and out.activout.dtype == torch.float32
    assert bool(torch.isfinite(out.activout).all())


def test_padded_training_through_start_train(tmp_path):
    """tests/test_trunk_pad.py::test_padded_training_through_driver, through
    the port's driver: finite losses that move, the reference artifacts."""
    x_train, x_valid, y_train, y_valid = synthetic_split(6, 3, size=SIZE, seed=9)
    cfg = TrainConfig(out_dir=str(tmp_path / "pad"), epochs=2, lr=3e-4, val_every=2, save_every=2, im_width=SIZE,
                      im_height=SIZE, im_chan=1, neurons=2, dropout_ratio=0.25, trunk_pad=32,
                      matmul_precision="parity")
    res = start_train(x_train, x_valid, y_train, y_valid, cfg, device="cpu")
    assert res.model.trunk_pad == 32
    assert np.all(np.isfinite(res.all_losses)) and res.all_losses[0] != res.all_losses[-1]
    assert os.path.exists(str(tmp_path / "pad" / "train_net.pth"))
