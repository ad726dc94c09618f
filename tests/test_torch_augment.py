"""Augmentation of the port (plastic_unet_tpu_torch.ops.augment) against
plastic_unet_tpu.ops.augment: fed the choices that the JAX key derivation
makes, augment_stream gives the JAX arrays exactly, for images and for
channel-less masks; parse_tta parses as the JAX one does."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.ops import augment as jaug
from plastic_unet_tpu_torch.ops import augment as taug


def jax_choices(key, n):
    """(n, 3) choices as plastic_unet_tpu.ops.augment draws them: one key per
    sample, split into h-flip, v-flip and rotation keys (augment.py:133-135)."""

    def one(k):
        kh, kv, kr = jax.random.split(k, 3)
        return jnp.stack([jax.random.bernoulli(kh).astype(jnp.int32), jax.random.bernoulli(kv).astype(jnp.int32),
                          jax.random.randint(kr, (), 0, 4)])

    return np.asarray(jax.vmap(one)(jax.random.split(key, n)))


def _stream(n, size, seed, mask_channel):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, 1)).astype(np.float32)
    y = (rng.random((n, size, size) + ((1,) if mask_channel else ())) > 0.5).astype(np.float32)
    return x, y


@pytest.mark.parametrize("mask_channel", [False, True], ids=["mask_hw", "mask_hwc"])
@pytest.mark.parametrize("seed", [0, 5])
def test_augment_stream_matches_jax(seed, mask_channel):
    x, y = _stream(24, 9, seed, mask_channel)
    key = jax.random.PRNGKey(seed)
    want_x, want_y = jaug.augment_stream(key, jnp.asarray(x), jnp.asarray(y))
    choices = jax_choices(key, x.shape[0])
    assert set(map(tuple, choices[:, :2])) >= {(0, 0), (1, 1)} and set(choices[:, 2]) == {0, 1, 2, 3}
    got_x, got_y = taug.augment_stream(torch.from_numpy(x), torch.from_numpy(y), torch.tensor(choices, dtype=torch.int64))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


@pytest.mark.parametrize("choice", [(h, v, k) for h in (0, 1) for v in (0, 1) for k in range(4)])
def test_each_choice_is_hflip_then_vflip_then_rot90(choice):
    """Every one of the 16 choices, on a non-symmetric tile, as the JAX ops compose."""
    img = np.arange(7 * 7 * 2, dtype=np.float32).reshape(7, 7, 2)
    mask = np.arange(49, dtype=np.float32).reshape(7, 7)
    want_i, want_m = jnp.asarray(img), jnp.asarray(mask)
    if choice[0]:
        want_i, want_m = jaug.flip_h(want_i), jaug.flip_h(want_m, False)
    if choice[1]:
        want_i, want_m = jaug.flip_v(want_i), jaug.flip_v(want_m, False)
    want_i, want_m = jaug.rot90k(want_i, choice[2]), jaug.rot90k(want_m, choice[2], False)
    got_i, got_m = taug.random_flip_rotate(torch.tensor(choice), torch.from_numpy(img), torch.from_numpy(mask))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    for fn, jfn in ((taug.flip_h, jaug.flip_h), (taug.flip_v, jaug.flip_v)):
        np.testing.assert_array_equal(fn(torch.from_numpy(img)).numpy(), np.asarray(jfn(jnp.asarray(img))))
    np.testing.assert_array_equal(taug.rot90k(torch.from_numpy(img), choice[2]).numpy(),
                                  np.asarray(jaug.rot90k(jnp.asarray(img), choice[2])))


def test_draw_augment_choices():
    gen = torch.Generator().manual_seed(3)
    c = taug.draw_augment_choices(4000, gen)
    assert c.shape == (4000, 3) and c.dtype == torch.int64
    assert set(c[:, 0].tolist()) == {0, 1} and set(c[:, 1].tolist()) == {0, 1} and set(c[:, 2].tolist()) == {0, 1, 2, 3}
    for col, p in ((0, 0.5), (1, 0.5)):
        assert abs(float(c[:, col].float().mean()) - p) < 0.05
    assert torch.equal(c, taug.draw_augment_choices(4000, torch.Generator().manual_seed(3)))
    with pytest.raises(ValueError, match="choices"):
        taug.augment_stream(torch.zeros(3, 4, 4, 1), torch.zeros(3, 4, 4), c[:2])


@pytest.mark.parametrize("spec", ["tta2", "tta4", "tta8", "all", " TTA4 ", "identity", "identity, hflip,rot270",
                                  "transpose,anti_transpose"])
def test_parse_tta_matches_jax(spec):
    assert taug.parse_tta(spec) == jaug.parse_tta(spec)
    assert tuple(taug.TTA_TRANSFORMS) == tuple(jaug.TTA_TRANSFORMS)


@pytest.mark.parametrize("spec", ["", " , ", "identity,flip", "tta3"])
def test_parse_tta_errors_match_jax(spec):
    with pytest.raises(ValueError) as want:
        jaug.parse_tta(spec)
    with pytest.raises(ValueError) as got:
        taug.parse_tta(spec)
    assert str(got.value) == str(want.value)
