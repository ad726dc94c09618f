"""The port's TTA and single-image serving (ops.augment views, submit.inference
predict_masks_tta / inference / predict(save_masks=True), MaskPredictor(tta=...))
on the CPU against the JAX package, UNetPRes at nbf=16, neurons=2, JAX init
weights carried by state_dict_from_jax_params, inputs from a numpy seed.
Probabilities within atol=1e-5, the tolerance of the port's model tests
(tests/test_torch_unet_res.py): fp32 sums in another order."""

import importlib
import os
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.ops import augment as jaug
from plastic_unet_tpu.submit.server import MaskPredictor as JaxMaskPredictor
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops import augment as taug
from plastic_unet_tpu_torch.submit import inference as tinf
from plastic_unet_tpu_torch.submit.server import MaskPredictor
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params

torch.set_num_threads(2)

jinf = importlib.import_module("plastic_unet_tpu.submit.inference")

SIZE, ATOL = 16, 1e-5
VIEWS = tuple(jaug.TTA_TRANSFORMS)


@pytest.fixture(scope="module")
def models():
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, nbf=SIZE, rule="hebb")
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, SIZE, SIZE, 1)), jm.initial_zero_hebb(1))["params"]
    tm = UNetPRes(neurons=2, nbf=SIZE, rule="hebb")
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, tm


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal((n, SIZE, SIZE, 1)).astype(np.float32)


def _gap_threshold(probs) -> float:
    """A threshold in the widest gap between the middle half of the sorted
    probabilities, so that no pixel lies within the tolerance of it and both
    packages set the same pixels."""
    p = np.unique(np.asarray(probs, np.float32))
    mid = p[len(p) // 4: 3 * len(p) // 4 + 1]
    i = int(np.argmax(np.diff(mid)))
    assert mid[i + 1] - mid[i] > 2 * ATOL
    return float((mid[i] + mid[i + 1]) / 2)


def test_registry_is_the_jax_registry():
    assert tuple(taug.TTA_TRANSFORMS) == VIEWS
    assert (taug.TTA_VIEWS_2, taug.TTA_VIEWS_4, taug.TTA_VIEWS_8) == (jaug.TTA_VIEWS_2, jaug.TTA_VIEWS_4,
                                                                       jaug.TTA_VIEWS_8)


@pytest.mark.parametrize("channels_last", [True, False], ids=["nhwc", "mask"])
@pytest.mark.parametrize("view", VIEWS)
def test_view_and_inverse_equal_jax(view, channels_last):
    """Each view's forward and inverse, on NHWC images and on (N, H, W)
    masks, equal JAX's exactly, and the inverse undoes the forward."""
    shape = (3, 7, 7, 2) if channels_last else (3, 7, 7)
    a = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x = torch.from_numpy(a)
    for i in (0, 1):
        got = taug.TTA_TRANSFORMS[view][i](x, channels_last)
        ref = np.asarray(jaug.TTA_TRANSFORMS[view][i](jnp.asarray(a), channels_last))
        np.testing.assert_array_equal(got.numpy(), ref)
    fwd, inv = taug.TTA_TRANSFORMS[view]
    torch.testing.assert_close(inv(fwd(x, channels_last), channels_last), x, rtol=0, atol=0)


def test_expand_and_merge_match_jax():
    a = np.random.default_rng(2).standard_normal((4, 9, 9, 1)).astype(np.float32)
    got = taug.tta_expand(torch.from_numpy(a), VIEWS)
    ref = np.asarray(jaug.tta_expand(jnp.asarray(a), VIEWS))
    np.testing.assert_array_equal(got.numpy(), ref)
    preds = np.random.default_rng(3).random((8, 4, 9, 9)).astype(np.float32)
    np.testing.assert_allclose(taug.tta_merge(torch.from_numpy(preds), VIEWS).numpy(),
                               np.asarray(jaug.tta_merge(jnp.asarray(preds), VIEWS)), rtol=0, atol=1e-7)
    # an identity forward: merge(expand(x)) is x
    np.testing.assert_allclose(taug.tta_merge(got[..., 0], VIEWS).numpy(), a[..., 0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("preset", ["tta2", "tta4", "tta8"])
def test_predict_masks_tta_matches_jax(models, preset):
    """Sequential views against JAX; batched views equal sequential bit for bit."""
    jm, params, tm = models
    views = taug.parse_tta(preset)
    x = _images(5)
    ref = np.asarray(jinf.predict_masks_tta(jm, params, jnp.asarray(x), transforms=views, chunk=4))
    seq = tinf.predict_masks_tta(tm, x, transforms=views, chunk=4, device="cpu")
    bat = tinf.predict_masks_tta(tm, x, transforms=views, chunk=4, batch_views=True, device="cpu")
    assert seq.shape == (5, SIZE, SIZE)
    np.testing.assert_allclose(seq.numpy(), ref, rtol=0, atol=ATOL)
    torch.testing.assert_close(bat, seq, rtol=0, atol=0)


def test_strided_input_gives_the_same_masks(models):
    """A view of the images that is not contiguous (a transposed copy read
    back through a transpose) gives the masks of the contiguous images."""
    _, _, tm = models
    x = torch.from_numpy(_images(3, seed=4))
    strided = x.transpose(1, 2).contiguous().transpose(1, 2)
    assert not strided.is_contiguous()
    for batch in (False, True):
        a = tinf.predict_masks_tta(tm, x, transforms=taug.TTA_VIEWS_8, chunk=4, batch_views=batch, device="cpu")
        b = tinf.predict_masks_tta(tm, strided, transforms=taug.TTA_VIEWS_8, chunk=4, batch_views=batch,
                                   device="cpu")
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("layout", ["hw", "hwc", "chw"])
def test_inference_single_image_matches_jax(models, layout):
    jm, params, tm = models
    img = _images(1, seed=5)[0]  # (H, W, 1)
    img = {"hw": img[..., 0], "hwc": img, "chw": np.transpose(img, (2, 0, 1))}[layout]
    got = tinf.inference(tm, img, device="cpu")
    ref = np.asarray(jinf.inference(jm, params, img))
    assert got.shape == (SIZE, SIZE) and isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_predict_save_masks_png_bytes_match_jax(models, tmp_path):
    jm, params, tm = models
    x = _images(4, seed=6)
    ids = [f"t{i}" for i in range(4)]
    probs = np.asarray(jinf.predict_masks_tta(jm, params, jnp.asarray(x), transforms=taug.TTA_VIEWS_4, chunk=4))
    thr = _gap_threshold(probs)
    rp = {"img_height": SIZE, "img_width": SIZE, "img_chan": 1, "mask_threshold": thr, "subm_file": "s.csv"}
    test_df = pd.DataFrame({"images": [im for im in x]}, index=ids)
    jinf.predict(jm, params, test_df, dict(rp, out_dir=str(tmp_path / "jax")), save_masks=True,
                 tta=taug.TTA_VIEWS_4, chunk=4)
    tinf.predict(tm, ids, x, dict(rp, out_dir=str(tmp_path / "port")), save_masks=True, tta=taug.TTA_VIEWS_4,
                 chunk=4, device="cpu")
    n_set = 0
    for idx in ids:
        port, jax_png = (tmp_path / d / "masks" / f"{idx}.png" for d in ("port", "jax"))
        assert port.read_bytes() == jax_png.read_bytes(), idx
        n_set += int((np.asarray(Image.open(port))[..., 0] > 0).sum())
    assert 0 < n_set < 4 * SIZE * SIZE


def test_predict_visualize_raises(models, tmp_path, monkeypatch):
    """visualize=True without matplotlib raises ImportError naming it, before
    any prediction or file (the figures themselves: tests/test_torch_viz.py)."""
    _, _, tm = models
    rp = {"out_dir": str(tmp_path), "img_height": SIZE, "img_width": SIZE, "img_chan": 1, "mask_threshold": 0.5,
          "subm_file": "s.csv"}
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tinf.predict(tm, ["a"], _images(1), rp, visualize=True, device="cpu")
    assert not os.path.exists(tmp_path / "s.csv")


@pytest.mark.parametrize("own_threshold", [False, True])
def test_mask_predictor_tta_matches_jax(models, own_threshold):
    """predict and predict_rle through tta4, without a threshold (the
    probabilities; RLE at a call's threshold) and with one (boolean masks)."""
    jm, params, tm = models
    x = _images(3, seed=7)[..., 0]
    probs = JaxMaskPredictor(jm, params, chunk=4, tta=taug.TTA_VIEWS_4).predict(x)
    thr = _gap_threshold(probs)
    own = thr if own_threshold else None
    jp = JaxMaskPredictor(jm, params, chunk=4, tta=taug.TTA_VIEWS_4, threshold=own)
    tp = MaskPredictor(tm, chunk=4, tta=taug.TTA_VIEWS_4, threshold=own, device="cpu")
    ref, got = jp.predict(x), tp.predict(x)
    if own is None:
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    else:
        assert got.dtype == bool
        np.testing.assert_array_equal(got, ref)
    assert tp.predict_rle(x, threshold=thr) == jp.predict_rle(x, threshold=thr)


def test_from_pth_refuses_unported_options(tmp_path, models):
    _, _, tm = models
    path = str(tmp_path / "m.pth")
    torch.save(tm.state_dict(), path)
    with pytest.raises(ValueError, match="unet_res-only knob"):  # the JAX predictor's refusal
        MaskPredictor.from_pth(path, arch="unet", nbf=SIZE, compute_dtype=torch.bfloat16, device="cpu")
    # UNetPRes in bf16 raised until the bf16 trunk was ported; it serves now
    bf16 = MaskPredictor.from_pth(path, nbf=SIZE, neurons=2, compute_dtype=torch.bfloat16, device="cpu")
    assert bf16.model.compute_dtype == torch.bfloat16
    p = MaskPredictor.from_pth(path, nbf=SIZE, neurons=2, tta=("identity", "hflip"), device="cpu")
    assert p.tta == ("identity", "hflip")
