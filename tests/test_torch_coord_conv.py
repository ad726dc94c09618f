"""The port's CoordConv U-Net (plastic_unet_tpu_torch.models.coord_conv,
train.coord_trainer, cli.coord_conv) on the CPU against the JAX package's:
add_coords, the forward on parameters carried by coord_conv_name_map (the
ConvTranspose kernels flipped), keras_bce and keras_mean_iou, two epochs of
do_training from the same parameters, data and seed (per-epoch losses,
val_loss and the final parameters), the artifacts and TimedStopping
(mirroring tests/test_coord_trainer.py), start_prediction's resize-back,
and the CLI on a fake TGS directory."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models.coord_conv import CoordConvUNet as JaxCoordConvUNet
from plastic_unet_tpu.ops.coords import add_coords as jax_add_coords
from plastic_unet_tpu.train import coord_trainer as jct
from plastic_unet_tpu_torch.data.synthetic import synthetic_tiles
from plastic_unet_tpu_torch.models.coord_conv import CoordConvUNet
from plastic_unet_tpu_torch.ops.coords import add_coords
from plastic_unet_tpu_torch.train import coord_trainer as tct
from plastic_unet_tpu_torch.utils.torch_interop import coord_conv_name_map, state_dict_from_jax_params

from test_torch_dataset import make_tgs_dir

torch.set_num_threads(2)

SIZE = 32  # CoordConvUNet needs /16-divisible inputs
# the port against JAX after 2 epochs (8 Adam steps at lr 1e-3), fp32. The losses and metrics hold to 1e-5. The
# gradients agree to float rounding, but the deep levels' are ~1e-8, the size of Adam's eps, and Adam scales every
# gradient to a step of ~lr whatever its size: a rounding difference there moves the step, and near zero flips its
# sign. So the parameters hold on average to 2e-5 and each to two steps' size, 2 * lr.
LOSS_ATOL, PARAM_MEAN_ATOL, PARAM_ATOL = 1e-5, 2e-5, 2e-3


def _data(n, seed=0):
    imgs, masks = synthetic_tiles(n, size=SIZE, seed=seed)
    X = np.transpose(imgs, (0, 2, 3, 1)) * 255.0  # the Keras path feeds 0..255 (x/255 in the model)
    return X.astype(np.float32), np.transpose(masks, (0, 2, 3, 1)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX module and its init parameters (with_r: every stem channel)."""
    jm = JaxCoordConvUNet(im_chan=1, with_r=True)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)))["params"]
    return jm, params


def _port(params, with_r=True):
    tm = CoordConvUNet(im_chan=1, with_r=with_r)
    tm.load_state_dict(state_dict_from_jax_params(params, coord_conv_name_map()), strict=True)
    return tm


@pytest.mark.parametrize("with_r", [False, True])
def test_add_coords_matches_jax(with_r):
    x = np.random.default_rng(0).standard_normal((2, 7, 5, 3)).astype(np.float32)
    got = add_coords(torch.from_numpy(x), with_r).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_add_coords(jnp.asarray(x), with_r)))


def test_name_map_covers_the_flax_tree(jax_model):
    _, params = jax_model
    paths = {tuple(str(getattr(k, "key", k)) for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}
    m = coord_conv_name_map()
    assert set(m) == paths and len(m) == 2 * 24
    assert [key for key, _ in m.values()] == list(CoordConvUNet().state_dict())


def test_forward_matches_jax(jax_model):
    """The carried parameters give the JAX forward: the four ConvTranspose
    kernels only with the flip (without it the maps differ)."""
    jm, params = jax_model
    X, _ = _data(3, seed=1)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(X)))
    tm = _port(params).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(X)).numpy()
    assert got.shape == (3, SIZE, SIZE, 1)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    unflipped = state_dict_from_jax_params(params, coord_conv_name_map())
    for j in range(4):  # the same kernels carried without the flip
        k = np.asarray(params[f"ConvTranspose_{j}"]["kernel"])
        unflipped[f"upconvs.{j}.weight"] = torch.from_numpy(np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1))))
    tm.load_state_dict(unflipped, strict=True)
    with torch.no_grad():
        assert float(np.abs(tm(torch.from_numpy(X)).numpy() - ref).max()) > 1e-3


def test_keras_bce_matches_jax(rng):
    p = rng.random(1000).astype(np.float32)
    p[:5] = [0.0, 1.0, 1e-9, 1 - 1e-9, 0.5]  # inside and outside the clip
    y = (rng.random(1000) > 0.5).astype(np.float32)
    got = float(tct.keras_bce(torch.from_numpy(p), torch.from_numpy(y)))
    assert got == pytest.approx(float(jct.keras_bce(jnp.asarray(p), jnp.asarray(y))), rel=1e-6)


@pytest.mark.parametrize("case", ["random", "perfect", "inverted", "no_salt", "all_salt"])
def test_keras_mean_iou_matches_jax(case):
    rng = np.random.default_rng(3)
    y = (rng.random((4, SIZE, SIZE, 1)) > 0.5).astype(np.float32)
    p = rng.random((4, SIZE, SIZE, 1)).astype(np.float32)
    if case == "perfect":
        p = y.copy()
    elif case == "inverted":
        p = 1 - y
    elif case == "no_salt":  # background alone: its IoU, not half of it
        y = np.zeros_like(y)
        p = p * 0.4
    elif case == "all_salt":
        y = np.ones_like(y)
    got = float(tct.keras_mean_iou(torch.from_numpy(y), torch.from_numpy(p)))
    want = float(jct.keras_mean_iou(jnp.asarray(y), jnp.asarray(p)))
    assert got == pytest.approx(want, abs=1e-6)
    if case in ("perfect", "no_salt"):
        assert got == pytest.approx(1.0, abs=1e-6)


def test_do_training_matches_jax(jax_model, tmp_path):
    """2 epochs (36 training tiles: 4 batches of 8 a epoch, the remainder
    dropped; 4 validation tiles) from the same parameters, data and seed."""
    jm, params = jax_model
    X, Y = _data(40, seed=2)
    jparams, jhist = jct.do_training(jm, params, X, Y, epochs=2, max_train_time=-1,
                                     model_file=str(tmp_path / "j.ckpt"), seed=5)
    tm, hist = tct.do_training(_port(params), X, Y, epochs=2, max_train_time=-1,
                               model_file=str(tmp_path / "t.ckpt"), seed=5, device="cpu")
    for key in ("loss", "val_loss", "mean_iou", "val_mean_iou"):
        assert len(hist[key]) == 2
        np.testing.assert_allclose(hist[key], jhist[key], atol=LOSS_ATOL, err_msg=key)
    want = state_dict_from_jax_params(jparams, coord_conv_name_map())
    got = tm.state_dict()
    diffs = []
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=PARAM_ATOL, err_msg=k)
        diffs.append(np.abs(got[k].numpy() - want[k].numpy()).ravel())
    assert float(np.concatenate(diffs).mean()) <= PARAM_MEAN_ATOL


def test_training_and_artifacts(tmp_path):
    X, Y = _data(40)
    model = tct.construct_model(SIZE, SIZE, 1, with_r=False)
    model_file = str(tmp_path / "model-tgs.ckpt")
    model, history = tct.do_training(model, X, Y, epochs=2, max_train_time=-1, model_file=model_file, batch_size=8,
                                     verbose=1, device="cpu")
    assert len(history["loss"]) == 2 and len(history["val_mean_iou"]) == 2
    assert os.path.exists(model_file)  # the best checkpoint
    hist_file = model_file + "_final_history.pickle"
    with open(hist_file, "rb") as f:
        assert set(pickle.load(f)) == {"loss", "val_loss", "mean_iou", "val_mean_iou"}
    final = tct.load_coord_model(model_file + "_final", SIZE, SIZE, 1, with_r=False)
    sd = model.state_dict()
    assert all(torch.equal(t, sd[k]) for k, t in final.state_dict().items())


def test_timed_stopping(tmp_path):
    X, Y = _data(24)
    _, history = tct.do_training(tct.construct_model(SIZE, SIZE, 1, with_r=False), X, Y, epochs=1000,
                                 max_train_time=1, model_file=str(tmp_path / "m.ckpt"), device="cpu")
    assert len(history["loss"]) < 1000


def test_start_prediction_resizes_back_as_jax(jax_model):
    jm, params = jax_model
    X, _ = _data(4, seed=4)
    sizes = [(101, 101)] * 4  # the original tile size; predictions resized back
    got = tct.start_prediction(_port(params), X, sizes, device="cpu")
    want = jct.start_prediction(jm, params, X, sizes)
    assert len(got) == 4 and got[0].shape == (101, 101)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_cli_train_inference_short_run(tmp_path):
    """cli.coord_conv --train --inference --short-run --device cpu on a fake
    TGS directory: the model files, the history, submission-6.csv."""
    import pandas as pd

    from plastic_unet_tpu_torch.cli import coord_conv
    from plastic_unet_tpu_torch.ops.rle import rle_decode

    data = make_tgs_dir(tmp_path / "tgs", n=20, n_test=5)
    out = str(tmp_path / "out")
    subm = coord_conv.main(["--data", data, "--out", out, "--train", "--inference", "--short-run", "--epochs", "2",
                            "--im-size", str(SIZE), "--device", "cpu"])
    assert subm == os.path.join(out, "submission-6.csv")
    for f in ("model-tgs-salt-6.ckpt", "model-tgs-salt-6.ckpt_final", "model-tgs-salt-6.ckpt_final_history.pickle"):
        assert os.path.exists(os.path.join(out, f)), f
    sub = pd.read_csv(subm, index_col="id", keep_default_na=False)
    assert sorted(sub.index) == [f"t{j}" for j in range(5)]
    for rle in sub.rle_mask:
        assert rle_decode(str(rle), (101, 101)).shape == (101, 101)


def test_cli_needs_cuda_unless_told(tmp_path):
    from plastic_unet_tpu_torch.cli import coord_conv

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coord_conv.main(["--data", str(tmp_path), "--train"])
