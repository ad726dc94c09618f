"""The port's classic plastic U-Net (plastic_unet_tpu_torch.models.unet_classic.UNetP,
CPU, the plastic head's plain version) against the JAX package's UNetP:
the forward at 32 and 128 px (hebb/oja x free/yoked x ConvTranspose/bilinear;
batch_norm at the module level with batch_stats), a 4-step B=1 training
trajectory against the JAX make_epoch_fn, the name maps, the 101-px error,
the driver end to end (mirroring tests/test_classic_train.py), the
predictor, TTA, the export artifact and the options UNetP refuses. Weights
come from the JAX init through state_dict_from_jax_params, inputs from a
numpy seed."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.config import TrainConfig as JaxTrainConfig
from plastic_unet_tpu.models import UNetP as JaxUNetP
from plastic_unet_tpu.submit.inference import predict_masks_tta as jax_predict_masks_tta
from plastic_unet_tpu.train import driver as jdriver
from plastic_unet_tpu.train import loop as jloop
from plastic_unet_tpu.train.optimizer import adam_step_lr as jax_adam_step_lr
from plastic_unet_tpu.utils import torch_interop as jti
from plastic_unet_tpu_torch.config import TrainConfig
from plastic_unet_tpu_torch.data.synthetic import synthetic_split, synthetic_tiles
from plastic_unet_tpu_torch.eval.evaluate import predict_masks
from plastic_unet_tpu_torch.models import UNetP
from plastic_unet_tpu_torch.models.blocks import BatchNorm
from plastic_unet_tpu_torch.submit.export import export_predictor, load_predictor
from plastic_unet_tpu_torch.submit.inference import predict_masks_tta
from plastic_unet_tpu_torch.submit.quant import quantize_for_serving
from plastic_unet_tpu_torch.submit.server import MaskPredictor
from plastic_unet_tpu_torch.train import driver
from plastic_unet_tpu_torch.train.loop import create_train_state, make_epoch_fn
from plastic_unet_tpu_torch.utils.torch_interop import (
    state_dict_from_jax_params,
    trace_from_jax,
    unetp_batch_stats_map,
    unetp_name_map,
)

torch.set_num_threads(2)

SIZE, B = 32, 3
LR, GAMMA, STEPLR, STEPS = 1e-3, 0.5, 3, 4
TTA4 = ("identity", "hflip", "vflip", "rot180")


def _jax_variables(size, seed=0, bilinear=False, batch_norm=False, **kw):
    """(JAX UNetP, its variables) with the weights of a seeded port model (BN
    parameters and statistics drawn at random too), through the JAX
    package's own converter: no JAX init, whose random draws compile slowly
    on the CPU."""
    jm = JaxUNetP(n_channels=1, n_classes=1, nbf=size, bilinear_upsample=bilinear, batch_norm=batch_norm, **kw)
    tm = UNetP(nbf=size, bilinear_upsample=bilinear, batch_norm=batch_norm, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for bn in (m for m in tm.modules() if isinstance(m, BatchNorm)):
            for t, lo, scale in ((bn.weight, 0.5, 1.0), (bn.bias, -0.1, 0.2), (bn.running_mean, -0.1, 0.2),
                                 (bn.running_var, 0.5, 1.0)):
                t.copy_(lo + scale * torch.rand(t.shape, generator=g))
    sd = tm.state_dict()
    v = {"params": jti.state_dict_to_flax_params(sd, unetp_name_map(bilinear, batch_norm))}
    if batch_norm:
        v["batch_stats"] = jti.state_dict_to_flax_params(sd, {p: (k, None) for p, k in unetp_batch_stats_map().items()})
    return jm, v


def _port(params, size, bilinear=False, **kw):
    tm = UNetP(n_channels=1, n_classes=1, nbf=size, bilinear_upsample=bilinear, **kw)
    tm.load_state_dict(state_dict_from_jax_params(params, unetp_name_map(bilinear)), strict=True)
    return tm


def _inputs(n, size, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, size, size, 1)).astype(np.float32)
    hebb = (rng.standard_normal((n, size, size)) * 0.1).astype(np.float32)
    return x, hebb


FORWARD_CASES = [(SIZE, r, a, bil) for r in ("hebb", "oja") for a in ("free", "yoked") for bil in (False, True)]
FORWARD_CASES += [(128, "hebb", "free", False), (128, "oja", "yoked", True)]


@pytest.mark.parametrize("size,rule,alfa_type,bilinear", FORWARD_CASES)
def test_forward_matches_jax(size, rule, alfa_type, bilinear):
    jm, v = _jax_variables(size, seed=size, bilinear=bilinear, rule=rule, alfa_type=alfa_type)
    x, hebb = _inputs(2, size, seed=7)
    ref = jm.apply(v, jnp.asarray(x), jnp.asarray(hebb))
    tm = _port(v["params"], size, bilinear, rule=rule, alfa_type=alfa_type).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(hebb))
    for name, g, r in zip(("activ", "activout", "hebb"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches_jax(train):
    """batch_norm at the module level: train mode against apply(...,
    mutable=["batch_stats"]) (outputs and the updated statistics), eval mode
    against apply with the statistics; flax BN semantics."""
    jm, v = _jax_variables(SIZE, seed=3, batch_norm=True)
    rng = np.random.default_rng(4)
    warm = rng.standard_normal((B, SIZE, SIZE, 1)).astype(np.float32) * 2 + 0.5
    x, hebb = _inputs(B, SIZE, seed=5)
    fn = jax.jit(lambda v, x, h: jm.apply(v, x, h, train=True, mutable=["batch_stats"]))
    _, upd = fn(v, jnp.asarray(warm), jnp.asarray(hebb))
    v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    tm = UNetP(n_channels=1, n_classes=1, nbf=SIZE, batch_norm=True)
    tm.load_state_dict(state_dict_from_jax_params(v["params"], unetp_name_map(batch_norm=True),
                                                  batch_stats=v["batch_stats"], stats_map=unetp_batch_stats_map()),
                       strict=True)
    if train:
        ref, upd = fn(v, jnp.asarray(x), jnp.asarray(hebb))
        got = tm.train()(torch.from_numpy(x), torch.from_numpy(hebb))
        want = state_dict_from_jax_params(v["params"], unetp_name_map(batch_norm=True),
                                          batch_stats=upd["batch_stats"], stats_map=unetp_batch_stats_map())
        stats = {k: t for k, t in tm.state_dict().items() if k.endswith(("running_mean", "running_var"))}
        assert len(stats) == 2 * 2 * 9
        for k, t in stats.items():
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), atol=1e-6, rtol=1e-5, err_msg=k)
    else:
        ref = jm.apply(v, jnp.asarray(x), jnp.asarray(hebb))
        with torch.no_grad():
            got = tm.eval()(torch.from_numpy(x), torch.from_numpy(hebb))
    for name, g, r in zip(("activ", "activout", "hebb"), got, ref):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=1e-5, err_msg=name)


@pytest.mark.parametrize("rule,loss_space", [("hebb", "probs"), ("oja", "logits")])
def test_trajectory_matches_jax_epoch(rule, loss_space):
    """4 steps at B=1 against the JAX epoch: losses within 5e-5, parameters
    within 5e-4, the trace within 1e-4, eta exactly 0.01."""
    rng = np.random.default_rng(11)
    X = (rng.standard_normal((STEPS, 1, SIZE, SIZE, 1)) * 0.5).astype(np.float32)
    Y = (rng.random((STEPS, 1, SIZE, SIZE)) > 0.5).astype(np.float32)
    jm, v = _jax_variables(SIZE, seed=3, rule=rule)
    params0 = jax.tree_util.tree_map(np.asarray, v["params"])
    tx = jax_adam_step_lr(LR, GAMMA, STEPLR)
    jstate = jloop.TrainState(params=v["params"], opt_state=tx.init(v["params"]), hebb=jm.initial_zero_hebb(1),
                              step=jnp.zeros((), jnp.int32))
    epoch = jloop.make_epoch_fn(jm, tx, loss_space=loss_space, donate=False)
    final, jl = epoch(jstate, jnp.asarray(X), jnp.asarray(Y), jax.random.PRNGKey(0))

    tm = _port(params0, SIZE, rule=rule)
    state = create_train_state(tm, LR, GAMMA, STEPLR, device="cpu")
    state, losses = make_epoch_fn(loss_space=loss_space)(state, torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), atol=5e-5)
    want = state_dict_from_jax_params(final.params, unetp_name_map())
    got = state.model.state_dict()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=5e-4, err_msg=k)
    assert float(state.model.eta.detach()) == float(np.float32(0.01))
    np.testing.assert_array_equal(np.asarray(final.params["eta"]), np.array([0.01], np.float32))
    np.testing.assert_allclose(state.hebb.numpy(), trace_from_jax(final.hebb).numpy(), atol=1e-4)
    assert float(state.hebb.abs().max()) > 0.0 and state.step == STEPS


@pytest.mark.parametrize("bilinear,batch_norm", [(False, False), (True, False), (False, True)])
def test_name_map_and_state_dict_keys(bilinear, batch_norm):
    """The port's map holds the JAX map's entries (BN adds its own), and
    its torch keys are the module's state_dict keys, in order."""
    m = unetp_name_map(bilinear, batch_norm)
    if not batch_norm:
        assert m == jti.unetp_name_map(bilinear)
    else:
        assert {k: v for k, v in m.items() if "BatchNorm_0" not in k and "BatchNorm_1" not in k} == {
            k: (v[0].replace("conv.2.", "conv.3."), v[1]) for k, v in jti.unetp_name_map(bilinear).items()}
    tm = UNetP(nbf=SIZE, bilinear_upsample=bilinear, batch_norm=batch_norm)
    params = [k for k in tm.state_dict() if not k.endswith(("running_mean", "running_var"))]
    assert [key for key, _ in m.values()] == params
    assert ("inc.conv.conv.0.weight" in params and "down1.mpconv.1.conv.0.weight" in params
            and ("up1.up.weight" in params) != bilinear and "outc.conv.weight" in params)


def test_101px_raises_the_jax_error():
    jm, v = _jax_variables(101)
    x = np.zeros((1, 101, 101, 1), np.float32)
    with pytest.raises(ValueError, match="divisible by 16") as je:
        jm.apply(v, jnp.asarray(x), jm.initial_zero_hebb(1))
    tm = UNetP(nbf=101)
    with pytest.raises(ValueError, match="divisible by 16") as te:
        tm(torch.from_numpy(x), tm.initial_zero_hebb(1))
    assert str(te.value) == str(je.value)


OPTIONS = [dict(trunk_pad=128), dict(patch_conv=32), dict(pallas_trunk=True), dict(fast_dw=True),
           dict(remat_trunk=True), dict(compute_dtype="bfloat16")]


@pytest.mark.parametrize("option", OPTIONS, ids=[next(iter(o)) for o in OPTIONS])
def test_refused_options_match_jax(option):
    with pytest.raises(ValueError) as je:
        jdriver.build_model(JaxTrainConfig(arch="unet", im_width=SIZE, **option))
    with pytest.raises(ValueError) as te:
        driver.build_model(TrainConfig(arch="unet", im_width=SIZE, **option))
    assert str(te.value) == str(je.value)


def test_build_model_and_name_map():
    m = driver.build_model(TrainConfig(arch="unet", im_width=SIZE, bilinear_upsample=True, use_pallas=True))
    assert isinstance(m, UNetP) and m.nbf == SIZE and m.bilinear_upsample and m.use_pallas
    # plastic=False is not passed to UNetP, as in the JAX driver; its map loses the head keys as there
    m = driver.build_model(TrainConfig(arch="unet", im_width=SIZE, plastic=False))
    assert "w" in m.state_dict()
    assert driver.name_map_for(TrainConfig(arch="unet", plastic=False)) == jdriver.name_map_for(
        JaxTrainConfig(arch="unet", plastic=False))
    with pytest.raises(ValueError, match="batch_stats"):
        driver.build_model(TrainConfig(arch="unet", im_width=SIZE, batch_norm=True))


def test_driver_e2e(tmp_path):
    """train (from a .pth of carried JAX-layout weights) -> reference-format
    checkpoint -> .pth resume -> threshold search -> inference -> RLE
    submission, on the classic model (the JAX test_unetp_driver_e2e)."""
    import pandas as pd

    from plastic_unet_tpu_torch.ops.rle import rle_decode
    from plastic_unet_tpu_torch.submit.inference import start_inference

    x_train, x_valid, y_train, y_valid = synthetic_split(8, 4, size=SIZE, seed=5)
    _, v = _jax_variables(SIZE, seed=9)
    init = str(tmp_path / "init.pth")
    jti.save_pth(jti.flax_params_to_state_dict(v["params"], jti.unetp_name_map()), init)
    kw = dict(arch="unet", epochs=2, lr=3e-4, val_every=1, save_every=2, steplr=1e5, im_width=SIZE, im_height=SIZE,
              im_chan=1, debug=True, matmul_precision="parity", loss_space="probs", load=True, model_path=init)
    result = driver.start_train(x_train, x_valid, y_train, y_valid, TrainConfig(out_dir=str(tmp_path / "out"), **kw),
                                device="cpu")
    assert type(result.model).__name__ == "UNetP"
    assert len(result.all_losses) == 16 and len(result.val_accuracies) == 2
    assert all(np.isfinite(result.all_losses))

    prefix = os.path.join(str(tmp_path / "out"), "train")
    sd = torch.load(prefix + "_net.pth", map_location="cpu", weights_only=True)
    assert sd["w"].shape == (SIZE, SIZE) and any(k.startswith("inc.") for k in sd)
    assert list(sd) == [key for key, _ in driver.name_map_for(TrainConfig(arch="unet")).values()]

    kw2 = dict(kw, epochs=1, save_every=1, model_path=prefix + "_net.pth")
    result2 = driver.start_train(x_train, x_valid, y_train, y_valid,
                                 TrainConfig(out_dir=str(tmp_path / "out2"), **kw2), device="cpu")
    assert len(result2.all_losses) == 8 and all(np.isfinite(result2.all_losses))

    test_imgs, _ = synthetic_tiles(5, size=SIZE, seed=6)
    ids = [f"tile{i}" for i in range(5)]
    subm = start_inference(result.model, ids, test_imgs[:, 0], x_valid, y_valid, out_dir=str(tmp_path / "out"),
                           img_width=SIZE, img_height=SIZE, img_chan=1, device="cpu")
    sub = pd.read_csv(subm, index_col="id", keep_default_na=False)
    assert list(sub.index) == ids
    for rle in sub.rle_mask:
        assert rle_decode(str(rle), (SIZE, SIZE)).shape == (SIZE, SIZE)


@pytest.fixture(scope="module")
def classic(tmp_path_factory):
    """(JAX module, params, the port's model, a .pth the port wrote)."""
    jm, v = _jax_variables(SIZE, seed=2, rule="oja")
    tm = _port(v["params"], SIZE, rule="oja").eval()
    path = str(tmp_path_factory.mktemp("pth") / "unetp.pth")
    torch.save(tm.state_dict(), path)
    return jm, v["params"], tm, path


def test_mask_predictor_from_pth(classic):
    jm, params, tm, path = classic
    p = MaskPredictor.from_pth(path, arch="unet", nbf=SIZE, rule="oja", device="cpu")
    assert isinstance(p.model, UNetP)
    x = np.random.default_rng(3).random((5, SIZE, SIZE), dtype=np.float32)
    got = p.predict(x)
    np.testing.assert_array_equal(got, predict_masks(tm, x[..., None], device="cpu").numpy())
    jp = jti.load_pth(path)
    ref = jax_predict_masks_tta(JaxUNetP(nbf=SIZE, rule="oja"),
                                       jti.state_dict_to_flax_params(jp, jti.unetp_name_map()), jnp.asarray(x[..., None]))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_tta4_matches_jax_and_folds(classic):
    jm, params, tm, _ = classic
    x = np.random.default_rng(4).random((6, SIZE, SIZE, 1), dtype=np.float32)
    got = predict_masks_tta(tm, x, transforms=TTA4, chunk=4, device="cpu")
    folded = predict_masks_tta(tm, x, transforms=TTA4, chunk=4, batch_views=True, device="cpu")
    ref = jax_predict_masks_tta(jm, params, jnp.asarray(x), transforms=TTA4, chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(folded.numpy(), got.numpy(), rtol=0, atol=1.2e-7)


def test_export_artifact_equals_live(classic, tmp_path):
    _, _, tm, _ = classic
    path = export_predictor(tm, str(tmp_path / "art"), chunk=4, platforms=("cpu",))
    pred = load_predictor(path, device="cpu")
    assert pred.meta["model"] == "UNetP" and pred.meta["neurons"] is None and pred.meta["nbf"] == SIZE
    x = np.random.default_rng(5).random((7, SIZE, SIZE, 1), dtype=np.float32)
    np.testing.assert_array_equal(pred.predict(x), predict_masks_tta(tm, x, chunk=4, device="cpu").numpy())


def test_int8_is_refused(classic):
    """The JAX UNetP has no quant field; the port raises rather than serve fp32."""
    _, _, tm, _ = classic
    with pytest.raises(ValueError, match="UNetPRes mode"):
        quantize_for_serving(tm, np.zeros((2, SIZE, SIZE, 1), np.float32), device="cpu")


@pytest.mark.parametrize("cli", ["eval", "infer", "export_model"])
def test_cli_arch_unet(classic, tmp_path, cli):
    """--arch unet: cli.eval and cli.infer size tiles at 101 px, as the JAX
    CLIs do, and raise UNetP's geometry error; cli.export_model at --nbf 32
    writes an artifact equal to the live path."""
    from plastic_unet_tpu_torch.cli import eval as tcli_eval
    from plastic_unet_tpu_torch.cli import export_model, infer

    from test_torch_dataset import make_tgs_dir

    _, _, tm, path = classic
    if cli == "export_model":
        out = export_model.main(["-m", path, "-o", str(tmp_path / "art"), "--arch", "unet", "--nbf", str(SIZE),
                                 "--prule", "oja", "--chunk", "4", "--platforms", "cpu"])
        x = np.random.default_rng(6).random((3, SIZE, SIZE, 1), dtype=np.float32)
        np.testing.assert_array_equal(load_predictor(out, device="cpu").predict(x),
                                      predict_masks_tta(tm, x, chunk=4, device="cpu").numpy())
        return
    pth = str(tmp_path / "unetp101.pth")
    torch.save(UNetP(nbf=101).state_dict(), pth)
    data = make_tgs_dir(tmp_path / "tgs", n_test=2)
    argv = ["-m", pth, "-i", data, "--arch", "unet", "--device", "cpu"]
    with pytest.raises(ValueError, match="divisible by 16"):
        (tcli_eval if cli == "eval" else infer).main(argv + (["-o", str(tmp_path / "o")] if cli == "infer" else []))
