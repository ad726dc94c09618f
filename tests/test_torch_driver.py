"""The port's training driver (plastic_unet_tpu_torch.train.driver) against
plastic_unet_tpu.train.driver: the same run from one .pth gives the same
losses, validation lists, parameters and artifact names; the JAX package's
readers load the port's artifacts; INTERRUPTED on KeyboardInterrupt and
SIGTERM and NAN_ABORT (chunked too) as in tests/test_interrupt.py; resume
from the port's resume-state file is bit-identical to a straight run; the
configuration and the options the port lacks."""

import dataclasses
import os
import pickle
import signal

import numpy as np
import pytest
import torch

import jax

from plastic_unet_tpu.config import TrainConfig as JaxTrainConfig
from plastic_unet_tpu.data.synthetic import synthetic_split
from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.train import driver as jdriver
from plastic_unet_tpu.train import loop as jloop
from plastic_unet_tpu.train.optimizer import adam_step_lr as jax_adam_step_lr
from plastic_unet_tpu.utils import torch_interop as jti
from plastic_unet_tpu_torch.config import TrainConfig
from plastic_unet_tpu_torch.train import driver
from plastic_unet_tpu_torch.train import loop as tloop
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params

torch.set_num_threads(2)

SIZE = 16
REFERENCE_ARTIFACTS = ("_data.hdf5", "_net.pth", "_parameters.dat")


def _data(seed=7, n_train=6, n_val=3):
    return synthetic_split(n_train, n_val, size=SIZE, seed=seed)


def _kw(out_dir, **extra):
    kw = dict(out_dir=str(out_dir), epochs=3, lr=3e-4, val_every=1, save_every=2, rollout=2, steplr=7,
              im_width=SIZE, im_height=SIZE, neurons=2, dropout_ratio=0.0, matmul_precision="parity")
    kw.update(extra)
    return kw


def _reference_files(out_dir):
    return sorted(f for f in os.listdir(out_dir) if f.endswith(REFERENCE_ARTIFACTS))


@pytest.fixture(scope="module")
def jax_pth(tmp_path_factory):
    """A reference-format .pth of JAX-initialized UNetPRes weights."""
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=SIZE)
    st = jloop.create_train_state(jm, jax_adam_step_lr(3e-4, 0.666, 7), jax.random.PRNGKey(5), (SIZE, SIZE, 1))
    path = str(tmp_path_factory.mktemp("pth") / "init.pth")
    jti.save_pth(jti.flax_params_to_state_dict(st.params, jti.unetp_res_name_map()), path)
    return path


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory, jax_pth):
    root = tmp_path_factory.mktemp("runs")
    data = _data()
    want = jdriver.start_train(*data, JaxTrainConfig(**_kw(root / "jax", load=True, model_path=jax_pth)))
    got = driver.start_train(*data, TrainConfig(**_kw(root / "port", load=True, model_path=jax_pth)), device="cpu")
    return root, want, got


def test_driver_matches_jax(both_runs):
    root, want, got = both_runs
    assert len(got.all_losses) == len(want.all_losses) == 3 * 6
    np.testing.assert_allclose(got.all_losses, want.all_losses, atol=5e-5)
    np.testing.assert_allclose(got.val_train_losses, want.val_train_losses, atol=5e-5)
    assert len(got.val_test_losses) == len(want.val_test_losses) == 3
    np.testing.assert_allclose(got.val_test_losses, want.val_test_losses, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.val_accuracies, want.val_accuracies, rtol=1e-5, atol=1e-6)
    ref = state_dict_from_jax_params(want.state.params)
    sd = got.model.state_dict()
    for k in ref:
        np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), atol=5e-4, err_msg=k)
    assert float(got.model.eta.detach()) == float(np.float32(0.01))
    assert got.state.step == int(want.state.step) == 18
    files = _reference_files(root / "port")
    assert files == _reference_files(root / "jax") and "train_2_net.pth" in files and "train_net.pth" in files
    assert os.path.exists(root / "port" / driver.RESUME_STATE)


def test_jax_readers_load_the_port_artifacts(both_runs):
    import h5py

    root, want, got = both_runs
    params = jti.load_unetp_res_pth(str(root / "port" / "train_net.pth"))
    ref = state_dict_from_jax_params(params)
    for k, v in got.model.state_dict().items():
        assert torch.equal(ref[k], v), k
    with h5py.File(root / "port" / "train_data.hdf5", "r") as f, h5py.File(root / "jax" / "train_data.hdf5", "r") as g:
        names = []
        f.visit(names.append)
        jnames = []
        g.visit(jnames.append)
        assert sorted(names) == sorted(jnames)
        np.testing.assert_array_equal(f["train/all_losses"][()], np.asarray(got.all_losses))
        np.testing.assert_allclose(f["train/all_losses"][()], g["train/all_losses"][()], atol=5e-5)
        np.testing.assert_array_equal(f["validation/accuracies"][()], np.asarray(got.val_accuracies))
        np.testing.assert_array_equal(f["net/w"][()], got.model.w.detach().numpy())
        assert f["net/w"].compression == "gzip" and f["net/w"].fletcher32 and f["net/w"].shuffle
    with open(root / "port" / "train_parameters.dat", "rb") as f:
        rp = pickle.load(f)
    with open(root / "jax" / "train_parameters.dat", "rb") as f:
        jrp = pickle.load(f)
    assert list(rp) == list(jrp) and rp["device"] == "cpu" and jrp["device"] == "tpu"
    assert {k: v for k, v in rp.items() if k not in ("out_dir", "device", "stop_time")} == \
        {k: v for k, v in jrp.items() if k not in ("out_dir", "device", "stop_time")}


def _interrupting_eval(monkeypatch, action):
    calls = {"n": 0}
    real_eval = driver.eval_net

    def fake(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            action()
        return real_eval(*a, **kw)

    monkeypatch.setattr(driver, "eval_net", fake)


def _raise_interrupt():
    raise KeyboardInterrupt


@pytest.mark.parametrize("how", ["keyboard", "sigterm"])
def test_interrupt_saves_state(tmp_path, monkeypatch, how):
    cfg = TrainConfig(**_kw(tmp_path / "out", epochs=5, save_every=100, rollout=50000))
    _interrupting_eval(monkeypatch, _raise_interrupt if how == "keyboard"
                       else lambda: os.kill(os.getpid(), signal.SIGTERM))
    with pytest.raises(KeyboardInterrupt):
        driver.start_train(*_data(4, 8, 4), cfg, device="cpu")
    for suffix in REFERENCE_ARTIFACTS:
        assert os.path.exists(os.path.join(cfg.out_dir, "INTERRUPTED" + suffix))
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, signal.default_int_handler)


def test_nan_abort_saves_state(tmp_path):
    x_train, x_valid, y_train, y_valid = _data(4, 8, 4)
    x_train = x_train.copy()
    x_train[0] = np.nan
    cfg = TrainConfig(**_kw(tmp_path / "out", epochs=2, val_every=10, save_every=100))
    with pytest.raises(FloatingPointError, match="epoch 0"):
        driver.start_train(x_train, x_valid, y_train, y_valid, cfg, device="cpu")
    assert os.path.exists(os.path.join(cfg.out_dir, "NAN_ABORT_data.hdf5"))
    assert not os.path.exists(os.path.join(cfg.out_dir, "train_net.pth"))


def test_nan_abort_chunked_truncates_at_first_bad_epoch(tmp_path, monkeypatch):
    import h5py

    real_make = tloop.make_multi_epoch_fn

    def poisoned_make(*a, **kw):
        fn = real_make(*a, **kw)

        def wrapped(*args, **kwargs):
            state, losses = fn(*args, **kwargs)
            losses = losses.clone()
            losses[2] = float("nan")  # rows 0, 1 fine; row 2 bad
            return state, losses

        return wrapped

    monkeypatch.setattr(tloop, "make_multi_epoch_fn", poisoned_make)
    cfg = TrainConfig(**_kw(tmp_path / "out", epochs=4, epochs_per_dispatch=4, val_every=10, save_every=100,
                            rollout=50000))
    with pytest.raises(FloatingPointError, match=r"epoch 2 .*row 2"):
        driver.start_train(*_data(4, 8, 4), cfg, device="cpu")
    with h5py.File(os.path.join(cfg.out_dir, "NAN_ABORT_data.hdf5"), "r") as f:
        saved = np.asarray(f["train"]["all_losses"])
    assert saved.shape[0] == 3 * 8
    assert np.isfinite(saved[: 2 * 8]).all() and not np.isfinite(saved[2 * 8:]).all()


def test_exact_resume_is_bit_identical(tmp_path):
    """2 epochs straight against 1 epoch, then a resume for 1 more, with
    dropout 0.5, shuffle and augmentation: the same bits."""
    data = _data(9, 6, 2)
    kw = dict(val_every=1, save_every=1, rollout=50000, dropout_ratio=0.5, shuffle=True, augment=True)
    straight = driver.start_train(*data, TrainConfig(**_kw(tmp_path / "a", epochs=2, **kw)), device="cpu")
    first = driver.start_train(*data, TrainConfig(**_kw(tmp_path / "b", epochs=1, **kw)), device="cpu")
    state_file = str(tmp_path / "b" / driver.RESUME_STATE)
    rest = driver.start_train(*data, TrainConfig(**_kw(tmp_path / "c", epochs=1, resume_orbax=state_file, **kw)),
                              device="cpu")
    assert first.all_losses + rest.all_losses == straight.all_losses
    assert first.all_losses != rest.all_losses
    assert rest.val_test_losses[-1] == straight.val_test_losses[-1]
    for p, q in zip(rest.model.parameters(), straight.model.parameters()):
        assert torch.equal(p, q)
    for a, b in zip(rest.state.optimizer.state.values(), straight.state.optimizer.state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert rest.state.step == straight.state.step == 12
    assert rest.state.scheduler.get_last_lr() == straight.state.scheduler.get_last_lr()
    assert torch.equal(rest.state.generator.get_state(), straight.state.generator.get_state())
    # the same run without the resume state: another trajectory
    other = driver.start_train(*data, TrainConfig(**_kw(tmp_path / "d", epochs=1, load=True,
                                                        model_path=str(tmp_path / "b" / "train_net.pth"), **kw)),
                               device="cpu")
    assert other.all_losses != rest.all_losses


def test_config_fields_and_run_params_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    assert tf == jf
    assert list(TrainConfig().as_run_params(device="cuda")) == list(JaxTrainConfig().as_run_params())
    assert TrainConfig().as_run_params(1.0)["device"] == "cuda"
    assert TrainConfig().as_run_params(1.0, device="cpu")["stop_time"] == 1.0


# the ids of the cases as they were when every option here raised; option0 was arch="unet" alone
# until UNetP was ported, and is now UNetP with a trunk option it refuses, as the JAX driver does;
# option1 (devices=2) is ported, and start_train raises, naming torchrun, without a process group of 2;
# option6 (compute_dtype="bfloat16") is ported, and build_model makes the bf16 UNetPRes
@pytest.mark.parametrize("option", [pytest.param(dict(arch="unet", remat_trunk=True), id="option0"),
                                    pytest.param(dict(devices=2), id="option1"),
                                    pytest.param(dict(compute_dtype="bfloat16"), id="option6"),
                                    pytest.param(dict(batch_norm=True), id="option7")])
def test_unported_options_raise(option, tmp_path):
    name = list(option)[-1]
    if name == "devices":
        x_train, x_valid, y_train, y_valid = synthetic_split(4, 2, size=SIZE, seed=2)
        cfg = TrainConfig(out_dir=str(tmp_path), im_width=SIZE, im_height=SIZE, neurons=2, **option)
        with pytest.raises(ValueError, match="torchrun"):
            driver.start_train(x_train, x_valid, y_train, y_valid, cfg, device="cpu")
        return
    if name == "compute_dtype":
        m = driver.build_model(TrainConfig(im_width=SIZE, neurons=2, **option))
        assert m.compute_dtype == torch.bfloat16 and all(p.dtype == torch.float32 for p in m.parameters())
        return
    with pytest.raises(ValueError, match=name):
        driver.build_model(TrainConfig(**option))


@pytest.mark.parametrize("option,attr,value", [
    (dict(trunk_pad=32), "trunk_pad", 32),  # takes effect: the model pads to it
    (dict(remat_trunk=True), "remat_trunk", True),  # takes effect: the trunk is checkpointed
    (dict(patch_conv=32), "patch_conv", 32),  # recorded; a TPU lowering of the same conv
    (dict(fast_dw=True), "fast_dw", True),  # recorded; a TPU lowering of the same conv
    (dict(bilinear_upsample=True), "bilinear_upsample", True),  # recorded; unused by UNetPRes
    (dict(rng_impl="rbg"), None, None),  # the JAX PRNG: no trace in the model
    (dict(rng_impl="unsafe_rbg"), None, None),
])
def test_ported_options_accepted(option, attr, value):
    cfg = TrainConfig(im_width=SIZE, neurons=2, **option)
    m = driver.build_model(cfg)
    if attr is not None:
        assert getattr(m, attr) == value
    plain = driver.build_model(TrainConfig(im_width=SIZE, neurons=2))
    sd, sd0 = m.state_dict(), plain.state_dict()  # the same parameters from the same seed
    assert list(sd) == list(sd0) and all(torch.equal(sd[k], sd0[k]) for k in sd)


def test_unknown_rng_impl_raises():
    with pytest.raises(ValueError, match="rng_impl"):
        driver.build_model(TrainConfig(rng_impl="philox"))


def test_unported_option_messages_give_reasons():
    with pytest.raises(ValueError) as e:
        driver.build_model(TrainConfig(devices=2, compute_dtype="bfloat16", batch_norm=True))
    assert "batch_stats" in str(e.value)
    assert "devices" not in str(e.value)  # data parallel is ported (start_train's route)
    assert "compute_dtype" not in str(e.value) and "A4d" not in str(e.value)  # so is the bf16 trunk


def test_accepted_options_and_no_plastic():
    m = driver.build_model(TrainConfig(use_pallas=True, pallas_trunk=True, im_width=SIZE, neurons=2))
    assert m.plastic and m.nbf == SIZE
    m = driver.build_model(TrainConfig(plastic=False, im_width=SIZE, neurons=2))
    assert not m.plastic and "w" not in m.state_dict()
    keys = [k for k, _ in driver.name_map_for(TrainConfig(plastic=False)).values()]
    assert "w" not in keys and list(keys) == list(m.state_dict())


def test_start_train_needs_cuda_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.start_train(*_data(), TrainConfig(**_kw(tmp_path)))
