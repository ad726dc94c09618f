"""The port's serving artifacts (plastic_unet_tpu_torch.submit.export:
export_predictor, load_predictor, ExportedPredictor; torch.export programs
with the kernels as custom ops) on the CPU, mirroring tests/test_export.py:
the reloaded program equals the live serving path bit for bit (the padding
included), the TTA program is within 1.2e-7 of the live sequential TTA (the
views folded into one forward sum in another batch), baked thresholds,
RLE, validation, the int8 model, the device rule, and agreement with the
JAX package's artifact (jax.export) on the same weights within phase 12's
serving tolerance (rtol 1e-5, atol 1e-6). UNetPRes at nbf=32, neurons=2,
JAX init weights carried by state_dict_from_jax_params, inputs from a
numpy seed."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.submit import export as jexport
from plastic_unet_tpu_torch.eval.evaluate import predict_masks
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.submit.export import export_predictor, load_predictor
from plastic_unet_tpu_torch.submit.inference import predict_masks_tta, threshold_as_f32
from plastic_unet_tpu_torch.submit.quant import quantize_for_serving
from plastic_unet_tpu_torch.submit.server import MaskPredictor
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params

torch.set_num_threads(2)

SIZE, CHUNK = 32, 4
VIEWS = ("identity", "hflip", "rot90", "transpose")
TTA4 = ("identity", "hflip", "vflip", "rot180")
RTOL, ATOL = 1e-5, 1e-6  # the port against JAX, fp32 serving (chip_smoke.py phase 12)


@pytest.fixture(scope="module")
def models():
    jm = JaxUNetPRes(nbf=SIZE, neurons=2)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), jm.initial_zero_hebb(1))["params"]
    tm = UNetPRes(nbf=SIZE, neurons=2)
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def artifacts(models, tmp_path_factory):
    """The port's exports, made once: name -> artifact directory."""
    _, _, tm = models
    root = tmp_path_factory.mktemp("artifacts")
    specs = {"plain": {}, "tta": {"tta": VIEWS}, "tta4": {"tta": TTA4}, "thr03": {"threshold": 0.3},
             "thr05": {"threshold": 0.5}}
    return {name: export_predictor(tm, str(root / name), chunk=CHUNK, platforms=("cpu",), **kw)
            for name, kw in specs.items()}


def _images(n, seed=0, channels=1):
    return np.random.default_rng(seed).standard_normal((n, SIZE, SIZE, channels)).astype(np.float32)


def test_roundtrip_exact(models, artifacts):
    """Export, save, load, predict equals the live serving forward bit for
    bit, the padding of the last partial chunk included (N=7, chunk=4)."""
    _, _, tm = models
    pred = load_predictor(artifacts["plain"], device="cpu").warmup()
    X = _images(7)
    got = pred.predict(X)
    want = predict_masks_tta(tm, X, chunk=CHUNK, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (7, SIZE, SIZE)
    np.testing.assert_array_equal(got, want)


def test_tta_artifact_close(models, artifacts):
    """The views folded into one forward (a transpose among them) against
    the live sequential TTA, one pass a view: within 1.2e-7."""
    _, _, tm = models
    X = _images(5, seed=1)
    got = load_predictor(artifacts["tta"], device="cpu").predict(X)
    want = predict_masks_tta(tm, X, transforms=VIEWS, chunk=CHUNK, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


def test_threshold_artifact(models, artifacts):
    """A baked threshold emits uint8 masks from the float64-exact compare
    (0.3: its nearest f32 lies above the float64 value)."""
    _, _, tm = models
    X = _images(4, seed=2)
    got = load_predictor(artifacts["thr03"], device="cpu").predict(X)
    probs = predict_masks_tta(tm, X, chunk=CHUNK, device="cpu").numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, (probs > threshold_as_f32(0.3)).astype(np.uint8))


def test_predict_rle_paths(models, artifacts):
    """RLE from a thresholded and from a probability artifact, equal to the
    live MaskPredictor's strings; a probability artifact needs a threshold."""
    _, _, tm = models
    X = _images(3, seed=3)[..., 0]
    want = MaskPredictor(tm, chunk=CHUNK, threshold=0.5, device="cpu").predict_rle(X)
    assert load_predictor(artifacts["thr05"], device="cpu").predict_rle(X) == want
    prob = load_predictor(artifacts["plain"], device="cpu")
    assert prob.predict_rle(X, threshold=0.5) == want
    with pytest.raises(ValueError, match="requires a threshold"):
        prob.predict_rle(X)


def _bad_format(path, tmp_path):
    bad = tmp_path / "bad_format"
    shutil.copytree(path, bad)
    meta = json.loads((bad / "meta.json").read_text())
    meta["format_version"] = 99
    (bad / "meta.json").write_text(json.dumps(meta))
    return str(bad)


def _jax_dir(path, tmp_path):
    d = tmp_path / "jax_art"
    d.mkdir()
    (d / "forward.jaxexp").write_bytes(b"")
    shutil.copy(os.path.join(path, "meta.json"), d / "meta.json")
    return str(d)


def _no_program(path, tmp_path):
    d = tmp_path / "no_program"
    d.mkdir()
    shutil.copy(os.path.join(path, "meta.json"), d / "meta.json")
    return str(d)


@pytest.mark.parametrize("case,match", [
    ("image_shape", "expected"), ("unknown_view", "unknown TTA"), ("chunk", "chunk must be >= 1"),
    ("data_devices", "divisible by data_devices"), ("no_data_devices", "data_devices must be >= 1"),
    ("format_version", "format_version"),
    ("jax_artifact", "plastic_unet_tpu.submit.export.load_predictor"), ("no_program", "no program for cpu"),
    ("calib_model", "quant"),
])
def test_artifact_validation(models, artifacts, tmp_path, case, match):
    _, _, tm = models
    calls = {
        "image_shape": lambda: load_predictor(artifacts["plain"], device="cpu").predict(
            np.zeros((2, SIZE + 1, SIZE), np.float32)),
        "unknown_view": lambda: export_predictor(tm, str(tmp_path / "a"), tta=("identity", "nope"),
                                                 platforms=("cpu",)),
        "chunk": lambda: export_predictor(tm, str(tmp_path / "a"), chunk=0, platforms=("cpu",)),
        # sharded export is ported; a chunk (128) that 3 ranks cannot share raises
        "data_devices": lambda: export_predictor(tm, str(tmp_path / "a"), data_devices=3, platforms=("cpu",)),
        "no_data_devices": lambda: export_predictor(tm, str(tmp_path / "a"), data_devices=0, platforms=("cpu",)),
        "format_version": lambda: load_predictor(_bad_format(artifacts["plain"], tmp_path), device="cpu"),
        "jax_artifact": lambda: load_predictor(_jax_dir(artifacts["plain"], tmp_path), device="cpu"),
        "no_program": lambda: load_predictor(_no_program(artifacts["plain"], tmp_path), device="cpu"),
        "calib_model": lambda: export_predictor(_with_quant(tm, "calib"), str(tmp_path / "a"), platforms=("cpu",)),
    }
    with pytest.raises(ValueError, match=match):
        calls[case]()


def _with_quant(model, mode):
    import copy

    m = copy.deepcopy(model)
    m.quant = mode
    return m


def test_device_rule_without_cuda(artifacts, models, tmp_path):
    """No device means CUDA: loading, and exporting for "cuda", raise on a
    host without it, and the load's message names device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device loads")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_predictor(artifacts["plain"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_predictor(models[2], str(tmp_path / "cuda"), platforms=("cpu", "cuda"))


def test_multichannel_warmup(tmp_path):
    """warmup() of a 3-channel artifact feeds a 3-channel dummy batch."""
    model = UNetPRes(nbf=SIZE, neurons=2, n_channels=3, generator=torch.Generator().manual_seed(0))
    pred = load_predictor(export_predictor(model, str(tmp_path / "art3c"), chunk=2, platforms=("cpu",)),
                          device="cpu").warmup()
    X = _images(3, seed=4, channels=3)
    got = pred.predict(X)
    assert got.shape == (3, SIZE, SIZE)
    np.testing.assert_array_equal(got, predict_masks(model, X, chunk=2, device="cpu").numpy())


def test_int8_artifact_exact(models, tmp_path):
    """The int8 model (its 49 ranges are constants of the program) equals
    the live int8 forward bit for bit."""
    _, _, tm = models
    qmodel = quantize_for_serving(tm, np.random.default_rng(7).random((8, SIZE, SIZE, 1), dtype=np.float32),
                                  device="cpu")
    path = export_predictor(qmodel, str(tmp_path / "int8"), chunk=CHUNK, platforms=("cpu",))
    X = _images(6, seed=5)
    got = load_predictor(path, device="cpu").predict(X)
    np.testing.assert_array_equal(got, predict_masks(qmodel, X, chunk=CHUNK, device="cpu").numpy())


def test_program_calls_the_kernels_as_custom_ops(artifacts):
    """The program launches the serving kernels through the two custom ops:
    one head and 9 residual tails a forward; with tta4 still one forward."""
    for name in ("plain", "tta4"):
        program = torch.export.load(os.path.join(artifacts[name], "forward.cpu.pt2"))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert targets.count("plastic_unet_tpu_torch.plastic_head_forward.default") == 1, name
        assert targets.count("plastic_unet_tpu_torch.residual_tail_forward.default") == 9, name


def test_meta_has_the_jax_keys(models, artifacts, tmp_path):
    """meta.json carries the JAX manifest's keys with the same values, but
    for the platforms, which name the port's devices."""
    jm, params, _ = models
    jpath = jexport.export_predictor(jm, params, str(tmp_path / "jax"), chunk=CHUNK, tta=TTA4,
                                     platforms=("cpu",))
    want = json.loads(open(os.path.join(jpath, "meta.json")).read())
    got = json.loads(open(os.path.join(artifacts["tta4"], "meta.json")).read())
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k != "platforms"} == {k: v for k, v in want.items() if k != "platforms"}
    assert got["platforms"] == ["cpu"]


@pytest.mark.parametrize("name,views", [("plain", ("identity",)), ("tta4", TTA4)])
def test_matches_the_jax_artifact(models, artifacts, tmp_path, name, views):
    """The port's artifact against the JAX package's, exported from the same
    weights and loaded by jax: within rtol 1e-5, atol 1e-6."""
    jm, params, _ = models
    jpath = jexport.export_predictor(jm, params, str(tmp_path / "jax"), chunk=CHUNK, tta=views,
                                     platforms=("cpu",))
    X = _images(6, seed=6)
    want = jexport.load_predictor(jpath).predict(X)
    got = load_predictor(artifacts[name], device="cpu").predict(X)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
