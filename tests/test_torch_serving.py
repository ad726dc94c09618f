"""The port's serving path on the CPU against the JAX package: weight
carrying, the threshold sweep, the best-threshold search on the committed
epoch-225 checkpoint, submission bytes, synthetic tiles, the device rule and
the port's independence from JAX."""

import importlib
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.data.synthetic import synthetic_split as jax_synthetic_split
from plastic_unet_tpu.eval import evaluate as jeval
from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.ops.iou import threshold_sweep_jit
from plastic_unet_tpu.ops.rle import encode as jax_encode
from plastic_unet_tpu.utils import torch_interop as jti
from plastic_unet_tpu_torch.data.synthetic import synthetic_split
from plastic_unet_tpu_torch.eval import evaluate as teval
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops.iou import threshold_sweep
from plastic_unet_tpu_torch.ops.rle import encode, encode_batch, rle_decode
from plastic_unet_tpu_torch.submit import inference as tinf
from plastic_unet_tpu_torch.submit.server import MaskPredictor
from plastic_unet_tpu_torch.utils import torch_interop as tti

torch.set_num_threads(2)

# the JAX package's submit/__init__ re-exports a function named `inference`
jinf = importlib.import_module("plastic_unet_tpu.submit.inference")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "results/showdown_r5/sd_torch_oja_250h.json.ckpt.pth")
JAX_SCORE = (0.48954824, 0.83124983)  # JAX score_model_best_iou on this checkpoint


def _hard_val():
    _, xv, _, yv = synthetic_split(256, 64, size=101, seed=77, hard=True)
    return np.transpose(xv, (0, 2, 3, 1)), yv


def _jax_ckpt_model():
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=8, nbf=101, rule="oja")
    return jm, jti.state_dict_to_flax_params(tti.load_pth(CKPT, "model"), jti.unetp_res_name_map())


def _port_ckpt_model():
    tm = UNetPRes(neurons=8, nbf=101, rule="oja")
    tm.load_state_dict(tti.load_pth(CKPT, "model"), strict=True)
    return tm


def test_name_map_equals_jax():
    assert tti.unetp_res_name_map() == jti.unetp_res_name_map()


def test_threshold_sweep_matches_jax():
    rng = np.random.default_rng(3)
    y = (rng.random((9, 1, 12, 12)) > 0.6).astype(np.float32)
    y[0] = 0.0  # an empty mask: the 1e-9 union patch
    p = rng.random((9, 12, 12)).astype(np.float32)
    thr = teval.threshold_grid().astype(np.float32)
    got = threshold_sweep(torch.from_numpy(y), torch.from_numpy(p), torch.from_numpy(thr)).numpy()
    ref = np.asarray(threshold_sweep_jit(jnp.asarray(y), jnp.asarray(p), jnp.asarray(thr)))
    assert got.dtype == np.float32 and got.shape == (31,)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_score_checkpoint_matches_jax():
    xv, yv = _hard_val()
    jm, params = _jax_ckpt_model()
    ref = jeval.score_model_best_iou(jm, params, xv, yv)
    np.testing.assert_allclose(ref, JAX_SCORE, atol=1e-6)
    got = teval.score_model_best_iou(_port_ckpt_model(), xv, yv, device="cpu")
    assert got[0] == pytest.approx(ref[0], abs=1e-6)
    assert got[1] == pytest.approx(ref[1], abs=1e-6)


def test_predict_submission_bytes_match_jax(tmp_path):
    xv, _ = _hard_val()
    x = xv[:16]
    ids = [f"tile{i:03d}" for i in range(16)]
    thr = float(np.float32(JAX_SCORE[0]))
    jm, params = _jax_ckpt_model()
    tm = _port_ckpt_model()
    rp = {"img_height": 101, "img_width": 101, "img_chan": 1, "mask_threshold": thr, "subm_file": "s.csv"}
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    test_df = pd.DataFrame({"images": [im for im in x]}, index=ids)
    jpath = jinf.predict(jm, params, test_df, dict(rp, out_dir=str(tmp_path / "jax")), chunk=16)
    tpath = tinf.predict(tm, ids, x, dict(rp, out_dir=str(tmp_path / "port")), chunk=16, device="cpu")
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    pj = np.asarray(jeval.predict_masks(jm, params, x, chunk=16))
    pt = teval.predict_masks(tm, x, chunk=16, device="cpu").numpy()
    far = np.abs(pj - thr) > 1e-5
    np.testing.assert_array_equal((pt > thr)[far], (pj > thr)[far])


def test_start_inference_matches_jax(tmp_path):
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, nbf=16, rule="hebb")
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 1)), jm.initial_zero_hebb(1))["params"]
    tm = UNetPRes(neurons=2, nbf=16, rule="hebb")
    tm.load_state_dict(tti.state_dict_from_jax_params(params), strict=True)
    xt, xv, _, yv = synthetic_split(6, 10, size=16, seed=4)
    ids = [f"t{i}" for i in range(6)]
    test_imgs = np.transpose(xt, (0, 2, 3, 1))
    test_df = pd.DataFrame({"images": [im for im in test_imgs]}, index=ids)
    jpath = jinf.start_inference(jm, params, test_df, xv, yv, str(tmp_path / "jax"), 16, 16, 1)
    tpath = tinf.start_inference(tm, ids, test_imgs, xv, yv, str(tmp_path / "port"), 16, 16, 1, device="cpu")
    assert open(tpath, "rb").read() == open(jpath, "rb").read()


def test_eval_net_matches_jax():
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, nbf=16, rule="oja")
    params = jm.init(jax.random.PRNGKey(6), jnp.zeros((1, 16, 16, 1)), jm.initial_zero_hebb(1))["params"]
    tm = UNetPRes(neurons=2, nbf=16, rule="oja")
    tm.load_state_dict(tti.state_dict_from_jax_params(params), strict=True)
    _, xv, _, yv = synthetic_split(0, 5, size=16, seed=9)
    xv = np.transpose(xv, (0, 2, 3, 1))
    ref = jeval.eval_net(jm, params, xv, yv, chunk=4)
    got = teval.eval_net(tm, xv, yv, chunk=4, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_start_inference_takes_tta(tmp_path):
    """predict and start_inference take the views: the identity is the
    default path, and other views write the masks of predict_masks_tta at
    the searched (or given) threshold."""
    tm = UNetPRes(neurons=2, nbf=16, generator=torch.Generator().manual_seed(2))
    xt, xv, _, yv = synthetic_split(3, 4, size=16, seed=5)
    ids, imgs = ["a", "b", "c"], xt[:, 0]
    args = (tm, ids, imgs, xv, yv, str(tmp_path), 16, 16, 1)
    plain = open(tinf.start_inference(*args, device="cpu")).read()
    assert open(tinf.start_inference(*args, tta=("identity",), device="cpu")).read() == plain
    views = ("identity", "hflip")
    rows = open(tinf.start_inference(*args, tta=views, device="cpu")).read().splitlines()
    thr, _ = teval.score_model_best_iou(tm, np.transpose(xv, (0, 2, 3, 1)), yv, device="cpu")
    want = tinf.binarize(tinf.predict_masks_tta(tm, imgs[..., None], transforms=views, device="cpu"), thr)
    assert rows == ["id,rle_mask"] + [f"{i},{r}" for i, r in zip(ids, encode_batch(want))]
    rp = {"out_dir": str(tmp_path), "img_height": 16, "img_width": 16, "img_chan": 1, "mask_threshold": 0.5,
          "subm_file": "s.csv"}
    rows = open(tinf.predict(tm, ids, imgs, rp, tta=("vflip",), device="cpu")).read().splitlines()
    flipped = teval.predict_masks(tm, imgs[:, ::-1, :, None].copy(), device="cpu").flip(1)
    assert rows[1:] == [f"{i},{r}" for i, r in zip(ids, encode_batch(tinf.binarize(flipped, 0.5)))]


@pytest.mark.parametrize("hard", [False, True])
def test_synthetic_tiles_byte_equal(hard):
    got = synthetic_split(5, 3, size=33, seed=12, hard=hard)
    ref = jax_synthetic_split(5, 3, size=33, seed=12, hard=hard)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes()


def test_rle_matches_jax_and_roundtrips():
    rng = np.random.default_rng(5)
    masks = (rng.random((4, 11, 7)) > 0.5).astype(np.uint8)
    masks[0] = 0
    rles = encode_batch(masks)
    assert rles == [jax_encode(m) for m in masks]
    assert rles[0] == ""
    for m, r in zip(masks, rles):
        np.testing.assert_array_equal(rle_decode(r, m.shape), m)
    assert encode(np.array([[1, 0], [1, 1]])) == "1 2 4 1"  # column-major, 1-based


@pytest.mark.parametrize("t", [0.3, 0.5, float(np.float32(0.48954824)), -0.2, 1e-8])
def test_threshold_as_f32_matches_jax(t):
    assert tinf.threshold_as_f32(t) == jinf.threshold_as_f32(t)


def test_predictor_on_cpu_matches_predict_masks():
    tm = UNetPRes(neurons=2, nbf=16, rule="oja", generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(1).random((5, 16, 16)).astype(np.float32)
    p = MaskPredictor(tm, chunk=4, threshold=0.5, device="cpu")
    probs = teval.predict_masks(tm, x[..., None], chunk=4, device="cpu").numpy()
    np.testing.assert_array_equal(p.predict(x), probs > 0.5)
    assert p.predict_rle(x) == [jax_encode(m) for m in (probs > 0.5).astype(np.uint8)]
    assert p.warmup() is p


@pytest.mark.parametrize("own_threshold", [0.9, None])
def test_predict_rle_threshold_contract_matches_jax(own_threshold):
    """A predictor with a threshold of its own binarizes at it and ignores the
    call's argument, as the JAX predictor does; without one the argument holds."""
    from plastic_unet_tpu.submit.server import MaskPredictor as JaxMaskPredictor

    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, nbf=16)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)), jm.initial_zero_hebb(1))["params"]
    tm = UNetPRes(neurons=2, nbf=16)
    tm.load_state_dict(tti.state_dict_from_jax_params(params), strict=True)
    x = np.random.RandomState(0).rand(2, 16, 16).astype(np.float32)
    ref = JaxMaskPredictor(jm, params, threshold=own_threshold).predict_rle(x, threshold=0.5005)
    got = MaskPredictor(tm, threshold=own_threshold, device="cpu").predict_rle(x, threshold=0.5005)
    assert got == ref
    if own_threshold is not None:
        assert ref[0] == ""  # the case where binarizing at the argument gave a non-empty mask


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = UNetPRes(neurons=2, nbf=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskPredictor(tm)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskPredictor.from_pth(CKPT, neurons=8, rule="oja", key="model")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.predict_masks(tm, np.zeros((1, 16, 16, 1), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.score_model_best_iou(tm, np.zeros((1, 16, 16, 1), np.float32), np.zeros((1, 16, 16)))


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import plastic_unet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "added = set(sys.modules) - before\n"
        "bad = sorted(m for m in added if m == 'jax' or m.startswith('jax.') or m == 'plastic_unet_tpu'"
        " or m.startswith('plastic_unet_tpu.'))\n"
        "assert len(names) >= 15, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """chip_smoke.py prints no result and exits non-zero on a host without
    CUDA, in the repository and as a lone copy of the script."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = str(tmp_path / "chip_smoke.py")
        with open(os.path.join(REPO, "chip_smoke.py")) as src, open(script, "w") as dst:
            dst.write(src.read())
    out = subprocess.run([sys.executable, script], cwd=os.path.dirname(script), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_wrappers_never_fall_back():
    """Only CPU tensors take the plain versions; any other device must
    launch a kernel or raise (here: tensors on the meta device)."""
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3
    from plastic_unet_tpu_torch.ops.plastic_head import plastic_head
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail

    m = torch.device("meta")
    x, w, b = torch.empty(1, 5, 5, 4, device=m), torch.empty(3, 3, 4, 4, device=m), torch.empty(4, device=m)
    with pytest.raises(RuntimeError, match="no kernel"):
        conv3x3(x, w, b)
    wt = torch.empty(4, 4, 3, 3, device=m)
    with pytest.raises(RuntimeError, match="no kernel"):
        residual_tail(x, wt, b, wt, b, wt, b, wt, b)
    h = torch.empty(2, 6, 6, device=m)
    with pytest.raises(RuntimeError, match="no kernel"):
        plastic_head(torch.empty(6, 6, device=m), torch.empty(6, 6, device=m), torch.empty(1, device=m), h, h)


def test_build_reports_missing_nvcc_and_cuda_errors(tmp_path, monkeypatch):
    from plastic_unet_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    with pytest.raises(RuntimeError, match="CUDA error 209"):
        _build.check(209, "conv3x3")
    _build.check(0, "conv3x3")
    names = sorted(p.name.split(".")[0] for p in _build.CSRC.glob("*.cu"))
    assert names == ["conv3x3", "conv3x3_wgrad", "plastic_head", "residual_tail", "residual_tail_backward"]


def test_numpy_iou_metrics_match_jax():
    from plastic_unet_tpu.ops import iou as jiou
    from plastic_unet_tpu_torch.ops import iou as tiou

    rng = np.random.default_rng(8)
    t = (rng.random((6, 10, 10)) > 0.5).astype(np.float32)
    p = rng.random((6, 10, 10)).astype(np.float32)
    t[0] = 0.0
    p[0] = 0.0  # both empty: metric 1
    for i in range(6):
        assert tiou.iou_metric(t[i], p[i]) == jiou.iou_metric(t[i], p[i])
    assert tiou.iou_metric_batch(t, p) == jiou.iou_metric_batch(t, p)
    assert tiou.get_iou_vector(t, p > 0.5) == jiou.get_iou_vector(t, p > 0.5)
    assert tiou.fast_iou_metric(t.ravel(), p.ravel()) == jiou.fast_iou_metric(t.ravel(), p.ravel())


def test_no_source_of_the_port_imports_jax():
    """Static check of every import statement in the port, chip_smoke.py and kernel_ab.py."""
    import ast
    import glob

    files = glob.glob(os.path.join(REPO, "plastic_unet_tpu_torch", "**", "*.py"), recursive=True)
    files += [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "kernel_ab.py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "plastic_unet_tpu"), f"{path}: imports {n}"


def test_kernels_refuse_autograd_tracked_inputs():
    """The wrappers used to refuse inputs that autograd tracks; they now
    differentiate. Nothing refuses a tracked tensor any more, neither entry
    point the model calls (residual_tail, plastic_head) returns an output
    without a grad_fn for one, and under no_grad / inference_mode nothing is
    tracked."""
    from plastic_unet_tpu_torch.ops import _build
    from plastic_unet_tpu_torch.ops.plastic_head import plastic_head
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail

    assert not hasattr(_build, "require_no_grad")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 5, 5, 4, generator=g)
    ws = [torch.randn(4, 4, 3, 3, generator=g).requires_grad_() for _ in range(4)]
    bs = [torch.zeros(4, requires_grad=True) for _ in range(4)]
    tail_args = [x] + [t for pair in zip(ws, bs) for t in pair]
    n = 5
    head_args = (torch.randn(n, n, generator=g).requires_grad_(), torch.rand(n, n, generator=g),
                 torch.full((1,), 0.01), torch.randn(1, n, n, generator=g), torch.zeros(1, n, n))
    calls = [lambda: residual_tail(*tail_args), lambda: plastic_head(*head_args)[0]]
    for call in calls:
        assert call().grad_fn is not None
        with torch.no_grad():
            assert call().grad_fn is None
        with torch.inference_mode():
            assert not call().requires_grad
