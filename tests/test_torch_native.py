"""The port's native host library (plastic_unet_tpu_torch.ops.native):
its three functions against the numpy/PIL paths and against the JAX
package's ops.native on the same inputs (strings equal, arrays to 1e-6);
the build under build/plastic_unet_tpu_torch/, named by a hash, leaving
native/ as it was; the callers (ops.rle.encode_batch,
data.dataset._load_batch) on the native path; and the fallback rule: the
numpy/PIL path only where the library cannot be built or loaded, with the
reason in native_status(), while a loaded library's errors propagate."""

import hashlib
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from plastic_unet_tpu.ops import native as jnative
from plastic_unet_tpu_torch.data import dataset as tds
from plastic_unet_tpu_torch.data.images import load_image
from plastic_unet_tpu_torch.ops import _build, native, rle
from plastic_unet_tpu_torch.ops.iou import iou_metric_batch, threshold_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO, "native")


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's library (its get_lib builds it with make in native/, as its own tests do)."""
    return jnative.get_lib()


@pytest.fixture
def fresh(monkeypatch, tmp_path):
    """ops.native as in a new process, building into tmp_path/build."""
    for name, value in (("_lib", None), ("_error", None), ("_status", "not tried"), ("_warned", False),
                        ("BUILD_DIR", tmp_path / "build")):
        monkeypatch.setattr(native, name, value)
    return tmp_path / "build"


def _native_snapshot() -> dict:
    """native/'s files and their hashes, but the JAX package's own make output."""
    out = {}
    for name in sorted(os.listdir(NATIVE_DIR)):
        if name.startswith("libplasticnet_native.so"):
            continue
        with open(os.path.join(NATIVE_DIR, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.mark.parametrize("case", ["random", "empty_and_full", "chunked", "salt_like"])
def test_rle_batch_matches_numpy_and_jax(case, jax_lib):
    rng = np.random.default_rng(0)
    chunk = 512
    if case == "random":
        masks = (rng.random((16, 101, 101)) > 0.5).astype(np.uint8)
    elif case == "empty_and_full":
        masks = np.stack([np.zeros((101, 101), np.uint8), np.ones((101, 101), np.uint8)])
    elif case == "chunked":
        masks, chunk = (rng.random((7, 13, 9)) > 0.3).astype(np.uint8), 3
    else:
        from plastic_unet_tpu_torch.data.synthetic import synthetic_tiles

        masks = synthetic_tiles(24, size=101, seed=1)[1][:, 0]  # float {0, 1}: binarized by != 0
    got = native.rle_encode_batch_native(masks, chunk=chunk)
    assert got == [rle.encode(m) for m in masks]
    assert got == jnative.rle_encode_batch_native(masks, chunk=chunk)
    assert rle.encode_batch(masks) == got


@pytest.mark.parametrize("kind", ["gray8", "gray16", "rgb", "resized"])
def test_png_loader_matches_pil_and_jax(tmp_path, kind, jax_lib):
    rng = np.random.default_rng(1)
    arr = {"gray8": lambda: (rng.random((101, 101)) * 255).astype(np.uint8),
           "gray16": lambda: (rng.random((101, 101)) * 65535).astype(np.uint16),
           "rgb": lambda: (rng.random((101, 101, 3)) * 255).astype(np.uint8),
           "resized": lambda: (rng.random((64, 48)) * 255).astype(np.uint8)}[kind]()
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"{kind}{i}.png"))
        Image.fromarray(arr if i == 0 else np.roll(arr, i, axis=0)).save(paths[-1])
    for h, w in ((101, 101), (128, 96)):
        got = native.load_png_gray_batch_native(paths, h, w)
        assert got.shape == (3, h, w) and got.dtype == np.float64
        for g, p in zip(got, paths):
            np.testing.assert_allclose(g, load_image(p, (h, w)), rtol=0, atol=1e-6, err_msg=p)
        np.testing.assert_allclose(got, jnative.load_png_gray_batch_native(paths, h, w), rtol=0, atol=1e-6)


def test_iou_sweep_matches_numpy_and_jax(jax_lib):
    rng = np.random.default_rng(2)
    y = (rng.random((10, 1, 101, 101)) > 0.6).astype(np.float32)
    y[0] = 0  # an empty ground truth
    preds = rng.random((10, 101, 101)).astype(np.float32)
    tori = np.linspace(0.3, 0.7, 31)
    thr = np.log(tori / (1 - tori)).astype(np.float32)
    got = native.iou_threshold_sweep_native(y, preds, thr)
    assert got.dtype == np.float32 and got.shape == (31,)
    np.testing.assert_allclose(got, [iou_metric_batch(y, preds > t) for t in thr], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, threshold_sweep(torch.from_numpy(y), torch.from_numpy(preds),
                                                    torch.from_numpy(thr)).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, jnative.iou_threshold_sweep_native(y, preds, thr))


def test_build_lands_in_build_dir_and_leaves_native_unchanged(fresh, monkeypatch, tmp_path):
    """A fresh build (into a test directory) writes one library under a hashed name and nothing under
    native/; another source gets another name."""
    before = _native_snapshot()
    native.get_lib()
    assert _native_snapshot() == before
    built = sorted(os.listdir(fresh))
    assert len(built) == 1 and re.fullmatch(r"libplasticnet_native\.[0-9a-f]{12}\.so", built[0]), built
    assert re.fullmatch(rf"loaded {re.escape(str(fresh / built[0]))} \(built in [0-9.]+ s\)",
                        native.native_status())
    edited = tmp_path / "edited.cc"
    edited.write_bytes(native.SOURCE.read_bytes() + b"\n// edited\n")
    name = native.lib_path().name
    monkeypatch.setattr(native, "SOURCE", edited)
    assert native.lib_path().name != name


def test_package_library_is_under_build():
    """With the package's own settings, the loaded library is build/plastic_unet_tpu_torch/<hashed>.so."""
    assert native.load() is not None, native.native_status()
    path = native.lib_path()
    assert native.BUILD_DIR == _build.BUILD_DIR == Path(REPO) / "build" / "plastic_unet_tpu_torch"
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert native.native_status().startswith(f"loaded {path} (")


def test_callers_take_the_native_path(monkeypatch, tmp_path):
    assert native.load() is not None, native.native_status()
    seen = []
    real_rle, real_png = native.rle_encode_batch_native, native.load_png_gray_batch_native
    monkeypatch.setattr(native, "rle_encode_batch_native", lambda m: seen.append("rle") or real_rle(m))
    monkeypatch.setattr(native, "load_png_gray_batch_native",
                        lambda p, h, w: seen.append("png") or real_png(p, h, w))
    masks = (np.random.default_rng(3).random((5, 20, 20)) > 0.5).astype(np.uint8)
    assert rle.encode_batch(masks) == [rle.encode(m) for m in masks]
    p = str(tmp_path / "a.png")
    Image.fromarray((np.random.default_rng(4).random((20, 20)) * 255).astype(np.uint8)).save(p)
    np.testing.assert_array_equal(tds._load_batch([p], 20, 20)[0], load_image(p, (20, 20)))
    assert seen == ["rle", "png"]
    with pytest.raises(OSError, match="failed to load"):  # a loaded library's error propagates
        tds._load_batch([str(tmp_path / "missing.png")], 20, 20)


@pytest.mark.parametrize("fault", ["missing_source", "compiler_fails"])
def test_library_that_cannot_build_falls_back(fresh, monkeypatch, tmp_path, capsys, fault):
    """A missing source (the build pointed at it) or a failing compiler: get_lib raises, native_status
    says why, the reason is printed once, and the callers take the numpy/PIL path."""
    if fault == "missing_source":
        monkeypatch.setattr(native, "SOURCE", tmp_path / "nowhere" / "plasticnet_native.cc")
        reason = "native source .* not found"
    else:
        monkeypatch.setenv("CXX", "false")
        reason = r"false failed \(rc=1\)"
    with pytest.raises(OSError, match=reason):
        native.get_lib()
    assert native.native_status().startswith("unavailable: ")
    masks = (np.random.default_rng(5).random((4, 9, 9)) > 0.5).astype(np.uint8)
    assert rle.encode_batch(masks) == [rle.encode(m) for m in masks]
    p = str(tmp_path / "b.png")
    Image.fromarray((np.random.default_rng(6).random((9, 9)) * 255).astype(np.uint8)).save(p)
    np.testing.assert_array_equal(tds._load_batch([p, p], 9, 9), np.stack([load_image(p, (9, 9))] * 2))
    err = capsys.readouterr().err
    assert err.count("native host library unavailable, numpy/PIL fallback") == 1
    assert not fresh.exists() or not any(f.suffix == ".so" for f in fresh.iterdir())
