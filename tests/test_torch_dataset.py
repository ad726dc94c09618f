"""Data staging of the port (plastic_unet_tpu_torch.data) against the JAX
package's and sklearn: the fake TGS directory of tests/test_dataset.py
loads to the same arrays, the numpy stratified split equals sklearn's
train_test_split index for index and raises where it raises, load_image
equals the JAX loader on 8- and 16-bit PNGs, and the HDF5 dataset file
round-trips."""

import os
import random
import sys

import numpy as np
import pytest

from sklearn.model_selection import train_test_split as sk_train_test_split

from plastic_unet_tpu.data import dataset as jds
from plastic_unet_tpu.data import hdf5_io as jh5
from plastic_unet_tpu.data import images as jimg
from plastic_unet_tpu_torch.data import dataset as tds
from plastic_unet_tpu_torch.data import hdf5_io as th5
from plastic_unet_tpu_torch.data import images as timg

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

N, SIZE = 30, 101


def make_tgs_dir(root, n=N, size=SIZE, n_test=7, seed=0):
    """Fake TGS layout (the fixture of tests/test_dataset.py): train.csv,
    depths.csv (with ids not in train.csv), 16-bit masks, 8-bit images."""
    (root / "train" / "images").mkdir(parents=True)
    (root / "train" / "masks").mkdir(parents=True)
    (root / "test" / "images").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    ids = [f"id{i:03d}" for i in range(n)]
    for i, idx in enumerate(ids):
        img = (rng.random((size, size)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "train" / "images" / f"{idx}.png")
        mask = np.zeros((size, size), np.uint16)
        k = i % 5
        if k:
            mask[: size * k // 5] = 65535
        Image.fromarray(mask).save(root / "train" / "masks" / f"{idx}.png")
    for j in range(n_test):
        img = (rng.random((size, size)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "test" / "images" / f"t{j}.png")
    with open(root / "train.csv", "w") as f:
        f.write("id,rle_mask\n" + "\n".join(f"{i}," for i in ids))
    with open(root / "depths.csv", "w") as f:
        f.write("id,z\n" + "\n".join(f"{i},{100 + 3 * k}" for k, i in enumerate(ids + ["t0", "t1"])))
    return str(root)


@pytest.fixture(scope="module")
def tgs_dir(tmp_path_factory):
    return make_tgs_dir(tmp_path_factory.mktemp("tgs"))


def test_load_train_dataset_equals_jax(tgs_dir, capsys):
    want = jds.load_train_dataset(tgs_dir, SIZE, SIZE, 1)
    got = tds.load_train_dataset(tgs_dir, SIZE, SIZE, 1)
    assert len(got) == 4 and got[0].shape == (24, 1, SIZE, SIZE) and got[1].shape == (6, 1, SIZE, SIZE)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    capsys.readouterr()
    tds.load_train_dataset(tgs_dir, SIZE, SIZE, 1, debug=True)  # the mask spot-check, row 10
    assert capsys.readouterr().out.strip() != ""


@pytest.mark.parametrize("debug", [False, True], ids=["frames", "frames_and_plots"])
def test_load_train_dataset_frames_equal_jax(tgs_dir, debug):
    """return_frames=True: the split, then JAX's train_df (train.csv's ids joined with depths.csv's z, then
    masks, coverage, coverage_class) and test_df (the depths rows not in train.csv), by
    pandas.testing.assert_frame_equal with the masks column compared array by array; debug=True draws
    JAX's coverage and depth figures (show_plots=False)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import pandas as pd

    from test_torch_viz import assert_same_figure

    plt.close("all")
    got = tds.load_train_dataset(tgs_dir, SIZE, SIZE, 1, debug=debug, return_frames=True, show_plots=False)
    port_figs = [plt.figure(n) for n in plt.get_fignums()]
    want = jds.load_train_dataset(tgs_dir, SIZE, SIZE, 1, debug=debug, return_frames=True, show_plots=False)
    jax_figs = [plt.figure(n) for n in plt.get_fignums()][len(port_figs):]
    assert len(got) == len(want) == 6
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, w)
    (train_df, test_df), (jtrain_df, jtest_df) = got[4:], want[4:]
    assert list(train_df.columns) == list(jtrain_df.columns) == ["z", "masks", "coverage", "coverage_class"]
    pd.testing.assert_frame_equal(train_df.drop(columns="masks"), jtrain_df.drop(columns="masks"))
    assert len(train_df.masks) == len(jtrain_df.masks) == N
    for a, b in zip(train_df.masks, jtrain_df.masks):
        np.testing.assert_array_equal(a, b)
    pd.testing.assert_frame_equal(test_df, jtest_df)
    assert list(test_df.index) == ["t0", "t1"]
    assert len(port_figs) == len(jax_figs) == (2 if debug else 0)
    for a, b in zip(port_figs, jax_figs):
        assert_same_figure(a, b)
    plt.close("all")


def test_load_train_dataset_debug_without_matplotlib(tgs_dir, capsys, monkeypatch):
    """debug=True on a host without matplotlib (the card's): the spot-check prints, the plots are not
    drawn and a line says so; the split is the same, and return_frames still returns the frames."""
    want = tds.load_train_dataset(tgs_dir, SIZE, SIZE, 1, return_frames=True)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for frames in (False, True):
        got = tds.load_train_dataset(tgs_dir, SIZE, SIZE, 1, debug=True, return_frames=frames)
        assert "the coverage and depth plots were not drawn" in capsys.readouterr().out
        assert len(got) == (6 if frames else 4)
        for g, w in zip(got[:4], want[:4]):
            np.testing.assert_array_equal(g, w)
    assert list(got[4].columns) == list(want[4].columns)
    np.testing.assert_array_equal(got[4].coverage, want[4].coverage)
    assert got[5].equals(want[5])


def test_load_test_dataset_equals_jax(tgs_dir):
    for kw in ({}, {"partial": True, "part_size": 3}):
        df = jds.load_test_dataset(tgs_dir, SIZE, SIZE, 1, **kw)
        ids, images = tds.load_test_dataset(tgs_dir, SIZE, SIZE, 1, **kw)
        assert ids == list(df.index)
        np.testing.assert_array_equal(images, np.stack(df.images.tolist()))
        assert images.shape == (len(ids), SIZE, SIZE)


def test_read_train_index_in_file_order(tgs_dir):
    assert tds.read_train_index(tgs_dir) == [f"id{i:03d}" for i in range(N)]


def test_cov_to_class_equals_jax():
    for v in np.linspace(0, 1, 201):
        assert tds.cov_to_class(v) == jds.cov_to_class(v)


@pytest.mark.parametrize("n", [10, 16, 30, 37, 101, 400, 1003])
@pytest.mark.parametrize("n_classes", [2, 3, 5, 11])
def test_split_equals_sklearn(n, n_classes):
    rng = np.random.default_rng(n * 7 + n_classes)
    for trial in range(3):
        strata = rng.integers(0, n_classes, n)
        x = np.arange(n)
        for test_size in (0.2, 0.25, 0.1):
            try:
                want = sk_train_test_split(x, test_size=test_size, stratify=strata.tolist(), random_state=42)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tds.stratified_split_indices(n, strata.tolist(), test_size, 42)
                assert str(got.value) == str(e)
                continue
            train, test = tds.stratified_split_indices(n, strata.tolist(), test_size, 42)
            np.testing.assert_array_equal(train, want[0])
            np.testing.assert_array_equal(test, want[1])


def test_split_errors_equal_sklearn():
    x = np.arange(12)
    cases = [[0] * 11 + [1],  # a class of one member
             list(range(6)) * 2,  # 6 classes, 3 test samples
             [0, 1] * 6]
    for strata in cases:
        for test_size in (0.2, 0.5, 0.0, 1.0, 12):
            try:
                want = sk_train_test_split(x, test_size=test_size, stratify=strata, random_state=42)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tds.train_test_split(x, test_size=test_size, stratify=strata, random_state=42)
                if test_size not in (0.0, 1.0):  # sklearn's parameter check words these its own way
                    assert str(got.value) == str(e)
            else:
                got = tds.train_test_split(x, test_size=test_size, stratify=strata, random_state=42)
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", [(SIZE, SIZE), (64, 80)])
@pytest.mark.parametrize("kind", ["image_u8", "mask_u16", "rgb_u8"])
def test_load_image_equals_jax(tgs_dir, tmp_path, kind, shape):
    if kind == "image_u8":
        path = os.path.join(tgs_dir, "train/images/id003.png")
    elif kind == "mask_u16":
        path = os.path.join(tgs_dir, "train/masks/id004.png")
    else:
        path = str(tmp_path / "rgb.png")
        Image.fromarray((np.random.default_rng(1).random((33, 47, 3)) * 255).astype(np.uint8)).save(path)
    got, want = timg.load_image(path, shape), jimg.load_image(path, shape)
    assert got.dtype == np.float64 and got.shape == shape
    np.testing.assert_array_equal(got, want)
    if kind == "mask_u16" and shape == (SIZE, SIZE):
        assert got.max() == 65535.0


def test_image_helpers_equal_jax(tmp_path):
    a = np.random.default_rng(2).random((5, 6, 3))
    np.testing.assert_array_equal(timg.hwc_to_chw(a), jimg.hwc_to_chw(a))
    np.testing.assert_array_equal(timg.chw_to_hwc(timg.hwc_to_chw(a)), a)
    np.testing.assert_array_equal(timg._resize_bilinear(a[..., 0], (9, 4)), jimg._resize_bilinear(a[..., 0], (9, 4)))
    m = a[..., 0] > 0.5
    timg.save_mask_png(str(tmp_path / "t.png"), m)
    jimg.save_mask_png(str(tmp_path / "j.png"), m)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")), np.asarray(Image.open(tmp_path / "j.png")))


def test_hdf5_dataset_round_trip(tmp_path):
    pytest.importorskip("h5py")
    root = tmp_path / "tgs"
    make_tgs_dir(root, n=6, size=24, n_test=1, seed=3)
    got_path = th5.create_hdf5_data_set(str(root), "port.hdf5", im_width=16, im_height=16, im_chan=3)
    want_path = jh5.create_hdf5_data_set(str(root), "jax.hdf5", im_width=16, im_height=16, im_chan=3)
    got, want = th5.load_hdf5_data_set(got_path), jh5.load_hdf5_data_set(want_path)
    assert got[0].shape == (6, 16, 16, 3) and got[1].shape == (6, 16, 16, 1) and got[1].dtype == bool
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert jh5.load_hdf5_data_set(got_path)[0].shape == (6, 16, 16, 3)
    # the check plot: JAX's figure (the same draw from Python's global random) after loading
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    figs = []
    for mod in (th5, jh5):
        random.seed(11)
        mod.create_hdf5_data_set(str(root), f"{mod.__name__.split('.')[0]}_check.hdf5", im_width=16, im_height=16,
                                 im_chan=3, show_check_plot=True)
        figs.append(plt.gcf())
        plt.close(figs[-1])
    (tf, jf) = figs
    assert [a.get_title() for a in tf.axes] == [a.get_title() for a in jf.axes] == ["Image", "Mask"]
    for ta, ja in zip(tf.axes, jf.axes):
        np.testing.assert_array_equal(ta.get_images()[0].get_array(), ja.get_images()[0].get_array())
