"""The port's plots (plastic_unet_tpu_torch.viz.plots) against the JAX
package's on the same seeded inputs, headless (Agg): the same axes, titles,
labels, limits and legends, the same line data (moving_average exactly),
patches and image arrays. render_data reads the HDF5 that each package's
save_reference_artifacts writes from the same numbers, plot_history the
pickle of the port's CoordConv trainer, and predict(visualize=True) draws
per tile the image and mask arrays JAX draws."""

import pickle
import random

import matplotlib

matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from plastic_unet_tpu.train.checkpoint import save_reference_artifacts as jax_save_artifacts  # noqa: E402
from plastic_unet_tpu.viz import plots as jplots  # noqa: E402
from plastic_unet_tpu_torch.train.checkpoint import save_reference_artifacts  # noqa: E402
from plastic_unet_tpu_torch.viz import plots as tplots  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore:FigureCanvasAgg is non-interactive")


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def _artist_data(ax) -> dict:
    legend = ax.get_legend()
    return {
        "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
        "xlim": ax.get_xlim(), "ylim": ax.get_ylim(),
        "legend": [t.get_text() for t in legend.get_texts()] if legend else None,
        "lines": [(ln.get_xdata(), ln.get_ydata(), ln.get_color(), ln.get_label(), ln.get_alpha(), ln.get_marker())
                  for ln in ax.get_lines()],
        "images": [im.get_array() for im in ax.get_images()],
        "patches": [(p.get_x(), p.get_y(), p.get_width(), p.get_height()) for p in ax.patches
                    if hasattr(p, "get_height")],
        "fills": [[path.vertices for path in c.get_paths()] for c in ax.collections],
    }


def assert_same_figure(got, want):
    assert len(got.axes) == len(want.axes)
    sup = [f._suptitle.get_text() if f._suptitle else None for f in (got, want)]
    assert sup[0] == sup[1]
    assert tuple(got.get_size_inches()) == tuple(want.get_size_inches())
    for ga, wa in zip(got.axes, want.axes):
        g, w = _artist_data(ga), _artist_data(wa)
        assert g.keys() == w.keys()
        for key in g:
            if key in ("lines", "images", "patches", "fills"):
                assert len(g[key]) == len(w[key]), key
                for a, b in zip(g[key], w[key]):
                    if key == "fills":
                        assert len(a) == len(b)
                        for va, vb in zip(a, b):
                            np.testing.assert_array_equal(va, vb)
                    elif key == "lines":
                        np.testing.assert_array_equal(a[0], b[0])
                        np.testing.assert_array_equal(a[1], b[1])
                        assert a[2:] == b[2:]
                    else:
                        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            else:
                assert g[key] == w[key], key


@pytest.mark.parametrize("window", [1, 3, 10, 1000])
def test_moving_average_matches_jax(window):
    data = np.random.default_rng(window).random(257)
    np.testing.assert_array_equal(tplots.moving_average(data, window), jplots.moving_average(data, window))


class _Params(torch.nn.Module):
    """A module whose state_dict is the plastic head's w, alpha, eta."""

    def __init__(self, params: dict):
        super().__init__()
        for k, v in params.items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v)))


@pytest.mark.parametrize("validation", [True, False], ids=["val", "no_val"])
def test_render_data_matches_jax(tmp_path, validation):
    """The port's render_data on the port's HDF5 == JAX's on JAX's, the same numbers written by each
    package's save_reference_artifacts; load_train_history reads both files alike."""
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((16, 16)).astype(np.float32),
              "alpha": rng.random((16, 16)).astype(np.float32), "eta": np.array([0.01], np.float32)}
    losses = rng.random(200).tolist()
    vals = ([0.6, 0.5, 0.4], [0.65, 0.55, 0.5], [0.7, 0.8, 0.85]) if validation else ([], [], [])
    save_reference_artifacts(str(tmp_path / "port"), _Params(params), {"lr": 3e-4}, losses, *vals)
    jax_save_artifacts(str(tmp_path / "jax"), params, {"lr": 3e-4}, losses, *vals)
    port_h5, jax_h5 = str(tmp_path / "port_data.hdf5"), str(tmp_path / "jax_data.hdf5")
    for a, b in ((tplots.load_train_history(port_h5), jplots.load_train_history(jax_h5)),
                 (tplots.load_train_history(jax_h5), jplots.load_train_history(port_h5))):
        assert a.keys() == b.keys() == {"all_losses", "val_train_losses", "val_test_losses", "val_accuracies",
                                         "w", "alpha", "eta"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for rpe, window in ((50, 10), (-1, 1)):
        got = tplots.render_data(port_h5, runs_per_epoch=rpe, window_size=window, show=False)
        want = jplots.render_data(jax_h5, runs_per_epoch=rpe, window_size=window, show=False)
        assert len(got.axes) == (3 if validation else 1)  # the validation plot's twin axis
        assert_same_figure(got, want)


def test_plot_best_iou_matches_jax():
    thr = np.linspace(-0.8, 0.8, 31)
    ious = np.exp(-((thr - 0.1) ** 2))
    assert_same_figure(tplots.plot_best_iou(thr, ious, show=False), jplots.plot_best_iou(thr, ious, show=False))


def test_plot_coverage_and_depth_match_jax():
    rng = np.random.default_rng(0)
    train_df = pd.DataFrame({"coverage": rng.random(50), "coverage_class": rng.integers(0, 11, 50),
                             "z": rng.integers(50, 900, 50)})
    test_df = pd.DataFrame({"z": rng.integers(50, 900, 30)})
    assert_same_figure(tplots.plot_coverage(train_df, show=False), jplots.plot_coverage(train_df, show=False))
    got = tplots.plot_depth(train_df, test_df, show=False)
    want = jplots.plot_depth(train_df, test_df, show=False)
    assert len(got.axes[0].collections) == 2  # the two filled densities
    assert_same_figure(got, want)


@pytest.mark.parametrize("keys", ["coord_trainer", "keras_accuracy"])
def test_plot_history_matches_jax(tmp_path, keys):
    """The pickle the port's CoordConv trainer writes (do_training at 16 px, 2 epochs), and a Keras
    history with accuracy keys in place of mean_iou."""
    if keys == "coord_trainer":
        from plastic_unet_tpu_torch.train import coord_trainer as ct

        rng = np.random.default_rng(1)
        X = (rng.random((20, 16, 16, 1)) * 255).astype(np.float32)
        Y = (rng.random((20, 16, 16, 1)) > 0.5).astype(np.float32)
        ct.do_training(ct.construct_model(16, 16, 1), X, Y, 2, -1, str(tmp_path / "cc"), device="cpu")
        path = str(tmp_path / "cc_final_history.pickle")
        with open(path, "rb") as f:
            assert set(pickle.load(f)) == {"loss", "val_loss", "mean_iou", "val_mean_iou"}
    else:
        path = str(tmp_path / "keras.pickle")
        with open(path, "wb") as f:
            pickle.dump({"loss": [0.7, 0.5, 0.4], "val_loss": [0.72, 0.6, 0.55], "accuracy": [0.5, 0.6, 0.7],
                         "val_accuracy": [0.45, 0.5, 0.6]}, f)
    got, want = tplots.plot_history(path, show=False), jplots.plot_history(path, show=False)
    assert [a.get_title() for a in got.axes] == ["model accuracy", "model loss"]
    assert_same_figure(got, want)


def test_spot_checks_match_jax():
    """plot_train_check / plot_test_check draw their index from Python's global random: seeded alike,
    they draw the same tile; plot_image_mask as predict calls it."""
    rng = np.random.default_rng(3)
    X = rng.random((6, 16, 16, 1))
    Y = rng.random((6, 16, 16, 1)) > 0.5
    for fn in ("plot_train_check", "plot_test_check"):
        args = (X, Y) if fn == "plot_train_check" else (X,)
        figs = []
        for mod in (tplots, jplots):
            random.seed(7)
            figs.append(getattr(mod, fn)(*args, show=False))
        assert_same_figure(*figs)
    img = X[2].squeeze()
    assert_same_figure(tplots.plot_image_mask(np.dstack((img, img, img)), Y[2], show=False),
                       jplots.plot_image_mask(np.dstack((img, img, img)), Y[2], show=False))


def _gap_threshold(probs) -> float:
    """A threshold in the widest gap of the middle half of the sorted probabilities."""
    p = np.unique(np.asarray(probs, np.float32))
    mid = p[len(p) // 4: 3 * len(p) // 4 + 1]
    i = int(np.argmax(np.diff(mid)))
    assert mid[i + 1] - mid[i] > 2e-5
    return float((mid[i] + mid[i + 1]) / 2)


def test_predict_visualize_matches_jax(tmp_path, monkeypatch):
    """predict(visualize=True) at neurons=2, 16 px, weights carried from JAX by state_dict_from_jax_params:
    one figure a tile, holding the tile (stacked x3) and its mask as JAX's do; the port closes each figure
    after its show; the submission is the one written without visualize."""
    import importlib

    import jax.numpy as jnp

    from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
    from plastic_unet_tpu.utils.torch_interop import state_dict_to_flax_params, unetp_res_name_map
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.submit import inference as tinf
    from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params

    jinf = importlib.import_module("plastic_unet_tpu.submit.inference")  # the package exports a function of this name
    size = 16
    seeded = UNetPRes(neurons=2, nbf=size, rule="hebb", generator=torch.Generator().manual_seed(4))
    params = state_dict_to_flax_params({k: v.numpy() for k, v in seeded.state_dict().items()},
                                       unetp_res_name_map())
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, nbf=size, rule="hebb")
    tm = UNetPRes(neurons=2, nbf=size, rule="hebb")
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)

    x = np.random.default_rng(5).standard_normal((3, size, size, 1)).astype(np.float32)
    ids = [f"t{i}" for i in range(3)]
    thr = _gap_threshold(np.asarray(jinf.predict_masks_tta(jm, params, jnp.asarray(x), chunk=4)))
    rp = {"img_height": size, "img_width": size, "img_chan": 1, "mask_threshold": thr, "subm_file": "s.csv"}
    drawn = {}
    for name, mod in (("port", tplots), ("jax", jplots)):
        calls = drawn[name] = []
        real = mod.plot_image_mask

        def spy(image, mask, show=True, real=real, calls=calls):
            fig = real(image, mask, show=show)
            calls.append((image, mask, fig))
            return fig

        monkeypatch.setattr(mod, "plot_image_mask", spy)
    for d in ("port", "jax", "plain"):
        (tmp_path / d).mkdir()
    tinf.predict(tm, ids, x, dict(rp, out_dir=str(tmp_path / "port")), visualize=True, chunk=4, device="cpu")
    assert plt.get_fignums() == []  # each figure closed after its show
    test_df = pd.DataFrame({"images": list(x)}, index=ids)
    jinf.predict(jm, params, test_df, dict(rp, out_dir=str(tmp_path / "jax")), visualize=True, chunk=4)
    tinf.predict(tm, ids, x, dict(rp, out_dir=str(tmp_path / "plain")), chunk=4, device="cpu")

    assert len(drawn["port"]) == len(drawn["jax"]) == 3
    n_set = 0
    for (ti, tmask, tfig), (ji, jmask, jfig) in zip(drawn["port"], drawn["jax"]):
        assert ti.shape == (size, size, 3)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tmask, np.asarray(jmask))
        n_set += int(tmask.sum())
        assert_same_figure(tfig, jfig)
    assert 0 < n_set < 3 * size * size
    sub = (tmp_path / "port" / "s.csv").read_text()
    assert sub == (tmp_path / "jax" / "s.csv").read_text() == (tmp_path / "plain" / "s.csv").read_text()
