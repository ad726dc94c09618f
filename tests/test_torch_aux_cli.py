"""The port's aux CLIs (cli.visualize, cli.keras_history, cli.build_dataset)
and cli.infer --visualize against the JAX package's: the same parsers
(flags, short forms, defaults, types, help), the same HDF5 dataset from the
same TGS directory, the same figures headless (Agg), and no module of the
port importing matplotlib, seaborn, h5py or pandas when it is imported."""

import argparse
import os
import random
import subprocess
import sys

import matplotlib

matplotlib.use("Agg", force=True)

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from plastic_unet_tpu.cli import build_dataset as jbuild  # noqa: E402
from plastic_unet_tpu.cli import keras_history as jhist  # noqa: E402
from plastic_unet_tpu.cli import visualize as jvis  # noqa: E402
from plastic_unet_tpu.data.hdf5_io import load_hdf5_data_set  # noqa: E402
from plastic_unet_tpu_torch.cli import build_dataset as tbuild  # noqa: E402
from plastic_unet_tpu_torch.cli import infer as tinfer  # noqa: E402
from plastic_unet_tpu_torch.cli import keras_history as thist  # noqa: E402
from plastic_unet_tpu_torch.cli import train as ttrain  # noqa: E402
from plastic_unet_tpu_torch.cli import visualize as tvis  # noqa: E402
from plastic_unet_tpu_torch.viz import plots as tplots  # noqa: E402
from test_torch_dataset import make_tgs_dir  # noqa: E402
from test_torch_viz import assert_same_figure  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.filterwarnings("ignore:FigureCanvasAgg is non-interactive")


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli.train --synthetic 10 on the CPU: its out dir (train_net.pth, train_data.hdf5)."""
    out = tmp_path_factory.mktemp("train")
    ttrain.main(["--synthetic", "10", "-o", str(out), "-e", "2", "--neurons", "2", "--validate_every", "1",
                 "--device", "cpu"])
    return out


class _Parsed(Exception):
    pass


def parser_of(main) -> argparse.ArgumentParser:
    """The parser a CLI's main builds, caught as it parses."""
    real = argparse.ArgumentParser.parse_args

    def catch(self, *a, **k):
        raise _Parsed(self)

    argparse.ArgumentParser.parse_args = catch
    try:
        main([])
    except _Parsed as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("main did not parse")


def _actions(p: argparse.ArgumentParser) -> list:
    return [(type(a).__name__, a.option_strings, a.dest, a.default, a.type, a.required, a.help, a.nargs, a.const)
            for a in p._actions]


@pytest.mark.parametrize("name", ["visualize", "keras_history", "build_dataset"])
def test_parsers_match_jax(name):
    port, jax_cli = {"visualize": (tvis, jvis), "keras_history": (thist, jhist),
                     "build_dataset": (tbuild, jbuild)}[name]
    got, want = parser_of(port.main), parser_of(jax_cli.main)
    assert got.description == want.description
    assert _actions(got) == _actions(want)
    assert _actions(port.build_parser()) == _actions(want)


def test_build_dataset_matches_jax(tmp_path):
    """The same HDF5 arrays from the same TGS directory (two copies: each CLI writes <dir>/dataset.hdf5);
    --check-plot draws JAX's figure from the same draw of Python's random; an unknown action raises."""
    dirs = [make_tgs_dir(tmp_path / d, n=6, size=24, n_test=1, seed=3) for d in ("port", "jax")]
    got = load_hdf5_data_set(tbuild.main(["-i", dirs[0]]))
    jbuild.main(["-i", dirs[1]])
    want = load_hdf5_data_set(os.path.join(dirs[1], "dataset.hdf5"))
    assert got[0].shape == (6, 128, 128, 3) and got[1].dtype == bool
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    figs = []
    for main, d in ((tbuild.main, dirs[0]), (jbuild.main, dirs[1])):
        random.seed(21)
        main(["--data", d, "--check-plot"])
        figs.append(plt.gcf())
    assert [a.get_title() for a in figs[0].axes] == ["Image", "Mask"]
    assert_same_figure(*figs)
    with pytest.raises(ValueError, match="Usuported action requested: plot"):
        tbuild.main(["-i", dirs[0], "--action", "plot"])


def test_visualize_cli_matches_jax(trained):
    """cli.visualize on cli.train's own train_data.hdf5, headless: JAX's figure."""
    figs = []
    for main in (tvis.main, jvis.main):
        main(["-f", str(trained / "train_data.hdf5"), "-r", "8", "-w", "3"])
        figs.append(plt.gcf())
    assert [a.get_title() for a in figs[0].axes][:2] == ["Validation Data", "Training Costs"]
    assert_same_figure(*figs)


def test_keras_history_cli_matches_jax(tmp_path):
    import pickle

    path = str(tmp_path / "h.pickle")
    with open(path, "wb") as f:
        pickle.dump({"loss": [0.7, 0.5], "val_loss": [0.72, 0.6], "mean_iou": [0.5, 0.6],
                     "val_mean_iou": [0.45, 0.5]}, f)
    figs = []
    for main in (thist.main, jhist.main):
        main(["-f", path])
        figs.append(plt.gcf())
    assert_same_figure(*figs)
    with pytest.raises(SystemExit):  # -f is required, as in JAX
        thist.main([])


@pytest.mark.parametrize("fixed", [False, True], ids=["searched", "fixed_threshold"])
def test_cli_infer_visualize_runs(trained, tmp_path, monkeypatch, fixed):
    """cli.infer --visualize --device cpu: one figure a test tile (each closed after its show), holding the
    tile and the mask that submission.csv encodes; the same submission as without --visualize."""
    tgs = make_tgs_dir(tmp_path / "tgs")
    drawn = []
    real = tplots.plot_image_mask
    monkeypatch.setattr(tplots, "plot_image_mask",
                        lambda i, m, show=True: drawn.append((i, m, real(i, m, show))) or drawn[-1][2])
    base = ["-m", str(trained / "train_net.pth"), "-i", tgs, "--neurons", "2", "--partial", "-d", "4",
            "--precision", "parity", "--device", "cpu"] + (["--fixed-threshold", "0.5"] if fixed else [])
    got = tinfer.main(base + ["-o", str(tmp_path / "vis"), "--visualize"])
    assert len(drawn) == 4 and not any(plt.fignum_exists(fig.number) for _, _, fig in drawn)
    assert len(plt.get_fignums()) == 2  # the loader's debug plots (coverage, depth) stay open, as in JAX
    plain = tinfer.main(base + ["-o", str(tmp_path / "plain")])
    assert open(got).read() == open(plain).read()
    from plastic_unet_tpu_torch.ops.rle import encode

    rows = open(got).read().splitlines()[1:]
    for (image, mask, _), row in zip(drawn, rows):
        assert image.shape == (101, 101, 3) and np.array_equal(image[..., 0], image[..., 2])
        assert encode(mask) == row.split(",", 1)[1]


def test_port_imports_no_plotting_or_table_library():
    """Every module of the port imports on a host without matplotlib, seaborn, h5py or pandas (the card's
    host): none of them is imported when the package's modules are."""
    code = (
        "import sys, pkgutil, importlib\n"
        "import plastic_unet_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'seaborn', 'h5py', 'pandas'))\n"
        "assert not bad, bad\n"
        "assert {'plastic_unet_tpu_torch.viz.plots', 'plastic_unet_tpu_torch.ops.native',\n"
        "        'plastic_unet_tpu_torch.utils.profiling', 'plastic_unet_tpu_torch.cli.build_dataset'} <= set(names)\n"
        "print('ok', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
