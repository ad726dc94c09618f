"""The port's CLIs (python -m plastic_unet_tpu_torch.cli.{train,eval,infer,
tuned_run}): every option string, default and choice of the JAX parsers;
runs on the CPU with --device cpu (synthetic training, the tuned run to
submission.csv, eval and infer on a fake TGS directory with a .pth the
training wrote, held against the JAX CLIs); CUDA by default; the flags of
options the port lacks raise."""

import argparse
import json
import os
import sys

import numpy as np
import pytest
import torch

from plastic_unet_tpu.cli import eval as jeval
from plastic_unet_tpu.cli import infer as jinfer
from plastic_unet_tpu.cli import train as jtrain
from plastic_unet_tpu.cli import tuned_run as jtuned
from plastic_unet_tpu_torch.cli import eval as teval
from plastic_unet_tpu_torch.cli import infer as tinfer
from plastic_unet_tpu_torch.cli import train as ttrain
from plastic_unet_tpu_torch.cli import tuned_run as ttuned
from test_torch_dataset import make_tgs_dir

torch.set_num_threads(2)

PAIRS = [(jtrain, ttrain), (jeval, teval), (jinfer, tinfer), (jtuned, ttuned)]


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


@pytest.mark.parametrize("jmod,tmod", PAIRS, ids=["train", "eval", "infer", "tuned_run"])
def test_parser_keeps_every_jax_flag(jmod, tmod):
    want, got = _actions(jmod.build_parser()), _actions(tmod.build_parser())
    for dest, a in want.items():
        assert dest in got, dest
        b = got[dest]
        assert set(a.option_strings) <= set(b.option_strings), dest
        assert (b.default, b.choices, b.type, b.required, type(b)) == (a.default, a.choices, a.type, a.required,
                                                                       type(a)), dest
    assert got["device"].default is None and "--device" in got["device"].option_strings


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli.train --synthetic 10 on the CPU: its out dir."""
    out = tmp_path_factory.mktemp("train")
    result = ttrain.main(["--synthetic", "10", "-o", str(out), "-e", "2", "--neurons", "2", "--validate_every", "1",
                          "--shuffle", "--augment", "--epochs-per-dispatch", "2", "--device", "cpu"])
    return out, result


def test_cli_train_synthetic(trained):
    out, result = trained
    assert len(result.all_losses) == 2 * 8 and np.isfinite(result.all_losses).all()
    assert len(result.val_test_losses) == 2 and result.state.step == 16
    for f in ("train_net.pth", "train_parameters.dat", "train_data.hdf5", "train_state.pt"):
        assert os.path.exists(out / f), f


def test_cli_train_resume_continues(trained, tmp_path):
    out, first = trained
    more = ttrain.main(["--synthetic", "10", "-o", str(tmp_path), "-e", "1", "--neurons", "2", "--shuffle",
                        "--augment", "--resume", str(out / "train_state.pt"), "--device", "cpu"])
    assert more.state.step == 24 and more.state.scheduler.last_epoch == 24


def test_cli_tuned_run_writes_submission(tmp_path):
    path = ttuned.main(["--synthetic", "10", "--epochs", "1", "--neurons", "2", "--out", str(tmp_path),
                        "--device", "cpu"])
    assert path == str(tmp_path / "submission.csv")
    lines = open(path).read().splitlines()
    assert lines[0] == "id,rle_mask" and [ln.split(",")[0] for ln in lines[1:]] == [f"syn{i}" for i in range(5)]
    assert os.path.exists(tmp_path / "train_net.pth")


@pytest.fixture(scope="module")
def tgs_dir(tmp_path_factory):
    return make_tgs_dir(tmp_path_factory.mktemp("tgs"))


def test_cli_eval_matches_jax(trained, tgs_dir):
    pth = str(trained[0] / "train_net.pth")
    thr, iou = teval.main(["-m", pth, "-i", tgs_dir, "--neurons", "2", "--precision", "parity", "--device", "cpu"])
    jthr, jiou = jeval.main(["-m", pth, "-i", tgs_dir, "--neurons", "2", "--precision", "parity"])
    assert thr == jthr
    assert iou == pytest.approx(jiou, abs=1e-6)


def test_cli_infer_matches_jax(trained, tgs_dir, tmp_path):
    pth = str(trained[0] / "train_net.pth")
    for extra in ([], ["--fixed-threshold", "0.5", "--partial", "-d", "4"]):
        got = tinfer.main(["-m", pth, "-i", tgs_dir, "-o", str(tmp_path / "port"), "--neurons", "2",
                           "--precision", "parity", "--device", "cpu"] + extra)
        jinfer.main(["-m", pth, "-i", tgs_dir, "-o", str(tmp_path / "jax"), "--neurons", "2",
                     "--precision", "parity"] + extra)
        text = open(got).read()
        assert text == open(tmp_path / "jax" / "submission.csv").read()
        assert len(text.splitlines()) == 1 + (4 if extra else 7)


def test_cli_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the refusal shows only without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["--synthetic", "10", "-o", str(tmp_path), "-e", "1", "--neurons", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttuned.main(["--synthetic", "10", "--epochs", "1", "--neurons", "2", "--out", str(tmp_path)])


# the ids of the cases as they were when the options of test_cli_train_ported_flags_run raised too;
# --arch unet is ported and raises UNetP's geometry error on the CLI's 101-px tiles, as the JAX CLI does;
# --devices 2 is ported and, outside torchrun's environment, raises naming it;
# --compute-dtype bfloat16 is ported (match None): it trains the bf16 trunk
@pytest.mark.parametrize("flags,match", [pytest.param(["--arch", "unet"], "divisible by 16", id="flags1"),
                                         pytest.param(["--devices", "2"], "torchrun", id="flags2"),
                                         pytest.param(["--compute-dtype", "bfloat16"], None, id="flags3")])
def test_cli_train_unported_flags_raise(tmp_path, flags, match):
    if match is None:
        res = ttrain.main(["--synthetic", "5", "-o", str(tmp_path), "-e", "1", "--neurons", "2", "--device", "cpu"]
                          + flags)
        assert res.model.compute_dtype == torch.bfloat16 and np.isfinite(res.all_losses).all()
        return
    with pytest.raises(ValueError, match=match):
        ttrain.main(["--synthetic", "10", "-o", str(tmp_path), "-e", "1", "--neurons", "2", "--device", "cpu"]
                    + flags)


@pytest.mark.parametrize("flags,attr,value", [(["--trunk-pad", "128"], "trunk_pad", 128),
                                              (["--remat-trunk"], "remat_trunk", True),
                                              (["--fast-dw"], "fast_dw", True),
                                              (["--patch-conv", "32"], "patch_conv", 32),
                                              (["--rng-impl", "rbg"], None, None)])
def test_cli_train_ported_flags_run(tmp_path, flags, attr, value):
    res = ttrain.main(["--synthetic", "5", "-o", str(tmp_path), "-e", "1", "--neurons", "2", "--device", "cpu"]
                      + flags)
    assert np.isfinite(res.all_losses).all() and res.state.step == 4
    if attr is not None:
        assert getattr(res.model, attr) == value


def test_cli_infer_unported_flags_raise(trained, tgs_dir, tmp_path, monkeypatch):
    pth = str(trained[0] / "train_net.pth")
    base = ["-m", pth, "-i", tgs_dir, "-o", str(tmp_path), "--neurons", "2", "--device", "cpu"]
    with pytest.raises(ValueError, match="torchrun"):  # --devices is ported: it needs torchrun's ranks
        tinfer.main(base + ["--devices", "2"])
    with pytest.raises(ValueError, match="unknown TTA"):
        tinfer.main(base + ["--tta", "flip"])
    # --visualize is ported (tests/test_torch_aux_cli.py); without matplotlib it raises, naming it
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match="matplotlib"):
            tinfer.main(base + ["--visualize", "--fixed-threshold", "0.5"])


def test_cli_infer_trunk_pad_matches_jax(trained, tgs_dir, tmp_path):
    """--trunk-pad 128 (the model trained unpadded, as a user may serve it):
    the JAX CLI's submission.csv, word for word."""
    pth = str(trained[0] / "train_net.pth")
    extra = ["--trunk-pad", "128", "--fixed-threshold", "0.5", "--partial", "-d", "4"]
    got = tinfer.main(["-m", pth, "-i", tgs_dir, "-o", str(tmp_path / "port"), "--neurons", "2",
                       "--precision", "parity", "--device", "cpu"] + extra)
    jinfer.main(["-m", pth, "-i", tgs_dir, "-o", str(tmp_path / "jax"), "--neurons", "2", "--precision", "parity"]
                + extra)
    assert open(got).read() == open(tmp_path / "jax" / "submission.csv").read()


def test_cli_infer_tta_save_int8(trained, tgs_dir, tmp_path):
    """--tta tta4 --save --quant int8 writes submission.csv and one PNG per
    test id that decodes to that id's RLE; --quant-calib 4 calibrates on the
    first 4 validation tiles; the threshold search runs on the int8 model."""
    from PIL import Image

    from plastic_unet_tpu_torch.ops.rle import rle_decode

    pth = str(trained[0] / "train_net.pth")
    out = tmp_path / "out"
    path = tinfer.main(["-m", pth, "-i", tgs_dir, "-o", str(out), "--neurons", "2", "--tta", "tta4", "--save",
                        "--quant", "int8", "--quant-calib", "4", "--device", "cpu"])
    rows = [ln.split(",", 1) for ln in open(path).read().splitlines()[1:]]
    assert sorted(i for i, _ in rows) == [f"t{j}" for j in range(7)]
    for idx, rle in rows:
        png = np.asarray(Image.open(out / "masks" / f"{idx}.png"))
        assert png.shape == (101, 101, 3)
        np.testing.assert_array_equal(png[..., 0] > 0, rle_decode(rle, (101, 101)).astype(bool))


def test_cli_export_parser_keeps_every_jax_flag():
    """cli.export_model keeps the JAX parser's flags, defaults and choices;
    only --platforms names the port's devices (cpu,cuda for cpu,tpu)."""
    from plastic_unet_tpu.cli import export_model as jexport_cli
    from plastic_unet_tpu_torch.cli import export_model as texport_cli

    want, got = _actions(jexport_cli.build_parser()), _actions(texport_cli.build_parser())
    assert set(want) == set(got)
    for dest, a in want.items():
        b = got[dest]
        assert set(a.option_strings) == set(b.option_strings), dest
        same = (b.choices, b.type, b.required, type(b)) == (a.choices, a.type, a.required, type(a))
        assert same and (b.default == a.default or dest == "platforms"), dest
    assert (want["platforms"].default, got["platforms"].default) == ("cpu,tpu", "cpu,cuda")


def test_cli_export_roundtrips(tmp_path):
    """cli.export_model --platforms cpu: a .pth in, an artifact out whose
    tta2 masks are within 1.2e-7 of the live TTA on the same weights."""
    from plastic_unet_tpu_torch.cli import export_model
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.submit.export import load_predictor
    from plastic_unet_tpu_torch.submit.inference import predict_masks_tta

    model = UNetPRes(nbf=32, neurons=2, generator=torch.Generator().manual_seed(2))
    pth = str(tmp_path / "m.pth")
    torch.save(model.state_dict(), pth)
    out = export_model.main(["--model", pth, "--out", str(tmp_path / "artifact"), "--nbf", "32", "--neurons", "2",
                             "--chunk", "4", "--tta", "tta2", "--platforms", "cpu"])
    assert sorted(os.listdir(out)) == ["forward.cpu.pt2", "meta.json"]
    X = np.random.default_rng(8).standard_normal((5, 32, 32, 1)).astype(np.float32)
    got = load_predictor(out, device="cpu").predict(X)
    want = predict_masks_tta(model, X, transforms=("identity", "hflip"), chunk=4, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1.2e-7)


@pytest.mark.parametrize("flags,item", [(["--compute-dtype", "bfloat16"], None),
                                        (["--data-devices", "3"], "divisible by data_devices"),
                                        (["--arch", "unet", "--compute-dtype", "bfloat16"], "unet_res-only")],
                         ids=["bfloat16", "data-devices", "unet"])
def test_cli_export_unported_flags_raise(tmp_path, flags, item):
    """UNetP exports in fp32 only and refuses a compute dtype before any
    work, with the JAX predictor's message; sharded export is ported, and a
    chunk (128) that the data devices cannot share evenly raises before any
    work too. bfloat16 (item None) is ported: it exports the bf16 graph."""
    from plastic_unet_tpu_torch.cli import export_model

    if item is None:
        from plastic_unet_tpu_torch.models.unet_res import UNetPRes

        pth = str(tmp_path / "m.pth")
        torch.save(UNetPRes(nbf=16, neurons=2, generator=torch.Generator().manual_seed(2)).state_dict(), pth)
        out = export_model.main(["--model", pth, "--out", str(tmp_path / "a"), "--nbf", "16", "--neurons", "2",
                                 "--chunk", "2", "--platforms", "cpu", *flags])
        with open(os.path.join(out, "meta.json")) as f:
            assert json.load(f)["compute_dtype"] == "bfloat16"
        return
    with pytest.raises(ValueError, match=item):
        export_model.main(["--model", str(tmp_path / "none.pth"), "--out", str(tmp_path / "a"), *flags])


def test_cli_export_default_platforms_need_cuda(tmp_path):
    """--platforms defaults to cpu,cuda: on a host without CUDA it raises
    rather than writing a CPU program alone."""
    from plastic_unet_tpu_torch.cli import export_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default platforms export")
    pth = str(tmp_path / "m.pth")
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes

    torch.save(UNetPRes(nbf=32, neurons=2).state_dict(), pth)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_model.main(["--model", pth, "--out", str(tmp_path / "a"), "--nbf", "32", "--neurons", "2"])
    assert not os.path.exists(tmp_path / "a")
