"""The port's HTTP endpoint (plastic_unet_tpu_torch.submit.http_server) on
the CPU: /healthz names the predictor's device, /predict round-trips .npy
and equals the predictor's masks, /predict_rle returns its RLE strings,
errors answer 400 and unknown paths 404, as the JAX server does
(tests/test_http_server.py). Port 0: the suite runs under xdist."""

import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.submit import http_server as jhttp
from plastic_unet_tpu.submit.server import MaskPredictor as JaxMaskPredictor
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.submit import http_server as thttp
from plastic_unet_tpu_torch.submit.server import MaskPredictor
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params

torch.set_num_threads(2)

SIZE = 16


@pytest.fixture(scope="module")
def servers():
    """The port's and the JAX package's servers on the same weights, tta2."""
    jm = JaxUNetPRes(nbf=SIZE, neurons=2)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), jm.initial_zero_hebb(1))["params"]
    tm = UNetPRes(nbf=SIZE, neurons=2)
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    tp = MaskPredictor(tm, chunk=4, tta=("identity", "hflip"), threshold=0.5, device="cpu")
    jp = JaxMaskPredictor(jm, params, chunk=4, tta=("identity", "hflip"), threshold=0.5)
    ts, js = thttp.serve(tp, port=0, block=False), jhttp.serve(jp, port=0, block=False)
    yield ts, tp, js
    for s in (ts, js):
        s.shutdown()
        s.server_close()


def _url(srv, path):
    host, port = srv.server_address
    return f"http://{host}:{port}{path}"


def _npy(a) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a, allow_pickle=False)
    return buf.getvalue()


def _post(srv, path, body):
    req = urllib.request.Request(_url(srv, path), data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()


def test_healthz_names_the_device(servers):
    ts, tp, _ = servers
    with urllib.request.urlopen(_url(ts, "/healthz"), timeout=30) as r:
        body = json.loads(r.read())
    assert body == {"status": "ok", "device": "cpu"}
    assert thttp.device_label(tp.device) == "cpu"


def test_predict_npy_roundtrip(servers):
    ts, tp, js = servers
    imgs = np.random.default_rng(1).standard_normal((3, SIZE, SIZE)).astype(np.float32)
    status, body = _post(ts, "/predict", _npy(imgs))
    preds = np.load(io.BytesIO(body), allow_pickle=False)
    assert status == 200 and preds.dtype == np.float32 and preds.shape == (3, SIZE, SIZE)
    np.testing.assert_array_equal(preds.astype(bool), tp.predict(imgs))
    jpreds = np.load(io.BytesIO(_post(js, "/predict", _npy(imgs))[1]), allow_pickle=False)
    assert jpreds.dtype == preds.dtype and jpreds.shape == preds.shape


def test_predict_rle_returns_the_strings(servers):
    ts, tp, _ = servers
    imgs = np.random.default_rng(2).standard_normal((2, SIZE, SIZE, 1)).astype(np.float32)
    status, body = _post(ts, "/predict_rle", _npy(imgs))
    rles = json.loads(body)
    assert status == 200 and rles == tp.predict_rle(imgs)
    assert len(rles) == 2 and all(isinstance(r, str) for r in rles)


@pytest.mark.parametrize("path,body,code", [("/predict", b"not an npy file", 400),
                                            ("/predict_rle", b"", 400),
                                            ("/predict_nothing", b"x", 404)])
def test_errors_answer_as_jax(servers, path, body, code):
    ts, _, js = servers
    for srv in (ts, js):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, path, body)
        assert e.value.code == code
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(_url(ts, "/nothing"), timeout=30)
    assert e.value.code == 404


def test_parser_keeps_every_jax_flag():
    want = {a.dest: a for a in jhttp.build_parser()._actions}
    got = {a.dest: a for a in thttp.build_parser()._actions}
    for dest, a in want.items():
        b = got[dest]
        assert (set(a.option_strings), a.default, a.type) == (set(b.option_strings), b.default, b.type), dest
    assert got["device"].default is None


def test_main_refuses_artifact_and_serves_a_pth_on_cpu(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="export"):
        thttp.main(["--artifact", str(tmp_path)])
    path = str(tmp_path / "m.pth")
    torch.save(UNetPRes(nbf=SIZE, neurons=2).state_dict(), path)
    seen = {}
    monkeypatch.setattr(thttp, "serve", lambda p, host, port: seen.update(p=p, host=host, port=port))
    thttp.main(["--model", path, "--nbf", str(SIZE), "--neurons", "2", "--tta", "tta4", "--threshold", "0.4",
                "--port", "0", "--device", "cpu"])
    p = seen["p"]
    assert (p.tta, p.threshold, p.device.type, seen["port"]) == (("identity", "hflip", "vflip", "rot180"), 0.4,
                                                                 "cpu", 0)


@pytest.fixture(scope="module")
def artifact_model():
    return UNetPRes(nbf=SIZE, neurons=2, generator=torch.Generator().manual_seed(1)).eval()


def _serve_and_post(predictor, imgs):
    """(the /predict masks, the /predict_rle strings or the error code, /healthz) of a served predictor."""
    srv = thttp.serve(predictor, port=0, block=False)
    try:
        masks = np.load(io.BytesIO(_post(srv, "/predict", _npy(imgs))[1]), allow_pickle=False)
        try:
            rles = json.loads(_post(srv, "/predict_rle", _npy(imgs))[1])
        except urllib.error.HTTPError as e:
            rles = e.code
        with urllib.request.urlopen(_url(srv, "/healthz"), timeout=30) as r:
            health = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
    return masks, rles, health


def test_serve_artifact_equals_the_loaded_predictor(artifact_model, tmp_path):
    """An exported artifact (tta2, threshold 0.5) served over HTTP: /predict
    equals the loaded predictor bit for bit, /predict_rle its strings."""
    from plastic_unet_tpu_torch.submit.export import export_predictor, load_predictor

    path = export_predictor(artifact_model, str(tmp_path / "art"), chunk=4, tta=("identity", "hflip"),
                            threshold=0.5, platforms=("cpu",))
    pred = load_predictor(path, device="cpu")
    imgs = np.random.default_rng(11).standard_normal((5, SIZE, SIZE)).astype(np.float32)
    masks, rles, health = _serve_and_post(pred, imgs)
    np.testing.assert_array_equal(masks, pred.predict(imgs).astype(np.float32))
    assert rles == pred.predict_rle(imgs)
    assert health == {"status": "ok", "device": "cpu"}


def test_serve_int8_artifact(artifact_model, tmp_path):
    """An int8 artifact served over HTTP equals the live int8 forward bit
    for bit (as JAX's test_serve_int8_artifact holds)."""
    from plastic_unet_tpu_torch.eval.evaluate import predict_masks
    from plastic_unet_tpu_torch.submit.export import export_predictor, load_predictor
    from plastic_unet_tpu_torch.submit.quant import quantize_for_serving

    qmodel = quantize_for_serving(artifact_model, np.random.default_rng(12).random((8, SIZE, SIZE, 1),
                                                                                   dtype=np.float32), device="cpu")
    path = export_predictor(qmodel, str(tmp_path / "int8"), chunk=4, platforms=("cpu",))
    imgs = np.random.default_rng(13).standard_normal((6, SIZE, SIZE)).astype(np.float32)
    masks, rles, _ = _serve_and_post(load_predictor(path, device="cpu"), imgs)
    np.testing.assert_array_equal(masks, predict_masks(qmodel, imgs[..., None], chunk=4, device="cpu").numpy())
    assert rles == 400  # a probability artifact without a threshold: predict_rle refuses


@pytest.mark.parametrize("flag,value", [("--tta", "tta4"), ("--threshold", "0.4"), ("--chunk", "8"),
                                        ("--nbf", "32"), ("--neurons", "4"), ("--prule", "oja")])
def test_artifact_rejects_baked_flags(tmp_path, capsys, flag, value):
    """Flags the artifact bakes in are refused with --artifact (parser.error),
    as the JAX server refuses them."""
    with pytest.raises(SystemExit) as e:
        thttp.main(["--artifact", str(tmp_path), flag, value])
    assert e.value.code == 2
    assert flag in capsys.readouterr().err


def test_main_serves_an_artifact_on_cpu(artifact_model, tmp_path, monkeypatch):
    """--artifact loads the artifact on --device and serves it."""
    from plastic_unet_tpu_torch.submit.export import ExportedPredictor, export_predictor

    path = export_predictor(artifact_model, str(tmp_path / "art"), chunk=4, platforms=("cpu",))
    seen = {}
    monkeypatch.setattr(thttp, "serve", lambda p, host, port: seen.update(p=p, port=port))
    thttp.main(["--artifact", path, "--port", "0", "--device", "cpu"])
    assert isinstance(seen["p"], ExportedPredictor) and seen["p"].device.type == "cpu" and seen["port"] == 0
