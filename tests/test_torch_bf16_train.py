"""bfloat16 training, serving and export through the port's entry points
(CPU, plain versions), and the precision policy.

The 8-step B=1 trajectory (dropout 0) of the port's bf16 UNetPRes against
the JAX ``make_epoch_fn`` with the bf16 module from the same weights: the
losses within 3e-2 relative (tests/test_patch_conv.py's bf16 bound), and the
final parameters no farther from the JAX bf16 run than the JAX bf16 run is
from the JAX fp32 run from the same start (largest |difference| over every
parameter). Measured on an x86 CPU at neurons=2, SIZE=16, hebb and oja: the
losses within 3.9e-6 relative of JAX bf16, the parameters 7.0e-4 from JAX
bf16 against 3.7e-3 between the JAX bf16 and fp32 runs (Adam turns the last
bits of a small bf16 gradient into steps of up to the learning rate, 1e-3,
in both comparisons). ``eta`` stays exactly
0.01, as in JAX. Then the driver (with an exact resume), the CLIs, the
predictor, the bf16 artifact, data parallel over 2 Gloo ranks, and the
policy that ``matmul_precision`` hands to the step and the serving chunk."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.train import loop as jloop
from plastic_unet_tpu.train.optimizer import adam_step_lr as jax_adam_step_lr
from plastic_unet_tpu.utils import torch_interop as jti
from plastic_unet_tpu.utils.precision import matmul_precision as jax_precision
from plastic_unet_tpu_torch.cli import export_model as texport
from plastic_unet_tpu_torch.cli import train as ttrain
from plastic_unet_tpu_torch.cli import tuned_run as ttuned
from plastic_unet_tpu_torch.config import TrainConfig
from plastic_unet_tpu_torch.data.synthetic import synthetic_split
from plastic_unet_tpu_torch.eval.evaluate import predict_masks
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.submit.export import export_predictor, load_predictor
from plastic_unet_tpu_torch.submit.server import MaskPredictor
from plastic_unet_tpu_torch.train import driver
from plastic_unet_tpu_torch.train.loop import create_train_state, make_epoch_fn, make_train_step, reshape_stream
from plastic_unet_tpu_torch.utils.precision import current_policy, matmul_precision
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params, unetp_res_name_map
from test_torch_dp_worker import GAMMA, LR, NBF, STEPLR, join, spawn

torch.set_num_threads(2)

SIZE, NEURONS, STEPS = 16, 2, 8
SERVE_ATOL = 2e-2  # bf16 serving against fp32 (tests/test_export.py's bound for the JAX bf16 artifact)


def _seeded(seed=3, **kw):
    return UNetPRes(neurons=NEURONS, nbf=SIZE, dropout_ratio=0.0, generator=torch.Generator().manual_seed(seed), **kw)


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, SIZE, SIZE, 1)) * 0.5).astype(np.float32)
    y = (rng.random((n, SIZE, SIZE)) > 0.5).astype(np.float32)
    return x, y


def _jax_epoch(params, rule, dtype, X, Y):
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=NEURONS, dropout_ratio=0.0, nbf=SIZE, rule=rule,
                     compute_dtype=dtype)
    tx = jax_adam_step_lr(LR, GAMMA, STEPLR)
    state = jloop.TrainState(params, tx.init(params), jnp.zeros((1, SIZE, SIZE), jnp.float32),
                             jnp.zeros((), jnp.int32))
    with jax_precision("parity"):
        final, losses = jloop.make_epoch_fn(jm, tx, lanes=1, donate=False)(state, jnp.asarray(X), jnp.asarray(Y),
                                                                           jax.random.PRNGKey(0))
    return state_dict_from_jax_params(final.params), np.asarray(losses)


@pytest.mark.parametrize("rule", ["hebb", "oja"])
def test_trajectory_matches_jax_bf16_epoch(rule):
    x, y = _stream(STEPS, seed=11)
    X, Y = x[:, None], y[:, None]  # (S, B=1, ...)
    start = _seeded(rule=rule)
    params = jti.state_dict_to_flax_params(start.state_dict(), unetp_res_name_map())
    jb, jb_losses = _jax_epoch(params, rule, jnp.bfloat16, X, Y)
    j32, _ = _jax_epoch(params, rule, None, X, Y)
    model = UNetPRes(neurons=NEURONS, nbf=SIZE, dropout_ratio=0.0, rule=rule, compute_dtype="bfloat16")
    model.load_state_dict(start.state_dict(), strict=True)
    state = create_train_state(model, LR, GAMMA, STEPLR, device="cpu")
    state, losses = make_epoch_fn()(state, torch.from_numpy(X), torch.from_numpy(Y))
    np.testing.assert_allclose(losses.numpy(), jb_losses, rtol=3e-2)
    got = state.model.state_dict()
    assert list(got) == list(jb) and all(t.dtype == torch.float32 for t in got.values())
    port = max(float((got[k] - jb[k]).abs().max()) for k in jb)
    ref = max(float((jb[k] - j32[k]).abs().max()) for k in jb)
    assert 0 < port <= ref, (port, ref)
    assert float(state.model.eta.detach()) == float(np.float32(0.01)) == float(jb["eta"])
    assert all(s["exp_avg"].dtype == torch.float32 for s in state.optimizer.state.values())


def _cfg(out_dir, **kw):
    base = dict(out_dir=str(out_dir), epochs=2, lr=3e-4, val_every=1, save_every=1, rollout=50000, im_width=SIZE,
                im_height=SIZE, neurons=NEURONS, dropout_ratio=0.5, shuffle=True, augment=True,
                compute_dtype="bfloat16", matmul_precision="parity")
    base.update(kw)
    return TrainConfig(**base)


def test_start_train_bf16_resumes_bit_for_bit(tmp_path):
    data = synthetic_split(6, 2, size=SIZE, seed=9)
    straight = driver.start_train(*data, _cfg(tmp_path / "a"), device="cpu")
    first = driver.start_train(*data, _cfg(tmp_path / "b", epochs=1), device="cpu")
    rest = driver.start_train(*data, _cfg(tmp_path / "c", epochs=1, resume_orbax=str(tmp_path / "b" /
                                                                                    driver.RESUME_STATE)),
                              device="cpu")
    assert straight.model.compute_dtype == torch.bfloat16 and np.isfinite(straight.all_losses).all()
    assert first.all_losses + rest.all_losses == straight.all_losses
    assert rest.val_test_losses[-1] == straight.val_test_losses[-1]
    assert all(torch.equal(p, q) and p.dtype == torch.float32
               for p, q in zip(rest.model.parameters(), straight.model.parameters()))
    assert torch.equal(rest.state.generator.get_state(), straight.state.generator.get_state())
    fp32 = driver.start_train(*data, _cfg(tmp_path / "d", compute_dtype="float32"), device="cpu")
    assert fp32.all_losses != straight.all_losses  # no quiet fp32 trunk


def test_cli_train_and_tuned_run_bf16(tmp_path):
    res = ttrain.main(["--synthetic", "5", "-o", str(tmp_path / "t"), "-e", "1", "--neurons", "2",
                       "--compute-dtype", "bfloat16", "--precision", "parity", "--device", "cpu"])
    assert res.model.compute_dtype == torch.bfloat16 and np.isfinite(res.all_losses).all() and res.state.step == 4
    path = ttuned.main(["--synthetic", "10", "--epochs", "1", "--neurons", "2", "--compute-dtype", "bfloat16",
                        "--out", str(tmp_path / "tuned"), "--device", "cpu"])
    lines = open(path).read().splitlines()
    assert lines[0] == "id,rle_mask" and len(lines) == 6


def test_predictor_and_artifact_bf16(tmp_path):
    """from_pth in bf16 serves the bf16 model; its artifact says so in
    meta.json and equals the live path; both within 2e-2 of fp32."""
    pth = str(tmp_path / "m.pth")
    torch.save(_seeded().state_dict(), pth)
    X = np.random.default_rng(4).standard_normal((5, SIZE, SIZE, 1)).astype(np.float32)
    pred = MaskPredictor.from_pth(pth, nbf=SIZE, neurons=NEURONS, compute_dtype=torch.bfloat16, chunk=4, device="cpu")
    fp32 = MaskPredictor.from_pth(pth, nbf=SIZE, neurons=NEURONS, chunk=4, device="cpu").predict(X)
    live = pred.predict(X)
    assert pred.model.compute_dtype == torch.bfloat16 and live.dtype == np.float32
    assert not np.array_equal(live, fp32)
    np.testing.assert_allclose(live, fp32, rtol=0, atol=SERVE_ATOL)
    path = export_predictor(pred.model, str(tmp_path / "art"), chunk=4, platforms=("cpu",))
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    program = torch.export.load(os.path.join(path, "forward.cpu.pt2"))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("plastic_unet_tpu_torch.plastic_head_forward.default") == 1
    assert "plastic_unet_tpu_torch.residual_tail_forward.default" not in targets  # the bf16 trunk has no tail op
    np.testing.assert_array_equal(load_predictor(path, device="cpu").predict(X), live)


def test_cli_export_model_bf16(tmp_path):
    pth = str(tmp_path / "m.pth")
    torch.save(_seeded().state_dict(), pth)
    out = texport.main(["--model", pth, "--out", str(tmp_path / "art"), "--nbf", str(SIZE), "--neurons", "2",
                        "--chunk", "4", "--compute-dtype", "bfloat16", "--platforms", "cpu"])
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f)["compute_dtype"] == "bfloat16"
    model = UNetPRes(neurons=NEURONS, nbf=SIZE, compute_dtype="bfloat16")
    model.load_state_dict(torch.load(pth, weights_only=True), strict=True)
    X = np.random.default_rng(5).standard_normal((3, SIZE, SIZE, 1)).astype(np.float32)
    np.testing.assert_array_equal(load_predictor(out, device="cpu").predict(X),
                                  predict_masks(model, X, chunk=4, device="cpu").numpy())


def test_dp_bf16_matches_single_device_lanes(tmp_path):
    """2 Gloo ranks x 1 lane in bf16 against one process with 2 lanes in
    bf16: the same losses within 3e-2 relative, and the parameters no
    farther apart than the single process's bf16 run is from its fp32 run
    (the ranks' bf16 gradients are summed in fp32 after the casts, one
    process sums both lanes inside each bf16 conv)."""
    x, y = _stream(8, seed=21)
    params0 = UNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=NBF,
                       generator=torch.Generator().manual_seed(4)).state_dict()
    inputs = {"params0": params0, "X": torch.from_numpy(x), "Y": torch.from_numpy(y)}
    procs = spawn("dp_bf16", 2, str(tmp_path / "w2"), inputs)
    singles = {}
    try:
        for dtype in ("bfloat16", None):
            model = UNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=NBF, compute_dtype=dtype)
            model.load_state_dict(params0, strict=True)
            state = create_train_state(model, LR, GAMMA, STEPLR, lanes=2, device="cpu")
            with matmul_precision("parity"):
                singles[dtype] = make_epoch_fn()(state, *reshape_stream(inputs["X"], inputs["Y"], 2))
    finally:
        ranks = [r["dp_bf16"] for r in join(procs, str(tmp_path / "w2"))]
    (state, losses), (state32, _) = singles["bfloat16"], singles[None]
    for r in ranks:
        np.testing.assert_allclose(r["losses"].numpy(), losses.numpy(), rtol=3e-2)
        assert r["replicated"] and r["step"] == 4
    want, want32 = state.model.state_dict(), state32.model.state_dict()
    dp = max(float((ranks[0]["params"][k] - want[k]).abs().max()) for k in want)
    ref = max(float((want[k] - want32[k]).abs().max()) for k in want)
    assert dp <= ref, (dp, ref)


def _recording_model(seen):
    """A bf16 model whose forward records the precision flags it runs under."""
    model = _seeded(compute_dtype="bfloat16")
    flags = (lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.deterministic, current_policy()))
    model.register_forward_pre_hook(lambda mod, args: seen.append(flags()))
    return model


@pytest.mark.parametrize("policy", [None, "parity", "perf"])
def test_policy_reaches_the_step_and_the_chunk(policy):
    """Inside the training step and the serving chunk the TF32 flags follow
    the matmul_precision block around them ("parity" with none), cuDNN is
    deterministic, and both are restored after."""
    seen = []
    model = _recording_model(seen)
    state = create_train_state(model, LR, GAMMA, STEPLR, device="cpu")
    x, y = _stream(1, seed=2)
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.deterministic)

    def run():
        make_train_step()(state, (torch.from_numpy(x), torch.from_numpy(y)))
        predict_masks(model, x, chunk=2, device="cpu")

    if policy is None:
        run()
    else:
        with matmul_precision(policy):
            run()
    allow = policy == "perf"
    assert seen == [(allow, allow, True, policy or "parity")] * 2
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic) == before


@pytest.mark.parametrize("precision", ["perf", "parity"])
def test_driver_precision_reaches_the_step(precision, tmp_path, monkeypatch):
    """TrainConfig.matmul_precision (cli.train's --precision) is the policy
    of the driver's steps and validations."""
    seen = []
    real = driver.build_model
    monkeypatch.setattr(driver, "build_model", lambda cfg: (lambda m: (m.register_forward_pre_hook(
        lambda mod, args: seen.append((torch.backends.cudnn.allow_tf32, current_policy()))), m)[1])(real(cfg)))
    driver.start_train(*synthetic_split(2, 1, size=SIZE, seed=1),
                       _cfg(tmp_path, epochs=1, matmul_precision=precision, dropout_ratio=0.0), device="cpu")
    assert len(seen) == 3 and set(seen) == {(precision == "perf", precision)}
