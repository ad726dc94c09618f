"""Data parallel on the CPU: the port's DP step (parallel.dp) in Gloo groups
of 4 ranks x 1 lane and 2 ranks x 2 lanes, one process per rank
(test_torch_dp_worker.py, which imports only the port), against the JAX
package's make_dp_epoch_fn on 4 and 2 of conftest's 8 virtual CPU devices
and against the port's own single-process lanes; the 2x2 ("dcn", "data")
mesh; parameters replicated bit for bit; pmean traces; augmentation; K-epoch
dispatch; the shard-local shuffle; the ranks' generators.

Weights: a seeded port model carried into flax by the JAX package's
state_dict_to_flax_params, and the JAX params back by the port's
state_dict_from_jax_params (a JAX init compiles its random draws for ~25 s
here). Dropout 0 where trajectories are compared; 4 steps. Each spawn runs
once (module fixture) and several tests read it; the spawns run while the
JAX references compile.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.parallel import make_dp_epoch_fn as jax_make_dp_epoch_fn
from plastic_unet_tpu.parallel import make_mesh as jax_make_mesh
from plastic_unet_tpu.parallel import shard_stream as jax_shard_stream
from plastic_unet_tpu.train.loop import TrainState as JaxTrainState
from plastic_unet_tpu.train.optimizer import adam_step_lr as jax_adam_step_lr
from plastic_unet_tpu.utils import matmul_precision
from plastic_unet_tpu.utils import torch_interop as jti
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops.augment import draw_augment_choices
from plastic_unet_tpu_torch.parallel import make_mesh
from plastic_unet_tpu_torch.train.loop import create_train_state, make_epoch_fn, make_multi_epoch_fn, reshape_stream
from plastic_unet_tpu_torch.utils.torch_interop import state_dict_from_jax_params, trace_from_jax
from test_torch_dp_worker import GAMMA, LR, NBF, STEPLR, join, spawn

SAMPLES = 16  # 4 steps at 4 lanes in all
AUGMENT_SEED = 5
# (scenario of the worker, ranks, lanes a rank, trace mode)
DP_CASES = {"4x1-per_device": ("dp_per_device_1", 4, 1, "per_device"), "4x1-pmean": ("dp_pmean_1", 4, 1, "pmean"),
            "2x2-per_device": ("dp_per_device_2", 2, 2, "per_device"), "2x2-pmean": ("dp_pmean_2", 2, 2, "pmean")}
WORLD4 = "dp_per_device_1,dp_pmean_1,multislice,shuffle,generators"
WORLD2 = "dp_per_device_2,dp_pmean_2,augment,k_epochs"


def _inputs():
    rng = np.random.default_rng(31)
    X = (rng.standard_normal((SAMPLES, NBF, NBF, 1)) * 0.5).astype(np.float32)
    Y = (rng.random((SAMPLES, NBF, NBF)) > 0.5).astype(np.float32)
    sx = rng.standard_normal((32, 4, 4, 1)).astype(np.float32)
    sy = (rng.random((32, 4, 4)) > 0.5).astype(np.float32)
    seeded = UNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=NBF,
                      generator=torch.Generator().manual_seed(3))
    params = jti.state_dict_to_flax_params({k: v.numpy() for k, v in seeded.state_dict().items()},
                                           jti.unetp_res_name_map())
    return params, {"params0": state_dict_from_jax_params(params), "X": torch.from_numpy(X),
                    "Y": torch.from_numpy(Y), "shuffle_X": torch.from_numpy(sx), "shuffle_Y": torch.from_numpy(sy),
                    "augment_seed": AUGMENT_SEED}


def _jax_dp(params, X, Y, devices, lanes, trace_mode):
    model = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=NBF)
    tx = jax_adam_step_lr(LR, GAMMA, STEPLR)
    state = JaxTrainState(params, tx.init(params), jnp.zeros((devices * lanes, NBF, NBF), jnp.float32),
                          jnp.zeros((), jnp.int32))
    mesh = jax_make_mesh(devices)
    Xs, Ys = jax_shard_stream(jnp.asarray(X), jnp.asarray(Y), mesh, lanes_per_device=lanes)
    final, losses = jax_make_dp_epoch_fn(model, tx, mesh, trace_mode=trace_mode)(state, Xs, Ys,
                                                                                 jax.random.PRNGKey(1))
    return {"losses": np.asarray(losses), "params": state_dict_from_jax_params(final.params),
            "hebb": trace_from_jax(final.hebb), "shard": np.asarray(Xs), "step": int(final.step)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, inputs = _inputs()
    root = tmp_path_factory.mktemp("dp")
    procs4 = spawn(WORLD4, 4, str(root / "w4"), inputs)
    procs2 = spawn(WORLD2, 2, str(root / "w2"), inputs)
    try:
        with matmul_precision("parity"):
            jax_refs = {case: _jax_dp(params, inputs["X"].numpy(), inputs["Y"].numpy(), d, l, mode)
                        for case, (_, d, l, mode) in DP_CASES.items()}
    finally:
        ranks4, ranks2 = join(procs4, str(root / "w4")), join(procs2, str(root / "w2"))
    return {"inputs": inputs, "jax": jax_refs, 4: ranks4, 2: ranks2}


def _port_lanes(inputs, lanes, *, choices=None):
    """The port's single-process run at ``lanes`` lanes on the same stream."""
    model = UNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=NBF)
    model.load_state_dict(inputs["params0"], strict=True)
    state = create_train_state(model, LR, GAMMA, STEPLR, lanes=lanes, device="cpu")
    Xl, Yl = reshape_stream(inputs["X"], inputs["Y"], lanes)
    if choices is None:
        return make_epoch_fn()(state, Xl, Yl)
    state, losses = make_multi_epoch_fn(augment=True)(state, Xl, Yl, None, choices, epochs=1)
    return state, losses[0]


def _ranks(runs, scenario, world):
    return [r[scenario] for r in runs[world]]


def _compare(ranks, losses, params, hebb, *, atol_losses, atol_params, atol_trace):
    for r in ranks:  # the losses are the global mean on every rank
        np.testing.assert_allclose(r["losses"].numpy(), np.asarray(losses), rtol=0, atol=atol_losses)
    for k, v in params.items():
        np.testing.assert_allclose(ranks[0]["params"][k].numpy(), v.numpy(), rtol=0, atol=atol_params, err_msg=k)
    assert float(ranks[0]["params"]["eta"]) == float(np.float32(0.01))
    trace = torch.cat([r["hebb"] for r in ranks])  # the lanes in rank order: the JAX layout's
    assert tuple(trace.shape) == tuple(hebb.shape) and float(trace.abs().max()) > 0
    np.testing.assert_allclose(trace.numpy(), hebb.numpy(), rtol=0, atol=atol_trace)


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_matches_jax_dp_epoch(runs, case):
    """Losses 5e-5, parameters 5e-4, trace 1e-4 (the ROADMAP's tolerances)."""
    scenario, world, _, _ = DP_CASES[case]
    ref = runs["jax"][case]
    ranks = _ranks(runs, scenario, world)
    assert all(r["step"] == ref["step"] == SAMPLES // 4 for r in ranks)
    _compare(ranks, ref["losses"], ref["params"], ref["hebb"], atol_losses=5e-5, atol_params=5e-4, atol_trace=1e-4)


@pytest.mark.parametrize("case", list(DP_CASES))
def test_shard_stream_is_the_jax_columns(runs, case):
    scenario, world, lanes, _ = DP_CASES[case]
    ref = runs["jax"][case]["shard"]
    for rank, r in enumerate(_ranks(runs, scenario, world)):
        np.testing.assert_array_equal(r["shard"].numpy(), ref[:, rank * lanes:(rank + 1) * lanes])


@pytest.mark.parametrize("scenario,world", [("dp_per_device_1", 4), ("dp_per_device_2", 2), ("multislice", 4)],
                         ids=["4x1", "2x2", "dcn2xdata2"])
def test_dp_matches_port_lanes(runs, scenario, world):
    """D ranks x L lanes, per_device, == one process with D*L lanes: atol
    1e-5, JAX's own (test_parallel.py::test_dp_matches_single_device_lanes)."""
    state, losses = _port_lanes(runs["inputs"], 4)
    _compare(_ranks(runs, scenario, world), losses.numpy(), state.model.state_dict(), state.hebb,
             atol_losses=1e-5, atol_params=1e-5, atol_trace=1e-5)


@pytest.mark.parametrize("scenario,world", [("dp_per_device_1", 4), ("dp_pmean_1", 4), ("multislice", 4),
                                            ("dp_per_device_2", 2), ("dp_pmean_2", 2)])
def test_params_stay_replicated(runs, scenario, world):
    """After the epoch every rank holds rank 0's parameters bit for bit
    (an all-gather on the ranks, and their state_dicts here)."""
    ranks = _ranks(runs, scenario, world)
    assert all(r["replicated"] for r in ranks)
    for r in ranks[1:]:
        assert all(torch.equal(r["params"][k], v) for k, v in ranks[0]["params"].items())


@pytest.mark.parametrize("scenario,world", [("dp_pmean_1", 4), ("dp_pmean_2", 2)])
def test_pmean_traces_equal_across_lanes(runs, scenario, world):
    trace = torch.cat([r["hebb"] for r in _ranks(runs, scenario, world)])
    assert float(trace.abs().max()) > 0
    assert all(torch.equal(trace[0], lane) for lane in trace)


def test_dp_augment_matches_port_lanes(runs):
    """2 ranks x 2 lanes with augmentation == one process with 4 lanes and
    the same generator's choices for the whole stream: atol 1e-5."""
    choices = draw_augment_choices(SAMPLES, torch.Generator().manual_seed(AUGMENT_SEED))[None]
    state, losses = _port_lanes(runs["inputs"], 4, choices=choices)
    _compare(_ranks(runs, "augment", 2), losses.numpy(), state.model.state_dict(), state.hebb,
             atol_losses=1e-5, atol_params=1e-5, atol_trace=1e-5)


def test_k_epoch_dispatch_bit_identical(runs):
    """2 epochs in one DP dispatch == 2 one-epoch dispatches, with shuffle,
    augmentation and dropout 0.5, on every rank, bit for bit."""
    for one, two in _ranks(runs, "k_epochs", 2):
        assert torch.equal(one["losses"], two["losses"]) and tuple(one["losses"].shape) == (2, SAMPLES // 4)
        assert all(torch.equal(one["params"][k], two["params"][k]) for k in one["params"])
        assert torch.equal(one["hebb"], two["hebb"]) and torch.equal(one["generator"], two["generator"])
        assert one["step"] == two["step"] == 2 * SAMPLES // 4
    a, b = _ranks(runs, "k_epochs", 2)
    assert not torch.equal(a[0]["hebb"], b[0]["hebb"])  # per_device: each rank its own lanes


def test_shard_local_shuffle(runs):
    """Each rank permutes its own (S, L) block from its own generator: the
    same multiset of samples before and after, (img, mask) pairs kept, at
    least one rank permuted, and no collective called (the ranks ran it with
    every collective made to raise)."""
    changed = False
    pairs_before, pairs_after = set(), set()
    for r in _ranks(runs, "shuffle", 4):
        a, b = r["X"].reshape(-1, 16).numpy(), r["Xp"].reshape(-1, 16).numpy()
        np.testing.assert_array_equal(a[np.lexsort(a.T)], b[np.lexsort(b.T)])
        changed = changed or not np.array_equal(a, b)
        for X, Y, pairs in ((r["X"], r["Y"], pairs_before), (r["Xp"], r["Yp"], pairs_after)):
            pairs.update((float(x.sum()), float(y.sum())) for x, y in zip(X.reshape(-1, 16), Y.reshape(-1, 16)))
    assert changed and pairs_before == pairs_after


def test_rank_generators_differ_and_repeat(runs):
    """The driver's generators: dropout and shuffle differ from rank to rank,
    augmentation is alike on every rank, each is the same when made again,
    and rank 0 draws as the single-device run (seed +0, +1, +2)."""
    draws = [r["generators"] for r in runs[4]]
    for first, again in draws:
        assert all(torch.equal(first[k], again[k]) for k in first)
    for name in ("dropout", "shuffle"):
        seen = [d[0][name] for d in draws]
        assert all(not torch.equal(seen[i], seen[j]) for i in range(4) for j in range(i))
    assert all(torch.equal(d[0]["augment"], draws[0][0]["augment"]) for d in draws)
    for i, name in enumerate(("dropout", "shuffle", "augment")):
        assert torch.equal(draws[0][0][name], torch.rand(8, generator=torch.Generator().manual_seed(7 + i)))


def test_make_mesh_needs_a_process_group():
    """Here (no process group): the mesh and the driver's DP route raise,
    naming torchrun."""
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="torchrun"):
        make_mesh(device="cpu")
