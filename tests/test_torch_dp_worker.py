"""Rank processes of the port's data-parallel tests (test_torch_parallel.py,
test_torch_dp_driver.py); it holds no test.

One process per rank on the CPU, a Gloo group over a ``file://`` store in
the test's directory (no TCP port for parallel test workers to race for),
``init_process_group(timeout=60 s)``, one thread each, and only the port
imported (no JAX). Each rank runs the named scenarios in order and writes
what it saw to ``<dir>/rank<r>.pt``; :func:`spawn` starts the ranks,
:func:`join` waits for them within a time limit and kills them after it.

    python tests/test_torch_dp_worker.py SCENARIOS RANK WORLD DIR
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from datetime import timedelta
from unittest import mock

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_TIMEOUT = 150.0  # seconds for a whole spawn; its ranks are killed after it
LR, GAMMA, STEPLR = 1e-3, 0.5, 3
NBF = 16


def spawn(scenarios: str, world: int, workdir: str, inputs: dict) -> list:
    """Start ``world`` rank processes running ``scenarios`` (comma list) on
    ``inputs`` (saved to ``workdir``); returns the processes."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(inputs, os.path.join(workdir, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(workdir, f"rank{r}.log"), "w")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), scenarios, str(r), str(world),
                                       workdir], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def join(procs: list, workdir: str, timeout: float = JOIN_TIMEOUT) -> list:
    """Wait for every rank within ``timeout`` seconds in all (then kill them
    and fail); raise with the logs of a rank that failed; the ranks' results."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError(f"the ranks in {workdir} did not finish within {timeout} s: {_logs(workdir, procs)}")
    if any(p.returncode for p in procs):
        raise AssertionError(f"a rank failed: {_logs(workdir, procs)}")
    return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False) for r in range(len(procs))]


def _logs(workdir, procs) -> str:
    out = []
    for r, p in enumerate(procs):
        with open(os.path.join(workdir, f"rank{r}.log")) as f:
            out.append(f"--- rank {r} (exit {p.returncode}) ---\n{f.read()[-3000:]}")
    return "\n".join(out)


# --------------------------------------------------------------------------- the rank's side

def _model(inputs, dropout=0.0, compute_dtype=None):
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes

    model = UNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=dropout, nbf=NBF, compute_dtype=compute_dtype)
    model.load_state_dict(inputs["params0"], strict=True)
    return model


def _state(inputs, lanes, dropout=0.0, generator=None, compute_dtype=None):
    from plastic_unet_tpu_torch.train.loop import create_train_state

    return create_train_state(_model(inputs, dropout, compute_dtype), LR, GAMMA, STEPLR, lanes=lanes,
                              generator=generator, device="cpu")


def _snapshot(state, losses) -> dict:
    return {"losses": losses.clone(), "params": {k: v.clone() for k, v in state.model.state_dict().items()},
            "hebb": state.hebb.clone(), "step": state.step}


def _replicated(state) -> bool:
    """Every rank's parameters equal rank 0's bit for bit (an all-gather)."""
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in state.model.parameters()])
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return all(torch.equal(parts[0], q) for q in parts)


def _dp_epoch(inputs, mesh, lanes, trace_mode, compute_dtype=None) -> dict:
    from plastic_unet_tpu_torch.parallel import make_dp_epoch_fn, shard_stream

    state = _state(inputs, lanes, compute_dtype=compute_dtype)
    X, Y = shard_stream(inputs["X"], inputs["Y"], mesh, lanes_per_device=lanes)
    state, losses = make_dp_epoch_fn(mesh, trace_mode=trace_mode)(state, X, Y)
    return dict(_snapshot(state, losses), replicated=_replicated(state), shard=X.clone())


def _scenario_dp(inputs, mode, lanes, compute_dtype=None):
    from plastic_unet_tpu_torch.parallel import make_mesh

    return _dp_epoch(inputs, make_mesh(device="cpu"), lanes, mode, compute_dtype)


def _scenario_multislice(inputs):
    from plastic_unet_tpu_torch.parallel import make_multislice_mesh

    return _dp_epoch(inputs, make_multislice_mesh(2, 2, device="cpu"), 1, "per_device")


def _scenario_shuffle(inputs):
    """The shard-local shuffle with every collective made to raise."""
    import torch.distributed as dist

    from plastic_unet_tpu_torch.parallel import make_mesh, shard_stream
    from plastic_unet_tpu_torch.parallel.dp import shard_perms

    mesh = make_mesh(device="cpu")
    X, Y = shard_stream(inputs["shuffle_X"], inputs["shuffle_Y"], mesh, lanes_per_device=2)
    names = ("all_reduce", "all_gather", "all_gather_object", "broadcast", "barrier", "reduce", "gather", "scatter",
             "all_to_all", "send", "recv", "reduce_scatter")

    def refuse(*args, **kwargs):
        raise AssertionError("the shard-local shuffle called a collective")

    with mock.patch.multiple(dist, **{n: refuse for n in names if hasattr(dist, n)}):
        gen = torch.Generator().manual_seed(100 + dist.get_rank())
        perm = shard_perms(X, gen, 1)[0]
        n = X.shape[0] * X.shape[1]
        Xp = X.reshape(n, *X.shape[2:])[perm].reshape(X.shape)
        Yp = Y.reshape(n, *Y.shape[2:])[perm].reshape(Y.shape)
    return {"X": X, "Y": Y, "Xp": Xp, "Yp": Yp}


def _scenario_generators(inputs):
    """Draws of the driver's generators, made twice from the same config."""
    import torch.distributed as dist

    from plastic_unet_tpu_torch.config import TrainConfig
    from plastic_unet_tpu_torch.train.driver import make_generators

    draws = []
    for _ in range(2):
        dropout, gens = make_generators(TrainConfig(seed=7), torch.device("cpu"), dist.get_rank())
        draws.append({name: torch.rand(8, generator=g) for name, g in dict(gens, dropout=dropout).items()})
    return draws


def _scenario_augment(inputs):
    """A one-epoch DP dispatch with augmentation: choices drawn for the global
    stream, this rank's rows taken."""
    import torch.distributed as dist

    from plastic_unet_tpu_torch.ops.augment import draw_augment_choices
    from plastic_unet_tpu_torch.parallel import make_dp_multi_epoch_fn, make_mesh, shard_stream
    from plastic_unet_tpu_torch.parallel.dp import shard_choices

    mesh = make_mesh(device="cpu")
    lanes = 2
    X, Y = shard_stream(inputs["X"], inputs["Y"], mesh, lanes_per_device=lanes)
    n_global = X.shape[0] * X.shape[1] * dist.get_world_size()
    choices = draw_augment_choices(n_global, torch.Generator().manual_seed(inputs["augment_seed"]))[None]
    state, losses = make_dp_multi_epoch_fn(mesh, augment=True)(_state(inputs, lanes), X, Y, None,
                                                               shard_choices(choices, lanes, mesh), epochs=1)
    return _snapshot(state, losses[0])


def _scenario_k_epochs(inputs):
    """Two epochs in one dispatch against two one-epoch dispatches, with
    shuffle, augmentation and dropout 0.5, from the driver's generators."""
    import torch.distributed as dist

    from plastic_unet_tpu_torch.config import TrainConfig
    from plastic_unet_tpu_torch.ops.augment import draw_augment_choices
    from plastic_unet_tpu_torch.parallel import make_dp_multi_epoch_fn, make_mesh, shard_stream
    from plastic_unet_tpu_torch.parallel.dp import shard_choices, shard_perms
    from plastic_unet_tpu_torch.train.driver import make_generators

    mesh = make_mesh(device="cpu")
    lanes = 2
    X, Y = shard_stream(inputs["X"], inputs["Y"], mesh, lanes_per_device=lanes)
    n_global = X.shape[0] * X.shape[1] * dist.get_world_size()
    runs = []
    for per_dispatch in (2, 1):
        dropout, gens = make_generators(TrainConfig(seed=11), torch.device("cpu"), dist.get_rank())
        state = _state(inputs, lanes, dropout=0.5, generator=dropout)
        run = make_dp_multi_epoch_fn(mesh, shuffle=True, augment=True)
        rows = []
        for _ in range(2 // per_dispatch):
            perms = shard_perms(X, gens["shuffle"], per_dispatch)
            choices = torch.stack([draw_augment_choices(n_global, gens["augment"]) for _ in range(per_dispatch)])
            state, losses = run(state, X, Y, perms, shard_choices(choices, lanes, mesh), epochs=per_dispatch)
            rows.append(losses)
        runs.append(dict(_snapshot(state, torch.cat(rows)), generator=dropout.get_state()))
    return runs


def _scenario_driver(inputs):
    """start_train with devices=2: a fresh run of 4 epochs, one of 2 and its
    resume for 2 more; the files each rank wrote."""
    from plastic_unet_tpu_torch.config import TrainConfig
    from plastic_unet_tpu_torch.parallel.multihost import process_local_slice
    from plastic_unet_tpu_torch.train import driver

    out = {"slices": {n: process_local_slice(n) for n in (16, 13, 7)}}
    x_train, x_valid, y_train, y_valid = inputs["split"]
    for name, epochs, resume in (("straight", 4, None), ("first", 2, None), ("resumed", 2, "first")):
        out_dir = os.path.join(inputs["dir"], name)
        cfg = TrainConfig(out_dir=out_dir, epochs=epochs, val_every=1, save_every=2, im_width=NBF, im_height=NBF,
                          neurons=2, devices=2, lanes=inputs["lanes"], shuffle=True, augment=True, dropout_ratio=0.5,
                          matmul_precision="parity",
                          resume_orbax="" if resume is None else os.path.join(inputs["dir"], resume, "train_state.pt"))
        written = []
        real_save = torch.save

        def save(obj, path, *a, **k):
            if isinstance(path, (str, os.PathLike)):  # not the buffers the collectives pickle into
                written.append(os.path.basename(path))
            return real_save(obj, path, *a, **k)

        with mock.patch.object(torch, "save", save):
            res = driver.start_train(x_train, x_valid, y_train, y_valid, cfg, device="cpu")
        out[name] = {"losses": list(res.all_losses), "val": (res.val_train_losses, res.val_test_losses,
                                                             res.val_accuracies),
                     "params": {k: v.clone() for k, v in res.model.state_dict().items()}, "hebb": res.state.hebb,
                     "step": res.state.step, "generator": res.state.generator.get_state(), "written": written}
    return out


def _scenario_predict(inputs):
    """Sharded predict_masks and predict_masks_tta; chunk % world raising."""
    from plastic_unet_tpu_torch.eval.evaluate import predict_masks
    from plastic_unet_tpu_torch.parallel import make_mesh
    from plastic_unet_tpu_torch.submit.inference import predict_masks_tta

    mesh = make_mesh(device="cpu")
    model = _model(inputs)
    X = inputs["images"]
    out = {"masks": predict_masks(model, X, chunk=8, device="cpu", mesh=mesh),
           "tta": predict_masks_tta(model, X, transforms=("identity", "hflip"), chunk=8, device="cpu", mesh=mesh)}
    try:
        predict_masks(model, X, chunk=3, device="cpu", mesh=mesh)
    except ValueError as e:
        out["odd_chunk"] = str(e)
    return out


def _scenario_artifact(inputs):
    """A data_devices=2 artifact served by the two ranks."""
    from plastic_unet_tpu_torch.submit.export import load_predictor

    return {"masks": load_predictor(inputs["artifact"], device="cpu").predict(inputs["images"].numpy())}


SCENARIOS = {
    "dp_per_device_1": lambda i: _scenario_dp(i, "per_device", 1),
    "dp_pmean_1": lambda i: _scenario_dp(i, "pmean", 1),
    "dp_per_device_2": lambda i: _scenario_dp(i, "per_device", 2),
    "dp_pmean_2": lambda i: _scenario_dp(i, "pmean", 2),
    "dp_bf16": lambda i: _scenario_dp(i, "per_device", 1, "bfloat16"),
    "multislice": _scenario_multislice,
    "shuffle": _scenario_shuffle,
    "generators": _scenario_generators,
    "augment": _scenario_augment,
    "k_epochs": _scenario_k_epochs,
    "driver": _scenario_driver,
    "predict": _scenario_predict,
    "artifact": _scenario_artifact,
}


def main(argv) -> None:
    import torch.distributed as dist

    from plastic_unet_tpu_torch.parallel import init_distributed
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    scenarios, rank, world, workdir = argv[0].split(","), int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    init_distributed("cpu", init_method="file://" + os.path.join(workdir, "store"), rank=rank, world_size=world,
                     timeout=GROUP_TIMEOUT)
    try:
        with matmul_precision("parity"):
            results = {name: SCENARIOS[name](inputs) for name in scenarios}
    finally:
        dist.destroy_process_group()
    torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1:])
