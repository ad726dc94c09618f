"""The data-parallel entry points on the CPU: the staging math against the
JAX package's, start_train with devices=2 under 2 Gloo ranks (one process
each, test_torch_dp_worker.py), its resume, the torchrun launches of
cli.train and cli.infer, sharded predict_masks / predict_masks_tta, and a
data_devices=2 artifact served by 2 ranks; what raises without a process
group."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plastic_unet_tpu.parallel import make_mesh as jax_make_mesh
from plastic_unet_tpu.parallel import shard_stream as jax_shard_stream
from plastic_unet_tpu.parallel.multihost import local_lane_block as jax_local_lane_block
from plastic_unet_tpu_torch.cli import infer as tinfer
from plastic_unet_tpu_torch.config import TrainConfig
from plastic_unet_tpu_torch.data.synthetic import synthetic_split
from plastic_unet_tpu_torch.eval.evaluate import predict_masks
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.parallel.multihost import local_lane_block, process_local_slice
from plastic_unet_tpu_torch.submit.export import export_predictor, load_predictor
from plastic_unet_tpu_torch.submit.inference import predict_masks_tta
from plastic_unet_tpu_torch.train import driver
from test_torch_dataset import make_tgs_dir
from test_torch_dp_worker import NBF, REPO, join, spawn

LANES = 2  # a rank's lanes in the driver's runs
CHUNK = 8
STEPS = 16 // (2 * LANES)  # 16 training tiles over 2 ranks x 2 lanes
CLI_TIMEOUT = 120


def _model():
    return UNetPRes(n_channels=1, n_classes=1, neurons=2, dropout_ratio=0.0, nbf=NBF,
                    generator=torch.Generator().manual_seed(4))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_driver")
    model = _model()
    images = torch.from_numpy(np.random.default_rng(5).standard_normal((20, NBF, NBF, 1)).astype(np.float32))
    artifacts = {n: export_predictor(model, str(root / f"artifact{n}"), chunk=CHUNK, platforms=("cpu",),
                                     data_devices=n) for n in (1, 2)}
    inputs = {"params0": model.state_dict(), "images": images, "artifact": artifacts[2], "lanes": LANES,
              "split": synthetic_split(16, 4, size=NBF, seed=12), "dir": str(root)}
    tgs = make_tgs_dir(root / "tgs")
    pth = str(root / "infer_net.pth")
    torch.save(UNetPRes(n_channels=1, n_classes=1, neurons=2, nbf=101,
                        generator=torch.Generator().manual_seed(6)).state_dict(), pth)
    infer_args = ["-m", pth, "-i", tgs, "--neurons", "2", "--tta", "tta2", "--save", "--device", "cpu"]
    clis = {"train": ["plastic_unet_tpu_torch.cli.train", "--devices", "2", "--device", "cpu", "--synthetic", "16",
                      "-o", str(root / "cli"), "-e", "1", "--neurons", "2"],
            "infer": ["plastic_unet_tpu_torch.cli.infer", "--devices", "2", "-o", str(root / "infer2")] + infer_args}
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    launched = {name: subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                                        "--nproc-per-node", "2", "-m"] + argv, cwd=REPO, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for name, argv in clis.items()}
    procs = spawn("driver,predict,artifact", 2, str(root / "ranks"), inputs)
    cli = {}
    try:
        ranks = join(procs, str(root / "ranks"))
    finally:
        for name, p in launched.items():
            try:
                log, _ = p.communicate(timeout=CLI_TIMEOUT)
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
            cli[name] = (p.returncode, log)
    return {"ranks": ranks, "model": model, "images": images, "artifacts": artifacts, "cli": cli,
            "root": root, "infer_args": infer_args}


@pytest.mark.parametrize("n,pc,total_lanes", [(32, 2, 8), (32, 4, 4), (24, 2, 4), (13, 2, 4), (9, 2, 2)],
                         ids=["32-2x4", "32-4x1", "24-2x2", "ragged13", "ragged9"])
def test_local_lane_block_matches_jax(n, pc, total_lanes):
    """The port's layout math is JAX's, ragged n included; where n is a
    multiple of the lanes, the ranks' blocks stacked are shard_stream's."""
    rng = np.random.default_rng(n)
    X = rng.standard_normal((n, 4, 4, 1)).astype(np.float32)
    Y = (rng.random((n, 4, 4)) > 0.5).astype(np.float32)
    per = -(-n // pc)
    blocks = []
    for p in range(pc):
        sl = slice(p * per, min((p + 1) * per, n))
        got, want = local_lane_block(X[sl], Y[sl], pc, total_lanes), jax_local_lane_block(X[sl], Y[sl], pc, total_lanes)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        blocks.append(got)
    if n % total_lanes == 0:
        gx, gy = jax_shard_stream(jnp.asarray(X), jnp.asarray(Y), jax_make_mesh(total_lanes), lanes_per_device=1)
        np.testing.assert_array_equal(np.concatenate([b[0] for b in blocks], axis=1), np.asarray(gx))
        np.testing.assert_array_equal(np.concatenate([b[1] for b in blocks], axis=1), np.asarray(gy))


def test_process_local_slice():
    """Without a process group this process loads the whole stream; each
    rank of 2 loads its contiguous block (ceil(n / 2), as JAX splits by
    process)."""
    assert process_local_slice(100) == slice(0, 100)


def test_process_local_slice_on_ranks(runs):
    for rank, r in enumerate(runs["ranks"]):
        for n, sl in r["driver"]["slices"].items():
            per = -(-n // 2)
            assert sl == slice(rank * per, min((rank + 1) * per, n))


def test_start_train_devices_2(runs):
    """Losses finite and equal on both ranks, each rank's trace (lanes, 16,
    16) and its own, rank 0 alone writes the artifacts and the resume
    state."""
    a, b = (r["driver"]["straight"] for r in runs["ranks"])
    assert len(a["losses"]) == 4 * STEPS and np.all(np.isfinite(a["losses"])) and a["losses"] == b["losses"]
    assert a["val"] == b["val"] and len(a["val"][2]) == 4
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert tuple(a["hebb"].shape) == tuple(b["hebb"].shape) == (LANES, NBF, NBF)
    assert not torch.equal(a["hebb"], b["hebb"]) and not torch.equal(a["generator"], b["generator"])
    assert {"train_net.pth", "train_state.pt.tmp"} <= set(a["written"]) and b["written"] == []
    out = runs["root"] / "straight"
    assert {"train_net.pth", "train_parameters.dat", "train_state.pt"} <= set(os.listdir(out))
    saved = torch.load(os.path.join(out, "train_state.pt"), weights_only=True)
    assert saved["world_size"] == 2 and tuple(saved["hebb"].shape) == (2 * LANES, NBF, NBF)
    assert torch.equal(saved["hebb"], torch.cat([a["hebb"], b["hebb"]]))


def test_resume_bit_identical(runs):
    """2 epochs, then a resume for 2 more, == 4 epochs straight, on both
    ranks, bit for bit: losses, validation, parameters, each rank's trace and
    dropout generator (shuffle, augmentation and dropout 0.5 on)."""
    for r in runs["ranks"]:
        straight, first, resumed = (r["driver"][k] for k in ("straight", "first", "resumed"))
        assert first["losses"] + resumed["losses"] == straight["losses"]
        assert tuple(v[2:] for v in straight["val"]) == resumed["val"]
        assert all(torch.equal(straight["params"][k], resumed["params"][k]) for k in straight["params"])
        assert torch.equal(straight["hebb"], resumed["hebb"]) and torch.equal(straight["generator"],
                                                                              resumed["generator"])
        assert straight["step"] == resumed["step"] == 4 * STEPS


def test_devices_2_without_process_group_raises(tmp_path):
    x_train, x_valid, y_train, y_valid = synthetic_split(8, 2, size=NBF, seed=1)
    cfg = TrainConfig(out_dir=str(tmp_path), epochs=1, im_width=NBF, im_height=NBF, neurons=2, devices=2)
    with pytest.raises(ValueError, match="torchrun"):
        driver.start_train(x_train, x_valid, y_train, y_valid, cfg, device="cpu")


def test_torchrun_cli_train(runs):
    """torchrun --nproc-per-node 2 -m plastic_unet_tpu_torch.cli.train
    --devices 2 --device cpu: exit 0, rank 0's artifacts written."""
    rc, log = runs["cli"]["train"]
    assert rc == 0, log[-3000:]
    assert {"train_net.pth", "train_state.pt"} <= set(os.listdir(runs["root"] / "cli"))
    assert torch.load(runs["root"] / "cli" / "train_state.pt", weights_only=True)["world_size"] == 2


def test_torchrun_cli_infer(runs):
    """torchrun ... cli.infer --devices 2 --device cpu --tta tta2 --save:
    exit 0; the submission and the mask PNGs (rank 0's) equal one process's."""
    rc, log = runs["cli"]["infer"]
    assert rc == 0, log[-3000:]
    single = runs["root"] / "infer1"
    tinfer.main(["-o", str(single)] + runs["infer_args"])
    sharded = runs["root"] / "infer2"
    assert (sharded / "submission.csv").read_text() == (single / "submission.csv").read_text()
    pngs = sorted(os.listdir(single / "masks"))
    assert pngs and sorted(os.listdir(sharded / "masks")) == pngs
    assert all((sharded / "masks" / f).read_bytes() == (single / "masks" / f).read_bytes() for f in pngs)


def test_sharded_predict_matches_single(runs):
    """predict_masks and predict_masks_tta with a 2-rank mesh: every rank
    gets all masks, within 1e-6 of one process (JAX test_parallel.py:236-254);
    a chunk the ranks cannot share raises."""
    model, X = runs["model"], runs["images"]
    single = predict_masks(model, X, chunk=CHUNK, device="cpu")
    tta = predict_masks_tta(model, X, transforms=("identity", "hflip"), chunk=CHUNK, device="cpu")
    for r in runs["ranks"]:
        got = r["predict"]
        np.testing.assert_allclose(got["masks"].numpy(), single.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got["tta"].numpy(), tta.numpy(), rtol=0, atol=1e-6)
        assert "divisible" in got["odd_chunk"]


def test_sharded_artifact_matches_unsharded(runs):
    """A data_devices=2 artifact (the per-rank program of a chunk/2 batch)
    served by 2 ranks == the unsharded artifact within 1.5e-7 (JAX
    tests/test_export.py:189); loading it without 2 ranks raises."""
    import json

    with open(os.path.join(runs["artifacts"][2], "meta.json")) as f:
        meta = json.load(f)
    assert meta["data_devices"] == 2 and meta["chunk"] == CHUNK
    want = load_predictor(runs["artifacts"][1], device="cpu").predict(runs["images"].numpy())
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["artifact"]["masks"], want, rtol=0, atol=1.5e-7)
    with pytest.raises(ValueError, match="torchrun"):
        load_predictor(runs["artifacts"][2], device="cpu")
