"""The frozen plain references against the port's CPU path at a small size:
the same weights (made by the benchmark, in the published layout) give the
same masks, and the same training steps give the same losses, first
gradients and parameter changes."""

import pytest
import torch

from conftest import small_cell
from portbench import check, train
from portbench.tiles import make_generator, synthetic_tiles
from portbench.weights import build_port_model, build_reference, make_state_dict

SEED = 2 ** 31 + 55


@pytest.mark.parametrize("name", ["unetpres-n16.serve-r512", "unetp-128.serve-r512"])
def test_forward_matches_port(name):
    cell = small_cell(name)
    sd = make_state_dict(cell.config, SEED, "cpu")
    port = build_port_model(cell.config, sd, "cpu").eval()
    ref = build_reference(cell.config, sd, "cpu").eval()
    s, nbf = cell.config["image_size"], cell.config["model"]["nbf"]
    x, _ = synthetic_tiles(6, s, make_generator(SEED, 0, "cpu"), "cpu")
    hebb = 0.01 * torch.rand(6, nbf, nbf, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        p = port(x[..., None], hebb)
        r = ref(x[:, None], hebb)
    for a, b in zip((p.activ, p.activout, p.hebb), r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_dropout_draws_match_port():
    cell = small_cell("unetpres-n16.train-b1")
    sd = make_state_dict(cell.config, SEED, "cpu")
    port = build_port_model(cell.config, sd, "cpu").train()
    ref = build_reference(cell.config, sd, "cpu").train()
    s, nbf = cell.config["image_size"], cell.config["model"]["nbf"]
    x, _ = synthetic_tiles(3, s, make_generator(SEED, 0, "cpu"), "cpu")
    hebb = torch.zeros(3, nbf, nbf)
    p = port(x[..., None], hebb, generator=make_generator(SEED, 2, "cpu"))
    r = ref(x[:, None], hebb, generator=make_generator(SEED, 2, "cpu"))
    torch.testing.assert_close(p.activ, r[0], rtol=1e-5, atol=1e-6)
    q = ref(x[:, None], hebb, generator=make_generator(SEED + 1, 2, "cpu"))
    assert not torch.allclose(q[0], r[0])  # the masks come from the generator


@pytest.mark.parametrize("name", ["unetpres-n16.train-b1", "unetpres-n16.train-l128"])
def test_training_steps_match_port(name):
    cell = small_cell(name)
    prog, sd, x, y, readings = train.setup(cell, SEED, torch.device("cpu"))
    ref = train.reference_steps(cell, sd, x, y, SEED, cell.workload["check_calls"], torch.device("cpu"))
    numbers = check.train_numbers(readings, ref)
    assert len(readings["losses"]) == sum(cell.workload["check_calls"]) == 3
    assert max(numbers.values()) < 1e-4, numbers
    ok, _ = check.verdict(numbers, cell.workload["limits"])
    assert ok
    assert "eta" not in readings["grad1"] and readings["change"]["eta"] == 0.0  # the loss sends eta no gradient
    assert readings["grad1"]["alpha"] == 0.0  # a zero trace gives alpha no gradient at the first step
    assert "alpha" in check.moved_leaves(ref["grad_steps"])  # the third step's carried trace does


def test_leaf_gap_measures_by_the_worst_leaf():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-9}
    assert check.leaf_gap(dict(ref), ref) == 0.0
    assert check.leaf_gap({"a": 1.0, "b": 2.2, "c": 1e-9}, ref) == pytest.approx(0.1)
    assert check.leaf_gap({"a": 1.0, "b": 2.0, "c": 0.0}, ref) == pytest.approx(1e-9)  # over the median leaf
    assert check.leaf_gap({"a": 0.0, "b": 0.0, "c": 0.0}, ref) == 1.0  # a state left unchanged reads 1
    assert check.moved_leaves([{"a": 1.0, "b": 2.0, "c": 1e-9}]) == {"a", "b"}
