"""On the card, at each cell's own size: the program comes out correct, and
its control, the program with its TF32 path on where the configuration
states float32 with TF32 off, comes out not correct on three seeds. Run on
a card with ``python -m pytest benchmark/tests -q -m card``."""

import copy

import pytest

from calibrate import read_serve, read_train
from conftest import CELLS
from portbench import check, spec

SEEDS = (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103)


def verdict(cell, device, seed) -> tuple:
    if cell.kind == "train":
        numbers = read_train(cell, seed, device, False)["program"]
    else:
        numbers = read_serve(cell, seed, device, 2.0, False)["program"]
    return check.verdict(numbers, cell.workload["limits"])


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_and_control_is_not(card, name):
    cell = spec.load_cell(name)
    ok, table = verdict(cell, card, SEEDS[0])
    assert ok, table
    control = copy.deepcopy(cell)
    control.config["precision"] = "perf"
    for seed in SEEDS:
        ok, table = verdict(control, card, seed)
        assert not ok, table
