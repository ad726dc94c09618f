"""The rest of a run, the look for a card skipped, at a size the CPU holds:
sound runs come out correct, and with the timed path broken underneath
(a step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced) ``correct`` comes out false."""

import time

import pytest
import torch

from calibrate import planted
from conftest import small_cell
from portbench import check, serve, train

SEED = 2 ** 31 + 4099
KINDS = {"train": train, "serve": serve}


def verdict(name, fault=None):
    cell = small_cell(name)
    with planted(cell.kind, fault):
        res = KINDS[cell.kind].run(cell, SEED, 0.3, False, torch.device("cpu"), time.perf_counter())
    ok, table = check.verdict(res["numbers"], cell.workload["limits"])
    return ok and res["failed"] == 0, table


@pytest.mark.parametrize("name", ["unetpres-n16.train-b1", "unetpres-n16.train-l128", "unetpres-n16.serve-r512",
                                  "unetp-128.serve-r512"])
def test_sound_run_is_correct(name):
    ok, table = verdict(name)
    assert ok, table


@pytest.mark.parametrize("name,fault", [
    ("unetpres-n16.train-b1", "unchanged"),
    ("unetpres-n16.train-b1", "altered_answer"),
    ("unetpres-n16.train-l128", "unchanged"),
    ("unetpres-n16.train-l128", "half_batch"),
    ("unetpres-n16.train-l128", "altered_answer"),
    ("unetpres-n16.serve-r512", "altered_answer"),
    ("unetpres-n16.serve-r512", "half_batch"),
    ("unetp-128.serve-r512", "altered_answer"),
    ("unetp-128.serve-r512", "half_batch"),
])
def test_broken_path_is_not_correct(name, fault):
    ok, table = verdict(name, fault)
    assert not ok, table


def test_unchanged_state_reads_one():
    ok, table = verdict("unetpres-n16.train-b1", "unchanged")
    assert table["grad_gap"]["value"] == pytest.approx(1.0)
    assert table["change_gap"]["value"] == pytest.approx(1.0)
