"""The benchmark's own tests (``python -m pytest benchmark/tests -q`` from
the checkout's root). Tests marked ``card`` need a CUDA card and skip
without one; the check is made inside the ``card`` fixture."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

SMALL = {"unet_res": {"model": {"neurons": 2, "nbf": 21}, "image_size": 21},
         "unet": {"model": {"nbf": 32}, "image_size": 32}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def small_cell(name: str):
    """The cell ``name`` of BENCHMARK.json at a size the CPU holds: the
    same kind, limits and layout, narrow widths, few rows."""
    from portbench import spec

    cell = spec.load_cell(name)
    cfg, wl = copy.deepcopy(cell.config), copy.deepcopy(cell.workload)
    small = SMALL[cfg["arch"]]
    cfg["model"].update(small["model"])
    cfg["image_size"] = small["image_size"]
    if wl["kind"] == "train":
        lanes = min(wl["lanes"], 4)
        wl.update(lanes=lanes, stream_tiles=6 * lanes, trace_steps=3, attribution_steps=1)
    else:
        wl.update(request_tiles=16, chunk=8, pool_tiles=48, warm_requests=1, trace_requests=2, check_requests=2)
    cell.config, cell.workload = cfg, wl
    return cell


CELLS = ["unetpres-n16.train-b1", "unetpres-n16.serve-r512", "unetp-128.serve-r512", "unetpres-n16.train-l128"]
