"""On the card: in the traced window of each cell, at the cell's own size,
the kernels whose names hold a family's symbols are as many as the
program's records say that family launched there (each launch's span
records how many kernels it runs), a replayed CUDA graph's launches
counted from its capture. Each cell runs in a process of its own, as
``run.py`` runs it. Run on a card with
``python -m pytest benchmark/tests -q -m card``."""

import json
import subprocess
import sys

import pytest

from conftest import BENCH, CELLS

SEED = 2 ** 31 + 211


def count_window(name: str, seed: int) -> dict:
    """{family: [window kernels, kernels the recorded launches run, launches]}
    of one traced run of the cell ``name`` in this process."""
    import importlib
    import time
    from types import SimpleNamespace

    import torch

    from portbench import spans, spec

    cell = spec.load_cell(name)
    kind = importlib.import_module(f"portbench.{cell.kind}")
    res = kind.run(cell, seed, 1.0, True, torch.device("cuda", 0), time.perf_counter())
    run = SimpleNamespace(trace=res["trace"])
    out = {}
    for family in spans.families():
        found = spans.launches(run, family)
        out[family] = [len(spans.family_kernels(run, family)), sum(a["kernels"] for a in found), len(found)]
    return out


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_window_kernels_match_the_recorded_launches(card, name):
    code = (f"import sys, json; sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, {str(BENCH.parent)!r}]\n"
            f"from test_portbench_spans_card import count_window\n"
            f"print(json.dumps(count_window({name!r}, {SEED})))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=BENCH.parent)
    assert res.returncode == 0, res.stderr[-4000:]
    seen = json.loads(res.stdout.strip().splitlines()[-1])
    print(name, seen)
    for family, (got, want, _) in seen.items():
        assert got == want, (family, seen[family])
    assert sum(v[2] for v in seen.values()) > 0, seen
    if name.split(".")[1].startswith("train"):
        assert seen["conv3x3"][2] and seen["wgrad"][2], seen  # read on the window's replayed steps
