"""The harness finds a new configuration, traffic mix and per-layer metric
by name, with no file that is there edited; and off the card the measuring
path refuses to run instead of falling back."""

import hashlib
import json
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import BENCH

ROOT = BENCH.parent


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_files_are_found_by_name(copy):
    from portbench import spec

    before = digests(copy / "benchmark")
    cfg = json.loads((copy / "benchmark/configs/unetpres-n16.json").read_text())
    cfg.update(name="unetpres-n8", model=dict(cfg["model"], neurons=8))
    (copy / "benchmark/configs/unetpres-n8.json").write_text(json.dumps(cfg))
    wl = json.loads((copy / "benchmark/workloads/unetpres-n16.serve-r512.json").read_text())
    wl.update(config="unetpres-n8", request_tiles=256)
    (copy / "benchmark/workloads/unetpres-n8.serve-r256.json").write_text(json.dumps(wl))
    (copy / "benchmark/metrics/serve.tiles_per_request.py").write_text(
        "def read(run):\n    return run.counters['tiles'] / run.counters['requests']\n")
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "unetpres-n8", "source": "https://example.org/n8",
                             "file": "benchmark/configs/unetpres-n8.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "unetpres-n8.serve-r256", "config": "unetpres-n8", "traffic": "serve-r256",
                               "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("serve_tiles_per_s", "serve_p95_ms"):
            m["workloads"].append("unetpres-n8.serve-r256")
    for m in bench["per_layer"]:
        if m["name"].startswith("serve.") and "unetpres-n16.serve-r512" in m["workloads"]:
            m["workloads"].append("unetpres-n8.serve-r256")
    bench["per_layer"].append({"name": "serve.tiles_per_request", "unit": "tiles", "better": "higher",
                               "source": "program_counter", "layer": "serving entry", "moves": "serve_tiles_per_s",
                               "workloads": ["unetpres-n8.serve-r256"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("unetpres-n8.serve-r256", copy / "BENCHMARK.json")
    assert cell.config["model"]["neurons"] == 8 and cell.workload["request_tiles"] == 256
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "serve_tiles_per_s", "serve_p95_ms"}
    readers = cell.readers()
    assert "serve.tiles_per_request" in readers and "serve.tails_roofline" in readers
    run = SimpleNamespace(counters={"tiles": 512, "requests": 2}, config=cell.config)
    assert readers["serve.tiles_per_request"](run) == 256
    assert cell.flops().forward_flops(cell.config) < spec.load_cell("unetpres-n16.serve-r512").flops().forward_flops(
        spec.load_cell("unetpres-n16.serve-r512").config)
    after = digests(copy / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed


@pytest.mark.parametrize("trace", ["0", "1"])
def test_run_refuses_without_a_card(copy, trace):
    """In a directory with only BENCHMARK.json and the benchmark (no program),
    and on a host without a card, a run exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "unetpres-n16.train-b1", "--seed",
                          str(2 ** 31 + 3), "--seconds", "1", "--trace", trace],
                         cwd=copy, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "benchmark:" in out.stderr


def test_unknown_cell_is_refused():
    from portbench import spec

    with pytest.raises(KeyError):
        spec.load_cell("no-such-config.no-such-traffic")


def test_benchmark_json_keeps_the_contract():
    """Names, units and keys of BENCHMARK.json as the driver reads them; each
    per-layer metric's cells report the metric it moves, and every cell
    reports set-up, another end-to-end metric and a per-layer metric."""
    import re

    from portbench import spec

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"} and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert all(w in e2e[m["moves"]]["workloads"] for w in m["workloads"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
    for w in bench["workloads"]:
        assert w["chips"] == 1 and name.match(w["name"]) and len(w["why"]) <= 200
        cell = spec.load_cell(w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer and set(cell.readers()) == {m["name"] for m in cell.per_layer}
    assert all(len(c["why"]) <= 200 and len(c["source"]) <= 200 for c in bench["configs"])
