"""What one cell is: its entry in ``BENCHMARK.json``, its configuration file
(``configs/<config>.json``), its traffic file (``workloads/<cell>.json``),
the per-layer metric readers that apply to it (``metrics/<metric>.py``) and
the FLOP counts of its architecture (``flops/<arch>.py``); the rest of the
architecture is its file ``reference/<arch>.py``, read by ``weights.py``.

Everything is found by name, so a new configuration, traffic mix, metric or
architecture is new files and new entries in ``BENCHMARK.json``; no file
here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent  # benchmark/
ROOT = BENCH_DIR.parent  # the checkout


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_file(path: Path, name: str):
    """Import one Python file by its path under a module name of our own
    (metric files carry dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json's workloads
    config: dict  # configs/<config>.json
    workload: dict  # workloads/<cell>.json
    end_to_end: list  # BENCHMARK.json's end_to_end entries this cell reports
    per_layer: list  # BENCHMARK.json's per_layer entries this cell reports
    bench_dir: Path

    @property
    def kind(self) -> str:
        return self.workload["kind"]

    def flops(self):
        """The FLOP and byte counts of the configuration's architecture."""
        arch = self.config["arch"]
        return load_file(self.bench_dir / "flops" / f"{arch}.py", f"portbench_flops_{arch}")

    def readers(self) -> dict:
        """{metric name: its reader's ``read``}, for every per-layer metric of this cell."""
        out = {}
        for m in self.per_layer:
            mod = load_file(self.bench_dir / "metrics" / f"{m['name']}.py",
                            "portbench_metric_" + m["name"].replace(".", "_").replace("-", "_"))
            out[m["name"]] = mod.read
        return out


def _reports(metric: dict, cell: str, e2e_of_cell: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_of_cell is None or metric.get("moves") in e2e_of_cell


def load_cell(name: str, bench_json: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the checkout's root unless given)."""
    bench_json = bench_json or ROOT / "BENCHMARK.json"
    bench = load_json(bench_json)
    bench_dir = bench_json.parent / "benchmark"
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in {bench_json} (have {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    config = load_json(bench_json.parent / cfg_entry["file"])
    workload = load_json(bench_dir / "workloads" / f"{name}.json")
    if workload.get("config") != entry["config"]:
        raise ValueError(f"workloads/{name}.json names config {workload.get('config')!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    unknown = {m["name"] for m in e2e} - set(workload.get("reports", {})) - {"setup_s"}
    if unknown:
        raise ValueError(f"workloads/{name}.json does not say which measurement reports {sorted(unknown)}")
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, entry, config, workload, e2e, per_layer, bench_dir)
