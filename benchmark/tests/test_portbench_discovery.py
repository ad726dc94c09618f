"""The harness finds a new configuration, traffic mix, per-layer metric and
architecture by name, with no file that is there edited; and off the card
the measuring path refuses to run instead of falling back."""

import hashlib
import json
import math
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


TOY_REFERENCE = '''"""A stateless two-level conv net with BatchNorm: an architecture the port lacks."""

import math

import torch
import torch.nn.functional as F
from torch import nn


class Block(nn.Module):
    def __init__(self, cin, c):
        super().__init__()
        self.conv = nn.Conv2d(cin, c, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(c)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class ToyBN(nn.Module):
    def __init__(self, n_channels=1, width=4):
        super().__init__()
        self.enc, self.low = Block(n_channels, width), Block(width, 2 * width)
        self.dec, self.outc = Block(3 * width, width), nn.Conv2d(width, 1, 1)

    def forward(self, x, state, generator=None):
        e = self.enc(x)
        up = F.interpolate(self.low(F.max_pool2d(e, 2)), size=e.shape[2:])
        logits = self.outc(self.dec(torch.cat([e, up], 1)))[:, 0]
        return logits, torch.sigmoid(logits), state


Reference = ToyBN
PORT = "reference.toy_bn:ToyBN"


def initial_state(ref, batch, device):
    return None


def init_weights(shell, generator):
    dev, sd = generator.device, {}
    for k, v in shell.state_dict().items():
        if k.endswith(("bn.weight", "running_var")):
            sd[k] = torch.ones(v.shape, device=dev)
        elif v.dim() == 4:
            sd[k] = (2 * torch.rand(v.shape, generator=generator, device=dev) - 1) / math.sqrt(v[0].numel())
        else:
            sd[k] = torch.zeros(v.shape, dtype=v.dtype, device=dev)
    return sd
'''

TOY_FLOPS = '''def forward_flops(config):
    w, s = config["model"]["width"], config["image_size"]
    return float(18 * s * s * (w + 3 * w * w) + 18 * (s // 2) ** 2 * 2 * w * w + 2 * s * s * w)


def train_flops(config):
    return 3 * forward_flops(config)


def tail_work(config, batch, train):
    return 0.0, 0.0
'''

# Run in the copy, from its own harness: every function a cell's run and its check call on the new arch.
TOY_CHECKS = '''
import json, sys
sys.path[:0] = ["benchmark", "."]
import torch
import portbench
from portbench import spec, serve, train
from portbench.weights import build_port_model, build_reference, make_state_dict, reference_class

cpu = torch.device("cpu")
out = {"harness": portbench.__file__}
for name in ("toy_bn-w4.train-l2", "toy_bn-w4.serve-r8"):
    cell = spec.load_cell(name)
    out[name] = {"kind": cell.kind, "e2e": sorted(m["name"] for m in cell.end_to_end),
                 "forward_flops": cell.flops().forward_flops(cell.config)}
cell = spec.load_cell("toy_bn-w4.train-l2")
with torch.device("meta"):
    keys = set(reference_class("toy_bn")(**cell.config["model"]).state_dict())
sd = make_state_dict(cell.config, 2 ** 31 + 9, cpu)
out["keys"], out["sd_keys"] = sorted(keys), sorted(sd)
same = lambda a, b: all(torch.equal(a[k], b[k]) for k in a)
out["repeats"] = same(sd, make_state_dict(cell.config, 2 ** 31 + 9, cpu))
out["differs"] = not same(sd, make_state_dict(cell.config, 2 ** 31 + 10, cpu))
out["reference"] = type(build_reference(cell.config, sd, cpu)).__name__
out["port"] = type(build_port_model(cell.config, sd, cpu)).__name__
x, y = train.make_stream(cell, 5, cpu)
out["losses"] = train.reference_steps(cell, sd, x, y, 5, cell.workload["check_calls"], cpu)["losses"]
scell = spec.load_cell("toy_bn-w4.serve-r8")
pool = serve.make_pool(scell, 5, cpu)
out["masks"] = [list(m.shape) for m in serve.reference_masks(scell, sd, [pool[:8], pool[3:6]], cpu, chunk=4)]
print(json.dumps(out))
'''


def test_new_arch_is_new_files_only(copy):
    """A new architecture (BatchNorm, no state, no plastic head) is a config,
    two traffic files, reference/<arch>.py and flops/<arch>.py: the copy's
    own harness finds both cells, makes every key of the state_dict, the BN
    buffers too, loads both models strictly, trains three reference steps
    and scores masks."""
    before = digests(copy / "benchmark")
    b = copy / "benchmark"
    (b / "reference/toy_bn.py").write_text(TOY_REFERENCE)
    (b / "flops/toy_bn.py").write_text(TOY_FLOPS)
    train_cfg = json.loads((b / "configs/unetpres-n16.json").read_text())["train"]
    (b / "configs/toy_bn-w4.json").write_text(json.dumps(
        {"name": "toy_bn-w4", "arch": "toy_bn", "model": {"n_channels": 1, "width": 4}, "image_size": 16,
         "precision": "parity", "train": train_cfg, "reduced": []}))
    limits = {"loss_gap": 2e-06, "grad_gap": 0.0005, "change_gap": 0.002}
    (b / "workloads/toy_bn-w4.train-l2.json").write_text(json.dumps(
        {"config": "toy_bn-w4", "kind": "train", "lanes": 2, "stream_tiles": 12, "check_calls": [1, 2],
         "trace_steps": 3, "attribution_steps": 1, "limits": limits,
         "reports": {"train_toy_samples_per_s": "samples_per_s"}}))
    (b / "workloads/toy_bn-w4.serve-r8.json").write_text(json.dumps(
        {"config": "toy_bn-w4", "kind": "serve", "request_tiles": 8, "chunk": 4, "pool_tiles": 16,
         "warm_requests": 1, "trace_requests": 2, "check_requests": 2, "limits": {"mask_gap": 5e-07},
         "reports": {"serve_toy_tiles_per_s": "tiles_per_s"}}))
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy_bn-w4", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy_bn-w4.json", "reduced": [], "why": "a test"})
    for traffic, metric, unit in (("train-l2", "train_toy_samples_per_s", "samples/s"),
                                  ("serve-r8", "serve_toy_tiles_per_s", "tiles/s")):
        bench["workloads"].append({"name": f"toy_bn-w4.{traffic}", "config": "toy_bn-w4", "traffic": traffic,
                                   "chips": 1, "why": "a test"})
        bench["end_to_end"].append({"name": metric, "unit": unit, "better": "higher", "bound": 0.05,
                                    "source": "host_clock", "workloads": [f"toy_bn-w4.{traffic}"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    run = subprocess.run([sys.executable, "-c", TOY_CHECKS], cwd=copy, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.strip().splitlines()[-1])
    assert out["harness"].startswith(str(copy))
    assert out["toy_bn-w4.train-l2"]["kind"] == "train" and out["toy_bn-w4.serve-r8"]["kind"] == "serve"
    assert out["toy_bn-w4.train-l2"]["e2e"] == ["setup_s", "train_toy_samples_per_s"]
    assert out["toy_bn-w4.serve-r8"]["e2e"] == ["serve_toy_tiles_per_s", "setup_s"]
    assert out["toy_bn-w4.train-l2"]["forward_flops"] > 0
    assert out["sd_keys"] == out["keys"]
    assert {"enc.bn.running_mean", "enc.bn.running_var", "enc.bn.num_batches_tracked"} <= set(out["keys"])
    assert out["repeats"] and out["differs"]
    assert out["reference"] == out["port"] == "ToyBN"
    assert len(out["losses"]) == 3 and all(math.isfinite(v) for v in out["losses"])
    assert out["masks"] == [[8, 16, 16], [3, 16, 16]]
    after = digests(copy / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed


def test_missing_arch_names_its_file():
    from portbench.weights import make_state_dict

    with pytest.raises(FileNotFoundError, match=r"reference/no_such_arch\.py"):
        make_state_dict({"arch": "no_such_arch", "model": {}}, 1, "cpu")


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
