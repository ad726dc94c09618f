"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic and per-layer metrics are files under
``benchmark/`` found by name (see ``portbench/spec.py``). With ``--trace 0``
the last line of standard output is the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each in one JSON object with
``correct``, ``attempted``, ``failed``, ``device`` and last ``checks``: each
number that decided ``correct`` beside its limit (also the last lines of
standard error). The run fails, and prints no result, without a CUDA card,
or if JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]
# PyTorch's runtime-compiled kernels are cached in the checkout, beside the port's own build
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(ROOT / "build" / "torch_kernels"))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "plastic_unet_tpu")
PORT = "plastic_unet_tpu_torch"


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def fail(msg: str, code: int = 2) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def import_everything(cell) -> list:
    """Import every module a run of ``cell`` uses: the kind's driver, the
    port's entry points it drives, the arch file with the port's model class
    it names, the FLOP counts and the metric readers. Returns the readers."""
    import portbench.check  # noqa: F401
    import portbench.tracing  # noqa: F401

    importlib.import_module(f"portbench.{cell.kind}")
    import plastic_unet_tpu_torch.submit.server  # noqa: F401
    import plastic_unet_tpu_torch.train.loop  # noqa: F401
    import plastic_unet_tpu_torch.utils.precision  # noqa: F401
    from portbench.weights import port_class, reference_class

    reference_class(cell.config["arch"])
    port_class(cell.config["arch"])
    cell.flops()
    return cell.readers()


def per_layer(cell, res: dict, dev: dict, readers: dict) -> dict:
    from portbench.tracing import port_kernel_names

    ctx = SimpleNamespace(cell=cell, config=cell.config, workload=cell.workload, counters=res["counters"],
                          trace=res.get("trace"), attribution=res.get("attribution"), flops=cell.flops(),
                          peaks=dev, port_kernels=port_kernel_names(cell.bench_dir))
    out = {}
    for m in cell.per_layer:
        value = readers[m["name"]](ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    from portbench.tracing import note

    note(T_START, "torch imported")

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the port on a card and has no CPU fallback")
    if torch.cuda.device_count() < cell.entry["chips"]:
        return fail(f"the cell asks for {cell.entry['chips']} cards, {torch.cuda.device_count()} visible")
    try:
        readers = import_everything(cell)
    except ImportError as e:
        return fail(f"cannot import the program or the harness: {e}")
    import plastic_unet_tpu_torch

    if not Path(plastic_unet_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        return fail(f"{PORT} was imported from {plastic_unet_tpu_torch.__file__}, outside this checkout")
    from portbench import check, device

    note(T_START, "program and harness imported")
    torch.zeros(1, device="cuda")
    note(T_START, "CUDA context made")
    dev_info = device.describe(cell.entry["chips"])
    kind = importlib.import_module(f"portbench.{cell.kind}")
    res = kind.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)

    bad = forbidden_modules()
    if bad:
        return fail(f"modules the benchmark may not load are loaded: {bad}", 3)
    ok, checks = check.verdict(res["numbers"], cell.workload["limits"])
    dev = {"platform": "gpu", "kind": dev_info["kind"], "count": dev_info["count"],
           "memory_peak_bytes": int(res["memory_peak_bytes"]), "power_limit_w": dev_info["power_limit_w"]}
    if args.trace:
        metrics = per_layer(cell, res, dev_info, readers)
        tr = res["trace"]
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    else:
        measured = dict(cell.workload["reports"], setup_s="setup_s")  # metric name -> what the kind measured
        metrics = {m["name"]: {"value": float(res[measured[m["name"]]]), "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": bool(ok and res["failed"] == 0), "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if args.trace:
        line["breakdown"] = res["trace"].breakdown()
    line["checks"] = checks
    print(f"benchmark: {cell.name} seed {args.seed} on {dev_info['kind']}, power limit "
          f"{dev_info['power_limit_w']} W: " + ", ".join(f"{k} {v['value']} {v['unit']}" for k, v in metrics.items()),
          file=sys.stderr)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
