"""The readings a cell's limits are set from: the compared numbers of the
program on many seeds, of its control, and of planted faults, at the
cell's own sizes, in one process (the kernels built once).

    python3 benchmark/calibrate.py --workload <cell> --seeds 101,102,... \
        [--control-seeds 201,202,203] [--fault-seeds 301,302,303] [--seconds 3]

The control is the program with its own lower-precision path switched on:
the "perf" policy, TF32 in cuDNN and cuBLAS, where the configuration states
float32 with TF32 off. The plain reference in TF32 is read beside it. The
faults planted, where the cell can have them: training on half of the
lanes, the loss their mean (``half_batch``); a step that returns its state
unchanged (``unchanged``: the loss computed, nothing updated), which reads
1 on ``grad_gap`` and ``change_gap`` by their definition; the step's loss
altered where it is produced (``altered_answer``: 0.01 added); a served
answer altered where it is produced (``altered_answer``: one mask's pixel
moved by 0.01); serving half of each chunk, the other half answered with
zeros (``half_batch``).
Training reads the checked steps only; serving runs a short window.
Each reading is one JSON line on standard output. Not run by the benchmark.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


FAULTS = {"train": ["unchanged", "altered_answer", "half_batch"], "serve": ["altered_answer", "half_batch"]}


@contextlib.contextmanager
def planted(kind: str, fault: str | None):
    """The program's timed path broken underneath, while the block runs."""
    if fault is None:
        yield
        return
    if kind == "train":
        from plastic_unet_tpu_torch.train import loop

        real_loss, real_body = loop._loss_fn, loop._step_body

        def loss_fn(loss_space):
            f = real_loss(loss_space)

            def loss(out, mask):
                if fault == "half_batch":
                    h = max(out.activ.shape[0] // 2, 1)
                    return f(type(out)(out.activ[:h], out.activout[:h], out.hebb[:h]), mask[:h])
                return f(out, mask) + 0.01 if fault == "altered_answer" else f(out, mask)
            return loss

        def unchanged(state, loss_of, img, mask, reducer=None):
            with torch.no_grad():
                return loss_of(state.model(img, state.hebb.detach(), generator=state.generator), mask).detach()

        if fault not in ("half_batch", "altered_answer", "unchanged"):
            raise ValueError(f"no fault {fault!r} for training")
        loop._loss_fn = loss_fn
        if fault == "unchanged":
            loop._step_body = unchanged
        try:
            yield
        finally:
            loop._loss_fn, loop._step_body = real_loss, real_body
        return
    if kind == "serve":
        from plastic_unet_tpu_torch.submit import server

        real = server.MaskPredictor.predict

        def broken(self, images):
            out = real(self, images)
            if fault == "altered_answer":
                out = out.copy()
                out[0, 0, 0] += 0.01
            elif fault == "half_batch":
                out = out.copy()
                for lo in range(0, out.shape[0], self.chunk):
                    out[lo + self.chunk // 2: lo + self.chunk] = 0.0
            return out
        server.MaskPredictor.predict = broken
        try:
            yield
        finally:
            server.MaskPredictor.predict = real
        return
    raise ValueError(f"no fault {fault!r} for kind {kind!r}")


def read_train(cell, seed: int, device, tf32_reference: bool) -> dict:
    from plastic_unet_tpu_torch.utils.precision import matmul_precision
    from portbench import check, train

    with matmul_precision(cell.config["precision"]):
        prog, sd, x, y, readings = train.setup(cell, seed, device)
    del prog
    ref = train.reference_steps(cell, sd, x, y, seed, cell.workload["check_calls"], device)
    out = {"program": check.train_numbers(readings, ref)}
    worst = lambda gaps: sorted(gaps.items(), key=lambda kv: -kv[1])[:4]  # noqa: E731
    out["worst_leaves"] = {"grad": worst(check.leaf_gaps(readings["grad1"], ref["grad1"])),
                           "change": worst(check.leaf_gaps(readings["change"], ref["change"],
                                                           check.moved_leaves(ref["grad_steps"])))}
    if tf32_reference:
        ref32 = train.reference_steps(cell, sd, x, y, seed, cell.workload["check_calls"], device, tf32=True)
        out["reference_tf32"] = check.train_numbers(ref32, ref)
    return out


def read_serve(cell, seed: int, device, seconds: float, tf32_reference: bool) -> dict:
    from portbench import check, serve

    res = serve.run(cell, seed, seconds, False, device, time.perf_counter())
    out = {"program": res["numbers"], "requests": res["attempted"]}
    if tf32_reference:
        pool = serve.make_pool(cell, seed, device)
        from portbench.weights import make_state_dict

        sd = make_state_dict(cell.config, seed, device)
        tiles = [pool[:cell.workload["request_tiles"]]]
        a = serve.reference_masks(cell, sd, tiles, device)
        b = serve.reference_masks(cell, sd, tiles, device, tf32=True)
        out["reference_tf32"] = {"mask_gap": check.mask_gap(b, a)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    from portbench import spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    seeds = lambda s: [int(v) for v in s.split(",") if v]  # noqa: E731
    control = copy.deepcopy(cell)
    control.config["precision"] = "perf"
    faults = FAULTS[cell.kind] if cell.workload.get("lanes", 2) > 1 else ["unchanged", "altered_answer"]

    def read(c, seed, tf32_reference=False):
        if c.kind == "train":
            return read_train(c, seed, dev, tf32_reference)
        return read_serve(c, seed, dev, args.seconds, tf32_reference)

    for seed in seeds(args.seeds):
        print(json.dumps({"cell": cell.name, "side": "program", "seed": seed, **read(cell, seed)}), flush=True)
    for seed in seeds(args.control_seeds):
        r = read(control, seed, tf32_reference=True)
        r["control"] = r.pop("program")
        print(json.dumps({"cell": cell.name, "side": "control", "seed": seed, **r}), flush=True)
    for seed in seeds(args.fault_seeds):
        for fault in faults:
            with planted(cell.kind, fault):
                r = read(cell, seed)
            print(json.dumps({"cell": cell.name, "side": f"fault:{fault}", "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
