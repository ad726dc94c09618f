#!/usr/bin/env python3
"""Why serving on the card does not repeat its bits (ROADMAP C5): one card.

    python3 serving_bits.py [OUT.json]   # from the repository root; the summary goes to OUT.json
                                         # (default out/serving_bits.json)

UNetPRes neurons=16, nbf=101 from seed 0 (oja), 512 synthetic tiles (seed
78), chunk 128: the sequence of chip_smoke.py phase 12. The 8 TTA views go
through the model one pass a view ("one-pass") and folded into the batch
("folded"); the chunks hold the same samples at the same places either way,
so every (view, chunk) pair should match bit for bit. Steps:

  1. build the kernels, run chip_smoke.py phase 2 (kernels against their plain
     versions; it also leaves the allocator as the full script does);
  2. the sequence under "parity" (TF32 off: what serving ran under until
     the repair) and under "serving" (utils.precision.serving_numerics:
     parity and deterministic cuDNN): which views and chunks differ;
  3. for each differing chunk, a digest of every module's input and output
     (forward hooks, in call order) in both paths: the first module whose
     output differs while its input does not; and chip_smoke's
     first_unrepeatable_layer on the chunk from either path's tensor;
  4. the sequence again with every free block of the caching allocator
     NaN-filled before each forward, and in a subprocess with
     PYTORCH_NO_CUDA_MEMORY_CACHING=1: a kernel reading memory it never
     wrote, or leaving part of its output unwritten, shows there;
  5. chip_smoke.phase_canary: every kernel family with its inputs inside
     NaN-filled buffers and its outputs in NaN-filled blocks, at the level
     shapes, B=128 and B=1; again in a subprocess with the inputs off
     16-byte alignment;
  6. compute-sanitizer's initcheck and racecheck on one launch of each
     family, if the CUDA toolkit has it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

TILES, NEURONS = 512, 16
OUT = os.path.join(cs.REPO, "out", "serving_bits.json")


def setup(dev):
    from plastic_unet_tpu_torch.data.synthetic import synthetic_tiles

    imgs, _ = synthetic_tiles(TILES, size=101, seed=78)
    X = torch.from_numpy(np.ascontiguousarray(imgs[:, 0, :, :, None])).to(dev)
    return cs.seeded_model(NEURONS, "oja", 0).to(dev).eval(), X


KINDS = ("parity", "serving")  # TF32 off only (serving before the repair); and utils.precision.serving_numerics


def numerics(kind):
    from plastic_unet_tpu_torch.utils.precision import matmul_precision, serving_numerics

    return serving_numerics() if kind == "serving" else matmul_precision("parity")


def masks(model, X, dev, poison=False):
    """eval.evaluate.predict_masks' loop (chunk B, zero traces), optionally with the free blocks
    NaN-filled before each forward."""
    from plastic_unet_tpu_torch.eval.evaluate import _padded

    n = X.shape[0]
    out = torch.empty((n, model.nbf, model.nbf), device=dev)
    with torch.inference_mode():
        for lo in range(0, n, cs.B):
            hi = min(lo + cs.B, n)
            if poison:
                cs.poison_free_blocks(dev)
            out[lo:hi] = model(_padded(X[lo:hi], cs.B), model.initial_zero_hebb(cs.B, device=dev)).activout[:hi - lo]
    return out


def sequence(model, X, dev, kind, poison=False):
    """(views, allv, per (view, chunk) max|one-pass - folded|, merged max|diff|, NaN found)."""
    from plastic_unet_tpu_torch.ops.augment import TTA_TRANSFORMS, TTA_VIEWS_8, tta_merge

    with numerics(kind):
        views = [TTA_TRANSFORMS[t][0](X, True).contiguous() for t in TTA_VIEWS_8]
        one = torch.stack([masks(model, v, dev, poison) for v in views])
        allv = torch.cat(views)
        folded = masks(model, allv, dev, poison).reshape(one.shape)
    torch.cuda.synchronize()
    diffs = {}
    for v, name in enumerate(TTA_VIEWS_8):
        for c in range(TILES // cs.B):
            sl = slice(c * cs.B, (c + 1) * cs.B)
            diffs[(name, c)] = float((one[v, sl] - folded[v, sl]).abs().max())
    merged = float((tta_merge(one, TTA_VIEWS_8) - tta_merge(folded, TTA_VIEWS_8)).abs().max())
    nan = bool(torch.isnan(one).any()) or bool(torch.isnan(folded).any())
    return views, allv, diffs, merged, nan


def report(tag, diffs, merged, nan):
    bad = {k: v for k, v in diffs.items() if v != 0 or v != v}
    by_view = {}
    for (view, c), v in bad.items():
        by_view.setdefault(view, []).append((c, v))
    print(f"[bits] {tag}: {len(bad)} of {len(diffs)} (view, chunk) pairs differ between one-pass and folded; "
          f"by view {by_view}; merged tta8 max|diff| {merged:.3g}; NaN in the masks: {nan}", flush=True)
    return {"tag": tag, "differing": [[k[0], k[1], v] for k, v in bad.items()], "merged": merged, "nan": nan}


def localize(model, views, allv, diffs, dev, kind):
    """For each differing (view, chunk): the first module whose output differs between the chunk run
    from the one-pass tensor and from the folded tensor, and first_unrepeatable_layer on each."""
    from plastic_unet_tpu_torch.ops.augment import TTA_VIEWS_8

    found = []
    with numerics(kind):
        for (view, c), d in diffs.items():
            if d == 0:
                continue
            v = TTA_VIEWS_8.index(view)
            a = views[v][c * cs.B:(c + 1) * cs.B]
            b = allv[v * TILES + c * cs.B:v * TILES + (c + 1) * cs.B]
            first = cs.first_differing_module(model, a, b)
            rep_a = cs.first_unrepeatable_layer(model, a)
            rep_b = cs.first_unrepeatable_layer(model, b)
            line = {"view": view, "chunk": c, "max_diff": d,
                    "first_module_differing_across_paths": None if first is None else first[0],
                    "its_input_equal": None if first is None else first[1],
                    "unrepeatable_one_pass": rep_a, "unrepeatable_folded": rep_b,
                    "input_chunks_equal": bool(torch.equal(a, b)),
                    "addresses_mod_4096": [a.data_ptr() % 4096, b.data_ptr() % 4096]}
            print(f"[bits] {kind} {view} chunk {c} (max|diff| {d:.3g}): {line}", flush=True)
            found.append(line)
    return found


def one_launch_each(dev):
    """One launch of each family at a small shape: the command compute-sanitizer runs."""
    from plastic_unet_tpu_torch.ops import conv3x3 as c3
    from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad
    from plastic_unet_tpu_torch.ops.plastic_head import FAMILIES, head_plan, plastic_head

    g = torch.Generator(device=dev).manual_seed(9)
    for b, h, w, cin, cout in ((2, 13, 7, 40, 24), (1, 12, 12, 128, 128)):
        x = torch.randn((b, h, w, cin), generator=g, device=dev)
        k = torch.randn((3, 3, cin, cout), generator=g, device=dev) * 0.05
        for fam in c3.FAMILIES:
            try:
                plan = c3.conv3x3_plan(b, h, w, cin, cout, family=fam)
            except ValueError:
                continue
            c3.conv3x3(x, k, torch.zeros(cout, device=dev), plan=plan, relu_in=True)
        conv3x3_wgrad(x, torch.randn((b, h, w, cout), generator=g, device=dev))
    n = 33
    for b in (1, 40):
        x = torch.randn((b, n, n), generator=g, device=dev)
        for fam in FAMILIES:
            try:
                plan = head_plan(b, n, family=fam)
            except ValueError:
                continue
            plastic_head(torch.zeros(n, n, device=dev), torch.zeros(n, n, device=dev),
                         torch.full((1,), 0.01, device=dev), x, torch.zeros_like(x), plan=plan)
    torch.cuda.synchronize()
    print("[sanitize] one launch of each family done", flush=True)


def sanitizer(summary):
    tool = shutil.which("compute-sanitizer") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                              "compute-sanitizer")
    if not os.path.exists(tool):
        print("[sanitize] compute-sanitizer: not in the CUDA toolkit here", flush=True)
        summary["sanitizer"] = "absent"
        return
    summary["sanitizer"] = {}
    for check in ("initcheck", "racecheck"):
        cmd = [tool, "--tool", check, "--error-exitcode", "9", sys.executable, __file__, "--one-launch-each"]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=240, cwd=cs.REPO)
            tail = (p.stdout + p.stderr).strip().splitlines()[-25:]
            summary["sanitizer"][check] = {"rc": p.returncode, "tail": tail}
        except subprocess.TimeoutExpired:
            summary["sanitizer"][check] = {"rc": "timeout after 240 s"}
        print(f"[sanitize] {check}: {summary['sanitizer'][check]}", flush=True)


def run_sequences(dev, model, X, summary, *, poison=False, localize_too=True):
    for kind in KINDS:
        views, allv, diffs, merged, nan = sequence(model, X, dev, kind, poison)
        tag = f"{kind}{' NaN-filled free blocks' if poison else ''}" + (
            " PYTORCH_NO_CUDA_MEMORY_CACHING=1" if os.environ.get("PYTORCH_NO_CUDA_MEMORY_CACHING") else "")
        summary.setdefault("sequences", []).append(report(tag, diffs, merged, nan))
        if localize_too:
            summary.setdefault("localized", []).extend(localize(model, views, allv, diffs, dev, kind))
        del views, allv


def main() -> int:
    if not torch.cuda.is_available():
        print("serving_bits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, cs.REPO)
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")
    args = sys.argv[1:]
    if args == ["--one-launch-each"]:
        one_launch_each(dev)
        return 0
    if args == ["--misaligned"]:
        print(json.dumps({"misaligned_canary": cs.phase_canary(dev, 1)}))
        return 0
    if args == ["--sequence"]:
        summary = {}
        model, X = setup(dev)
        run_sequences(dev, model, X, summary, localize_too=False)
        print(json.dumps(summary))
        return 0
    out_path = args[0] if args else OUT
    t0 = time.time()
    smi, _ = cs.phase_device()
    print(f"[bits] cuDNN {torch.backends.cudnn.version()}", flush=True)
    summary = {"card": smi, "cudnn": torch.backends.cudnn.version(), "torch": torch.__version__}
    t = torch.empty(1 << 20, device=dev)
    ptr = t.data_ptr()
    del t
    filled = cs.poison_free_blocks(dev)
    t = torch.empty(1 << 20, device=dev)
    summary["poison_self_test"] = [filled, t.data_ptr() == ptr, bool(torch.isnan(t).all())]
    print(f"[bits] poison self-test: {filled} bytes filled; the freed block came back at the same address: "
          f"{t.data_ptr() == ptr}, all NaN: {bool(torch.isnan(t).all())}", flush=True)
    del t
    cs.phase_kernels(dev)
    model, X = setup(dev)
    run_sequences(dev, model, X, summary)
    run_sequences(dev, model, X, summary, poison=True, localize_too=False)
    summary["canary"] = cs.phase_canary(dev, 4)
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    for label, extra_env, arg in (("no caching", env, "--sequence"), ("misaligned canary", None, "--misaligned")):
        p = subprocess.run([sys.executable, __file__, arg], capture_output=True, text=True, timeout=600,
                           env=extra_env, cwd=cs.REPO)
        out = (p.stdout + p.stderr).strip().splitlines()
        print(f"[bits] subprocess {label}: rc {p.returncode}; " + "\n".join(out[-12:]), flush=True)
        summary[label] = {"rc": p.returncode, "tail": out[-12:]}
    sanitizer(summary)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1, default=str)
    print(f"[bits] done in {time.time() - t0:.1f} s; card: {smi}; summary in {out_path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
