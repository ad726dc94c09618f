#!/usr/bin/env python3
"""Time the plastic head, the conv3x3, conv3x3_dgrad and conv3x3_wgrad kernels, the residual tail forward and
backward, the lanes=128 training step and the serving path of several checkouts of this repository on one CUDA
card, one after the other in one run:

    mkdir -p build/parent && git archive HEAD plastic_unet_tpu_torch | tar -x -C build/parent
    python3 kernel_ab.py build/parent . . build/parent

Each argument is a directory that holds a checkout (its own
``plastic_unet_tpu_torch`` package and ``csrc/``); each is built and timed in
a process of its own, in the order given. Two cards may run at two power
limits, so two versions are compared only within one run, and the order
A B B A shows how far the card drifts meanwhile.

Per checkout it prints device times (ms; CUDA events while the device is
kept busy, median of 20, chip_smoke.time_ms) of one plastic_head launch at
n=101, B=128 and B=1, hebb and oja (the plan's choice, then each tile
family of head_plan where the checkout has one; each with a digest of its
three outputs), one conv3x3 launch, one
conv3x3_dgrad launch (with in_gate and gate, as the tail's backward first
calls it) and one conv3x3_wgrad call (ReLU on load, torch layout, as the
tail's backward calls it; its second stage included) at the five UNetPRes
level shapes, B=1 and B=128, the forward residual tail at the five level
shapes, B=128, by the checkout's route (four conv3x3 launches, or the fused
kernel where its tail_plan says so; with a digest of out: the fused kernel
keeps the four launches' bits, so the digests must match), the tail
backward at the five level shapes, B=128, by the checkout's route (the
eight dgrad and wgrad launches, or the fused backward where its
tail_bwd_plan says so), with a digest of dx0 (the fused backward keeps the
eight launches' bits there, so these must match) and one of the weight and
bias gradients (which it sums in its own order, so these differ where the
route does; max|diff| against the plain chain beside them), the eager
training step at lanes=128 in samples/s, and the serving rate of the neurons=16
predictor on 4 chunks of 128 tiles (host clock, median of 3). Each conv3x3
and dgrad line ends with a digest of the output bytes (for dgrad, of the
output and the masked input) from inputs seeded by the shape: equal digests
across checkouts are equal bits. The B=1 lines also give max|diff| against
the plain version: where a checkout splits K across blocks at B=1 (the split
family of conv3x3_plan), it sums in another order than the square tiles, so
its B=1 digests differ from such a parent's by design; the B=128 digests
must not. Where a checkout's conv3x3 has whole-sample variants, each is also
timed at the levels it can take, B=128; where it has the split family, the
split tiling it would choose for each window of grid sizes in
SPLIT_WINDOWS is timed at the B=1 levels the family takes.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time

# blocks of a split grid: up to 1/2, ~3/4, 1-1.6 and 2 or more a SM (an H100 has 132)
SPLIT_WINDOWS = ((48, 64), (96, 112), (128, 208), (256, 320))


def digest(*ts) -> str:
    """A short hash of the tensors' bytes: equal digests are equal bits."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def time_head(label: str) -> None:
    """The plastic head at n=101, B=128 and B=1, hebb and oja (free alpha):
    the plan's choice, then each family forced where the checkout has
    head_plan; one line each with its time and a digest of its three outputs."""
    import torch

    from chip_smoke import B, time_ms

    from plastic_unet_tpu_torch.ops import plastic_head as head_mod

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    n = 101
    for b in (B, 1):
        for rule in ("hebb", "oja"):
            gen.manual_seed(1000 * n + b + (rule == "oja"))
            x, hebb = torch.randn(b, n, n, generator=gen, device=dev), 0.1 * torch.randn(b, n, n, generator=gen, device=dev)
            w, alpha = 0.01 * torch.randn(n, n, generator=gen, device=dev), 0.01 * torch.rand(n, n, generator=gen, device=dev)
            eta = torch.full((1,), 0.01, device=dev)
            plans = [None]
            if hasattr(head_mod, "head_plan"):
                for family in head_mod.FAMILIES:
                    try:
                        plans.append(head_mod.head_plan(b, n, family=family))
                    except ValueError:
                        pass
            for plan in plans:
                kw = {} if plan is None else {"plan": plan}
                ms = time_ms(lambda: head_mod.plastic_head(w, alpha, eta, x, hebb, rule=rule, **kw))[0]
                out = head_mod.plastic_head(w, alpha, eta, x, hebb, rule=rule, **kw)
                which = "the plan's choice" if plan is None else f"{plan.family} {plan.grid} {plan.threads} threads"
                print(f"[{label}] plastic_head B={b} n={n} {rule} ({which}): {ms:.4f} ms digest {digest(*out)}",
                      flush=True)


def lanes_rate(label: str) -> None:
    """The eager training step at lanes=128 (UNetPRes neurons=16, oja, dropout 0; as chip_smoke.py phase
    10): samples/s by the host clock over 4 steps, median of 3."""
    import numpy as np
    import torch

    from chip_smoke import B, train_stream

    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.train.loop import create_train_state, make_train_step

    dev = torch.device("cuda")
    X, Y = train_stream(2, B, seed=24)
    X, Y = X.to(dev), Y.to(dev)
    model = UNetPRes(neurons=16, nbf=101, rule="oja", dropout_ratio=0.0, generator=torch.Generator().manual_seed(3))
    state = create_train_state(model, 1e-3, 0.5, 1e6, lanes=B, device=dev)
    step = make_train_step()
    step(state, (X[0], Y[0]))
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(4):
            step(state, (X[i % 2], Y[i % 2]))
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) / 4)
    sec = float(np.median(secs))
    print(f"[{label}] training step lanes={B}, eager: {B / sec:.1f} samples/s ({sec * 1e3:.2f} ms per step)", flush=True)


def time_checkout(label: str) -> int:
    """Runs with the checkout as the working directory."""
    import numpy as np
    import torch

    from chip_smoke import LEVELS, B, tail_saved, time_ms  # this script's neighbour: the same clock for every checkout

    sys.path.insert(0, os.getcwd())  # the package of the checkout, not of this script's directory
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.ops.conv3x3 import (conv3x3, conv3x3_dgrad, conv3x3_dgrad_plain, conv3x3_plain,
                                                    hwio)
    from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad
    from plastic_unet_tpu_torch.submit.server import MaskPredictor

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def diff(got, ref):
        return float((got.double() - ref.double()).abs().max())

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[{label}] {smi}", flush=True)
    with torch.inference_mode():
        time_head(label)
        for b in (1, B):
            for hw, c in LEVELS:
                gen.manual_seed(1000 * hw + b)
                x, k, bias = rnd(b, hw, hw, c), hwio(rnd(c, c, 3, 3) * 0.05), rnd(c)
                ms = time_ms(lambda: conv3x3(x, k, bias, relu_in=True))[0]
                y = conv3x3(x, k, bias, relu_in=True)
                err = "" if b != 1 else f" max|diff| vs plain {diff(y, conv3x3_plain(x, k, bias, relu_in=True)):.3g}"
                print(f"[{label}] conv3x3 B={b} {hw}x{hw}x{c}: {ms:.4f} ms digest {digest(y)}{err}", flush=True)
        for b in (1, B):
            for hw, c in LEVELS:
                gen.manual_seed(1000 * hw + b + 1)
                d, k, out, pre = rnd(b, hw, hw, c), hwio(rnd(c, c, 3, 3) * 0.05), rnd(b, hw, hw, c), rnd(b, hw, hw, c)
                ms = time_ms(lambda: conv3x3_dgrad(d, k, in_gate=out, gate=pre))[0]
                y, masked = conv3x3_dgrad(d, k, in_gate=out, gate=pre)
                err = "" if b != 1 else (f" max|diff| vs plain "
                                         f"{diff(y, conv3x3_dgrad_plain(d, k, in_gate=out, gate=pre)[0]):.3g}")
                print(f"[{label}] conv3x3_dgrad B={b} {hw}x{hw}x{c}: {ms:.4f} ms digest {digest(y, masked)}{err}",
                      flush=True)
        from plastic_unet_tpu_torch.ops import conv3x3 as conv_mod

        for hw, c in LEVELS:  # each whole-sample variant where the checkout has them, at B=128
            for v in getattr(conv_mod, "SAMPLE_VARIANTS", ()):
                if hw * hw > conv_mod.SAMPLE_PIXELS:
                    continue
                gen.manual_seed(1000 * hw + B + 1)
                d, k, out, pre = rnd(B, hw, hw, c), hwio(rnd(c, c, 3, 3) * 0.05), rnd(B, hw, hw, c), rnd(B, hw, hw, c)
                try:
                    pf = conv_mod.conv3x3_plan(B, hw, hw, c, c, family="sample", variant=v)
                    pd = conv_mod.conv3x3_plan(B, hw, hw, c, c, True, family="sample", variant=v)
                except ValueError:
                    continue
                fwd = time_ms(lambda: conv3x3(d, k, None, out, relu_in=True, relu_res=True, relu_out=True, plan=pf))[0]
                dg = time_ms(lambda: conv3x3_dgrad(d, k, in_gate=out, gate=pre, plan=pd))[0]
                print(f"[{label}] whole-sample variant (nt, tp) {v} B={B} {hw}x{hw}x{c}, {pf.samples} samples a tile, "
                      f"{pf.blocks} blocks: conv3x3 (ReLU in, residual, ReLU out) {fwd:.4f} ms, conv3x3_dgrad "
                      f"(in_gate, gate) {dg:.4f} ms", flush=True)
        for hw, c in LEVELS:  # the split tiling of each window of grid sizes where the checkout has them, at B=1
            if not hasattr(conv_mod, "_split_choice") or conv_mod.conv3x3_plan(1, hw, hw, c, c).family != "split":
                continue
            gen.manual_seed(1000 * hw + 2)
            x, d, k = rnd(1, hw, hw, c), rnd(1, hw, hw, c), hwio(rnd(c, c, 3, 3) * 0.05)
            out, pre, bias = rnd(1, hw, hw, c), rnd(1, hw, hw, c), rnd(c)
            for lo, hi in SPLIT_WINDOWS:
                pf = conv_mod._split_choice(1, hw, hw, c, c, False, lo, hi)
                pd = conv_mod._split_choice(1, hw, hw, c, c, True, lo, hi)
                fwd = time_ms(lambda: conv3x3(x, k, bias, relu_in=True, plan=pf))[0]
                dg = time_ms(lambda: conv3x3_dgrad(d, k, in_gate=out, gate=pre, plan=pd))[0]
                print(f"[{label}] split window {lo}..{hi} blocks B=1 {hw}x{hw}x{c}: conv3x3 (nt, ks, rows) "
                      f"{(pf.nt, pf.ks, pf.rows)} {pf.blocks} blocks {fwd:.4f} ms, conv3x3_dgrad "
                      f"{(pd.nt, pd.ks, pd.rows)} {pd.blocks} blocks {dg:.4f} ms", flush=True)
        for b in (1, B):
            for hw, c in LEVELS:
                x, d = rnd(b, hw, hw, c), rnd(b, hw, hw, c)
                ms = time_ms(lambda: conv3x3_wgrad(x, d, relu_in=True, layout="oihw"))[0]
                print(f"[{label}] conv3x3_wgrad B={b} {hw}x{hw}x{c}: {ms:.4f} ms", flush=True)
        from plastic_unet_tpu_torch.ops import residual_tail as tail_mod

        for hw, c in LEVELS:  # the forward tail by the checkout's route (four conv3x3 launches, or fused)
            gen.manual_seed(1000 * hw + B + 2)
            args = [rnd(B, hw, hw, c)]
            for _ in range(4):
                args += [rnd(c, c, 3, 3) * (0.5 / (3 * c ** 0.5)), rnd(c) * 0.1]
            ms = time_ms(lambda: tail_mod.residual_tail(*args))[0]
            route = tail_mod.tail_plan(B, hw, hw, c).family if hasattr(tail_mod, "tail_plan") else "four"
            print(f"[{label}] residual_tail B={B} {hw}x{hw}x{c} ({route}): {ms:.4f} ms digest "
                  f"{digest(tail_mod.residual_tail(*args))}", flush=True)
        for hw, c in LEVELS:  # the tail backward by the checkout's route (eight launches, or the fused kernel)
            gen.manual_seed(1000 * hw + B + 3)
            args = [rnd(B, hw, hw, c)]
            for _ in range(4):
                args += [rnd(c, c, 3, 3) * (0.5 / (3 * c ** 0.5)), rnd(c) * 0.1]
            gout, saved, ws = rnd(B, hw, hw, c), tail_saved(args), args[1::2]
            ks = [hwio(w) for w in ws]
            ms = time_ms(lambda: tail_mod.residual_tail_backward(gout, *saved, *ks))[0]
            got = tail_mod.residual_tail_backward(gout, *saved, *ks)
            plain = tail_mod.residual_tail_backward_plain(gout, *saved, *ws)
            route = tail_mod.tail_bwd_plan(B, hw, hw, c).family if hasattr(tail_mod, "tail_bwd_plan") else "eight"
            print(f"[{label}] residual_tail_backward B={B} {hw}x{hw}x{c} ({route}): {ms:.4f} ms digest dx0 "
                  f"{digest(got[0])} dW, db {digest(*got[1:])} (max|diff| vs plain "
                  f"{max(diff(a, q) for a, q in zip(got[1:], plain[1:])):.3g})", flush=True)
            del args, gout, saved, ks, got, plain
    lanes_rate(label)
    model = UNetPRes(neurons=16, nbf=101, rule="oja", generator=torch.Generator().manual_seed(0))
    pred = MaskPredictor(model, threshold=0.5).warmup()
    xs = np.random.default_rng(2).random((4 * B, 101, 101), dtype=np.float32)
    pred.predict_probs(xs[:B])
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred.predict_probs(xs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = float(np.median(secs))
    print(f"[{label}] serving neurons=16 chunk {B}: {4 * B / sec:.1f} tiles/s ({sec / 4 * 1e3:.3f} ms per chunk)",
          flush=True)
    return 0


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        return time_checkout(argv[1])
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for i, tree in enumerate(argv):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one", f"{i}:{tree}"], cwd=tree, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
