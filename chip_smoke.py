#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (no JAX).

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --profile   # only: the B=1 training step's device time by kernel name

Phases, each printing its lines; any failed check raises and the exit code
is non-zero:

  1. device name and power limit (nvidia-smi), torch/CUDA versions; build
     every kernel of csrc/ with nvcc for sm_90a (one process per source).
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of the serving path (B=128) and of the training step (B=1):
     the plastic head (hebb/oja x free/yoked; each tile family of its plan,
     forced, at n in HEAD_NS and B in HEAD_BS, bit-identical over two runs
     and across families), the 3x3 conv at the five
     level shapes with every flag combination plus Cin != Cout cases (B=128
     takes the whole-sample tiles at 25^2, 12^2, 6^2; B=1 splits K across
     blocks from 50^2 down, each such case bit-identical over two runs), and
     at CONV_EDGE_CASES in all three families, each bit-identical over two
     runs; the residual tail at the five shapes. Tolerance max|diff| <= 1e-4 *
     max(1, max|ref|): fp32 sums taken in another order over up to 9*256 terms.
  3. UNetPRes at full width (neurons=16, nbf=101, seeded weights; hebb and
     oja) and the committed epoch-225 oja checkpoint (neurons=8): B=8 on
     the card against the same weights on the CPU port (activout and the
     updated trace within 1e-4).
  4. serving: the checkpoint's MaskPredictor scores the 64 hard validation
     tiles (threshold 0.48955 +- 1e-6, IoU 0.83125 +- 1/640, as the JAX
     package scores it), answers requests of 1, 37 and 128 tiles with RLE
     strings, writes submission.csv for 256 tiles; a full-width predictor
     answers a 128-tile request (the main path of the launch counts).
  5. proof of path: the launch counters of every serving call match one
     plastic-head launch, 9 residual tails and 36 conv3x3 launches per chunk.
  6. times (CUDA events around each call while the device is kept busy,
     so host issue time is excluded; warm-up excluded; median of 20) at B=128
     and at B=1: each kernel, its plain version, its bound and the cuDNN
     call where one exists (for the head, torch.bmm of its product alone,
     bmm_ms); serving tiles/s at neurons=16, chunk 128.

  7. the backward kernels against their plain versions on the card, at the
     five level shapes, B=1 and B=128: the conv's input-gradient form with
     the four flag sets of the tail's reverse chain plus Cin != Cout cases
     (the split cases at B=1 and CONV_EDGE_CASES in all three families
     bit-identical over two runs, the masked input equal to the plain one),
     the weight/bias gradient (ReLU on load on and off, both layouts, two
     runs bit-identical, and the error against a float64 run; also at
     WGRAD_EDGE_CASES, where its tiling could break), the whole
     tail backward (dx0 and 8 parameter gradients) against the plain chain
     and against autograd of the plain forward. Same tolerance as phase 2.
  8. the training path at full width: UNetPRes neurons=16, nbf=101, seeded
     weights, hebb and oja, B=1, dropout 0, 8 steps (lr 1e-3, gamma 0.5,
     step_size 3) on synthetic tiles, eager on the card against the CPU
     port: losses within 5e-5, final parameters within 5e-4, eta exactly
     0.01, the trace non-zero and within 1e-4; the default path on the
     card, the step replayed from a CUDA graph, gives the eager run's 8
     losses, parameters and trace bit for bit. Then 8 steps at dropout 0.5
     (graph against eager from the same generator seed, bit for bit; the
     mask contract on one eager forward) and 4 steps at lanes=128 (graph
     against eager, bit for bit; trace (128, 101, 101)).
  9. proof of path: per eager training step 1 head launch, 9 tail forwards
     (36 conv launches), 9 tail backwards (36 dgrad and 36 wgrad launches);
     the graph run launches the same for 3 steps (2 warm-up steps and the
     capture) and nothing in its replays.
  10. times: dgrad, wgrad and the tail backward at the five shapes, B=1 and
     B=128, with plain, bound and the library call (F.conv2d with flipped
     weights; aten.convolution_backward for weight and bias, also under
     training_numerics: deterministic cuDNN, as the training step runs it); the B=1 step
     eager and as a graph (steps/s, device time; the eager step's idle
     share is derived from the replay's device time), lanes=128 samples/s,
     and the step's FLOP bound.

In the kernels' JSON, ms / plain_ms / bound_ms / library_ms / max_abs_err
belong to the entry's "shape"; keys ending in _b1 or _b128 give the same at
the other batch size, max_abs_err_all_shapes the largest over every case,
library_det_ms the library call under deterministic cuDNN, bmm_ms the
head's product alone as one torch.bmm call.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "results", "showdown_r5", "sd_torch_oja_250h.json.ckpt.pth")
CKPT_THRESHOLD, CKPT_IOU = 0.48954822531870534, 0.83125  # JAX package and torch reference on this checkpoint
B = 128
LEVELS = [(101, 16), (50, 32), (25, 64), (12, 128), (6, 256)]  # (H=W, C) of the neurons=16 track
TAILS_PER_CHUNK = {101: 2, 50: 2, 25: 2, 12: 2, 6: 1}  # a DownRes and an UpRes Middle per level; Middle at 6
HEAD_PER_CHUNK, TAIL_PER_CHUNK, CONV_PER_CHUNK = 1, 9, 36
COUNTED = ("plastic_head", "residual_tail", "conv3x3", "residual_tail_backward", "conv3x3_dgrad", "conv3x3_wgrad")
STEP_COUNTS = {"plastic_head": 1, "residual_tail": 9, "conv3x3": 36, "residual_tail_backward": 9,
               "conv3x3_dgrad": 36, "conv3x3_wgrad": 36}  # per eager training step
TRAIN_STEPS, TRAIN_LR, TRAIN_GAMMA, TRAIN_STEP_SIZE = 8, 1e-3, 0.5, 3
WGRAD_EDGE_CASES = [(3, 13, 7, 40, 24), (5, 6, 6, 256, 256), (2, 101, 101, 16, 16), (8, 101, 101, 16, 16),
                    (2, 9, 9, 6, 10)]  # (B, H, W, Cin, Cout) beyond the level shapes; phase 7
CONV_EDGE_CASES = [(5, 6, 6, 256, 256), (3, 12, 12, 128, 128), (3, 13, 7, 40, 24), (2, 9, 9, 6, 10),
                   (1, 13, 7, 40, 24), (1, 9, 9, 48, 10),
                   (2, 6, 6, 256, 256)]  # conv3x3 and dgrad in every family (tile, sample, split); phases 2 and 7


def check(ok: bool, msg: str) -> None:
    """A check that holds under python -O too."""
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


def peaks(name: str) -> tuple[float, float]:
    """(fp32 non-tensor FLOP/s, memory bytes/s) of the named H100 part."""
    if "PCIe" in name:
        return 51e12, 2.0e12
    if "NVL" in name:
        return 60e12, 3.9e12
    return 67e12, 3.35e12  # SXM


def bound_ms(flops: float, nbytes: float, pk: tuple[float, float]) -> tuple[float, str]:
    t_ops, t_bytes = flops / pk[0], nbytes / pk[1]
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def forward_flops(neurons: int, size: int = 101, nbf: int = 101) -> float:
    """Multiply-adds x 2 of one UNetPRes forward of one tile: every conv,
    the transposed convs (9 taps per input pixel), the 1x1 outconv and the
    head's (nbf, nbf) @ (nbf, nbf)."""
    sizes = [size]
    for _ in range(4):
        sizes.append(sizes[-1] // 2)
    ch = [neurons * 2 ** i for i in range(5)]

    def trunk(cin, c, s):  # entry conv + the four convs of the residual tail
        return 2 * 9 * s * s * (cin * c + 4 * c * c)

    f = sum(trunk(1 if i == 0 else ch[i - 1], ch[i], sizes[i]) for i in range(5))
    for k in range(4):  # UpRes from level k+1 to level k
        f += 2 * 9 * sizes[k + 1] ** 2 * ch[k + 1] * ch[k] + trunk(2 * ch[k], ch[k], sizes[k])
    return float(f + 2 * neurons * size * size + 2 * nbf ** 3)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> tuple[float, float]:
    """(median device ms of one call, host ms to issue one call). While the
    host issues the timed calls the device is kept busy (torch.cuda._sleep),
    so the host's time between launches does not count as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(int((2 * host_s + 0.005) * 2e9))  # ~2 GHz clock: cycles for twice the issue time
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in events])), host_s / reps * 1e3


def max_err(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max|got - ref|, tolerance 1e-4 * max(1, max|ref|))."""
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    err = float((got.double() - ref.double()).abs().max())
    return err, 1e-4 * max(1.0, float(ref.abs().max()))


class Errors:
    """max|kernel - plain| per kernel: over every case ("all") and at one (B, H) of the level shapes."""

    def __init__(self):
        self.worst: dict = {}

    def note(self, kname: str, err: float, b: int | None = None, hw: int | None = None) -> None:
        for key in ((kname, "all"), (kname, b, hw)):
            self.worst[key] = max(self.worst.get(key, 0.0), err)

    def at(self, kname: str, b: int, hw: int = 101) -> float:
        return self.worst[(kname, b, hw)]

    def all(self, kname: str) -> float:
        return self.worst[(kname, "all")]


# --------------------------------------------------------------------------- phase 1

def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {name} x{torch.cuda.device_count()}", flush=True)
    from plastic_unet_tpu_torch.ops import _build

    t0 = time.time()
    libs = _build.build_all()
    print(f"[1] built {sorted(libs)} in {time.time() - t0:.1f}s", flush=True)
    for lib in libs.values():
        for line in lib.with_suffix(".so.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"[1] ptxas {lib.name.split('.')[0]}: {line.strip()}")
    return smi, name


# --------------------------------------------------------------------------- phase 2

HEAD_NS, HEAD_BS = (16, 33, 101, 128), (1, 3, 128, 129)  # phase 2: every family of the head, forced


def phase_head(dev, errs):
    """The plastic head against its plain version: every tile family of
    head_plan (the plan's choice among them), forced where it applies, at
    HEAD_NS x HEAD_BS, each bit-identical over two runs and to the other
    families (one order of sums in all)."""
    from plastic_unet_tpu_torch.ops.plastic_head import FAMILIES, head_plan, plastic_head, plastic_head_plain

    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    n_cases = 0
    for n in HEAD_NS:
        w, eta = rnd(n, n, scale=0.01), torch.full((1,), 0.01, device=dev)
        alphas = (("free", rnd(n, n).abs() * 0.01), ("yoked", torch.full((1,), 0.02, device=dev)))
        for b in HEAD_BS:
            x, hebb = rnd(b, n, n), rnd(b, n, n, scale=0.1)
            plans = []
            for family in FAMILIES:
                try:
                    plans.append(head_plan(b, n, family=family))
                except ValueError:
                    pass
            for rule in ("hebb", "oja"):
                for alfa_type, alpha in alphas:
                    ref = plastic_head_plain(w, alpha, eta, x, hebb, rule=rule, alfa_type=alfa_type)
                    first = None
                    for plan in plans:
                        what = f"plastic_head B={b} n={n} {rule}/{alfa_type} {plan.family}"
                        got = plastic_head(w, alpha, eta, x, hebb, rule=rule, alfa_type=alfa_type, plan=plan)
                        for name, gt, rf in zip(("activ", "activout", "hebb"), got, ref):
                            e, tol = max_err(gt, rf)
                            check(e <= tol, f"{what} {name}: max|diff| {e:.3g} > {tol:.3g}")
                            errs.note("plastic_head", e, b if n == 101 else None, n)
                        again = plastic_head(w, alpha, eta, x, hebb, rule=rule, alfa_type=alfa_type, plan=plan)
                        check(all(bool(torch.equal(a, c)) for a, c in zip(got, again)),
                              f"{what}: two runs differ in some bit")
                        first = first or (plan.family, got)
                        check(all(bool(torch.equal(a, c)) for a, c in zip(got, first[1])),
                              f"{what}: differs in some bit from the {first[0]} family")
                        n_cases += 1
            print(f"[2] plastic_head B={b} n={n}: families {[p.family for p in plans]} (the plan takes "
                  f"{head_plan(b, n).family}), hebb/oja x free/yoked, each bit-identical over two runs and "
                  f"across families", flush=True)
    print(f"[2] plastic_head {n_cases} cases: max|diff| at n=101 B={B} {errs.at('plastic_head', B):.3g}, "
          f"B=1 {errs.at('plastic_head', 1):.3g}; over all {errs.all('plastic_head'):.3g}", flush=True)


def phase_kernels(dev):
    from plastic_unet_tpu_torch.ops.conv3x3 import FAMILIES, conv3x3, conv3x3_plain, conv3x3_plan, hwio
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail, residual_tail_plain

    g = torch.Generator(device=dev).manual_seed(0)
    errs = Errors()

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    phase_head(dev, errs)
    flag_sets = [(False, None, False), (True, None, False), (False, None, True),
                 (True, "plain", False), (False, "relu", True), (True, "relu", True)]
    cases = [(hw, c, c, flags) for hw, c in LEVELS for flags in flag_sets]
    cases += [(101, 8, 16, (True, "relu", True)), (50, 16, 32, (True, None, False)),
              (25, 40, 24, (False, "plain", True))]
    n_split = 0
    for b in (B, 1):  # small grids (B=1) split K across blocks
        for hw, cin, cout, (relu_in, res_mode, relu_out) in cases:
            xx = rnd(b, hw, hw, cin)
            wk = hwio(rnd(cout, cin, 3, 3, scale=1.0 / (3 * cin ** 0.5)))
            bias = rnd(cout, scale=0.1)
            res = None if res_mode is None else rnd(b, hw, hw, cout)
            kw = dict(relu_in=relu_in, relu_res=res_mode == "relu", relu_out=relu_out)
            got = conv3x3(xx, wk, bias, res, **kw)
            what = f"conv3x3 B={b} {hw}x{hw} {cin}->{cout} {kw} res={res_mode}"
            e, tol = max_err(got, conv3x3_plain(xx, wk, bias, res, **kw))
            check(e <= tol, f"{what}: max|diff| {e:.3g} > {tol:.3g}")
            if conv3x3_plan(b, hw, hw, cin, cout).family == "split":  # the arrival order must not show
                check(bool(torch.equal(got, conv3x3(xx, wk, bias, res, **kw))), f"{what}: two runs differ in some bit")
                n_split += 1
            errs.note("conv3x3", e, b, hw if cin == cout else None)
    print(f"[2] conv3x3 {2 * len(cases)} cases (B={B} and B=1; 5 level shapes x 6 flag sets, 3 Cin!=Cout; "
          f"{n_split} split across blocks, each bit-identical over two runs): max|diff| {errs.all('conv3x3'):.3g}",
          flush=True)
    # Where the tilings can break: samples per tile not dividing B, a non-square image with channels
    # that fill no slice, the scalar paths (Cin, Cout not multiples of 4), ranges of one and two
    # slices; each in every family.
    for b, h, w_, cin, cout in CONV_EDGE_CASES:
        plans = [conv3x3_plan(b, h, w_, cin, cout, family=f) for f in FAMILIES]
        for plan in plans:
            for relu_in, res_mode, relu_out in flag_sets:
                xx = rnd(b, h, w_, cin)
                wk = hwio(rnd(cout, cin, 3, 3, scale=1.0 / (3 * cin ** 0.5)))
                bias = rnd(cout, scale=0.1)
                res = None if res_mode is None else rnd(b, h, w_, cout)
                kw = dict(relu_in=relu_in, relu_res=res_mode == "relu", relu_out=relu_out)
                got = conv3x3(xx, wk, bias, res, plan=plan, **kw)
                what = f"conv3x3 B={b} {h}x{w_} {cin}->{cout} {plan.family} {kw} res={res_mode}"
                e, tol = max_err(got, conv3x3_plain(xx, wk, bias, res, **kw))
                check(e <= tol, f"{what}: max|diff| {e:.3g} > {tol:.3g}")
                check(bool(torch.equal(got, conv3x3(xx, wk, bias, res, plan=plan, **kw))),
                      f"{what}: two runs differ in some bit")
                errs.note("conv3x3", e, b, None)
        print(f"[2] conv3x3 B={b} {h}x{w_} {cin}->{cout}, 6 flag sets, each bit-identical over two runs, plans "
              f"{[tuple(p) for p in plans]}", flush=True)

    for b in (B, 1):
        for hw, c in LEVELS:
            args = [rnd(b, hw, hw, c)]
            for _ in range(4):
                args += [rnd(c, c, 3, 3, scale=0.5 / (3 * c ** 0.5)), rnd(c, scale=0.1)]
            e, tol = max_err(residual_tail(*args), residual_tail_plain(*args))
            check(e <= tol, f"residual_tail B={b} {hw}x{hw}x{c}: max|diff| {e:.3g} > {tol:.3g}")
            errs.note("residual_tail", e, b, hw)
    print(f"[2] residual_tail 5 level shapes, B={B} and B=1: max|diff| {errs.all('residual_tail'):.3g}", flush=True)
    torch.cuda.synchronize()
    return errs


# --------------------------------------------------------------------------- phase 3

def seeded_model(neurons: int, rule: str, seed: int):
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes

    return UNetPRes(neurons=neurons, nbf=101, rule=rule, generator=torch.Generator().manual_seed(seed))


def checkpoint_model():
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.utils.torch_interop import load_pth

    m = UNetPRes(neurons=8, nbf=101, rule="oja")
    m.load_state_dict(load_pth(CKPT, "model"), strict=True)
    return m


def phase_model(dev):
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((8, 101, 101, 1), dtype=np.float32))
    hebb = torch.from_numpy((rng.standard_normal((8, 101, 101)) * 0.05).astype(np.float32))
    for label, model in (("neurons=16 hebb", seeded_model(16, "hebb", 0)),
                         ("neurons=16 oja", seeded_model(16, "oja", 0)),
                         ("epoch-225 oja checkpoint", checkpoint_model())):
        cpu = copy.deepcopy(model).eval()
        card = model.to(dev).eval()
        with torch.inference_mode(), matmul_precision("parity"):
            got = card(x.to(dev), hebb.to(dev))
            ref = cpu(x, hebb)
        out = []
        for what, g_, r_ in zip(("activ", "activout", "hebb"), got, ref):
            g_ = g_.cpu()
            check(bool(torch.isfinite(g_).all()), f"{label}: non-finite {what}")
            e = float((g_ - r_).abs().max())
            if what != "activ":
                check(e <= 1e-4, f"{label}: {what} card vs CPU max|diff| {e:.3g} > 1e-4")
            out.append(f"{what} {e:.3g}")
        print(f"[3] {label} B=8 card vs CPU port: " + ", ".join(out), flush=True)


# --------------------------------------------------------------------------- phases 4 and 5

def counted() -> dict:
    """name -> the wrapper that carries the launch count."""
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_dgrad
    from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad
    from plastic_unet_tpu_torch.ops.plastic_head import plastic_head
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail, residual_tail_backward

    fns = (plastic_head, residual_tail, conv3x3, residual_tail_backward, conv3x3_dgrad, conv3x3_wgrad)
    return dict(zip(COUNTED, fns))


def reset_counts():
    for fn in counted().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counted().items()}


def expect_counts(label: str, chunks: int) -> dict:
    """Serving: forward launches per chunk, and no backward launch at all."""
    counts = read_counts()
    want = dict.fromkeys(COUNTED, 0)
    want.update({"plastic_head": HEAD_PER_CHUNK * chunks, "residual_tail": TAIL_PER_CHUNK * chunks,
                 "conv3x3": CONV_PER_CHUNK * chunks})
    check(counts == want, f"{label}: launches {counts} != {want} for {chunks} chunk(s)")
    print(f"[5] {label}: launches {({k: v for k, v in counts.items() if v})} ({chunks} chunk(s))", flush=True)
    return counts


def phase_serving(dev):
    from plastic_unet_tpu_torch.data.synthetic import synthetic_split
    from plastic_unet_tpu_torch.eval.evaluate import predict_masks, score_model_best_iou
    from plastic_unet_tpu_torch.ops.rle import rle_decode
    from plastic_unet_tpu_torch.submit.inference import predict, threshold_as_f32
    from plastic_unet_tpu_torch.submit.server import MaskPredictor

    xt, xv, _, yv = synthetic_split(256, 64, size=101, seed=77, hard=True)
    xv = np.transpose(xv, (0, 2, 3, 1))
    tiles = xt[:, 0]  # (256, 101, 101)

    pred = MaskPredictor.from_pth(CKPT, neurons=8, rule="oja", key="model").warmup()
    reset_counts()
    thr, iou = score_model_best_iou(pred.model, xv, yv)
    expect_counts("score_model_best_iou, 64 tiles", 1)
    print(f"[4] epoch-225 checkpoint on the 64 hard validation tiles: best threshold {thr!r}, "
          f"best IoU {iou!r}", flush=True)
    check(abs(thr - CKPT_THRESHOLD) <= 1e-6, f"best threshold {thr} != {CKPT_THRESHOLD}")
    check(abs(iou - CKPT_IOU) <= 1 / 640, f"best IoU {iou} != {CKPT_IOU} +- 1/640")

    cpu_model = checkpoint_model()
    t32 = float(threshold_as_f32(thr))
    for n in (1, 37, 128):
        reset_counts()
        rles = pred.predict_rle(tiles[:n], threshold=thr)
        expect_counts(f"predict_rle {n} tiles", 1)
        check(len(rles) == n and all(isinstance(r, str) for r in rles), f"predict_rle {n}: bad result")
        if n == 37:  # hold the request against the CPU port on the same tiles
            card = pred.predict_probs(tiles[:n]).cpu()
            ref = predict_masks(cpu_model, tiles[:n, :, :, None], chunk=n, device="cpu")
            e = float((card - ref).abs().max())
            check(e <= 1e-4, f"37-tile request card vs CPU max|diff| {e:.3g} > 1e-4")
            far = (ref - t32).abs() > 1e-4
            masks = np.stack([rle_decode(r, (101, 101)) for r in rles]).astype(bool)
            check(bool((torch.from_numpy(masks)[far] == (ref > t32)[far]).all()),
                  "37-tile RLE masks disagree with the CPU port away from the threshold")
            print(f"[4] request of 37 tiles: card vs CPU port max|diff| {e:.3g}; RLE masks agree", flush=True)
        print(f"[4] request of {n} tiles -> {len(rles)} RLE strings, {sum(map(bool, rles))} non-empty", flush=True)

    with tempfile.TemporaryDirectory() as out_dir:
        ids = [f"syn{i:04d}" for i in range(256)]
        rp = {"out_dir": out_dir, "img_height": 101, "img_width": 101, "img_chan": 1,
              "mask_threshold": thr, "subm_file": "submission.csv"}
        reset_counts()
        path = predict(pred.model, ids, tiles, rp)
        expect_counts("predict 256 tiles -> submission.csv", 2)
        lines = open(path).read().splitlines()
        check(lines[0] == "id,rle_mask" and len(lines) == 257, "submission.csv: bad header or row count")
        check([ln.split(",")[0] for ln in lines[1:]] == ids, "submission.csv: ids out of order")
        want = pred.predict_probs(tiles[:3]).cpu() > t32
        for i in range(3):
            got = rle_decode(lines[1 + i].split(",", 1)[1], (101, 101)).astype(bool)
            check(bool((torch.from_numpy(got) == want[i]).all()), f"submission.csv row {i} != predicted mask")
        print(f"[4] submission.csv for 256 tiles: {len(lines) - 1} rows", flush=True)

    full = MaskPredictor(seeded_model(16, "oja", 0), threshold=0.5)
    full.warmup()
    torch.cuda.synchronize()
    reset_counts()
    probs = full.predict_probs(tiles[:128])
    torch.cuda.synchronize()
    main_counts = expect_counts("MAIN PATH: neurons=16 predictor, 128-tile request", 1)
    check(tuple(probs.shape) == (128, 101, 101) and bool(torch.isfinite(probs).all())
          and float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0, "neurons=16 request: bad probabilities")
    ref = predict_masks(seeded_model(16, "oja", 0), tiles[:4, :, :, None], chunk=4, device="cpu")
    e = float((probs[:4].cpu() - ref).abs().max())
    check(e <= 1e-4, f"neurons=16 request card vs CPU port max|diff| {e:.3g} > 1e-4")
    print(f"[4] neurons=16 predictor, 128-tile request: probabilities in [{float(probs.min()):.4f}, "
          f"{float(probs.max()):.4f}], first 4 tiles vs CPU port max|diff| {e:.3g}", flush=True)
    return main_counts, full


# --------------------------------------------------------------------------- phase 7

def tail_operands(rnd, b, hw, c):
    """x0, the four (w, b) pairs in torch layout, and an output gradient."""
    args = [rnd(b, hw, hw, c)]
    for _ in range(4):
        args += [rnd(c, c, 3, 3, scale=0.5 / (3 * c ** 0.5)), rnd(c, scale=0.1)]
    return args, rnd(b, hw, hw, c)


def tail_saved(args):
    """What the tail's forward keeps, from the plain convs: x0, pre11, x1, pre21, out."""
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_plain, hwio

    x0, w11, b11, w12, b12, w21, b21, w22, b22 = args
    pre11 = conv3x3_plain(x0, hwio(w11), b11, relu_in=True)
    x1 = conv3x3_plain(pre11, hwio(w12), b12, x0, relu_in=True, relu_res=True)
    pre21 = conv3x3_plain(x1, hwio(w21), b21, relu_in=True)
    out = conv3x3_plain(pre21, hwio(w22), b22, x1, relu_in=True, relu_res=True, relu_out=True)
    return x0, pre11, x1, pre21, out


def phase_backward_kernels(dev):
    from plastic_unet_tpu_torch.ops.conv3x3 import FAMILIES, conv3x3_dgrad, conv3x3_dgrad_plain, conv3x3_plan, hwio
    from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad, conv3x3_wgrad_plain, wgrad_plan
    from plastic_unet_tpu_torch.ops.residual_tail import (residual_tail_backward, residual_tail_backward_plain,
                                                          residual_tail_plain)

    g = torch.Generator(device=dev).manual_seed(7)
    errs = Errors()
    rel = dict.fromkeys(COUNTED[3:], 0.0)  # the error over max(1, max|ref|): what the tolerance 1e-4 bounds

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def hold(kname, b, hw, what, got, ref):
        e, tol = max_err(got, ref)
        check(e <= tol, f"{kname} B={b} {what}: max|diff| {e:.3g} > {tol:.3g}")
        errs.note(kname, e, b, hw)
        rel[kname] = max(rel[kname], e / max(1.0, float(ref.abs().max())))

    # (in_gate, residual, gate): the four lines of the reverse chain, and the bare pass
    dgrad_flags = [(True, False, True), (False, True, True), (False, False, True), (False, False, False)]
    n_dgrad = n_wgrad = n_split = 0
    for b in (1, B):
        cases = [(hw, c, c) for hw, c in LEVELS] + [(50, 16, 32), (25, 40, 24)]
        for hw, cin, cout in cases:
            k = hwio(rnd(cout, cin, 3, 3, scale=1.0 / (3 * cin ** 0.5)))  # the forward's (3,3,cin,cout)
            lvl = hw if cin == cout else None  # the error book keeps the level shapes apart
            d, x = rnd(b, hw, hw, cout), rnd(b, hw, hw, cin)
            in_gate, res, gate = rnd(b, hw, hw, cout), rnd(b, hw, hw, cin), rnd(b, hw, hw, cin)
            split = conv3x3_plan(b, hw, hw, cout, cin, True).family == "split"
            for f_in, f_res, f_gate in dgrad_flags:
                kw = dict(gate=gate if f_gate else None, in_gate=in_gate if f_in else None)
                got, masked = conv3x3_dgrad(d, k, res if f_res else None, **kw)
                ref, masked_ref = conv3x3_dgrad_plain(d, k, res if f_res else None, **kw)
                what = f"{hw}x{hw} {cout}->{cin} in_gate={f_in} res={f_res} gate={f_gate}"
                hold("conv3x3_dgrad", b, lvl, what, got, ref)
                check((masked is None) == (masked_ref is None), f"conv3x3_dgrad {what}: masked input")
                if masked is not None:
                    check(bool(torch.equal(masked, masked_ref)), f"conv3x3_dgrad {what}: masked input differs")
                if split:  # the arrival order must not show
                    again, masked2 = conv3x3_dgrad(d, k, res if f_res else None, **kw)
                    check(bool(torch.equal(got, again)) and (masked is None or bool(torch.equal(masked, masked2))),
                          f"conv3x3_dgrad B={b} {what}: two runs differ in some bit")
                    n_split += 1
                n_dgrad += 1
            for relu_in in (False, True):
                for layout in ("hwio", "oihw"):
                    dw, db = conv3x3_wgrad(x, d, relu_in=relu_in, layout=layout)
                    dw_ref, db_ref = conv3x3_wgrad_plain(x, d, relu_in=relu_in, layout=layout)
                    what = f"{hw}x{hw} {cin}->{cout} relu_in={relu_in} {layout}"
                    hold("conv3x3_wgrad", b, lvl, what + " dW", dw, dw_ref)
                    hold("conv3x3_wgrad", b, lvl, what + " db", db, db_ref)
                    dw2, db2 = conv3x3_wgrad(x, d, relu_in=relu_in, layout=layout)
                    check(bool(torch.equal(dw, dw2)) and bool(torch.equal(db, db2)),
                          f"conv3x3_wgrad {what}: two runs differ in some bit")
                    n_wgrad += 1
            if (hw, cin) == LEVELS[0]:
                dw, _ = conv3x3_wgrad(x, d)
                dw_plain, _ = conv3x3_wgrad_plain(x, d)
                dw64, _ = conv3x3_wgrad_plain(x.double(), d.double())
                print(f"[7] conv3x3_wgrad B={b} {hw}x{hw}x{cin}: {b * hw * hw} terms per sum, plan "
                      f"{tuple(wgrad_plan(b, hw, hw, cin, cout))}; against float64 "
                      f"max|diff| kernel {float((dw.double() - dw64).abs().max()):.3g}, plain "
                      f"{float((dw_plain.double() - dw64).abs().max()):.3g} (max|ref| {float(dw64.abs().max()):.3g})",
                      flush=True)
    for b, h, w, cin, cout in CONV_EDGE_CASES:  # the dgrad form where the tilings can break, every family
        k = hwio(rnd(cout, cin, 3, 3, scale=1.0 / (3 * cin ** 0.5)))
        d, in_gate = rnd(b, h, w, cout), rnd(b, h, w, cout)
        res, gate = rnd(b, h, w, cin), rnd(b, h, w, cin)
        for family in FAMILIES:
            plan = conv3x3_plan(b, h, w, cout, cin, True, family=family)
            for f_in, f_res, f_gate in dgrad_flags:
                kw = dict(gate=gate if f_gate else None, in_gate=in_gate if f_in else None)
                got, masked = conv3x3_dgrad(d, k, res if f_res else None, plan=plan, **kw)
                ref, masked_ref = conv3x3_dgrad_plain(d, k, res if f_res else None, **kw)
                what = f"B={b} {h}x{w} {cout}->{cin} {family} in_gate={f_in} res={f_res} gate={f_gate}"
                hold("conv3x3_dgrad", b, None, what, got, ref)
                again, masked2 = conv3x3_dgrad(d, k, res if f_res else None, plan=plan, **kw)
                check(bool(torch.equal(got, again)), f"conv3x3_dgrad {what}: two runs differ in some bit")
                if masked is not None:
                    check(bool(torch.equal(masked, masked_ref)) and bool(torch.equal(masked, masked2)),
                          f"conv3x3_dgrad {what}: masked input differs")
                n_dgrad += 1
        print(f"[7] conv3x3_dgrad B={b} {h}x{w} {cout}->{cin}, 4 flag sets, every family "
              f"({conv3x3_plan(b, h, w, cout, cin, True)[0]} by the plan), each bit-identical over two runs",
              flush=True)
    # Where the wgrad tiling can break: a non-square image with channels that fill no tile
    # (40 -> 24), samples per tile not dividing B, H not a multiple of the tile's rows (B=8: 3
    # rows; B=2 takes 202 chunks), and the 4-byte staging path (Cin, Cout not multiples of 4).
    for b, h, w, cin, cout in WGRAD_EDGE_CASES:
        x, d = rnd(b, h, w, cin), rnd(b, h, w, cout)
        for relu_in in (False, True):
            for layout in ("hwio", "oihw"):
                dw, db = conv3x3_wgrad(x, d, relu_in=relu_in, layout=layout)
                dw_ref, db_ref = conv3x3_wgrad_plain(x, d, relu_in=relu_in, layout=layout)
                what = f"B={b} {h}x{w} {cin}->{cout} relu_in={relu_in} {layout}"
                hold("conv3x3_wgrad", b, None, what + " dW", dw, dw_ref)
                hold("conv3x3_wgrad", b, None, what + " db", db, db_ref)
                dw2, db2 = conv3x3_wgrad(x, d, relu_in=relu_in, layout=layout)
                check(bool(torch.equal(dw, dw2)) and bool(torch.equal(db, db2)),
                      f"conv3x3_wgrad {what}: two runs differ in some bit")
                n_wgrad += 1
        print(f"[7] conv3x3_wgrad B={b} {h}x{w} {cin}->{cout}: plan {tuple(wgrad_plan(b, h, w, cin, cout))} "
              f"(ci_t, co_t, rows, samples, tiles, chunks, smem)", flush=True)
    print(f"[7] conv3x3_dgrad {n_dgrad} cases (B=1 and B={B}; 5 level shapes + 2 Cin!=Cout; "
          f"{len(CONV_EDGE_CASES)} edge cases in every family; 4 flag sets; {n_split} split across blocks at "
          f"the level shapes, each bit-identical over two runs): "
          f"max|diff| {errs.all('conv3x3_dgrad'):.3g}, over max(1, max|ref|) {rel['conv3x3_dgrad']:.3g}", flush=True)
    print(f"[7] conv3x3_wgrad {n_wgrad} cases (relu_in x layout; level shapes, 2 Cin!=Cout and "
          f"{len(WGRAD_EDGE_CASES)} edge cases), each bit-identical over two runs: "
          f"max|diff| {errs.all('conv3x3_wgrad'):.3g} (at B={B}, 101x101x16: {errs.at('conv3x3_wgrad', B):.3g}; at B=1 "
          f"there: {errs.at('conv3x3_wgrad', 1):.3g}), over max(1, max|ref|) {rel['conv3x3_wgrad']:.3g}", flush=True)

    names = ["dx0"] + ["d" + n for n in "w11 b11 w12 b12 w21 b21 w22 b22".split()]
    for b in (1, B):
        for hw, c in LEVELS:
            args, gout = tail_operands(rnd, b, hw, c)
            saved = tail_saved(args)
            ws = args[1::2]
            got = residual_tail_backward(gout, *saved, *(hwio(w) for w in ws))
            ref = residual_tail_backward_plain(gout, *saved, *ws)
            leaves = [a.clone().requires_grad_() for a in args]
            auto = torch.autograd.grad((residual_tail_plain(*leaves) * gout).sum(), leaves)
            for nm, gt, rf, au in zip(names, got, ref, auto):
                hold("residual_tail_backward", b, hw, f"{hw}x{hw}x{c} {nm} vs plain chain", gt, rf)
                hold("residual_tail_backward", b, hw, f"{hw}x{hw}x{c} {nm} vs autograd of the plain forward", gt, au)
    print(f"[7] residual_tail_backward 5 level shapes x B=1, B={B}, dx0 and 8 parameter gradients against the "
          f"plain chain and autograd of the plain forward: max|diff| {errs.all('residual_tail_backward'):.3g}, "
          f"over max(1, max|ref|) {rel['residual_tail_backward']:.3g}", flush=True)
    torch.cuda.synchronize()
    return errs


# --------------------------------------------------------------------------- phase 6

def phase_times(dev, name, full, main_counts, errs):
    import torch.nn.functional as F

    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, hwio
    from plastic_unet_tpu_torch.ops.plastic_head import head_plan, plastic_head, plastic_head_plain
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail, residual_tail_plain
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    pk = peaks(name)
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def cudnn_conv(x, w, b):
        return F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)

    def cudnn_tail(x0, w11, b11, w12, b12, w21, b21, w22, b22):
        h1 = torch.relu(x0)
        x1 = cudnn_conv(torch.relu(cudnn_conv(h1, w11, b11)), w12, b12) + h1
        h2 = torch.relu(x1)
        return torch.relu(cudnn_conv(torch.relu(cudnn_conv(h2, w21, b21)), w22, b22) + h2)

    table = {}  # (kernel, B, H) -> its times and bound
    with torch.inference_mode(), matmul_precision("parity"):
        n = 101
        w, a, eta = rnd(n, n, scale=0.01), rnd(n, n).abs() * 0.01, torch.full((1,), 0.01, device=dev)
        for b in (B, 1):  # the serving chunk, and the training step's B=1
            x, hebb = rnd(b, n, n), rnd(b, n, n, scale=0.1)
            eff = w + a * hebb  # the head's product alone, as one cuBLAS call: the yardstick bmm_ms
            head = dict(ms=time_ms(lambda: plastic_head(w, a, eta, x, hebb, rule="oja"))[0],
                        plain_ms=time_ms(lambda: plastic_head_plain(w, a, eta, x, hebb, rule="oja"))[0],
                        bmm_ms=time_ms(lambda: torch.bmm(x, eff))[0], cudnn_ms=None)
            head["bound_ms"], head["bound_by"] = bound_ms(
                2 * b * n ** 3 + 8 * b * n * n, 4 * (5 * b * n * n + 2 * n * n + 1), pk)
            table[("plastic_head", b, n)] = head
            print(f"[6] plastic_head B={b} nbf={n} ({head_plan(b, n).family}): kernel {head['ms']:.4f} ms, plain "
                  f"{head['plain_ms']:.4f} ms, torch.bmm of the product alone {head['bmm_ms']:.4f} ms, bound "
                  f"{head['bound_ms']:.5f} ms ({head['bound_by']}), {head['bound_ms'] / head['ms']:.1%} of bound",
                  flush=True)

            for hw, c in LEVELS:
                xx = rnd(b, hw, hw, c)
                wt = [rnd(c, c, 3, 3, scale=0.5 / (3 * c ** 0.5)) for _ in range(4)]
                bs = [rnd(c, scale=0.1) for _ in range(4)]
                k0 = hwio(wt[0])
                conv = dict(
                    ms=time_ms(lambda: conv3x3(xx, k0, bs[0]))[0],
                    plain_ms=time_ms(lambda: conv3x3_plain(xx, k0, bs[0]))[0],
                    cudnn_ms=time_ms(lambda: cudnn_conv(xx, wt[0], bs[0]))[0],  # one F.conv2d call
                )
                conv["bound_ms"], conv["bound_by"] = bound_ms(
                    2 * 9 * c * c * b * hw * hw, 4 * (2 * b * hw * hw * c + 9 * c * c + c), pk)
                targs = [xx] + [t for pair in zip(wt, bs) for t in pair]
                tail = dict(
                    ms=time_ms(lambda: residual_tail(*targs))[0],
                    plain_ms=time_ms(lambda: residual_tail_plain(*targs))[0],
                    cudnn_ms=time_ms(lambda: cudnn_tail(*targs))[0],  # four F.conv2d calls + elementwise
                )
                tail["bound_ms"], tail["bound_by"] = bound_ms(
                    4 * 2 * 9 * c * c * b * hw * hw, 4 * (2 * b * hw * hw * c + 4 * (9 * c * c + c)), pk)
                for kname, d in (("conv3x3", conv), ("residual_tail", tail)):
                    print(f"[6] {kname} {hw}x{hw}x{c} B={b}: kernel {d['ms']:.4f} ms, plain {d['plain_ms']:.4f} ms, "
                          f"cuDNN {d['cudnn_ms']:.4f} ms, bound {d['bound_ms']:.5f} ms ({d['bound_by']}), "
                          f"{d['bound_ms'] / d['ms']:.1%} of bound", flush=True)
                    table[(kname, b, hw)] = d
    tails_ms = sum(TAILS_PER_CHUNK[hw] * table[("residual_tail", B, hw)]["ms"] for hw, _ in LEVELS)

    xs = np.random.default_rng(2).random((4 * B, 101, 101), dtype=np.float32)
    full.predict_probs(xs[:B])
    torch.cuda.synchronize()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        full.predict_probs(xs)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    sec = float(np.median(secs))
    chunk_ms = sec / 4 * 1e3
    xc = torch.from_numpy(xs[:B, :, :, None]).to(dev)
    h0 = full.model.initial_zero_hebb(B, device=dev)
    with torch.inference_mode(), matmul_precision("parity"):
        fwd_ms, fwd_host_ms = time_ms(lambda: full.model(xc, h0))
    fb, _ = bound_ms(forward_flops(16) * B, 0.0, pk)
    print(f"[6] serving neurons=16 chunk {B}: {4 * B / sec:.1f} tiles/s ({chunk_ms:.3f} ms per chunk, host clock, "
          f"4 chunks); forward device time {fwd_ms:.3f} ms per chunk (host issue {fwd_host_ms:.3f} ms), "
          f"device idle share {max(0.0, 1 - fwd_ms / chunk_ms):.1%}; residual tails "
          f"{tails_ms:.3f} ms + plastic head {table[('plastic_head', B, 101)]['ms']:.4f} ms of it; "
          f"forward bound {forward_flops(16) / 1e9:.3f} GFLOP/tile -> {fb:.3f} ms per chunk at the fp32 peak",
          flush=True)

    sources = {
        "plastic_head": ("plastic_unet_tpu_torch/csrc/plastic_head.cu",
                         "plastic_unet_tpu/ops/pallas_plastic.py:40"),
        "conv3x3": ("plastic_unet_tpu_torch/csrc/conv3x3.cu", "plastic_unet_tpu/ops/pallas_conv.py:81"),
        "residual_tail": ("plastic_unet_tpu_torch/ops/residual_tail.py",
                          "plastic_unet_tpu/ops/pallas_trunk.py:215"),
    }
    kernels = []
    for kname, (src, replaces) in sources.items():
        many, one = table[(kname, B, 101)], table[(kname, 1, 101)]
        # library_ms: one PyTorch call computing the same function, where one exists (conv3x3's
        # F.conv2d); the tail's cuDNN time is four calls, so it is reported as cudnn_ms only.
        entry = {"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": main_counts[kname], "max_abs_err": errs.at(kname, B), "ms": many["ms"],
                 "plain_ms": many["plain_ms"], "bound_ms": many["bound_ms"], "bound_by": many["bound_by"],
                 "library_ms": many["cudnn_ms"] if kname == "conv3x3" else None,
                 "cudnn_ms": many["cudnn_ms"], "shape": f"B={B} nbf=101 oja free" if kname == "plastic_head" else f"B={B} 101x101x16"}
        # the same at B=1, as the training step runs it
        entry.update({f"{k}_b1": one[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "cudnn_ms")})
        entry.update({"library_ms_b1": one["cudnn_ms"] if kname == "conv3x3" else None,
                      "max_abs_err_b1": errs.at(kname, 1), "max_abs_err_all_shapes": errs.all(kname)})
        if kname == "plastic_head":
            entry.update({"bmm_ms": many["bmm_ms"], "bmm_ms_b1": one["bmm_ms"]})
        kernels.append(entry)
    return kernels, table


# --------------------------------------------------------------------------- phases 8 and 9

def train_stream(steps: int, lanes: int, seed: int):
    """(X (S, B, 101, 101, 1), Y (S, B, 101, 101)) of synthetic tiles, on the CPU."""
    from plastic_unet_tpu_torch.data.synthetic import synthetic_tiles
    from plastic_unet_tpu_torch.train.loop import reshape_stream

    x, y = synthetic_tiles(steps * lanes, size=101, seed=seed)
    x = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1))))
    return reshape_stream(x, torch.from_numpy(y[:, 0]), lanes)


def train_run(rule, device, X, Y, *, graph, dropout=0.0, lanes=1, drop_seed=None):
    """A seeded full-width model trained over the stream; (state, losses)."""
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.train.loop import create_train_state, make_epoch_fn

    model = UNetPRes(neurons=16, nbf=101, rule=rule, dropout_ratio=dropout,
                     generator=torch.Generator().manual_seed(3))
    gen = None if drop_seed is None else torch.Generator(device=device).manual_seed(drop_seed)
    state = create_train_state(model, TRAIN_LR, TRAIN_GAMMA, TRAIN_STEP_SIZE, lanes=lanes, generator=gen,
                               device=device)
    return make_epoch_fn(graph=graph)(state, X.to(device), Y.to(device))


def phase_training(dev):

    X, Y = train_stream(TRAIN_STEPS, 1, seed=21)
    step_counts = None
    for rule in ("hebb", "oja"):
        t0 = time.time()
        cpu_state, cpu_losses = train_run(rule, "cpu", X, Y, graph=False)
        t_cpu = time.time() - t0
        reset_counts()
        state, losses = train_run(rule, dev, X, Y, graph=False)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: v * TRAIN_STEPS for k, v in STEP_COUNTS.items()}
        check(counts == want, f"{rule}: launches of {TRAIN_STEPS} eager training steps {counts} != {want}")
        step_counts = {k: v // TRAIN_STEPS for k, v in counts.items()}
        print(f"[9] MAIN PATH (training): neurons=16 {rule}, B=1, {TRAIN_STEPS} eager steps: launches per step "
              f"{step_counts}", flush=True)
        check(bool(torch.isfinite(losses).all()) and tuple(losses.shape) == (TRAIN_STEPS,), f"{rule}: bad losses")
        e_loss = float((losses.cpu() - cpu_losses).abs().max())
        check(e_loss <= 5e-5, f"{rule}: per-step losses card vs CPU port max|diff| {e_loss:.3g} > 5e-5")
        e_par = max(float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(state.model.parameters(), cpu_state.model.parameters()))
        check(e_par <= 5e-4, f"{rule}: final parameters card vs CPU port max|diff| {e_par:.3g} > 5e-4")
        check(float(state.model.eta.detach()) == float(np.float32(0.01)), f"{rule}: eta moved off 0.01")
        e_tr = float((state.hebb.cpu() - cpu_state.hebb).abs().max())
        check(float(state.hebb.abs().max()) > 0 and e_tr <= 1e-4, f"{rule}: trace card vs CPU max|diff| {e_tr:.3g}")
        check(state.step == TRAIN_STEPS, f"{rule}: step counter {state.step}")
        print(f"[8] neurons=16 {rule} B=1, {TRAIN_STEPS} steps, eager on the card vs the CPU port ({t_cpu:.1f}s): "
              f"losses {[round(v, 6) for v in losses.tolist()]}, max|diff| losses {e_loss:.3g}, parameters "
              f"{e_par:.3g}, trace {e_tr:.3g}; eta == 0.01", flush=True)

        # The default on the card: the step captured into a CUDA graph. Its body runs three times
        # (two warm-up steps and the capture); the replays go through no wrapper.
        reset_counts()
        g_state, g_losses = train_run(rule, dev, X, Y, graph=None)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: 3 * v for k, v in STEP_COUNTS.items()}
        check(counts == want, f"{rule}: launches of the graph run {counts} != {want} (warm-up 2 + capture 1)")
        check(bool(torch.equal(g_losses, losses)), f"{rule}: graph losses differ from the eager ones: "
              f"{(g_losses - losses).abs().max().item():.3g}")
        same = all(bool(torch.equal(a, b)) for a, b in zip(g_state.model.parameters(), state.model.parameters()))
        check(same and bool(torch.equal(g_state.hebb, state.hebb)), f"{rule}: graph parameters or trace differ")
        print(f"[8] neurons=16 {rule} B=1, the default path (CUDA graph): {TRAIN_STEPS} losses, final parameters and "
              f"trace equal the eager ones bit for bit; the kernels were launched for 3 steps (2 warm-up + capture) "
              f"and by no replay", flush=True)

    # dropout 0.5: the graph step with a registered generator against the eager step from the same
    # seed (the same masks, so the same bits), then the mask contract on one eager forward
    _, e_losses = train_run("oja", dev, X, Y, graph=False, dropout=0.5, drop_seed=5)
    state, losses = train_run("oja", dev, X, Y, graph=None, dropout=0.5, drop_seed=5)
    check(bool(torch.isfinite(losses).all()), "dropout 0.5: non-finite losses")
    check(bool(torch.equal(losses, e_losses)), f"dropout 0.5: graph losses differ from the eager ones: "
          f"{(losses - e_losses).abs().max().item():.3g}")
    seen = {}
    hooks = [m.register_forward_pre_hook(lambda mod, args, k=k: seen.__setitem__(k, args[0].detach()))
             for k, m in (("conv2", state.model.conv2), ("conv3", state.model.conv3))]
    xb = X[:4, 0].to(dev)
    with torch.no_grad():
        state.model.train()(xb, state.model.initial_zero_hebb(4, device=dev), generator=state.generator)
        pooled = torch.nn.functional.max_pool2d(state.model.conv1(xb).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    for h in hooks:
        h.remove()
    fracs = {}
    for key in seen:
        t = seen[key]
        planes = t.permute(0, 3, 1, 2).reshape(t.shape[0] * t.shape[3], -1)
        dropped = (planes == 0).all(dim=1)
        check(0 < int(dropped.sum()) < planes.shape[0], f"dropout {key}: no plane dropped, or all")
        fracs[key] = float(dropped.float().mean())
    alive = seen["conv2"] != 0
    check(bool(torch.allclose(seen["conv2"][alive], (pooled / 0.75)[alive], rtol=1e-6, atol=1e-6)),
          "dropout: the first pool's survivors are not scaled by 1/(1 - rate/2)")
    print(f"[8] dropout 0.5, graph step, {TRAIN_STEPS} steps: losses finite ({float(losses.min()):.4f}.."
          f"{float(losses.max()):.4f}) and equal to the eager step's from the same seed bit for bit; whole (sample, channel) planes dropped: {fracs['conv2']:.2f} of them at "
          f"the first pool (rate 0.25), {fracs['conv3']:.2f} at the second (rate 0.5)", flush=True)

    Xl, Yl = train_stream(4, B, seed=22)
    e_state, e_losses = train_run("oja", dev, Xl, Yl, graph=False, lanes=B)
    state, losses = train_run("oja", dev, Xl, Yl, graph=None, lanes=B)
    check(bool(torch.isfinite(losses).all()) and tuple(state.hebb.shape) == (B, 101, 101)
          and bool(torch.isfinite(state.hebb).all()), f"lanes={B}: bad losses or trace")
    check(bool(torch.equal(losses, e_losses)) and bool(torch.equal(state.hebb, e_state.hebb)),
          f"lanes={B}: graph losses or trace differ from the eager ones: {(losses - e_losses).abs().max().item():.3g}")
    print(f"[8] lanes={B}, 4 steps, the default path (CUDA graph): losses {[round(v, 5) for v in losses.tolist()]}, "
          f"trace {tuple(state.hebb.shape)}; both equal the eager run's bit for bit", flush=True)
    return step_counts


# --------------------------------------------------------------------------- phase 10

def backward_flops(neurons: int, size: int = 101, nbf: int = 101) -> float:
    """Counted as forward_flops counts: every conv's backward is an input
    gradient and a weight gradient of the forward's size each, except that
    the first conv's input (the image) takes no gradient; the head's
    backward is two (nbf, nbf) products for the forward's one."""
    return 2 * forward_flops(neurons, size, nbf) - 2 * 9 * size * size * neurons


def phase_training_times(dev, name, errs, step_counts, fwd_table):
    import torch.nn.functional as F

    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_dgrad, conv3x3_dgrad_plain, hwio
    from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad, conv3x3_wgrad_plain
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail_backward, residual_tail_backward_plain
    from plastic_unet_tpu_torch.train.loop import GraphTrainStep, create_train_state, make_train_step
    from plastic_unet_tpu_torch.utils.precision import matmul_precision, training_numerics

    pk = peaks(name)
    g = torch.Generator(device=dev).manual_seed(11)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    table = {}
    with torch.no_grad(), matmul_precision("parity"):
        for b in (1, B):
            for hw, c in LEVELS:
                args, gout = tail_operands(rnd, b, hw, c)
                saved = tail_saved(args)
                ws = args[1::2]
                ks = [hwio(w) for w in ws]
                x, d, gate = saved[0], gout, saved[1]
                w_t = ws[0].flip(2, 3).transpose(0, 1).contiguous()  # the transposed conv's (Cin, Cout, 3, 3)
                x_nchw, d_nchw = x.permute(0, 3, 1, 2), d.permute(0, 3, 1, 2)
                act = 4 * b * hw * hw * c  # bytes of one activation
                conv_flops = 2 * 9 * c * c * b * hw * hw
                dgrad = dict(
                    ms=time_ms(lambda: conv3x3_dgrad(d, ks[0], gate=gate))[0],
                    plain_ms=time_ms(lambda: conv3x3_dgrad_plain(d, ks[0], gate=gate))[0],
                    # one F.conv2d with the flipped weights (without the mask)
                    library_ms=time_ms(lambda: F.conv2d(d_nchw, w_t, None, padding=1))[0],
                )
                dgrad["bound_ms"], dgrad["bound_by"] = bound_ms(conv_flops, 3 * act + 4 * 9 * c * c, pk)
                wgrad = dict(
                    ms=time_ms(lambda: conv3x3_wgrad(x, d, layout="oihw"))[0],
                    plain_ms=time_ms(lambda: conv3x3_wgrad_plain(x, d, layout="oihw"))[0],
                    # one aten.convolution_backward asked for the weight and bias gradients only
                    library_ms=time_ms(lambda: torch.ops.aten.convolution_backward(
                        d_nchw, x_nchw, ws[0], [c], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                        [False, True, True]))[0],
                )
                with training_numerics():  # the algorithm the training step's own cuDNN layers get
                    wgrad["library_det_ms"] = time_ms(lambda: torch.ops.aten.convolution_backward(
                        d_nchw, x_nchw, ws[0], [c], [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                        [False, True, True]))[0]
                wgrad["bound_ms"], wgrad["bound_by"] = bound_ms(conv_flops, 2 * act + 4 * (9 * c * c + c), pk)
                tail = dict(
                    ms=time_ms(lambda: residual_tail_backward(gout, *saved, *ks))[0],
                    plain_ms=time_ms(lambda: residual_tail_backward_plain(gout, *saved, *ws))[0],
                    library_ms=None,  # no single call computes the chain
                )
                # reads g and the five kept activations and four weights, writes dx0 and the gradients
                tail["bound_ms"], tail["bound_by"] = bound_ms(8 * conv_flops, 7 * act + 8 * 4 * (9 * c * c + c), pk)
                for kname, e in (("conv3x3_dgrad", dgrad), ("conv3x3_wgrad", wgrad), ("residual_tail_backward", tail)):
                    lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
                    if "library_det_ms" in e:
                        lib += f" (deterministic cuDNN {e['library_det_ms']:.4f} ms)"
                    print(f"[10] {kname} {hw}x{hw}x{c} B={b}: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
                          f"library {lib}, bound {e['bound_ms']:.5f} ms ({e['bound_by']}), "
                          f"{e['bound_ms'] / e['ms']:.1%} of bound", flush=True)
                    table[(kname, b, hw)] = e

    # the whole step, B=1
    X, Y = train_stream(16, 1, seed=23)
    X, Y = X.to(dev), Y.to(dev)
    n_steps = 48

    def fresh_state(lanes=1):
        from plastic_unet_tpu_torch.models.unet_res import UNetPRes

        model = UNetPRes(neurons=16, nbf=101, rule="oja", dropout_ratio=0.0,
                         generator=torch.Generator().manual_seed(3))
        return create_train_state(model, TRAIN_LR, TRAIN_GAMMA, 1e6, lanes=lanes, device=dev)

    def rate(step_fn, state, xs, ys, steps):
        """Median of three host-clock timings of `steps` steps ending in a synchronize; seconds per step."""
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                step_fn(state, (xs[i % xs.shape[0]], ys[i % ys.shape[0]]))
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t0) / steps)
        return float(np.median(secs))

    eager, st = make_train_step(), fresh_state()
    eager(st, (X[0], Y[0]))
    eager_s = rate(eager, st, X, Y, n_steps)
    st_g = fresh_state()
    graph = GraphTrainStep(st_g, X.shape[1:], Y.shape[1:])
    graph(st_g, (X[0], Y[0]))
    graph_s = rate(graph, st_g, X, Y, n_steps)
    # The replayed graph is the eager step's kernels with no host in between: its device time is
    # taken as the step's device work, and the eager step's idle share is derived from it (two
    # runs, not one trace; --profile sums the eager step's own kernels).
    work_ms, graph_issue_ms = time_ms(lambda: graph(st_g, (X[0], Y[0])), reps=10, warmup=1)
    flops = forward_flops(16) + backward_flops(16)
    step_bound, _ = bound_ms(flops, 0.0, pk)
    tails_fwd = sum(TAILS_PER_CHUNK[hw] * fwd_table[("residual_tail", 1, hw)]["ms"] for hw, _ in LEVELS)
    tails_bwd = sum(TAILS_PER_CHUNK[hw] * table[("residual_tail_backward", 1, hw)]["ms"] for hw, _ in LEVELS)
    print(f"[10] training step neurons=16 B=1 (host clock, {n_steps} steps, median of 3): eager "
          f"{1 / eager_s:.1f} steps/s ({eager_s * 1e3:.3f} ms per step; device idle share "
          f"{max(0.0, 1 - work_ms / (eager_s * 1e3)):.1%}, derived as 1 - a replay's device time / this); CUDA graph {1 / graph_s:.1f} steps/s "
          f"({graph_s * 1e3:.3f} ms per step, host issue {graph_issue_ms:.3f} ms, device idle share "
          f"{max(0.0, 1 - work_ms / (graph_s * 1e3)):.1%}); device work of one step {work_ms:.3f} ms (events around "
          f"a replay), of it 9 tail forwards {tails_fwd:.3f} ms and 9 tail backwards {tails_bwd:.3f} ms (sum of "
          f"count x per-shape time); step bound {flops / 1e9:.3f} GFLOP (forward {forward_flops(16) / 1e9:.3f} + "
          f"backward {backward_flops(16) / 1e9:.3f}) -> {step_bound:.4f} ms at the fp32 peak", flush=True)

    Xl, Yl = train_stream(2, B, seed=24)
    Xl, Yl = Xl.to(dev), Yl.to(dev)
    st_l = fresh_state(lanes=B)
    eager(st_l, (Xl[0], Yl[0]))
    lane_s = rate(eager, st_l, Xl, Yl, 4)
    lane_dev_ms, _ = time_ms(lambda: eager(st_l, (Xl[0], Yl[0])), reps=5, warmup=1)
    lane_bound, _ = bound_ms(flops * B, 0.0, pk)
    tails_bwd_l = sum(TAILS_PER_CHUNK[hw] * table[("residual_tail_backward", B, hw)]["ms"] for hw, _ in LEVELS)
    print(f"[10] training step neurons=16 lanes={B}, eager: {B / lane_s:.1f} samples/s ({lane_s * 1e3:.2f} ms per "
          f"step, host clock; device time {lane_dev_ms:.2f} ms, device idle share "
          f"{max(0.0, 1 - lane_dev_ms / (lane_s * 1e3)):.1%}); 9 tail backwards {tails_bwd_l:.2f} ms of it; bound "
          f"{lane_bound:.2f} ms at the fp32 peak", flush=True)

    sources = {
        "conv3x3_dgrad": ("plastic_unet_tpu_torch/csrc/conv3x3.cu", "plastic_unet_tpu/ops/pallas_trunk.py:231"),
        "conv3x3_wgrad": ("plastic_unet_tpu_torch/csrc/conv3x3_wgrad.cu", "plastic_unet_tpu/ops/pallas_trunk.py:231"),
        "residual_tail_backward": ("plastic_unet_tpu_torch/ops/residual_tail.py",
                                   "plastic_unet_tpu/ops/pallas_trunk.py:231"),
    }
    kernels = []
    hw0, c0 = LEVELS[0]
    for kname, (src, replaces) in sources.items():
        one, many = table[(kname, 1, hw0)], table[(kname, B, hw0)]  # the training path runs B=1
        entry = {"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": step_counts[kname], "max_abs_err": errs.at(kname, 1), "ms": one["ms"],
                 "plain_ms": one["plain_ms"], "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
                 "library_ms": one["library_ms"], "shape": f"B=1 {hw0}x{hw0}x{c0}"}
        entry.update({f"{k}_b{B}": many[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        entry.update({f"max_abs_err_b{B}": errs.at(kname, B), "max_abs_err_all_shapes": errs.all(kname)})
        if "library_det_ms" in one:
            entry.update({"library_det_ms": one["library_det_ms"], f"library_det_ms_b{B}": many["library_det_ms"]})
        kernels.append(entry)
    return kernels


def profile_training_step(dev, steps: int = 5):
    """``--profile``: the B=1 eager training step under torch.profiler; device time by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.train.loop import create_train_state, make_train_step

    X, Y = train_stream(steps, 1, seed=23)
    X, Y = X.to(dev), Y.to(dev)
    model = UNetPRes(neurons=16, nbf=101, rule="oja", dropout_ratio=0.0, generator=torch.Generator().manual_seed(3))
    state = create_train_state(model, TRAIN_LR, TRAIN_GAMMA, 1e6, device=dev)
    step = make_train_step()
    step(state, (X[0], Y[0]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(state, (X[i], Y[i]))
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / steps, e.count / steps) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
            and not e.is_user_annotation]  # an annotation's span (Optimizer.step) repeats its kernels' time
    check(bool(rows), "torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"[profile] B=1 eager training step, neurons=16: {total / 1e3:.3f} ms of kernels per step "
          f"({sum(r[2] for r in rows):.0f} launches), by kernel:")
    for key, us, n in rows[:32]:
        print(f"[profile] {us:9.1f} us {us / total:6.1%} {n:6.1f} x  {key[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")
    t0 = time.time()
    smi, name = phase_device()
    if sys.argv[1:] == ["--profile"]:
        profile_training_step(dev)
        return 0
    errs = phase_kernels(dev)
    phase_model(dev)
    main_counts, full = phase_serving(dev)
    kernels, fwd_table = phase_times(dev, name, full, main_counts, errs)
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    with matmul_precision("parity"):
        bwd_errs = phase_backward_kernels(dev)
    step_counts = phase_training(dev)
    for entry in kernels:  # the serving kernels are on the training path too
        entry["launches_train_step"] = step_counts[entry["name"]]
    kernels += phase_training_times(dev, name, bwd_errs, step_counts, fwd_table)
    print(f"[done] {time.time() - t0:.1f}s; card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
