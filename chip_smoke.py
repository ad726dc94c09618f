#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (no JAX).

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each printing its lines; any failed check raises and the exit code
is non-zero:

  1. device name and power limit (nvidia-smi), torch/CUDA versions; build
     every kernel of csrc/ with nvcc for sm_90a (one process per source).
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of the serving path (B=128): the plastic head (hebb/oja x
     free/yoked), the 3x3 conv at the five level shapes with every flag
     combination plus Cin != Cout cases, the residual tail at the five
     shapes. Tolerance max|diff| <= 1e-4 * max(1, max|ref|): fp32 sums
     taken in another order over up to 9*256 terms.
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
     so host issue time is excluded; warm-up excluded; median of 20) at B=128: each
     kernel, its plain version, its bound and the cuDNN call where one
     exists; serving tiles/s at neurons=16, chunk 128.

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

def phase_kernels(dev):
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, hwio
    from plastic_unet_tpu_torch.ops.plastic_head import plastic_head, plastic_head_plain
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail, residual_tail_plain

    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"plastic_head": 0.0, "conv3x3": 0.0, "residual_tail": 0.0}

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    n = 101
    x, hebb = rnd(B, n, n), rnd(B, n, n, scale=0.1)
    w, eta = rnd(n, n, scale=0.01), torch.full((1,), 0.01, device=dev)
    for rule in ("hebb", "oja"):
        for alfa_type, alpha in (("free", rnd(n, n).abs() * 0.01), ("yoked", torch.full((1,), 0.02, device=dev))):
            got = plastic_head(w, alpha, eta, x, hebb, rule=rule, alfa_type=alfa_type)
            ref = plastic_head_plain(w, alpha, eta, x, hebb, rule=rule, alfa_type=alfa_type)
            for what, gt, rf in zip(("activ", "activout", "hebb"), got, ref):
                e, tol = max_err(gt, rf)
                check(e <= tol, f"plastic_head {rule}/{alfa_type} {what}: max|diff| {e:.3g} > {tol:.3g}")
                errs["plastic_head"] = max(errs["plastic_head"], e)
    print(f"[2] plastic_head B={B} nbf={n} hebb/oja x free/yoked: max|diff| {errs['plastic_head']:.3g}", flush=True)

    flag_sets = [(False, None, False), (True, None, False), (False, None, True),
                 (True, "plain", False), (False, "relu", True), (True, "relu", True)]
    cases = [(hw, c, c, flags) for hw, c in LEVELS for flags in flag_sets]
    cases += [(101, 8, 16, (True, "relu", True)), (50, 16, 32, (True, None, False)),
              (25, 40, 24, (False, "plain", True))]
    for hw, cin, cout, (relu_in, res_mode, relu_out) in cases:
        xx = rnd(B, hw, hw, cin)
        wk = hwio(rnd(cout, cin, 3, 3, scale=1.0 / (3 * cin ** 0.5)))
        bias = rnd(cout, scale=0.1)
        res = None if res_mode is None else rnd(B, hw, hw, cout)
        kw = dict(relu_in=relu_in, relu_res=res_mode == "relu", relu_out=relu_out)
        e, tol = max_err(conv3x3(xx, wk, bias, res, **kw), conv3x3_plain(xx, wk, bias, res, **kw))
        check(e <= tol, f"conv3x3 {hw}x{hw} {cin}->{cout} {kw} res={res_mode}: max|diff| {e:.3g} > {tol:.3g}")
        errs["conv3x3"] = max(errs["conv3x3"], e)
    print(f"[2] conv3x3 {len(cases)} cases (5 level shapes x 6 flag sets, 3 Cin!=Cout): "
          f"max|diff| {errs['conv3x3']:.3g}", flush=True)

    for hw, c in LEVELS:
        args = [rnd(B, hw, hw, c)]
        for _ in range(4):
            args += [rnd(c, c, 3, 3, scale=0.5 / (3 * c ** 0.5)), rnd(c, scale=0.1)]
        e, tol = max_err(residual_tail(*args), residual_tail_plain(*args))
        check(e <= tol, f"residual_tail {hw}x{hw}x{c}: max|diff| {e:.3g} > {tol:.3g}")
        errs["residual_tail"] = max(errs["residual_tail"], e)
    print(f"[2] residual_tail 5 level shapes: max|diff| {errs['residual_tail']:.3g}", flush=True)
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

def reset_counts():
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3
    from plastic_unet_tpu_torch.ops.plastic_head import plastic_head
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail

    plastic_head.launches = residual_tail.launches = conv3x3.launches = 0


def read_counts() -> dict:
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3
    from plastic_unet_tpu_torch.ops.plastic_head import plastic_head
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail

    return {"plastic_head": plastic_head.launches, "residual_tail": residual_tail.launches,
            "conv3x3": conv3x3.launches}


def expect_counts(label: str, chunks: int) -> dict:
    counts = read_counts()
    want = {"plastic_head": HEAD_PER_CHUNK * chunks, "residual_tail": TAIL_PER_CHUNK * chunks,
            "conv3x3": CONV_PER_CHUNK * chunks}
    check(counts == want, f"{label}: launches {counts} != {want} for {chunks} chunk(s)")
    print(f"[5] {label}: launches {counts} ({chunks} chunk(s))", flush=True)
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


# --------------------------------------------------------------------------- phase 6

def phase_times(dev, name, full, main_counts, errs):
    import torch.nn.functional as F

    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, hwio
    from plastic_unet_tpu_torch.ops.plastic_head import plastic_head, plastic_head_plain
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

    entries = {}
    with torch.inference_mode(), matmul_precision("parity"):
        n = 101
        x, hebb, w, a = rnd(B, n, n), rnd(B, n, n, scale=0.1), rnd(n, n, scale=0.01), rnd(n, n).abs() * 0.01
        eta = torch.full((1,), 0.01, device=dev)
        kt, k_host = time_ms(lambda: plastic_head(w, a, eta, x, hebb, rule="oja"))
        pt, _ = time_ms(lambda: plastic_head_plain(w, a, eta, x, hebb, rule="oja"))
        bms, by = bound_ms(2 * B * n ** 3 + 8 * B * n * n, 4 * (5 * B * n * n + 2 * n * n + 1), pk)
        entries["plastic_head"] = dict(ms=kt, plain_ms=pt, bound_ms=bms, bound_by=by, cudnn_ms=None,
                                       shape=f"B={B} nbf={n} oja free")
        print(f"[6] plastic_head B={B} nbf={n}: kernel {kt:.4f} ms (host issue {k_host:.4f} ms), "
              f"plain {pt:.4f} ms, bound {bms:.4f} ms ({by}), {bms / kt:.1%} of bound", flush=True)

        for hw, c in LEVELS:
            xx = rnd(B, hw, hw, c)
            wt = [rnd(c, c, 3, 3, scale=0.5 / (3 * c ** 0.5)) for _ in range(4)]
            bs = [rnd(c, scale=0.1) for _ in range(4)]
            k0 = hwio(wt[0])
            conv = dict(
                ms=time_ms(lambda: conv3x3(xx, k0, bs[0]))[0],
                plain_ms=time_ms(lambda: conv3x3_plain(xx, k0, bs[0]))[0],
                cudnn_ms=time_ms(lambda: cudnn_conv(xx, wt[0], bs[0]))[0],  # one F.conv2d call
            )
            conv["bound_ms"], conv["bound_by"] = bound_ms(
                2 * 9 * c * c * B * hw * hw, 4 * (2 * B * hw * hw * c + 9 * c * c + c), pk)
            targs = [xx] + [t for pair in zip(wt, bs) for t in pair]
            tail = dict(
                ms=time_ms(lambda: residual_tail(*targs))[0],
                plain_ms=time_ms(lambda: residual_tail_plain(*targs))[0],
                cudnn_ms=time_ms(lambda: cudnn_tail(*targs))[0],  # four F.conv2d calls + elementwise
            )
            tail["bound_ms"], tail["bound_by"] = bound_ms(
                4 * 2 * 9 * c * c * B * hw * hw, 4 * (2 * B * hw * hw * c + 4 * (9 * c * c + c)), pk)
            for kname, d in (("conv3x3", conv), ("residual_tail", tail)):
                print(f"[6] {kname} {hw}x{hw}x{c} B={B}: kernel {d['ms']:.4f} ms, plain {d['plain_ms']:.4f} ms, "
                      f"cuDNN {d['cudnn_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms ({d['bound_by']}), "
                      f"{d['bound_ms'] / d['ms']:.1%} of bound", flush=True)
                if (hw, c) == LEVELS[0]:
                    entries[kname] = dict(d, shape=f"B={B} {hw}x{hw}x{c}")
            entries.setdefault("tails_per_chunk_ms", 0.0)
            entries["tails_per_chunk_ms"] += TAILS_PER_CHUNK[hw] * tail["ms"]

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
          f"{entries['tails_per_chunk_ms']:.3f} ms + plastic head {entries['plastic_head']['ms']:.4f} ms of it; "
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
        d = entries[kname]
        # library_ms: one PyTorch call computing the same function, where one exists (conv3x3's
        # F.conv2d); the tail's cuDNN time is four calls, so it is reported as cudnn_ms only.
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": main_counts[kname], "max_abs_err": errs[kname], "ms": d["ms"],
                        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
                        "library_ms": d["cudnn_ms"] if kname == "conv3x3" else None,
                        "cudnn_ms": d["cudnn_ms"], "shape": d["shape"]})
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on a card", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda")
    t0 = time.time()
    smi, name = phase_device()
    errs = phase_kernels(dev)
    phase_model(dev)
    main_counts, full = phase_serving(dev)
    kernels = phase_times(dev, name, full, main_counts, errs)
    print(f"[done] {time.time() - t0:.1f}s; card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
