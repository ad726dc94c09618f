#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (no JAX).

    python3 chip_smoke.py        # from the repository root; needs one CUDA card
    python3 chip_smoke.py --profile [bfloat16]   # only: the B=1 training step's device time by kernel name
                                                 # (utils.profiling.profile_to; trace in out/profile)

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
     at CONV_EDGE_CASES (the 8 routed entry-conv shapes at B=1 and B=128
     among them) in each of the three families that has a tiling for the
     shape, each bit-identical over two runs; the residual tail at the five shapes; the fused tail
     (csrc/residual_tail.cu, tail_plan's "fused" route) forced at 101^2x16,
     50^2x32 and the checkpoint's 50^2x16 and 25^2x32, B=128, 3 and 37 (but
     where the four launches take the split family, whose bits are its own),
     equal to the four conv3x3 launches bit for bit in out and in the kept
     pre11, x1, pre21, and under autograd in out and what it saves. Tolerance max|diff| <= 1e-4 *
     max(1, max|ref|): fp32 sums taken in another order over up to 9*256 terms.
     Then the NaN canary (phase_canary): every kernel and family at the level
     shapes, B=128 and B=1 (the fused tail and its fused backward at their
     two shapes), with its inputs inside NaN-filled buffers (16-byte
     aligned, and off it) and every free block of the allocator NaN-filled
     before the launch; finite and within the same tolerance.
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
     plastic-head launch and 9 residual tails per chunk, each tail one fused
     launch or four conv3x3 launches as tail_plan routes it, and one conv3x3
     launch for each entry conv models.blocks.EntryConv routes (chunk_counts:
     neurons=16 at B=128, 4 fused and 20 + 8 conv3x3).
  6. times (CUDA events around each call while the device is kept busy,
     so host issue time is excluded; warm-up excluded; median of 20) at B=128
     and at B=1: each kernel, its plain version, its bound and the cuDNN
     call where one exists (for the head, torch.bmm of its product alone,
     bmm_ms); where the tail takes the fused kernel, also the four conv3x3
     launches on the same inputs and the fused kernel keeping its three
     tensors; both tail routes forced at FUSED_TAIL_CHECKS over
     TAIL_SWEEP_BS (tail_route_sweep: where the fused kernel wins);
     serving tiles/s at neurons=16, chunk 128, under deterministic
     cuDNN (utils.precision.serving_numerics) and, for the cost, without it.

  7. the backward kernels against their plain versions on the card, at the
     five level shapes, B=1 and B=128: the conv's input-gradient form with
     the four flag sets of the tail's reverse chain plus Cin != Cout cases
     (the split cases at B=1 and CONV_EDGE_CASES in every family with a
     tiling bit-identical over two runs, the masked input equal to the plain one),
     the weight/bias gradient (ReLU on load on and off, both layouts, two
     runs bit-identical, and the error against a float64 run; also at
     WGRAD_EDGE_CASES, where its tiling could break), the whole
     tail backward (dx0 and 8 parameter gradients) against the plain chain
     and against autograd of the plain forward. Same tolerance as phase 2.
     Then the fused backward (csrc/residual_tail_backward.cu, forced) at
     FUSED_TAIL_CHECKS x FUSED_TAIL_BS: dx0 equal to the eight launches' bit
     for bit (not where their dgrad splits K), every gradient within
     tolerance of the plain chain, two runs alike, and where tail_bwd_plan
     fuses, dW and db no farther from a float64 run than the eight
     launches'; under autograd, residual_tail's gradients equal its route's.
  8. the training path at full width: UNetPRes neurons=16, nbf=101, seeded
     weights, hebb and oja, B=1, dropout 0, 8 steps (lr 1e-3, gamma 0.5,
     step_size 3) on synthetic tiles, eager on the card against the CPU
     port: losses within 5e-5, final parameters within 5e-4, eta exactly
     0.01, the trace non-zero and within 1e-4; the default path on the
     card, the step replayed from a CUDA graph, gives the eager run's 8
     losses, parameters and trace bit for bit. Then 8 steps at dropout 0.5
     (graph against eager from the same generator seed, bit for bit; the
     mask contract on one eager forward) and 4 steps at lanes=128 (graph
     against eager, bit for bit; trace (128, 101, 101)); then 4 steps at
     the fewest lanes at which tail_bwd_plan fuses the 101^2 and 50^2 tails
     (fused_bwd_lanes), eager on the card against the CPU port within the
     B=1 run's tolerances.
  9. proof of path: per eager training step 1 head launch, 9 tail forwards
     (36 conv launches), 9 tail backwards (36 dgrad and 36 wgrad launches),
     and 8 entry convs (a conv3x3, a dgrad and a wgrad launch each);
     the graph run counts the same for its 2 warm-up steps and each replay
     (the capture's launches, counted at each replay by
     utils.profiling.Capture.replayed). At lanes=128 (lane_step_counts):
     1 head, 9 tails (4 fused, 20 conv3x3), 9 tail backwards (4 fused, 20
     dgrad, 20 wgrad), 8 entry convs, the graph run 2 + 4 steps of them.
  10. times: dgrad, wgrad and the tail backward at the five shapes, B=1 and
     B=128, with plain, bound and the library call (F.conv2d with flipped
     weights; aten.convolution_backward for weight and bias, also under
     training_numerics: deterministic cuDNN, as the training step runs it); the B=1 step
     eager and as a graph (steps/s, device time; the eager step's idle
     share is derived from the replay's device time), lanes=128 samples/s
     and its 9 tail backwards by route, and the step's FLOP bound; at B=128
     the tail backward at the five levels by tail_bwd_plan's route, the
     eight launches forced, the fused kernel where it fits, and cuDNN's
     chain through autograd (deterministic, TF32 off); both backward routes
     forced at FUSED_TAIL_CHECKS over TAIL_SWEEP_BS (tail_bwd_route_sweep)
     and the B from which the rule fuses.
  11. the training entry point (python -m plastic_unet_tpu_torch.cli.train,
     in-process, in a temporary directory): UNetPRes neurons=16, nbf=101,
     B=1, --synthetic 40 (32 train / 8 validation tiles), dropout 0.5,
     shuffle and augmentation; 4 epochs at 2 a dispatch equal 4 at 1 a
     dispatch, and 2 epochs then a resume for 2 more, bit for bit (losses,
     parameters, validation, the dropout generator); the three artifacts
     read back (train_data.hdf5 where h5py is installed); cli.tuned_run to
     submission.csv; the launch counts of the driver's run (warm-up, replays
     and validation chunks); the driver's time per epoch against the bare
     graph step of phase 10.
  12. the serving features at full width (UNetPRes neurons=16, nbf=101,
     seeded weights, fp32 parity, 512 synthetic tiles = 4 chunks): the 8
     TTA views' inverses exact on the card; tta8 with the views folded into
     the batch equal to one pass a view, bit for bit, each 32 chunks of
     launches; tta4 on 8 tiles against the CPU port (rtol 1e-5, atol 1e-6);
     inference() on 3 single images (B=1 plans) against the chunked rows;
     the int8 convs (torch._int_mm) against their float64 plain versions
     at every level shape, bit for bit; calibration on 256 tiles (49
     ranges; 2 chunks of launches) and the int8 forward (the head only)
     against the CPU port with the card's ranges (atol 1e-5); the HTTP
     endpoint on 127.0.0.1 (a 128-tile tta4 /predict and /predict_rle equal
     to the predictor's, /healthz naming the card, the request's median
     latency); cli.infer --tta tta4 --save --quant int8 on a fake TGS
     directory (PNGs equal to their RLE rows); tiles/s at the identity,
     tta4 and tta8 batched, tta8 sequential, int8, and the first three
     again without deterministic cuDNN. tta8 folded against one pass a view
     is held with torch.equal; a difference names, for each differing
     (view, chunk), the first module whose output differs between the two
     paths, and fails the run.
  13. the export path (submit.export) at full width: programs for "cuda" of
     UNetPRes neurons=16, nbf=101 (seeded weights), loaded with the default
     device: the identity artifact at chunk 128 equal to the live
     predict_masks bit for bit on 512 tiles with chunk_counts() launches a
     chunk (1 head, 9 tails: 4 fused, 20 conv3x3; 8 entry conv3x3); the tta4 artifact at chunk 32 (B=128 in the
     program) equal to the live folded tta4 bit for bit; the head and
     conv3x3 at B=1024 against their plain versions, the fused tail there
     equal to the four conv3x3 launches, and the tta8 artifact
     at chunk 128 (B=1024) within 1.2e-7 of the live tta8; the int8
     artifact equal to the live int8 forward; HTTP /predict from the tta4
     artifact equal to MaskPredictor(tta4) bit for bit; export and load
     seconds, the artifacts' tiles/s beside the live path's.
  14. the UNetPRes options at full width (neurons=16, nbf=101, 101x101
     tiles, seeded weights): trunk_pad=128 moves the tails to the padded
     track (PAD_LEVELS: 128^2x16 ... 8^2x256), where tail_plan and
     tail_bwd_plan fuse 128^2x16 (clusters of 13 blocks of ~229 KB) and
     64^2x32 at B=128: the fused forward == the four conv3x3 launches and
     the fused backward's dx0 == the eight launches', bit for bit, each
     within phase 2's tolerance of its plain version, dW and db no farther
     from float64 than the eight launches', the NaN canary, and each
     one's time beside the other route, plain, cuDNN and the bound; then
     trunk_pad=128 with coord_conv: serving 512 tiles at chunk 128
     (tiles/s, launches by route: 4 fused, 20 + 8 conv3x3 a chunk), the
     forward on 4 tiles against the CPU port (atol 1e-5 x max(1,
     max|ref|)), 8 B=1 steps, the CUDA graph == eager bit for bit, and a
     lanes=128 eager step beside the default model's in ms. remat_trunk:
     a lanes=128 and a B=1 step at dropout 0.5 from an explicit generator
     give the plain step's loss, activ and gradients bit for bit, with
     every tail launched twice (the recompute) and their peak memory
     (torch.cuda.max_memory_allocated); 8 B=1 steps eager and as a CUDA
     graph == the plain eager run bit for bit. batch_norm: conv3x3_same
     (the BN trunks' differentiable conv) against autograd of the plain
     conv; a B=128 train-mode forward and backward (launches: the 20 convs
     of the BN trunks on conv3x3_same, the 4 UpRes middles by the tail
     routes); at B=2 the train-mode outputs, running statistics and
     gradients and the eval forward against the CPU port (atol 1e-5 and
     1e-4 x max(1, max|ref|)). fold_hires, patch_conv and fast_dw: the
     default model's loss, activ and gradients bit for bit. Finally every
     kernel is in the kernels line with every key.
  15. the other two model families at full width. The classic UNetP
     (nbf=128, 128x128 tiles, seeded weights; hebb, oja, and oja with the
     bilinear upsample): a B=128 chunk on the card against the CPU port
     (activout and the trace within 1e-4), one plastic-head launch a chunk
     and no other kernel, tiles/s on 4 chunks (host clock, median of 3);
     tta4 folded == one pass a view, the exported identity artifact == the
     live path and MaskPredictor.from_pth(arch="unet") of the port's .pth ==
     the live path, each by torch.equal; 8 B=1 training steps, hebb and oja,
     eager against the CPU port (losses 5e-5, parameters 5e-4, trace 1e-4,
     eta exactly 0.01) and as a CUDA graph == eager bit for bit, 1 head launch
     a step, the graph step's ms; start_train(arch="unet") on 32 128-px
     tiles for 2 epochs, a .pth resume, start_inference to submission.csv,
     and cli.train --arch unet --synthetic 40 raising the 101-px geometry
     error. The CoordConv U-Net (128 px, with_r, batch 8): the forward
     against the CPU port (1e-4), 3 epochs of do_training on 80 tiles
     against the CPU port (per-epoch loss and val_loss within 2e-4; the
     checkpoint files and the history pickle), its steady-state samples/s
     (do_training's epoch loop, fit_epoch, over 320 tiles: the median of 3
     epochs after a warm-up one), and
     cli.coord_conv --train --inference --short-run --epochs 2 to
     submission-6.csv. Then the head at n=128, B=128 and B=1 against its
     plain version (1e-4 * max(1, max|ref|)): kernel, plain, torch.bmm of the
     product, bound.
  16. data parallel on the card at world size 1: an NCCL process group of one
     rank (file store in a temporary directory; the CPU port's pmean run in a
     Gloo group of one rank first, as the reference). UNetPRes neurons=16,
     seeded, fp32 parity: the DP epoch (parallel.dp) == make_epoch_fn bit for
     bit, hebb and oja, 8 steps at lanes 1 and 4 at lanes 128, as a CUDA graph
     (the collective captured) and eager, with the launches of
     lane_step_counts and one gradient all-reduce a step (the counter
     collective.all_reduce; the graph run 2 + a replay a step of them); torch.profiler on an eager DP
     step and on graph replays at lanes 128 (the all-reduce's host ops, NCCL's
     kernels and their device time); pmean at lanes 4 (two all-reduces a step,
     every lane the lanes' mean, losses within 5e-5 and the trace within 1e-4
     of the CPU port's Gloo run); 2 epochs in one DP dispatch == 2 one-epoch
     dispatches with shuffle, augmentation and dropout 0.5; the driver's DP
     route (start_train with the mesh, 32 tiles, dropout, shuffle, augment):
     2 epochs + a resume for 2 == 4 straight, the resume state gathered over
     NCCL; predict_masks and tta4 with the mesh == without it on 512 tiles;
     the graph step with and without the all-reduce at lanes 1 and 128, in
     turns, and their ratio.
 17. compute_dtype bfloat16 (UNetPRes neurons=16, nbf=101, phase 3's seeded
     weights; the trunk on cuDNN's bf16 convs, the head's kernel in fp32):
     serving 512 tiles at chunk 128 within 2e-2 of the card's fp32 forward
     and of the CPU port in bf16, two runs equal, one head launch a chunk
     and no trunk kernel, tiles/s against fp32 in turns; the bf16 artifact
     equal to the live forward; tta8 folded against one pass a view
     (reported); int8 under bf16 within 0.05 of fp32; 8 B=1 training steps
     (hebb, dropout 0) eager and as a CUDA graph, equal bit for bit, losses
     within 3e-2 relative of the CPU port in bf16, parameters fp32; the
     graph step's ms and a lanes=128 step's samples/s against fp32, in
     turns; the precision policy on an fp32 B=1 graph step and serving
     chunk: "perf" and "parity" each repeat their bits, "perf" differs
     (TF32 engaged) within a quarter of the bf16 bounds, and both times.
     The CLIs default to "perf"; phases 11, 12 and 16 pass "parity", the
     policy their numbers are set against.
 18. the host tools: the native host library's status (ops.native: built
     from native/plasticnet_native.cc into build/plastic_unet_tpu_torch/,
     loaded, or the compiler's or loader's reason); predict() on 512 tiles
     (phase 12's model) with its launch counts; the host CPU seconds of
     ops.rle.encode over 18,000 masks; where the library loaded, the same
     submission.csv bytes with the native and the numpy encoder, the
     native RLE of the 18,000 masks equal to ops.rle.encode string for
     string (and its host seconds), the native PNG loader equal to
     data.images.load_image (1e-6) on write_tgs_dir's tiles, an RGB tile and
     a resize, the native IoU sweep equal to ops.iou (1e-6); profile_to
     around two B=1 eager steps in trace("step") ranges: the trace holds the
     ranges and B1's kernel, and the .spans.json beside it every kernel
     launch's span; predict(visualize=True) raises ImportError
     naming matplotlib where it is not installed.

In the kernels' JSON, ms / plain_ms / bound_ms / library_ms / max_abs_err
belong to the entry's "shape"; "launches" counts the serving request of
phase 5 (the backward kernels: one eager training step), launches_train_step
one eager training step (phase 9), launches_driver the driver's first run
of phase 11, launches_tta8_batched / launches_calib / launches_int8 the
paths of phase 12, launches_export the identity artifact's 512 tiles in
phase 13; keys ending in _b1 or _b128 give the same at the other batch size, max_abs_err_all_shapes the largest over every case,
library_det_ms the library call under deterministic cuDNN, bmm_ms the
head's product alone as one torch.bmm call. The residual_tail entry is
the fused kernel (csrc/residual_tail.cu) at 101x101x16, B=128: its
launches are the kernel's own (counter residual_tail_fused; launches_tails
counts the tails of either route), four_launch_ms the four conv3x3
launches on the same inputs, keep_ms the fused kernel keeping pre11, x1
and pre21, the _50 keys the same at 50x50x32; its _b1 keys are the B=1
tail, which takes the four launches (route_b1); route_sweep holds phase
6's rows [H, C, B, four ms, fused ms, keep ms, tail_plan's route]. The
residual_tail_backward_fused entry is the fused backward at 101x101x16,
B=128: launches per eager step of the lanes=128 path (phase 9; no B=1 step
takes it), eight_launch_ms the eight launches on the same inputs,
library_chain_ms cuDNN's chain through autograd (several calls, so
library_ms is null), the _50 keys at 50x50x32, route_sweep phase 10's rows
[H, C, B, eight ms, fused ms, tail_bwd_plan's route]. Phase 14 adds to
both the padded track's fused shapes at B=128 (keys ending in _128 for
128x128x16 and _64 for 64x64x32: ms, four_launch_ms or eight_launch_ms,
plain_ms, bound_ms, cudnn_ms or library_chain_ms, max_abs_err), and to
every entry the launches of its paths: launches_pad128_chunk (a padded
serving chunk), launches_pad128_step_b1 and launches_pad128_step_lanes (one
padded eager step at B=1 and at lanes=128), launches_plain_step_lanes,
launches_remat_step_lanes, launches_plain_step_b1, launches_remat_step_b1
(one forward and backward, dropout 0.5, without and with remat_trunk),
launches_bn_step_b128 (a batch_norm forward and backward at B=128).
Phase 15 adds to every entry launches_unet_chunk (one classic UNetP
serving chunk) and launches_unet_step (one classic eager B=1 step), and to
the plastic_head entry its times at n=128 (keys ending in _n128 for B=128
and _n128_b1 for B=1: ms, plain_ms, bmm_ms, bound_ms, bound_by,
max_abs_err) and classic_tiles_s, UNetP's serving tiles/s by variant.
Phase 16 adds to every entry launches_dp_step (one eager data-parallel step
at lanes=128, world size 1), phase 17 launches_bf16_chunk and
launches_bf16_step (one bf16 serving chunk, one bf16 B=1 training step),
phase 18 launches_host_tools (predict() on 512 tiles). The residual_tail_backward entry's
library_chain_ms is cuDNN's chain through autograd at its shape, B=1.

The line before the last is the kernels' JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "results", "showdown_r5", "sd_torch_oja_250h.json.ckpt.pth")
CKPT_THRESHOLD, CKPT_IOU = 0.48954822531870534, 0.83125  # JAX package and torch reference on this checkpoint
B = 128
LEVELS = [(101, 16), (50, 32), (25, 64), (12, 128), (6, 256)]  # (H=W, C) of the neurons=16 track
TAILS_PER_CHUNK = {101: 2, 50: 2, 25: 2, 12: 2, 6: 1}  # a DownRes and an UpRes Middle per level; Middle at 6
HEAD_PER_CHUNK = 1
COUNTED = ("plastic_head", "residual_tail", "residual_tail_fused", "conv3x3", "residual_tail_backward",
           "conv3x3_dgrad", "conv3x3_wgrad", "residual_tail_backward_fused")
STEP_COUNTS = {"plastic_head": 1, "residual_tail": 9, "residual_tail_fused": 0, "conv3x3": 44,
               "residual_tail_backward": 9, "conv3x3_dgrad": 44, "conv3x3_wgrad": 44,
               "residual_tail_backward_fused": 0}  # per eager training step, B=1: 36 tail convs + 8 entry convs
FUSED_TAIL_SHAPES = [(101, 16), (50, 32)]  # the levels tail_plan routes to csrc/residual_tail.cu at B=128
FUSED_TAIL_BS = (B, 3, 37)  # phase 2: the fused tail == four launches, bit for bit, at these B
FUSED_TAIL_CHECKS = FUSED_TAIL_SHAPES + [(50, 16), (25, 32)]  # and the epoch-225 checkpoint's (neurons=8) fused levels
TAIL_SWEEP_BS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64, 128)  # phase 6: both tail routes timed at these B


KERNELS = ("plastic_head", "conv3x3", "residual_tail", "conv3x3_dgrad", "conv3x3_wgrad", "residual_tail_backward",
           "residual_tail_backward_fused")  # the kernels line's entries
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def entry_counts(neurons: int = 16) -> int:
    """The trunks' entry convs that models.blocks.EntryConv runs on the
    conv3x3 kernel in fp32: those whose Cin is a multiple of
    ops.conv3x3.CK (8 of 9 at neurons=16, 7 at 8; never the stem's). Each
    is one conv3x3 launch a forward, and one dgrad and one wgrad a backward."""
    from plastic_unet_tpu_torch.ops.conv3x3 import CK

    return sum(neurons * m % CK == 0 for m in (1, 2, 4, 8, 16, 8, 4, 2))


def chunk_counts(neurons: int = 16, b: int = B, levels=LEVELS) -> dict:
    """Forward launches of one UNetPRes chunk of b samples: 1 head, 9
    tails, each tail one launch of the fused kernel or four conv3x3
    launches, as ops.residual_tail.tail_plan routes its shape, and a conv3x3
    launch for each routed entry conv (entry_counts). ``levels``:
    the track's sides (PAD_LEVELS for trunk_pad=128), TAILS_PER_CHUNK's
    counts in order."""
    from plastic_unet_tpu_torch.ops.residual_tail import tail_plan

    fused = sum(n for i, (n, (hw, _)) in enumerate(zip(TAILS_PER_CHUNK.values(), levels))
                if tail_plan(b, hw, hw, neurons * 2 ** i).family == "fused")
    tails = sum(TAILS_PER_CHUNK.values())
    return {"plastic_head": HEAD_PER_CHUNK, "residual_tail": tails, "residual_tail_fused": fused,
            "conv3x3": 4 * (tails - fused) + entry_counts(neurons)}


def lane_step_counts(lanes: int, neurons: int = 16, levels=LEVELS) -> dict:
    """Launches of one eager training step of ``lanes`` samples: the forward
    of chunk_counts, 9 tail backwards, each one launch of the fused
    backward or four dgrad and four wgrad launches, as
    ops.residual_tail.tail_bwd_plan routes its shape, and a dgrad and a
    wgrad for each routed entry conv."""
    from plastic_unet_tpu_torch.ops.residual_tail import tail_bwd_plan

    counts = dict.fromkeys(COUNTED, 0)
    counts.update(chunk_counts(neurons, lanes, levels))
    fused = sum(n for i, (n, (hw, _)) in enumerate(zip(TAILS_PER_CHUNK.values(), levels))
                if tail_bwd_plan(lanes, hw, hw, neurons * 2 ** i).family == "fused")
    tails = sum(TAILS_PER_CHUNK.values())
    entries = entry_counts(neurons)
    counts.update({"residual_tail_backward": tails, "residual_tail_backward_fused": fused,
                   "conv3x3_dgrad": 4 * (tails - fused) + entries, "conv3x3_wgrad": 4 * (tails - fused) + entries})
    return counts


def fused_bwd_lanes(neurons: int = 16) -> int:
    """The fewest lanes at which tail_bwd_plan fuses the tails at both 101^2 and 50^2."""
    from plastic_unet_tpu_torch.ops.residual_tail import tail_bwd_plan

    return next(b for b in range(1, B + 1) if all(
        tail_bwd_plan(b, hw, hw, neurons * 2 ** i).family == "fused" for i, (hw, _) in enumerate(LEVELS[:2])))


def scaled(counts: dict, k: int) -> dict:
    return {name: k * v for name, v in counts.items()}
TRAIN_STEPS, TRAIN_LR, TRAIN_GAMMA, TRAIN_STEP_SIZE = 8, 1e-3, 0.5, 3
ENTRY_SHAPES = [(50, 16, 32), (25, 32, 64), (12, 64, 128), (6, 128, 256), (12, 256, 128), (25, 128, 64),
                (50, 64, 32), (101, 32, 16)]  # (H=W, Cin, Cout) of the entry convs EntryConv routes at neurons=16
ENTRY_CASES = [(b, hw, hw, cin, cout) for b in (1, B) for hw, cin, cout in ENTRY_SHAPES]
WGRAD_EDGE_CASES = [(3, 13, 7, 40, 24), (5, 6, 6, 256, 256), (2, 101, 101, 16, 16), (8, 101, 101, 16, 16),
                    (2, 9, 9, 6, 10)] + ENTRY_CASES  # (B, H, W, Cin, Cout) beyond the level shapes; phase 7
CONV_EDGE_CASES = [(5, 6, 6, 256, 256), (3, 12, 12, 128, 128), (3, 13, 7, 40, 24), (2, 9, 9, 6, 10),
                   (1, 13, 7, 40, 24), (1, 9, 9, 48, 10),
                   (2, 6, 6, 256, 256)] + ENTRY_CASES  # conv3x3 and dgrad in every family that has a tiling; phases 2, 7


def family_plans(b: int, h: int, w: int, cin: int, cout: int, flip: bool = False) -> list:
    """conv3x3_plan forced to each family that has a tiling for these shapes (whole samples do not fit
    past SAMPLE_PIXELS-sized images)."""
    from plastic_unet_tpu_torch.ops.conv3x3 import FAMILIES, conv3x3_plan

    plans = []
    for family in FAMILIES:
        try:
            plans.append(conv3x3_plan(b, h, w, cin, cout, flip, family=family))
        except ValueError:
            pass
    return plans


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


class _RawBytes:
    """``n`` bytes of device memory at ``ptr``, as torch.as_tensor imports them (__cuda_array_interface__)."""

    def __init__(self, ptr: int, n: int):
        self.__cuda_array_interface__ = {"shape": (n,), "typestr": "|u1", "data": (ptr, False), "version": 2}


def poison_free_blocks(dev) -> int:
    """Fill every free block of the caching allocator on ``dev`` with all bits set (an fp32 NaN), so
    that a kernel reading memory it never wrote, or leaving part of its output unwritten, shows as a
    NaN. Returns the bytes filled."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    torch.cuda.synchronize(dev)
    filled = 0
    for seg in torch.cuda.memory_snapshot():
        if seg["device"] != index:
            continue
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "inactive":
                torch.as_tensor(_RawBytes(addr, blk["size"]), device=dev).fill_(255)
                filled += blk["size"]
            addr += blk["size"]
    torch.cuda.synchronize(dev)
    return filled


def in_nan_buffer(t: torch.Tensor, offset: int = 4) -> torch.Tensor:
    """A copy of ``t`` as a contiguous view ``offset`` floats into a NaN-filled buffer with
    ``offset`` NaNs after it too (4 keeps 16-byte alignment)."""
    buf = torch.full((t.numel() + 2 * offset,), float("nan"), dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def canary(fn, *args, offset: int = 4, **kw):
    """``fn(*args, **kw)`` with every tensor argument inside a NaN-filled buffer (``offset`` floats
    in) and every free block of the allocator (where the outputs land) NaN-filled before the launch."""
    moved = [in_nan_buffer(a, offset) if isinstance(a, torch.Tensor) else a for a in args]
    kw = {k: in_nan_buffer(v, offset) if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    poison_free_blocks(next(a for a in moved if isinstance(a, torch.Tensor)).device)
    return fn(*moved, **kw)


@contextlib.contextmanager
def serving_cudnn_not_deterministic():
    """For timing only: the serving forward (eval.evaluate) under TF32-off alone, with cuDNN free to
    pick algorithms that do not repeat their bits, as serving ran before the C5 repair."""
    from plastic_unet_tpu_torch.eval import evaluate
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    real = evaluate.serving_numerics
    evaluate.serving_numerics = lambda: matmul_precision("parity")
    try:
        yield
    finally:
        evaluate.serving_numerics = real


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
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, conv3x3_plan, hwio
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
        plans = family_plans(b, h, w_, cin, cout)
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
    phase_fused_tail(dev, errs)
    for offset in (4, 1):  # 16-byte aligned, and off it
        phase_canary(dev, offset)
    torch.cuda.synchronize()
    return errs


def phase_fused_tail(dev, errs):
    """The fused tail (csrc/residual_tail.cu, forced at each B) against the four conv3x3 launches at
    FUSED_TAIL_CHECKS x FUSED_TAIL_BS (where conv3x3_plan takes square tiles or whole samples), bit for
    bit: out alone, and out with pre11, x1 and pre21 kept; two runs alike; within tolerance of
    residual_tail_plain. Then residual_tail with autograd (the plan's route at that B): its out and the
    tensors it saved equal the four launches' bit for bit."""
    from plastic_unet_tpu_torch.ops import residual_tail as rt
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_plan, hwio

    g = torch.Generator(device=dev).manual_seed(12)
    for hw, c in FUSED_TAIL_CHECKS:
        for b in FUSED_TAIL_BS:
            if conv3x3_plan(b, hw, hw, c, c).family == "split":  # four launches with the split family's own bits
                continue
            args, _ = tail_operands(lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale,
                                    b, hw, c)
            x0, ws, bs = args[0], args[1::2], args[2::2]
            ks = [hwio(w) for w in ws]
            kargs = (x0, ks[0], bs[0], ks[1], bs[1], ks[2], bs[2], ks[3], bs[3])
            what = f"residual_tail_fused B={b} {hw}^2x{c} {tuple(rt.tail_plan(b, hw, hw, c, family='fused'))}"
            four = rt.residual_tail_four(*kargs)
            kept = rt.residual_tail_fused(*kargs, keep=True)
            alone = rt.residual_tail_fused(*kargs)
            check(all(bool(torch.equal(a, q)) for a, q in zip(kept, four)),
                  f"{what}: out, pre11, x1, pre21 differ from the four launches' in some bit")
            check(alone[1:] == (None, None, None) and bool(torch.equal(alone[0], four[0])),
                  f"{what}: out without the kept tensors differs from the four launches'")
            check(bool(torch.equal(rt.residual_tail_fused(*kargs)[0], alone[0])),
                  f"{what}: two runs differ in some bit")
            e, tol = max_err(kept[0], rt.residual_tail_plain(*args))
            check(e <= tol, f"{what}: max|diff| {e:.3g} > {tol:.3g} against the plain version")
            errs.note("residual_tail", e, b, hw)
            leaves = [t.clone().requires_grad_() for t in args]
            out = rt.residual_tail(*leaves)
            saved = out.grad_fn.saved_tensors
            check(bool(torch.equal(out, four[0])) and len(saved) == 9
                  and all(bool(torch.equal(a, q)) for a, q in zip(saved, (x0, *four[1:], four[0], *ks))),
                  f"{what}: residual_tail under autograd ({rt.tail_plan(b, hw, hw, c).family}) differs from "
                  f"the four launches in out or in what it saved")
            print(f"[2] {what}: == four conv3x3 launches bit for bit (out; out, pre11, x1, pre21 kept; under "
                  f"autograd by the plan's {rt.tail_plan(b, hw, hw, c).family} route), two runs alike, max|diff| "
                  f"{e:.3g} against the plain version", flush=True)
            del args, leaves, out, saved, four, kept, alone


def phase_canary(dev, offset: int):
    """The NaN canary of every kernel and family at the level shapes, B=128 and B=1 (conv3x3 and its
    input-gradient form in each family the shape takes, conv3x3_wgrad, the fused residual tail at its
    two shapes with pre11, x1 and pre21 kept, its fused backward there, the head's families, hebb and oja): inputs inside NaN-filled buffers ``offset`` floats in (1: off 16-byte alignment), outputs in
    NaN-filled blocks; each finite and within phase 2's tolerance of the plain version. A kernel
    that reads memory it never wrote, or leaves part of its output unwritten, fails here where two
    launches back to back (the same blocks) would agree. Returns [(kernel, case, max|diff|)]."""
    from plastic_unet_tpu_torch.ops import conv3x3 as c3
    from plastic_unet_tpu_torch.ops import residual_tail as rt
    from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad, conv3x3_wgrad_plain
    from plastic_unet_tpu_torch.ops.plastic_head import FAMILIES, head_plan, plastic_head, plastic_head_plain

    g = torch.Generator(device=dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    lines = []

    def hold(kname, case, got, ref):
        worst = 0.0
        for gt, rf in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
            if gt is not None:
                e, tol = max_err(gt, rf)  # raises on a non-finite output
                check(e <= tol, f"canary {kname} {case} (offset {offset}): max|diff| {e:.3g} > {tol:.3g}")
                worst = max(worst, e)
        lines.append((kname, case, worst))

    for b in (B, 1):
        for hw, c in LEVELS:
            x, res, gate = rnd(b, hw, hw, c), rnd(b, hw, hw, c), rnd(b, hw, hw, c)
            k, bias = c3.hwio(rnd(c, c, 3, 3, scale=1.0 / (3 * c ** 0.5))), rnd(c, scale=0.1)
            for fam in c3.FAMILIES:
                try:
                    plan = c3.conv3x3_plan(b, hw, hw, c, c, family=fam)
                    dplan = c3.conv3x3_plan(b, hw, hw, c, c, True, family=fam)
                except ValueError:  # a family that cannot take the shape
                    continue
                kw = dict(relu_in=True, relu_res=True, relu_out=True)
                hold("conv3x3", f"B={b} {hw}^2x{c} {fam}",
                     canary(c3.conv3x3, x, k, bias, res, plan=plan, offset=offset, **kw),
                     c3.conv3x3_plain(x, k, bias, res, **kw))
                hold("conv3x3_dgrad", f"B={b} {hw}^2x{c} {fam}",
                     canary(c3.conv3x3_dgrad, x, k, res, gate=gate, in_gate=res, plan=dplan, offset=offset),
                     c3.conv3x3_dgrad_plain(x, k, res, gate=gate, in_gate=res))
            hold("conv3x3_wgrad", f"B={b} {hw}^2x{c}",
                 canary(conv3x3_wgrad, x, res, relu_in=True, layout="oihw", offset=offset),
                 conv3x3_wgrad_plain(x, res, relu_in=True, layout="oihw"))
            if (hw, c) in FUSED_TAIL_SHAPES:  # the fused tail and its backward, forced at B=1 too
                args, gout = tail_operands(rnd, b, hw, c)
                saved = tail_saved(args)
                _, pre11, x1, pre21, out = saved
                kargs = [args[0]] + [c3.hwio(t) if t.dim() == 4 else t for t in args[1:]]
                hold("residual_tail_fused", f"B={b} {hw}^2x{c}",
                     canary(rt.residual_tail_fused, *kargs, keep=True, offset=offset),
                     (out, pre11, x1, pre21))
                hold("residual_tail_backward_fused", f"B={b} {hw}^2x{c}",
                     canary(rt.residual_tail_backward_fused, gout, *saved, *kargs[1::2], offset=offset),
                     rt.residual_tail_backward_plain(gout, *saved, *args[1::2]))
                del args, kargs, saved, pre11, x1, pre21, out, gout
        n = 101
        w, alpha, eta = rnd(n, n, scale=0.01), rnd(n, n).abs() * 0.01, torch.full((1,), 0.01, device=dev)
        x, hebb = rnd(b, n, n), rnd(b, n, n, scale=0.1)
        for fam in FAMILIES:
            try:
                plan = head_plan(b, n, family=fam)
            except ValueError:
                continue
            for rule in ("hebb", "oja"):
                hold("plastic_head", f"B={b} n={n} {fam} {rule}",
                     canary(plastic_head, w, alpha, eta, x, hebb, rule=rule, plan=plan, offset=offset),
                     plastic_head_plain(w, alpha, eta, x, hebb, rule=rule))
    torch.cuda.synchronize()
    print(f"[2] NaN canary, inputs {offset} float(s) into NaN-filled buffers, outputs in NaN-filled blocks: "
          f"{len(lines)} cases (conv3x3 and dgrad in each family, wgrad, the fused tail and its backward, the head's families; level shapes, "
          f"B={B} and B=1) finite and within tolerance, max|diff| {max(e for *_, e in lines):.3g}", flush=True)
    return lines


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

COUNTERS = dict(zip(COUNTED, ("kernel.head.all", "kernel.tail_fwd.all", "kernel.tail_fwd.fused", "kernel.conv3x3.fwd",
                               "kernel.tail_bwd.all", "kernel.conv3x3.dgrad", "kernel.wgrad.all",
                               "kernel.tail_bwd.fused")))  # COUNTED's names -> the counters of utils.profiling


def reset_counts():
    from plastic_unet_tpu_torch.utils import profiling

    profiling.reset()


def read_counts() -> dict:
    """The launches since the last reset_counts(), by COUNTED's names. A CUDA graph's launches count at
    each replay (utils.profiling.Capture.replayed), not at its capture."""
    from plastic_unet_tpu_torch.utils import profiling

    c = profiling.counters()
    return {name: c.get(key, 0) for name, key in COUNTERS.items()}


def all_reduces() -> int:
    """parallel.dp.all_reduce_mean's calls since the last reset_counts()."""
    from plastic_unet_tpu_torch.utils import profiling

    return profiling.counters().get("collective.all_reduce", 0)


def expect_counts(label: str, chunks: int, neurons: int = 16) -> dict:
    """Serving: forward launches per chunk of B (chunk_counts), and no backward launch at all."""
    counts = read_counts()
    want = dict.fromkeys(COUNTED, 0)
    want.update(scaled(chunk_counts(neurons), chunks))
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
    expect_counts("score_model_best_iou, 64 tiles", 1, 8)
    print(f"[4] epoch-225 checkpoint on the 64 hard validation tiles: best threshold {thr!r}, "
          f"best IoU {iou!r}", flush=True)
    check(abs(thr - CKPT_THRESHOLD) <= 1e-6, f"best threshold {thr} != {CKPT_THRESHOLD}")
    check(abs(iou - CKPT_IOU) <= 1 / 640, f"best IoU {iou} != {CKPT_IOU} +- 1/640")

    cpu_model = checkpoint_model()
    t32 = float(threshold_as_f32(thr))
    for n in (1, 37, 128):
        reset_counts()
        rles = pred.predict_rle(tiles[:n], threshold=thr)
        expect_counts(f"predict_rle {n} tiles", 1, 8)
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
        expect_counts("predict 256 tiles -> submission.csv", 2, 8)
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
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_dgrad, conv3x3_dgrad_plain, conv3x3_plan, hwio
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
        for plan in family_plans(b, h, w, cout, cin, True):
            family = plan.family
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
        print(f"[7] conv3x3_dgrad B={b} {h}x{w} {cout}->{cin}, 4 flag sets, every family with a tiling "
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
    phase_fused_backward(dev, hold, names)
    print(f"[7] residual_tail_backward_fused: max|diff| against the plain chain "
          f"{errs.all('residual_tail_backward_fused'):.3g}, over max(1, max|ref|) "
          f"{rel['residual_tail_backward_fused']:.3g}", flush=True)
    torch.cuda.synchronize()
    return errs


def phase_fused_backward(dev, hold, names):
    """The fused backward (csrc/residual_tail_backward.cu, forced) at FUSED_TAIL_CHECKS x FUSED_TAIL_BS:
    dx0 equal to the eight launches' bit for bit (where their dgrad takes square tiles or whole
    samples; the split family sums in its own order), every gradient within phase 2's tolerance of the
    plain chain, two runs alike; where tail_bwd_plan takes the fused route, dW and db no farther from
    a float64 run of the plain chain than the eight launches' (theirs sum in another order, so their
    bits differ). Then residual_tail under autograd: its gradients equal its route's own (fused or
    eight) on the tensors it saved, bit for bit."""
    from plastic_unet_tpu_torch.ops import residual_tail as rt
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_plan, hwio

    g = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    for hw, c in FUSED_TAIL_CHECKS:
        for b in FUSED_TAIL_BS:
            args, gout = tail_operands(rnd, b, hw, c)
            saved = tail_saved(args)
            ws = args[1::2]
            ks = [hwio(w) for w in ws]
            plan = rt.tail_bwd_plan(b, hw, hw, c, family="fused")
            what = f"residual_tail_backward_fused B={b} {hw}^2x{c} (bands, rows) {(plan.bands, plan.rows)}"
            fused = rt.residual_tail_backward_fused(gout, *saved, *ks)
            again = rt.residual_tail_backward_fused(gout, *saved, *ks)
            eight = rt.residual_tail_backward_eight(gout, *saved, *ks)
            for nm, gt, rf in zip(names, fused, rt.residual_tail_backward_plain(gout, *saved, *ws)):
                hold("residual_tail_backward_fused", b, hw, f"{what} {nm} vs plain chain", gt, rf)
            check(all(bool(torch.equal(x, y)) for x, y in zip(fused, again)), f"{what}: two runs differ in some bit")
            square = conv3x3_plan(b, hw, hw, c, c, True).family != "split"
            check(not square or bool(torch.equal(fused[0], eight[0])),
                  f"{what}: dx0 differs from the eight launches' in some bit")
            p64 = rt.residual_tail_backward_plain(gout.double(), *(t.double() for t in saved),
                                                  *(w.double() for w in ws))
            far = [max(float((x.double() - q).abs().max()) for x, q in zip(r[1:], p64[1:])) for r in (fused, eight)]
            routed = rt.tail_bwd_plan(b, hw, hw, c).family == "fused"
            check(not routed or far[0] <= far[1], f"{what}: dW, db {far[0]:.3g} from float64, the eight "
                  f"launches' {far[1]:.3g}")
            leaves = [t.clone().requires_grad_() for t in args]
            out = rt.residual_tail(*leaves)
            kept = out.grad_fn.saved_tensors
            grads = torch.autograd.grad(out, leaves, gout)
            route = rt.residual_tail_backward_fused if routed else rt.residual_tail_backward_eight
            want = route(gout, *kept)
            check(all(bool(torch.equal(x, y)) for x, y in zip(grads, want)),
                  f"{what}: residual_tail under autograd differs from its route's gradients")
            print(f"[7] {what}: two runs alike; dx0 {'== the eight launches bit for bit' if square else 'not held to the eight launches (their dgrad splits K)'}; "
                  f"dW, db from float64: fused {far[0]:.3g}, eight {far[1]:.3g}"
                  f"{' (held: tail_bwd_plan fuses here)' if routed else ''}; under autograd by the "
                  f"{'fused' if routed else 'eight'} route, equal to it", flush=True)
            del args, gout, saved, fused, again, eight, p64, leaves, out, kept, grads, want


# --------------------------------------------------------------------------- phase 6

def cudnn_tail_nhwc(x0, w11, b11, w12, b12, w21, b21, w22, b22):
    """The tail on cuDNN (NHWC in and out): four F.conv2d calls with their ReLUs and skips, the
    yardstick of the forward (phase 6) and, through autograd, of the backward (phase 10)."""
    import torch.nn.functional as F

    def conv(x, w, b):
        return F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)

    h1 = torch.relu(x0)
    x1 = conv(torch.relu(conv(h1, w11, b11)), w12, b12) + h1
    h2 = torch.relu(x1)
    return torch.relu(conv(torch.relu(conv(h2, w21, b21)), w22, b22) + h2)


def tail_route_sweep(rnd) -> list:
    """Both tail routes, forced, at FUSED_TAIL_CHECKS x TAIL_SWEEP_BS where the fused kernel may run
    (conv3x3_plan's square tiles): rows (H, C, B, four ms, fused ms, fused keeping pre11/x1/pre21 ms,
    tail_plan's route), printed with the faster route; the evidence tail_plan's rule is set from."""
    from plastic_unet_tpu_torch.ops import residual_tail as rt
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_plan, hwio

    rows = []
    for hw, c in FUSED_TAIL_CHECKS:
        for b in TAIL_SWEEP_BS:
            if conv3x3_plan(b, hw, hw, c, c).family != "tile":
                continue
            args, _ = tail_operands(rnd, b, hw, c)
            ks = [hwio(t) for t in args[1::2]]
            kargs = (args[0], ks[0], args[2], ks[1], args[4], ks[2], args[6], ks[3], args[8])
            four = time_ms(lambda: rt.residual_tail_four(*kargs))[0]
            fused = time_ms(lambda: rt.residual_tail_fused(*kargs))[0]
            keep = time_ms(lambda: rt.residual_tail_fused(*kargs, keep=True))[0]
            route = rt.tail_plan(b, hw, hw, c).family
            rows.append([hw, c, b, four, fused, keep, route])
            faster = "fused" if fused < four else "four"
            print(f"[6] tail routes {hw}x{hw}x{c} B={b}: four launches {four:.4f} ms, fused {fused:.4f} ms "
                  f"(keeping {keep:.4f}), faster {faster}, tail_plan {route}", flush=True)
            del args, ks, kargs
    return rows


def tail_bwd_route_sweep(rnd) -> list:
    """Both backward routes, forced, at FUSED_TAIL_CHECKS x TAIL_SWEEP_BS where the fused kernel fits,
    and at each shape's first B of tail_bwd_plan's fused route and the one before it: rows (H, C, B,
    eight ms, fused ms, tail_bwd_plan's route), printed with the faster route; the evidence the rule
    is set from."""
    from plastic_unet_tpu_torch.ops import residual_tail as rt
    from plastic_unet_tpu_torch.ops.conv3x3 import hwio

    rows = []
    for hw, c in FUSED_TAIL_CHECKS:
        first = next((b for b in range(1, 8 * B) if rt.tail_bwd_plan(b, hw, hw, c).family == "fused"), None)
        edge = {first - 1, first} if first else set()  # the rule's boundary, timed too
        for b in sorted(set(TAIL_SWEEP_BS) | edge):
            args, gout = tail_operands(rnd, b, hw, c)
            saved = tail_saved(args)
            ks = [hwio(t) for t in args[1::2]]
            eight = time_ms(lambda: rt.residual_tail_backward_eight(gout, *saved, *ks))[0]
            fused = time_ms(lambda: rt.residual_tail_backward_fused(gout, *saved, *ks))[0]
            route = rt.tail_bwd_plan(b, hw, hw, c).family
            rows.append([hw, c, b, eight, fused, route])
            print(f"[10] backward routes {hw}x{hw}x{c} B={b}: eight launches {eight:.4f} ms, fused {fused:.4f} ms, "
                  f"faster {'fused' if fused < eight else 'eight'}, tail_bwd_plan {route}", flush=True)
            del args, gout, saved, ks
        print(f"[10] tail_bwd_plan takes the fused backward at {hw}x{hw}x{c} from B={first} (the batch's pixels "
              f"fill {rt.BWD_MIN_FILL:.0%} of the card's pixel slots; not where the dgrad takes whole samples)",
              flush=True)
    return rows


def phase_times(dev, name, full, main_counts, errs):
    import torch.nn.functional as F

    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, hwio
    from plastic_unet_tpu_torch.ops.plastic_head import head_plan, plastic_head, plastic_head_plain
    from plastic_unet_tpu_torch.ops import residual_tail as rt
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail, residual_tail_plain
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    pk = peaks(name)
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def cudnn_conv(x, w, b):
        return F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)

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
                    cudnn_ms=time_ms(lambda: cudnn_tail_nhwc(*targs))[0],  # four F.conv2d calls + elementwise
                )
                tail["bound_ms"], tail["bound_by"] = bound_ms(
                    4 * 2 * 9 * c * c * b * hw * hw, 4 * (2 * b * hw * hw * c + 4 * (9 * c * c + c)), pk)
                plan = rt.tail_plan(b, hw, hw, c)
                tail["route"] = plan.family
                if plan.family == "fused":  # the other route on the same inputs: four conv3x3 launches
                    ks = [hwio(t) for t in wt]
                    kargs = (xx, ks[0], bs[0], ks[1], bs[1], ks[2], bs[2], ks[3], bs[3])
                    tail["four_ms"] = time_ms(lambda: rt.residual_tail_four(*kargs))[0]
                    tail["keep_ms"] = time_ms(lambda: rt.residual_tail_fused(*kargs, keep=True))[0]
                for kname, d in (("conv3x3", conv), ("residual_tail", tail)):
                    route = "" if kname == "conv3x3" else f" [{d['route']}]"
                    print(f"[6] {kname} {hw}x{hw}x{c} B={b}{route}: kernel {d['ms']:.4f} ms, plain {d['plain_ms']:.4f} ms, "
                          f"cuDNN {d['cudnn_ms']:.4f} ms, bound {d['bound_ms']:.5f} ms ({d['bound_by']}), "
                          f"{d['bound_ms'] / d['ms']:.1%} of bound", flush=True)
                    table[(kname, b, hw)] = d
                if "four_ms" in tail:
                    print(f"[6] residual_tail {hw}x{hw}x{c} B={b}: fused {tail['ms']:.4f} ms ({tuple(plan)}; "
                          f"keeping pre11, x1, pre21 {tail['keep_ms']:.4f} ms) "
                          f"against four conv3x3 launches {tail['four_ms']:.4f} ms: {tail['four_ms'] / tail['ms']:.3f}x",
                          flush=True)
        table["tail_sweep"] = tail_route_sweep(rnd)
    tails_ms = sum(TAILS_PER_CHUNK[hw] * table[("residual_tail", B, hw)]["ms"] for hw, _ in LEVELS)

    xs = np.random.default_rng(2).random((4 * B, 101, 101), dtype=np.float32)

    def serve_seconds():
        """Median of 3 host-clock timings of a 4-chunk request."""
        full.predict_probs(xs[:B])
        torch.cuda.synchronize()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            full.predict_probs(xs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return float(np.median(secs))

    sec = serve_seconds()
    with serving_cudnn_not_deterministic():
        sec_free = serve_seconds()
    sec_again = serve_seconds()
    table["serving_tiles_s"] = 4 * B / sec
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
    print(f"[6] serving under deterministic cuDNN (utils.precision.serving_numerics, the C5 repair) "
          f"{4 * B / sec:.1f} then {4 * B / sec_again:.1f} tiles/s; between them, cuDNN free to pick algorithms "
          f"that do not repeat (as before the repair) {4 * B / sec_free:.1f} tiles/s (NVIDIA card: {name})",
          flush=True)

    sources = {
        "plastic_head": ("plastic_unet_tpu_torch/csrc/plastic_head.cu",
                         "plastic_unet_tpu/ops/pallas_plastic.py:40"),
        "conv3x3": ("plastic_unet_tpu_torch/csrc/conv3x3.cu", "plastic_unet_tpu/ops/pallas_conv.py:81"),
        "residual_tail": ("plastic_unet_tpu_torch/csrc/residual_tail.cu",
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
        if kname == "residual_tail":  # the fused kernel's own launches; the tails of the path, either route
            other = table[(kname, B, 50)]
            entry.update({"counter": "residual_tail_fused", "launches": main_counts["residual_tail_fused"],
                          "launches_tails": main_counts["residual_tail"],
                          "route_b128": many["route"], "route_b1": one["route"], "four_launch_ms": many["four_ms"],
                          "keep_ms": many["keep_ms"], "ms_50": other["ms"], "four_launch_ms_50": other["four_ms"],
                          "keep_ms_50": other["keep_ms"], "plain_ms_50": other["plain_ms"],
                          "bound_ms_50": other["bound_ms"], "cudnn_ms_50": other["cudnn_ms"],
                          "max_abs_err_50": errs.at(kname, B, 50),
                          "route_sweep": table["tail_sweep"]})
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


def train_run(rule, device, X, Y, *, graph, dropout=0.0, lanes=1, drop_seed=None, mesh=None, trace_mode="per_device",
              **options):
    """A seeded full-width model (``options``: UNetPRes's, e.g. trunk_pad)
    trained over the stream; (state, losses). With a ``mesh``, the
    data-parallel epoch (phase 16)."""
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.parallel.dp import make_dp_epoch_fn
    from plastic_unet_tpu_torch.train.loop import create_train_state, make_epoch_fn

    model = UNetPRes(neurons=16, nbf=101, rule=rule, dropout_ratio=dropout,
                     generator=torch.Generator().manual_seed(3), **options)
    gen = None if drop_seed is None else torch.Generator(device=device).manual_seed(drop_seed)
    state = create_train_state(model, TRAIN_LR, TRAIN_GAMMA, TRAIN_STEP_SIZE, lanes=lanes, generator=gen,
                               device=device)
    epoch = make_epoch_fn(graph=graph) if mesh is None else make_dp_epoch_fn(mesh, graph=graph, trace_mode=trace_mode)
    return epoch(state, X.to(device), Y.to(device))


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

        # The default on the card: the step captured into a CUDA graph. Its body runs twice (the
        # warm-up steps) and is captured once; each replay counts the captured launches.
        reset_counts()
        g_state, g_losses = train_run(rule, dev, X, Y, graph=None)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {k: (TRAIN_STEPS + 2) * v for k, v in STEP_COUNTS.items()}
        check(counts == want, f"{rule}: launches of the graph run {counts} != {want} (warm-up 2 + a replay a step)")
        check(bool(torch.equal(g_losses, losses)), f"{rule}: graph losses differ from the eager ones: "
              f"{(g_losses - losses).abs().max().item():.3g}")
        same = all(bool(torch.equal(a, b)) for a, b in zip(g_state.model.parameters(), state.model.parameters()))
        check(same and bool(torch.equal(g_state.hebb, state.hebb)), f"{rule}: graph parameters or trace differ")
        print(f"[8] neurons=16 {rule} B=1, the default path (CUDA graph): {TRAIN_STEPS} losses, final parameters and "
              f"trace equal the eager ones bit for bit; the kernels were counted for 2 warm-up steps and each replay "
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
    reset_counts()
    e_state, e_losses = train_run("oja", dev, Xl, Yl, graph=False, lanes=B)
    torch.cuda.synchronize()
    counts, per_step = read_counts(), lane_step_counts(B)
    check(counts == scaled(per_step, 4), f"lanes={B}: launches of 4 eager steps {counts} != {scaled(per_step, 4)}")
    print(f"[9] MAIN PATH (training, lanes): neurons=16 oja, lanes={B}, 4 eager steps: launches per step "
          f"{({k: v for k, v in per_step.items() if v})}", flush=True)
    reset_counts()
    state, losses = train_run("oja", dev, Xl, Yl, graph=None, lanes=B)
    torch.cuda.synchronize()
    check(read_counts() == scaled(per_step, 4 + 2), f"lanes={B}: launches of the graph run {read_counts()} != "
          f"{scaled(per_step, 4 + 2)} (warm-up 2 + a replay a step)")
    check(bool(torch.isfinite(losses).all()) and tuple(state.hebb.shape) == (B, 101, 101)
          and bool(torch.isfinite(state.hebb).all()), f"lanes={B}: bad losses or trace")
    check(bool(torch.equal(losses, e_losses)) and bool(torch.equal(state.hebb, e_state.hebb)),
          f"lanes={B}: graph losses or trace differ from the eager ones: {(losses - e_losses).abs().max().item():.3g}")
    print(f"[8] lanes={B}, 4 steps, the default path (CUDA graph): losses {[round(v, 5) for v in losses.tolist()]}, "
          f"trace {tuple(state.hebb.shape)}; both equal the eager run's bit for bit; the kernels were launched for 3 "
          f"steps and by no replay", flush=True)

    # The fewest lanes at which the fused backward takes both 101^2 and 50^2: eager on the card against the CPU port.
    nl = fused_bwd_lanes()
    Xs, Ys = train_stream(4, nl, seed=25)
    t0 = time.time()
    cpu_state, cpu_losses = train_run("oja", "cpu", Xs, Ys, graph=False, lanes=nl)
    t_cpu = time.time() - t0
    reset_counts()
    state, losses = train_run("oja", dev, Xs, Ys, graph=False, lanes=nl)
    torch.cuda.synchronize()
    want = scaled(lane_step_counts(nl), 4)
    check(read_counts() == want and want["residual_tail_backward_fused"] == 16,
          f"lanes={nl}: launches of 4 eager steps {read_counts()} != {want}")
    e_loss = float((losses.cpu() - cpu_losses).abs().max())
    e_par = max(float((a.detach().cpu() - q.detach()).abs().max())
                for a, q in zip(state.model.parameters(), cpu_state.model.parameters()))
    e_tr = float((state.hebb.cpu() - cpu_state.hebb).abs().max())
    check(bool(torch.isfinite(losses).all()) and e_loss <= 5e-5,
          f"lanes={nl}: per-step losses card vs CPU port max|diff| {e_loss:.3g} > 5e-5")
    check(e_par <= 5e-4, f"lanes={nl}: final parameters card vs CPU port max|diff| {e_par:.3g} > 5e-4")
    check(float(state.hebb.abs().max()) > 0 and e_tr <= 1e-4, f"lanes={nl}: trace card vs CPU max|diff| {e_tr:.3g}")
    print(f"[8] lanes={nl} (the fewest at which the fused backward takes the 101^2 and 50^2 tails), 4 steps, eager on "
          f"the card vs the CPU port ({t_cpu:.1f}s): losses {[round(v, 6) for v in losses.tolist()]}, max|diff| "
          f"losses {e_loss:.3g}, parameters {e_par:.3g}, trace {e_tr:.3g}; launches per step "
          f"{({k: v // 4 for k, v in want.items() if v})}", flush=True)
    return step_counts, per_step


# --------------------------------------------------------------------------- phase 10

def backward_flops(neurons: int, size: int = 101, nbf: int = 101) -> float:
    """Counted as forward_flops counts: every conv's backward is an input
    gradient and a weight gradient of the forward's size each, except that
    the first conv's input (the image) takes no gradient; the head's
    backward is two (nbf, nbf) products for the forward's one."""
    return 2 * forward_flops(neurons, size, nbf) - 2 * 9 * size * size * neurons


def phase_training_times(dev, name, errs, step_counts, lane_counts, fwd_table):
    import torch.nn.functional as F

    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_dgrad, conv3x3_dgrad_plain, hwio
    from plastic_unet_tpu_torch.ops.conv3x3_wgrad import conv3x3_wgrad, conv3x3_wgrad_plain
    from plastic_unet_tpu_torch.ops import residual_tail as rt
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
                leaves = [t.clone().requires_grad_() for t in args]
                with torch.enable_grad(), training_numerics():  # cuDNN's chain through autograd, at both B
                    lib_out = cudnn_tail_nhwc(*leaves)
                    tail["library_chain_ms"] = time_ms(
                        lambda: torch.autograd.grad(lib_out, leaves, gout, retain_graph=True))[0]
                del leaves, lib_out
                if b == 1 and hw == LEVELS[0][0]:
                    print(f"[10] residual_tail_backward {hw}x{hw}x{c} B=1: cuDNN's chain by autograd (deterministic, "
                          f"TF32 off) {tail['library_chain_ms']:.4f} ms", flush=True)
                if b == B:  # the route, the eight launches forced, the fused kernel where it fits
                    tail["route"] = rt.tail_bwd_plan(b, hw, hw, c).family
                    tail["eight_ms"] = time_ms(lambda: rt.residual_tail_backward_eight(gout, *saved, *ks))[0]
                    try:
                        rt.tail_bwd_plan(b, hw, hw, c, family="fused")
                    except ValueError:  # no fused tiling at this width
                        tail["fused_ms"] = None
                    else:
                        tail["fused_ms"] = time_ms(lambda: rt.residual_tail_backward_fused(gout, *saved, *ks))[0]
                        table[("residual_tail_backward_fused", b, hw)] = dict(
                            ms=tail["fused_ms"], plain_ms=tail["plain_ms"], bound_ms=tail["bound_ms"],
                            bound_by=tail["bound_by"], eight_ms=tail["eight_ms"],
                            library_chain_ms=tail["library_chain_ms"])
                    fused = "none" if tail["fused_ms"] is None else f"{tail['fused_ms']:.4f} ms"
                    print(f"[10] residual_tail_backward {hw}x{hw}x{c} B={b}: route {tail['route']} {tail['ms']:.4f} ms; "
                          f"fused {fused}, eight launches {tail['eight_ms']:.4f} ms, cuDNN's chain by autograd "
                          f"(deterministic, TF32 off) {tail['library_chain_ms']:.4f} ms, bound {tail['bound_ms']:.5f} ms",
                          flush=True)
                for kname, e in (("conv3x3_dgrad", dgrad), ("conv3x3_wgrad", wgrad), ("residual_tail_backward", tail)):
                    lib = "none" if e["library_ms"] is None else f"{e['library_ms']:.4f} ms"
                    if "library_det_ms" in e:
                        lib += f" (deterministic cuDNN {e['library_det_ms']:.4f} ms)"
                    print(f"[10] {kname} {hw}x{hw}x{c} B={b}: kernel {e['ms']:.4f} ms, plain {e['plain_ms']:.4f} ms, "
                          f"library {lib}, bound {e['bound_ms']:.5f} ms ({e['bound_by']}), "
                          f"{e['bound_ms'] / e['ms']:.1%} of bound", flush=True)
                    table[(kname, b, hw)] = e

    table["bwd_sweep"] = tail_bwd_route_sweep(rnd)

    # the whole step, B=1
    X, Y = train_stream(16, 1, seed=23)
    X, Y = X.to(dev), Y.to(dev)
    n_steps = 48

    def fresh_state(lanes=1):
        from plastic_unet_tpu_torch.models.unet_res import UNetPRes

        model = UNetPRes(neurons=16, nbf=101, rule="oja", dropout_ratio=0.0,
                         generator=torch.Generator().manual_seed(3))
        return create_train_state(model, TRAIN_LR, TRAIN_GAMMA, 1e6, lanes=lanes, device=dev)

    eager, st = make_train_step(), fresh_state()
    eager(st, (X[0], Y[0]))
    eager_s = step_rate(eager, st, X, Y, n_steps)
    st_g = fresh_state()
    graph = GraphTrainStep(st_g, X.shape[1:], Y.shape[1:])
    graph(st_g, (X[0], Y[0]))
    graph_s = step_rate(graph, st_g, X, Y, n_steps)
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
    lane_s = step_rate(eager, st_l, Xl, Yl, 4)
    lane_dev_ms, _ = time_ms(lambda: eager(st_l, (Xl[0], Yl[0])), reps=5, warmup=1)
    lane_bound, _ = bound_ms(flops * B, 0.0, pk)
    tails_bwd_l = sum(TAILS_PER_CHUNK[hw] * table[("residual_tail_backward", B, hw)]["ms"] for hw, _ in LEVELS)
    tails_bwd_8 = sum(TAILS_PER_CHUNK[hw] * table[("residual_tail_backward", B, hw)]["eight_ms"] for hw, _ in LEVELS)
    print(f"[10] training step neurons=16 lanes={B}, eager: {B / lane_s:.1f} samples/s ({lane_s * 1e3:.2f} ms per "
          f"step, host clock; device time {lane_dev_ms:.2f} ms, device idle share "
          f"{max(0.0, 1 - lane_dev_ms / (lane_s * 1e3)):.1%}); 9 tail backwards {tails_bwd_l:.2f} ms of it by "
          f"tail_bwd_plan's routes ({lane_counts['residual_tail_backward_fused']} fused; all nine by the eight "
          f"launches: {tails_bwd_8:.2f} ms); bound {lane_bound:.2f} ms at the fp32 peak", flush=True)

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
        if kname == "residual_tail_backward":  # B=128 by route: the fused kernel at 101^2 and 50^2
            entry.update({f"route_b{B}": many["route"], f"eight_launch_ms_b{B}": many["eight_ms"],
                          "library_chain_ms": one["library_chain_ms"],
                          f"library_chain_ms_b{B}": many["library_chain_ms"]})
        kernels.append(entry)
    # the fused backward: the lanes path's kernel (no B=1 step takes it); its shape B=128 101x101x16
    fb, fb50 = table[("residual_tail_backward_fused", B, 101)], table[("residual_tail_backward_fused", B, 50)]
    kernels.append({
        "name": "residual_tail_backward_fused", "route": "cuda",
        "source": "plastic_unet_tpu_torch/csrc/residual_tail_backward.cu",
        "replaces": "plastic_unet_tpu/ops/pallas_trunk.py:231", "launches": lane_counts["residual_tail_backward_fused"],
        "main_path": f"one eager training step, lanes={B}", "max_abs_err": errs.at("residual_tail_backward_fused", B),
        "ms": fb["ms"], "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"], "bound_by": fb["bound_by"],
        "library_ms": None, "shape": f"B={B} 101x101x16", "eight_launch_ms": fb["eight_ms"],
        "library_chain_ms": fb["library_chain_ms"], "ms_50": fb50["ms"], "eight_launch_ms_50": fb50["eight_ms"],
        "plain_ms_50": fb50["plain_ms"], "bound_ms_50": fb50["bound_ms"], "library_chain_ms_50": fb50["library_chain_ms"],
        "max_abs_err_50": errs.at("residual_tail_backward_fused", B, 50),
        "max_abs_err_all_shapes": errs.all("residual_tail_backward_fused"), "route_sweep": table["bwd_sweep"]})
    return kernels, graph_s


# --------------------------------------------------------------------------- phase 11

# "--precision parity": the CLIs default to "perf" (TF32), and phase 11 sets the driver against the true-fp32
# graph step of phase 10; cli.tuned_run has no --precision (its TrainConfig's "perf"), as the JAX one
DRIVER_ARGS = ["--synthetic", "40", "--neurons", "16", "--dropout", "0.5", "--shuffle", "--augment",
               "--validate_every", "2", "--save_every", "2", "--precision", "parity"]  # 32 train / 8 validation tiles
TUNED_ARGS = ["--synthetic", "40", "--epochs", "2", "--neurons", "16"]
TIMED_ARGS = ["--synthetic", "4000", "--neurons", "16", "--dropout", "0.5", "--shuffle", "--augment", "-e", "2",
              "--precision", "parity"]
TIMED_TRAIN = 3200  # 3,200 train / 800 validation tiles: the TGS train set's 4,000, split as the CLI splits it


def phase_driver(dev, smi, graph_step_s):
    """The training entry point on the card: cli.train at full width with
    dropout, shuffle and augmentation, 4 epochs folded 2 a dispatch against
    1 a dispatch and against 2 epochs then a resume for 2 more (bit for bit);
    the three artifacts; cli.tuned_run to submission.csv; the kernels'
    launches during the driver's epochs; the driver's time per epoch at the
    TGS train set's size, 1 and 2 epochs a dispatch, against the bare graph
    step."""
    import pickle

    from plastic_unet_tpu_torch.cli import train as cli_train
    from plastic_unet_tpu_torch.cli import tuned_run as cli_tuned
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.train import loop
    from plastic_unet_tpu_torch.train.driver import RESUME_STATE

    dispatches = []  # (epochs, start, end) of every dispatch of a timed run, host clock
    real_make = loop.make_multi_epoch_fn

    def timed_make(*a, **kw):
        fn = real_make(*a, **kw)

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, losses = fn(*args, **kwargs)
            torch.cuda.synchronize()
            dispatches.append((losses.shape[0], t, time.perf_counter()))
            return state, losses

        return run

    def timed_train(argv):
        """cli.train.main(argv) with its dispatches timed -> (result, t0, t_end, dispatches)."""
        dispatches.clear()
        loop.make_multi_epoch_fn = timed_make
        try:
            t0 = time.perf_counter()
            res = cli_train.main(argv)
            torch.cuda.synchronize()
            return res, t0, time.perf_counter(), list(dispatches)
        finally:
            loop.make_multi_epoch_fn = real_make

    on = [] if dev.type == "cuda" else ["--device", str(dev)]  # the card takes the CLIs' default device

    def same_params(a, b):
        return all(bool(torch.equal(p, q)) for p, q in zip(a.model.parameters(), b.model.parameters()))

    with tempfile.TemporaryDirectory() as tmp:
        out = {k: os.path.join(tmp, k) for k in ("k2", "k1", "first", "rest", "tuned")}
        reset_counts()
        k2, t0, t_end, small = timed_train(DRIVER_ARGS + on + ["-o", out["k2"], "-e", "4",
                                                               "--epochs-per-dispatch", "2"])
        counts = read_counts()
        total_s = t_end - t0
        # the graph is captured once (2 warm-up steps launch the kernels, and each of the 128 replays
        # counts the captured launches) and each of the 2 validations runs one 128-tile chunk
        want = {k: (2 + 128) * v for k, v in STEP_COUNTS.items()}
        for k, v in chunk_counts().items():
            want[k] += 2 * v
        check(counts == want, f"driver launches {counts} != {want}")
        print(f"[11] MAIN PATH (driver): cli.train neurons=16, 4 epochs of 32 tiles, dropout 0.5, shuffle, augment, "
              f"2 epochs a dispatch: launches {counts} (2 warm-up steps + {len(k2.all_losses)} replays + 2 validation chunks)", flush=True)
        check(len(k2.all_losses) == 128 and bool(np.isfinite(k2.all_losses).all()), "driver: bad losses")
        check(len(k2.val_test_losses) == 2 and k2.state.step == 128, "driver: validations or step count")

        k1 = cli_train.main(DRIVER_ARGS + on + ["-o", out["k1"], "-e", "4", "--epochs-per-dispatch", "1"])
        check(k1.all_losses == k2.all_losses and k1.val_test_losses == k2.val_test_losses and same_params(k1, k2),
              "driver: 2 epochs a dispatch differ from 1 a dispatch")
        print("[11] 2 epochs a dispatch == 1 a dispatch, bit for bit: 128 losses, 2 validations, the parameters",
              flush=True)

        first = cli_train.main(DRIVER_ARGS + on + ["-o", out["first"], "-e", "2"])
        rest = cli_train.main(DRIVER_ARGS + on + ["-o", out["rest"], "-e", "2", "--resume",
                                             os.path.join(out["first"], RESUME_STATE)])
        check(first.all_losses + rest.all_losses == k2.all_losses, "resume: losses differ from the straight run")
        check(rest.val_test_losses[-1] == k2.val_test_losses[-1] and same_params(rest, k2)
              and rest.state.step == 128, "resume: parameters or validation differ from the straight run")
        check(bool(torch.equal(rest.state.generator.get_state(), k2.state.generator.get_state())),
              "resume: the dropout generator's state differs from the straight run's")
        print("[11] 2 epochs, then a resume for 2 more == 4 straight, bit for bit: losses, parameters, the last "
              "validation, the dropout generator's state", flush=True)

        model = UNetPRes(neurons=int(DRIVER_ARGS[DRIVER_ARGS.index("--neurons") + 1]), nbf=101)
        model.load_state_dict(torch.load(os.path.join(out["k2"], "train_net.pth"), weights_only=True), strict=True)
        check(all(bool(torch.equal(p.cpu(), q)) for p, q in zip(k2.model.parameters(), model.parameters())),
              "train_net.pth: weights differ from the run's")
        with open(os.path.join(out["k2"], "train_parameters.dat"), "rb") as f:
            rp = pickle.load(f)
        check(rp["device"] == dev.type and rp["epochs"] == 4, f"train_parameters.dat: {rp}")
        h5 = os.path.join(out["k2"], "train_data.hdf5")
        try:
            import h5py
        except ImportError:
            check(not os.path.exists(h5), "train_data.hdf5 written without h5py")
            h5_note = "h5py is not installed here: train_data.hdf5 not written (the save said so)"
        else:
            with h5py.File(h5, "r") as f:
                check(list(f["train/all_losses"][()]) == k2.all_losses, "train_data.hdf5: losses differ")
            h5_note = "train_data.hdf5 read back with h5py"
        print(f"[11] artifacts: train_net.pth loads strict into a fresh UNetPRes(neurons=16) with the run's weights; "
              f"train_parameters.dat unpickles (device {rp['device']!r}); {h5_note}", flush=True)

        path = cli_tuned.main(TUNED_ARGS + on + ["--out", out["tuned"]])
        lines = open(path).read().splitlines()
        check(lines[0] == "id,rle_mask" and [ln.split(",")[0] for ln in lines[1:]] == [f"syn{i}" for i in range(20)],
              "tuned_run: submission.csv header or ids")
        print(f"[11] cli.tuned_run --synthetic 40 --epochs 2 --neurons 16: submission.csv with {len(lines) - 1} rows, "
              f"{sum(1 for ln in lines[1:] if ln.split(',', 1)[1])} non-empty", flush=True)

        # the driver's time at a real epoch: 1 and 2 epochs a dispatch, each run 2 epochs, 1 validation, 1 save;
        # between them the bare epoch of the same length
        timed = {}
        for k in (1, 2):
            res, t0r, t_endr, ds = timed_train(TIMED_ARGS + on + ["-o", os.path.join(tmp, f"timed{k}"),
                                                                 "--epochs-per-dispatch", str(k)])
            check(len(res.all_losses) == 2 * TIMED_TRAIN and bool(np.isfinite(res.all_losses).all()),
                  f"timed run, {k} epochs a dispatch: bad losses")
            timed[k] = (t0r, t_endr, ds)
            if k == 1:
                bare_epoch_s = time_bare_epoch(dev)

    small_epoch_s = sum(e - b for _, b, e in small[1:]) / sum(n for n, _, _ in small[1:])  # after the capture
    print(f"[11] driver time (NVIDIA card: {smi}), 32-tile epochs: cli.train 4 epochs {total_s:.3f} s end to end "
          f"({total_s / 4:.3f} s per epoch, {128 / total_s:.1f} samples/s, with the start-up, the graph capture, 2 "
          f"validations, 2 saves); dispatches (epochs, s) {[(n, round(e - b, 4)) for n, b, e in small]}; after the "
          f"first: {small_epoch_s:.4f} s per epoch against the bare graph step's {32 * graph_step_s:.4f} s",
          flush=True)
    for k, (t0r, t_endr, ds) in timed.items():
        total = t_endr - t0r
        setup, tail = ds[0][1] - t0r, t_endr - ds[-1][2]
        gaps = [b2 - e1 for (_, _, e1), (_, b2, _) in zip(ds, ds[1:])]  # host bookkeeping and the next draws
        epochs = sum(n for n, _, _ in ds)
        epoch_s = (ds[-1][2] - ds[0][1]) / epochs  # dispatches and the gaps between them, per epoch
        print(f"[11] driver time (NVIDIA card: {smi}), {TIMED_TRAIN}-tile epochs (--synthetic 4000), {k} epoch(s) a "
              f"dispatch: cli.train 2 epochs {total:.3f} s end to end; set-up {setup:.3f} s ({setup / total:.1%}: "
              f"start-up, data, staging); dispatches (epochs, s) {[(n, round(e - b, 4)) for n, b, e in ds]}, gaps "
              f"between them {[round(g, 4) for g in gaps]} s; {epoch_s:.4f} s per epoch, "
              f"{TIMED_TRAIN / epoch_s:.1f} samples/s (the first dispatch captures the graph); last validation and "
              f"save {tail:.3f} s ({tail / total:.1%}); the bare epoch (make_epoch_fn's graph alone, same model, "
              f"{TIMED_TRAIN} steps, between the two runs) {bare_epoch_s:.4f} s, "
              f"{bare_epoch_s / TIMED_TRAIN * 1e3:.3f} ms per step (phase 10's 48-step bursts: "
              f"{graph_step_s * 1e3:.3f} ms); driver overhead share {1 - bare_epoch_s / epoch_s:.2%} of an epoch, "
              f"{1 - epochs * bare_epoch_s / total:.2%} end to end", flush=True)
    return counts


# --------------------------------------------------------------------------- phase 12

SERVE_TILES, CALIB_TILES, PARITY_TILES, SERVE_NEURONS = 512, 256, 8, 16
SERVE_RTOL, SERVE_ATOL = 1e-5, 1e-6  # card against the CPU port, fp32 serving
INT8_ATOL = 1e-5  # int8 probabilities, card against the CPU port (tests/test_torch_quant.py)
# (H=W, Cin, Cout) of the 45 quantized 3x3 convs' distinct shapes (entry convs, the Middles' entries in the
# decoder, the tails) and (H=W of the input, Cin, Cout) of the 4 ConvTransposes, at neurons=16
QCONV_SHAPES = ([(101, 1, 16), (50, 16, 32), (25, 32, 64), (12, 64, 128), (6, 128, 256)]
                + [(12, 256, 128), (25, 128, 64), (50, 64, 32), (101, 32, 16)]
                + [(hw, c, c) for hw, c in LEVELS])
QCONVT_SHAPES = [(6, 256, 128), (12, 128, 64), (25, 64, 32), (50, 32, 16)]


def write_tgs_dir(root: str, n: int = 30, n_test: int = 7, size: int = 101, seed: int = 0) -> str:
    """A small fake TGS directory (the layout of tests/test_torch_dataset.py::make_tgs_dir)."""
    from PIL import Image

    for sub in ("train/images", "train/masks", "test/images"):
        os.makedirs(os.path.join(root, sub))
    rng = np.random.default_rng(seed)
    ids = [f"id{i:03d}" for i in range(n)]
    for i, idx in enumerate(ids):
        Image.fromarray((rng.random((size, size)) * 255).astype(np.uint8)).save(
            os.path.join(root, "train/images", f"{idx}.png"))
        mask = np.zeros((size, size), np.uint16)
        mask[: size * (i % 5) // 5] = 65535
        Image.fromarray(mask).save(os.path.join(root, "train/masks", f"{idx}.png"))
    for j in range(n_test):
        Image.fromarray((rng.random((size, size)) * 255).astype(np.uint8)).save(
            os.path.join(root, "test/images", f"t{j}.png"))
    with open(os.path.join(root, "train.csv"), "w") as f:
        f.write("id,rle_mask\n" + "\n".join(f"{i}," for i in ids))
    with open(os.path.join(root, "depths.csv"), "w") as f:
        f.write("id,z\n" + "\n".join(f"{i},{100 + 3 * k}" for k, i in enumerate(ids + ["t0", "t1"])))
    return root


def expect_launches(label: str, want: dict, phase: int = 12) -> dict:
    """The launch counts since the last reset_counts() are ``want`` (0 for every kernel not named)."""
    counts = read_counts()
    full = dict.fromkeys(COUNTED, 0)
    full.update(want)
    check(counts == full, f"{label}: launches {counts} != {full}")
    print(f"[{phase}] {label}: launches {({k: v for k, v in counts.items() if v})}", flush=True)
    return counts


def first_unrepeatable_layer(model, x, tries: int = 2):
    """Pairs of forwards of the chunk ``x`` (any chunk) with zero traces, up to ``tries``:
    (name, max|diff|) of the first module, in call order (a cuDNN layer, or a
    DownRes / Middle / UpRes, whose tails are this package's kernels), whose
    output differs within a pair, or None if every pair agreed. The caller
    sets the numerics (utils.precision)."""
    runs, hooks = [], []
    for name, m in model.named_modules():
        if name:
            hooks.append(m.register_forward_hook(lambda _m, _i, out, name=name: runs[-1].append((name, out.clone()))))
    try:
        with torch.inference_mode():
            for _ in range(tries):
                runs[:] = []
                for _ in range(2):
                    runs.append([])
                    model(x, model.initial_zero_hebb(x.shape[0], device=x.device))
                for (name, a), (_, b) in zip(*runs):
                    if not torch.equal(a, b):
                        return name, float((a - b).abs().max())
    finally:
        for h in hooks:
            h.remove()
    return None


def digest(t) -> tuple[int, float]:
    """(sum of the fp32 bit patterns, sum of |t|): equal for equal bits, almost surely not otherwise.
    The model's own output (a PlasticOutput) is digested by its masks."""
    if isinstance(t, tuple):
        t = t[1]
    t = t.detach()
    return int(t.contiguous().view(torch.int32).to(torch.int64).sum()), float(t.double().abs().sum())


def module_trace(model, x) -> list:
    """[(module name, digest of its first input, digest of its output)] of one forward of the chunk
    ``x`` with zero traces, in call order; the model itself last, as "<model: head output>". The
    caller sets the numerics."""
    rec, hooks = [], []
    for name, m in model.named_modules():
        hooks.append(m.register_forward_hook(
            lambda _m, inp, out, name=name or "<model: head output>": rec.append((name, digest(inp[0]), digest(out)))))
    try:
        with torch.inference_mode():
            model(x, model.initial_zero_hebb(x.shape[0], device=x.device))
    finally:
        for h in hooks:
            h.remove()
    return rec


def first_differing_module(model, a, b):
    """Two chunks of equal values (taken from two paths' tensors): (name of the first module, in call
    order, whose output differs between their forwards, whether its input's digest was equal), or
    None where the forwards agree."""
    for (name, ia, oa), (_, ib, ob) in zip(module_trace(model, a), module_trace(model, b)):
        if oa != ob:
            return name, ia == ib
    return None


def phase_serving_features(dev, smi):
    """The serving features at full width (UNetPRes neurons=16, nbf=101, seeded weights, fp32 parity) on
    SERVE_TILES synthetic tiles: the TTA views, tta8 batched against sequential, tta4 against the CPU port,
    the single-image inference(), the int8 convs against their float64 plain versions at every level shape,
    calibration, the int8 forward against the CPU port with the card's ranges, the HTTP endpoint and
    cli.infer --tta tta4 --save --quant int8; launch counts of each path; tiles/s and latencies."""
    from plastic_unet_tpu_torch.cli import infer as cli_infer
    from plastic_unet_tpu_torch.data.synthetic import synthetic_tiles
    from plastic_unet_tpu_torch.eval.evaluate import predict_masks
    from plastic_unet_tpu_torch.ops import quant as tq
    from plastic_unet_tpu_torch.ops.augment import TTA_TRANSFORMS, TTA_VIEWS_4, TTA_VIEWS_8
    from plastic_unet_tpu_torch.ops.rle import rle_decode
    from plastic_unet_tpu_torch.submit.http_server import serve
    from plastic_unet_tpu_torch.submit.inference import inference, predict_masks_tta
    from plastic_unet_tpu_torch.submit.quant import quantize_for_serving
    from plastic_unet_tpu_torch.submit.server import MaskPredictor
    from plastic_unet_tpu_torch.utils.precision import serving_numerics

    t_phase = time.time()
    imgs, _ = synthetic_tiles(SERVE_TILES, size=101, seed=78)
    tiles = np.ascontiguousarray(imgs[:, 0, :, :, None])  # (512, 101, 101, 1) NHWC
    X = torch.from_numpy(tiles).to(dev)
    model = seeded_model(SERVE_NEURONS, "oja", 0).to(dev).eval()
    cpu_model = seeded_model(SERVE_NEURONS, "oja", 0).eval()
    chunks = SERVE_TILES // B

    for v, (fwd, inv) in TTA_TRANSFORMS.items():
        back = inv(fwd(X, True).contiguous()[..., 0], False)
        check(bool(torch.equal(back, X[..., 0])), f"TTA view {v}: inverse(forward) is not the identity on the card")
    print(f"[12] the 8 TTA views: inverse(forward(x)) == x on the card, bit for bit, {SERVE_TILES} tiles", flush=True)

    counts = {}
    outs = {}
    for label, batch in (("sequential", False), ("batched", True)):
        reset_counts()
        outs[label] = predict_masks_tta(model, X, transforms=TTA_VIEWS_8, batch_views=batch, device=dev)
        torch.cuda.synchronize()
        counts[f"tta8_{label}"] = expect_launches(
            f"MAIN PATH (tta8 {label}, {SERVE_TILES} tiles = {len(TTA_VIEWS_8) * chunks} chunks)",
            scaled(chunk_counts(), 8 * chunks))
    if not torch.equal(outs["batched"], outs["sequential"]):
        # The chunks hold the same samples at the same places either way (SERVE_TILES is a multiple of B),
        # so a difference is a layer whose bits depend on more than its input's values. Name it, then fail.
        d = float((outs["batched"] - outs["sequential"]).abs().max())
        views = [TTA_TRANSFORMS[t][0](X, True).contiguous() for t in TTA_VIEWS_8]
        allv = torch.cat(views)
        found = []
        for v, t in enumerate(TTA_VIEWS_8):
            one = predict_masks(model, views[v], device=dev)
            folded = predict_masks(model, allv[v * SERVE_TILES:(v + 1) * SERVE_TILES], device=dev)
            for c in range(chunks):
                a, b = views[v][c * B:(c + 1) * B], allv[v * SERVE_TILES + c * B:v * SERVE_TILES + (c + 1) * B]
                if not torch.equal(one[c * B:(c + 1) * B], folded[c * B:(c + 1) * B]):
                    with serving_numerics():
                        found.append((t, c, first_differing_module(model, a, b),
                                      first_unrepeatable_layer(model, a)))
        print(f"[12] tta8 batched views != sequential: max|diff| {d:.3g}; per (view, chunk): the first module "
              f"whose output differs between the two paths (and whether its input's digest was equal), the "
              f"first module differing between two forwards of the chunk: {found}", flush=True)
        check(False, f"tta8 batched vs sequential max|diff| {d:.3g}: not bit for bit (ROADMAP C5)")
    print("[12] tta8 batched views == sequential views, bit for bit (torch.equal)", flush=True)
    probs = outs["batched"]
    check(tuple(probs.shape) == (SERVE_TILES, 101, 101) and bool(torch.isfinite(probs).all())
          and float(probs.min()) >= 0.0 and float(probs.max()) <= 1.0, "tta8: bad probabilities")

    card = predict_masks_tta(model, X[:PARITY_TILES], transforms=TTA_VIEWS_4, device=dev).cpu()
    ref = predict_masks_tta(cpu_model, tiles[:PARITY_TILES], transforms=TTA_VIEWS_4, chunk=PARITY_TILES,
                            device="cpu")
    e = float((card - ref).abs().max())
    check(bool(torch.allclose(card, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL)),
          f"tta4 card vs CPU port max|diff| {e:.3g} beyond rtol={SERVE_RTOL}, atol={SERVE_ATOL}")
    print(f"[12] tta4 on {PARITY_TILES} tiles, card vs CPU port: max|diff| {e:.3g} (rtol={SERVE_RTOL}, "
          f"atol={SERVE_ATOL})", flush=True)

    ident = predict_masks(model, X[:B], device=dev)
    reset_counts()
    singles = [inference(model, tiles[i], device=dev) for i in range(3)]
    counts["inference_3"] = expect_launches("inference(), 3 single images (B=1 plans)", scaled(chunk_counts(b=1), 3))
    e = max(float(np.abs(s_ - ident[i].cpu().numpy()).max()) for i, s_ in enumerate(singles))
    check(all(np.allclose(s_, ident[i].cpu().numpy(), rtol=SERVE_RTOL, atol=SERVE_ATOL) for i, s_ in enumerate(singles)),
          f"inference() vs the chunked path max|diff| {e:.3g}")
    print(f"[12] inference() on 3 tiles (B=1) vs rows of the {B}-tile chunk: max|diff| {e:.3g}", flush=True)

    g = torch.Generator(device=dev).manual_seed(12)
    for transposed, shapes in ((False, QCONV_SHAPES), (True, QCONVT_SHAPES)):
        fn, plain = ((tq.qconvT3_s2_valid, tq.qconvT3_s2_valid_plain) if transposed
                     else (tq.qconv3_same, tq.qconv3_same_plain))
        for hw, cin, cout in shapes:
            x = torch.randn((B, hw, hw, cin), device=dev, generator=g)
            bound = 1.0 / (9 * (cout if transposed else cin)) ** 0.5
            w = (torch.rand((cin, cout, 3, 3) if transposed else (cout, cin, 3, 3), device=dev, generator=g)
                 * 2 - 1) * bound
            b = torch.rand((cout,), device=dev, generator=g) * bound
            amax = 0.8 * x.abs().amax()  # the top fifth saturates
            got, want = fn(x, w, b, amax), plain(x, w, b, amax)
            check(bool(torch.equal(got, want)), f"{fn.__name__} {hw}x{hw} {cin}->{cout} B={B}: not bit-exact "
                  f"against the float64 plain version (max|diff| {float((got - want).abs().max()):.3g})")
    print(f"[12] int8 convs on the card == their float64 plain versions, bit for bit: qconv3_same at "
          f"{len(QCONV_SHAPES)} shapes, qconvT3_s2_valid at {len(QCONVT_SHAPES)}, B={B}", flush=True)
    amaxes = torch.rand((4096,), device=dev, generator=g) * 20 + 1e-3
    kernel = torch.randn((256, 128, 3, 3), device=dev, generator=g)
    for what, card_q, cpu_q_ in (("act_qparams", tq.act_qparams(amaxes), tq.act_qparams(amaxes.cpu())),
                                 ("quantize_weight", tq.quantize_weight(kernel, 0), tq.quantize_weight(kernel.cpu(), 0))):
        check(all(bool(torch.equal(a.cpu(), b)) for a, b in zip(card_q, cpu_q_)),
              f"int8 {what} on the card differs from the CPU's")
    print("[12] int8 scales and quantized weights on the card == on the CPU, bit for bit (4096 ranges, a "
          "256x128x3x3 kernel)", flush=True)

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    qmodel = quantize_for_serving(model, X[:CALIB_TILES], device=dev)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    calib_chunks = CALIB_TILES // B
    counts["calib"] = expect_launches(
        f"calibration, {CALIB_TILES} tiles", scaled(chunk_counts(), calib_chunks))
    ranges = qmodel.quant_ranges()
    check(len(ranges) == 49 and all(bool(torch.isfinite(r)) and float(r) >= 0 for r in ranges.values()),
          f"calibration: {len(ranges)} ranges, want 49, finite and >= 0")
    reset_counts()
    q8 = predict_masks(qmodel, X, device=dev)
    torch.cuda.synchronize()
    counts["int8"] = expect_launches(f"int8 forward, {SERVE_TILES} tiles", {"plastic_head": HEAD_PER_CHUNK * chunks})
    check(bool(torch.isfinite(q8).all()), "int8: non-finite probabilities")
    cpu_q = copy.deepcopy(cpu_model)
    cpu_q.quant = "int8"
    cpu_q.load_quant_ranges({k: v.cpu() for k, v in ranges.items()})
    ref8 = predict_masks(cpu_q, tiles[:PARITY_TILES], chunk=PARITY_TILES, device="cpu")
    e8 = float((q8[:PARITY_TILES].cpu() - ref8).abs().max())
    check(e8 <= INT8_ATOL, f"int8 card vs CPU port (the card's ranges) max|diff| {e8:.3g} > {INT8_ATOL}")
    e_fp = float((q8[:B] - ident).abs().max())
    print(f"[12] calibration on {CALIB_TILES} tiles: {len(ranges)} ranges in {calib_s:.3f} s; int8 on "
          f"{PARITY_TILES} tiles, card vs CPU port with the card's ranges: max|diff| {e8:.3g} (atol {INT8_ATOL}); "
          f"int8 vs fp32 on the card, {B} tiles: max|diff| {e_fp:.3g}", flush=True)

    def rate(fn, n=SERVE_TILES, reps=3):
        fn()
        torch.cuda.synchronize()
        secs = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        return n / float(np.median(secs))

    rates = {
        "identity fp32": rate(lambda: predict_masks_tta(model, tiles, device=dev)),
        "tta4 batched": rate(lambda: predict_masks_tta(model, tiles, transforms=TTA_VIEWS_4, batch_views=True,
                                                       device=dev)),
        "tta8 batched": rate(lambda: predict_masks_tta(model, tiles, transforms=TTA_VIEWS_8, batch_views=True,
                                                       device=dev)),
        "tta8 sequential": rate(lambda: predict_masks_tta(model, tiles, transforms=TTA_VIEWS_8, device=dev)),
        "identity int8": rate(lambda: predict_masks_tta(qmodel, tiles, device=dev)),
    }
    with serving_cudnn_not_deterministic():  # the cost of the C5 repair, in the same call
        rates.update({
            "identity fp32, cuDNN not deterministic": rate(lambda: predict_masks_tta(model, tiles, device=dev)),
            "tta4 batched, cuDNN not deterministic": rate(lambda: predict_masks_tta(
                model, tiles, transforms=TTA_VIEWS_4, batch_views=True, device=dev)),
            "tta8 batched, cuDNN not deterministic": rate(lambda: predict_masks_tta(
                model, tiles, transforms=TTA_VIEWS_8, batch_views=True, device=dev)),
        })
    print(f"[12] serving tiles/s (NVIDIA card: {smi}), neurons=16, chunk {B}, {SERVE_TILES} tiles from the host, "
          f"host clock, median of 3: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
          + f"; calibration {CALIB_TILES} tiles {calib_s:.3f} s", flush=True)

    predictor = MaskPredictor(model, tta=TTA_VIEWS_4, threshold=0.5, device=dev)
    server = serve(predictor, "127.0.0.1", 0, block=False)
    try:
        host, port = server.server_address

        def post(path, body):
            req = urllib.request.Request(f"http://{host}:{port}{path}", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.read()

        buf = io.BytesIO()
        np.save(buf, tiles[:B, :, :, 0], allow_pickle=False)
        body = buf.getvalue()
        reset_counts()
        got = np.load(io.BytesIO(post("/predict", body)), allow_pickle=False)
        counts["http_predict"] = expect_launches(f"HTTP /predict, {B} tiles, tta4", scaled(chunk_counts(), 4))
        want = predictor.predict(tiles[:B, :, :, 0])
        check(got.dtype == np.float32 and np.array_equal(got, want.astype(np.float32)),
              "HTTP /predict differs from predictor.predict")
        check(json.loads(post("/predict_rle", body)) == predictor.predict_rle(tiles[:B, :, :, 0]),
              "HTTP /predict_rle differs from predictor.predict_rle")
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and torch.cuda.get_device_name(0) in health["device"],
              f"/healthz: {health}")
        lat = []
        for _ in range(5):
            t = time.perf_counter()
            post("/predict", body)
            lat.append(time.perf_counter() - t)
    finally:
        server.shutdown()
        server.server_close()
    print(f"[12] HTTP on 127.0.0.1: /predict ({B} tiles, tta4, threshold 0.5) == predictor.predict, /predict_rle "
          f"== predictor.predict_rle, /healthz {health}; /predict latency (NVIDIA card: {smi}) median "
          f"{float(np.median(lat)) * 1e3:.1f} ms of 5 ({[round(t_ * 1e3, 1) for t_ in lat]} ms)", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        data = write_tgs_dir(os.path.join(tmp, "tgs"))
        pth = os.path.join(tmp, "m.pth")
        torch.save(seeded_model(SERVE_NEURONS, "oja", 0).state_dict(), pth)
        out = os.path.join(tmp, "out")
        on = [] if dev.type == "cuda" else ["--device", str(dev)]
        path = cli_infer.main(["-m", pth, "-i", data, "-o", out, "--neurons", str(SERVE_NEURONS), "--prule", "oja", "--tta", "tta4",
                               "--save", "--quant", "int8", "--precision", "parity"] + on)
        rows = [ln.split(",", 1) for ln in open(path).read().splitlines()[1:]]
        check(sorted(i for i, _ in rows) == [f"t{j}" for j in range(7)], "cli.infer: submission.csv ids")
        from PIL import Image

        for idx, rle in rows:
            png = np.asarray(Image.open(os.path.join(out, "masks", f"{idx}.png")))
            check(png.shape == (101, 101, 3) and np.array_equal(png[..., 0] > 0, rle_decode(rle, (101, 101)) > 0),
                  f"cli.infer: masks/{idx}.png does not decode to its RLE")
    print(f"[12] cli.infer --tta tta4 --save --quant int8 on a fake TGS directory (30 train, 7 test tiles): "
          f"submission.csv with {len(rows)} rows, {sum(1 for _, r in rows if r)} non-empty; 7 PNGs equal to their "
          f"RLE masks", flush=True)
    print(f"[12] phase 12 took {time.time() - t_phase:.1f} s", flush=True)
    return counts


# --------------------------------------------------------------------------- phase 13

EXPORT_TTA4_CHUNK = 32  # 4 views x 32 tiles: B=128 inside the program, as the live folded path's chunks


def phase_export(dev, smi, live_rate):
    """The export path on the card (submit.export, cli.export_model's function): UNetPRes neurons=16,
    nbf=101, seeded weights, SERVE_TILES synthetic tiles; programs for ``dev`` (the card: "cuda"),
    loaded with the default device. Returns the launch counts of the identity artifact's run."""
    from plastic_unet_tpu_torch.data.synthetic import synthetic_tiles
    from plastic_unet_tpu_torch.eval.evaluate import predict_masks
    from plastic_unet_tpu_torch.ops.augment import TTA_VIEWS_4, TTA_VIEWS_8
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain, hwio
    from plastic_unet_tpu_torch.ops.plastic_head import head_plan, plastic_head, plastic_head_plain
    from plastic_unet_tpu_torch.ops.residual_tail import residual_tail_four, residual_tail_fused
    from plastic_unet_tpu_torch.ops.residual_tail import tail_plan as residual_tail_plan
    from plastic_unet_tpu_torch.submit.export import export_predictor, load_predictor
    from plastic_unet_tpu_torch.submit.http_server import serve
    from plastic_unet_tpu_torch.submit.inference import predict_masks_tta
    from plastic_unet_tpu_torch.submit.quant import quantize_for_serving
    from plastic_unet_tpu_torch.submit.server import MaskPredictor

    t_phase = time.time()
    imgs, _ = synthetic_tiles(SERVE_TILES, size=101, seed=79)
    tiles = np.ascontiguousarray(imgs[:, 0, :, :, None])  # (512, 101, 101, 1) NHWC, the channel's stride 0
    X = torch.from_numpy(tiles).to(dev)
    model = seeded_model(SERVE_NEURONS, "oja", 0).to(dev).eval()
    chunks = SERVE_TILES // B
    times = {}

    def exported(name, m, tmp, **kw):
        """export_predictor for "cuda", then load_predictor (default device) and warm up; times noted."""
        t0 = time.perf_counter()
        path = export_predictor(m, os.path.join(tmp, name), platforms=(dev.type,), **kw)
        t1 = time.perf_counter()
        pred = load_predictor(path, device=None if dev.type == "cuda" else dev).warmup()  # the card by default
        torch.cuda.synchronize()
        times[name] = (t1 - t0, time.perf_counter() - t1)
        check(pred.device.type == dev.type, f"{name}: loaded on {pred.device}")
        return pred

    with tempfile.TemporaryDirectory() as tmp:
        ident = exported("identity", model, tmp)
        reset_counts()
        got = ident.predict(tiles)
        torch.cuda.synchronize()
        counts = expect_launches(f"MAIN PATH (export): the identity artifact, chunk {B}, {SERVE_TILES} tiles = "
                                 f"{chunks} chunks", scaled(chunk_counts(), chunks), 13)
        want = predict_masks(model, X, device=dev).cpu().numpy()
        check(got.dtype == np.float32 and got.shape == (SERVE_TILES, 101, 101) and np.isfinite(got).all(),
              "identity artifact: bad masks")
        check(np.array_equal(got, want), f"identity artifact vs live predict_masks max|diff| "
              f"{float(np.abs(got - want).max()):.3g}: not bit for bit")
        print(f"[13] identity artifact (chunk {B}) == live predict_masks on {SERVE_TILES} tiles, bit for bit",
              flush=True)

        tta4 = exported("tta4", model, tmp, chunk=EXPORT_TTA4_CHUNK, tta=TTA_VIEWS_4)
        got = tta4.predict(tiles)
        want = predict_masks_tta(model, X, transforms=TTA_VIEWS_4, batch_views=True, device=dev).cpu().numpy()
        check(np.array_equal(got, want), f"tta4 artifact (chunk {EXPORT_TTA4_CHUNK}) vs live tta4 batched max|diff| "
              f"{float(np.abs(got - want).max()):.3g}: not bit for bit")
        print(f"[13] tta4 artifact (chunk {EXPORT_TTA4_CHUNK}: B={4 * EXPORT_TTA4_CHUNK} in the program) == live "
              f"predict_masks_tta(batch_views=True), bit for bit", flush=True)

        # tta8 at chunk 128 is a forward of B=1024: the kernels at that batch against their plain versions
        g = torch.Generator(device=dev).manual_seed(13)
        big = 8 * B
        n = 101
        w, alpha, eta = (torch.randn((n, n), generator=g, device=dev) * 0.01,
                         torch.rand((n, n), generator=g, device=dev) * 0.01, torch.full((1,), 0.01, device=dev))
        xh = torch.randn((big, n, n), generator=g, device=dev)
        hebb = torch.randn((big, n, n), generator=g, device=dev) * 0.1
        for gt, rf in zip(plastic_head(w, alpha, eta, xh, hebb, rule="oja"),
                          plastic_head_plain(w, alpha, eta, xh, hebb, rule="oja")):
            e, tol = max_err(gt, rf)
            check(e <= tol, f"plastic_head B={big}: max|diff| {e:.3g} > {tol:.3g}")
        errs_big = []
        for hw, c in LEVELS:
            xx = torch.randn((big, hw, hw, c), generator=g, device=dev)
            k = hwio(torch.randn((c, c, 3, 3), generator=g, device=dev) / (3 * c ** 0.5))
            bias, res = torch.randn((c,), generator=g, device=dev) * 0.1, torch.randn((big, hw, hw, c), generator=g,
                                                                                        device=dev)
            kw = dict(relu_in=True, relu_res=True, relu_out=True)
            e, tol = max_err(conv3x3(xx, k, bias, res, **kw), conv3x3_plain(xx, k, bias, res, **kw))
            check(e <= tol, f"conv3x3 B={big} {hw}^2x{c}: max|diff| {e:.3g} > {tol:.3g}")
            errs_big.append(round(e, 9))
            del xx, res
        for hw, c in FUSED_TAIL_SHAPES:  # the tail's route there: the fused kernel, with size_t offsets
            args, _ = tail_operands(lambda *shape, scale=1.0: torch.randn(shape, generator=g, device=dev) * scale,
                                    big, hw, c)
            kargs = [args[0]] + [hwio(t) if t.dim() == 4 else t for t in args[1:]]
            check(residual_tail_plan(big, hw, hw, c).family == "fused", f"tail at B={big} {hw}^2x{c}: not fused")
            fused = residual_tail_fused(*kargs)[0]
            check(bool(torch.isfinite(fused).all()) and bool(torch.equal(fused, residual_tail_four(*kargs)[0])),
                  f"residual_tail_fused B={big} {hw}^2x{c}: differs from the four conv3x3 launches")
            del args, kargs, fused
        print(f"[13] B={big} (tta8 at chunk {B}): plastic_head ({head_plan(big, n).family}) and conv3x3 at the five "
              f"level shapes within tolerance of their plain versions (conv max|diff| {errs_big}); the fused tail "
              f"at {FUSED_TAIL_SHAPES} (H, C) == four conv3x3 launches bit for bit", flush=True)
        tta8 = exported("tta8", model, tmp, tta=TTA_VIEWS_8)
        got = tta8.predict(tiles)
        want = predict_masks_tta(model, X, transforms=TTA_VIEWS_8, batch_views=True, device=dev).cpu().numpy()
        e = float(np.abs(got - want).max())
        check(np.isfinite(got).all() and e <= 1.2e-7, f"tta8 artifact (B={big}) vs live tta8 max|diff| {e:.3g} > 1.2e-7")
        print(f"[13] tta8 artifact (chunk {B}: B={big} in the program) vs live tta8 batched: max|diff| {e:.3g} "
              f"(<= 1.2e-7)", flush=True)

        qmodel = quantize_for_serving(model, X[:CALIB_TILES], device=dev)
        int8 = exported("int8", qmodel, tmp)
        reset_counts()
        got = int8.predict(tiles)
        torch.cuda.synchronize()
        counts_int8 = expect_launches(f"int8 artifact, {SERVE_TILES} tiles", {"plastic_head": HEAD_PER_CHUNK * chunks},
                                      13)
        want = predict_masks(qmodel, X, device=dev).cpu().numpy()
        check(np.array_equal(got, want), f"int8 artifact vs live int8 forward max|diff| "
              f"{float(np.abs(got - want).max()):.3g}: not bit for bit")
        print(f"[13] int8 artifact (49 ranges as constants of the program) == live int8 forward, bit for bit; "
              f"launches {({k: v for k, v in counts_int8.items() if v})}", flush=True)

        live_pred = MaskPredictor(model, tta=TTA_VIEWS_4, device=dev)
        server = serve(tta4, "127.0.0.1", 0, block=False)
        try:
            host, port = server.server_address
            buf = io.BytesIO()
            np.save(buf, tiles[:B, :, :, 0], allow_pickle=False)
            req = urllib.request.Request(f"http://{host}:{port}/predict", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                got = np.load(io.BytesIO(r.read()), allow_pickle=False)
            with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=30) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
        want = live_pred.predict(tiles[:B, :, :, 0])
        check(np.array_equal(got, want), f"HTTP /predict from the tta4 artifact vs MaskPredictor(tta4) max|diff| "
              f"{float(np.abs(got - want).max()):.3g}: not bit for bit")
        check(torch.cuda.get_device_name(0) in health["device"], f"/healthz: {health}")
        print(f"[13] HTTP /predict ({B} tiles) from the tta4 artifact == MaskPredictor(tta4, one pass a view), bit "
              f"for bit; /healthz {health}", flush=True)

        def rate(fn, reps=3):
            fn()
            torch.cuda.synchronize()
            secs = []
            for _ in range(reps):
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
            return SERVE_TILES / float(np.median(secs))

        live = MaskPredictor(model, device=dev)
        rates = {"identity artifact": rate(lambda: ident.predict(tiles)),
                 "identity live": rate(lambda: live.predict(tiles)),
                 f"tta4 artifact (chunk {EXPORT_TTA4_CHUNK})": rate(lambda: tta4.predict(tiles)),
                 f"tta8 artifact (B={big})": rate(lambda: tta8.predict(tiles)),
                 "int8 artifact": rate(lambda: int8.predict(tiles))}
    print(f"[13] export and load+warm-up seconds (NVIDIA card: {smi}): "
          + ", ".join(f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in times.items()), flush=True)
    print(f"[13] serving tiles/s (NVIDIA card: {smi}), {SERVE_TILES} tiles from the host, host clock, median of 3: "
          + ", ".join(f"{k} {v:.1f}" for k, v in rates.items()) + f"; phase 6's live identity {live_rate:.1f}",
          flush=True)
    print(f"[13] phase 13 took {time.time() - t_phase:.1f} s", flush=True)
    return counts


# --------------------------------------------------------------------------- phase 14

PAD = 128  # trunk_pad of the JAX package's aligned track
PAD_LEVELS = [(128, 16), (64, 32), (32, 64), (16, 128), (8, 256)]  # (H=W, C) of the padded neurons=16 track
PAD_FUSED_SHAPES = [(128, 16), (64, 32)]  # where tail_plan and tail_bwd_plan fuse on it at B=128
OPTION_TILES = 512  # the padded serving request: 4 chunks


def tail_bounds(b, hw, c, pk) -> tuple:
    """((forward bound ms, by), (backward bound ms, by)) of one tail, counted as phases 6 and 10 count them."""
    conv_flops, act = 2 * 9 * c * c * b * hw * hw, 4 * b * hw * hw * c
    return (bound_ms(4 * conv_flops, 2 * act + 4 * 4 * (9 * c * c + c), pk),
            bound_ms(8 * conv_flops, 7 * act + 8 * 4 * (9 * c * c + c), pk))


def phase_padded_tails(dev, pk) -> dict:
    """Phase 14 (1): the fused tail forward and backward at the padded track's fused shapes, B=128 (at
    128^2 x 16 a cluster of 13 blocks of ~229 KB each): forward == the four conv3x3 launches bit for
    bit (out, and with pre11, x1, pre21 kept), backward dx0 == the eight launches', every output within
    phase 2's tolerance of the plain versions, dW and db no farther from float64 than the eight
    launches', two runs alike, the NaN canary (16-byte aligned and off it); then each one's time
    beside the other route, the plain version, cuDNN and the bound. Returns the kernels' keys."""
    from plastic_unet_tpu_torch.ops import residual_tail as rt
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_plan, hwio
    from plastic_unet_tpu_torch.utils.precision import matmul_precision, training_numerics

    g = torch.Generator(device=dev).manual_seed(14)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    fwd, bwd = {}, {}
    names = ["dx0"] + ["d" + n for n in "w11 b11 w12 b12 w21 b21 w22 b22".split()]
    for hw, c in PAD_FUSED_SHAPES:
        fp, bp = rt.tail_plan(B, hw, hw, c), rt.tail_bwd_plan(B, hw, hw, c)
        check(fp.family == "fused" and bp.family == "fused" and conv3x3_plan(B, hw, hw, c, c, True).family == "tile",
              f"{hw}^2x{c} B={B}: tail_plan {fp.family}, tail_bwd_plan {bp.family}")
        what = f"{hw}^2x{c} B={B}"
        print(f"[14] fused tail at {what}: forward plan (bands, rows, px, threads, smem, blocks) "
              f"{tuple(fp)[1:]}, backward {tuple(bp)[1:7]}", flush=True)
        with torch.no_grad(), matmul_precision("parity"):
            args, gout = tail_operands(rnd, B, hw, c)
            saved = tail_saved(args)
            ws = args[1::2]
            ks = [hwio(w) for w in ws]
            kargs = (args[0], ks[0], args[2], ks[1], args[4], ks[2], args[6], ks[3], args[8])
            four = rt.residual_tail_four(*kargs)
            kept = rt.residual_tail_fused(*kargs, keep=True)
            alone = rt.residual_tail_fused(*kargs)
            check(all(bool(torch.equal(a, q)) for a, q in zip(kept, four)),
                  f"residual_tail_fused {what}: out, pre11, x1, pre21 differ from the four launches' in some bit")
            check(bool(torch.equal(alone[0], four[0])) and bool(torch.equal(rt.residual_tail_fused(*kargs)[0], alone[0])),
                  f"residual_tail_fused {what}: out alone differs from the four launches', or between two runs")
            e_fwd, tol = max_err(kept[0], saved[4])
            check(e_fwd <= tol, f"residual_tail_fused {what}: max|diff| {e_fwd:.3g} > {tol:.3g} against the plain version")
            fused = rt.residual_tail_backward_fused(gout, *saved, *ks)
            again = rt.residual_tail_backward_fused(gout, *saved, *ks)
            eight = rt.residual_tail_backward_eight(gout, *saved, *ks)
            plain = rt.residual_tail_backward_plain(gout, *saved, *ws)
            check(all(bool(torch.equal(x, y)) for x, y in zip(fused, again)),
                  f"residual_tail_backward_fused {what}: two runs differ in some bit")
            check(bool(torch.equal(fused[0], eight[0])), f"residual_tail_backward_fused {what}: dx0 differs from the "
                  f"eight launches' in some bit")
            e_bwd = 0.0
            for nm, gt, rf in zip(names, fused, plain):
                e, tol = max_err(gt, rf)
                check(e <= tol, f"residual_tail_backward_fused {what} {nm}: max|diff| {e:.3g} > {tol:.3g}")
                e_bwd = max(e_bwd, e)
            p64 = rt.residual_tail_backward_plain(gout.double(), *(t.double() for t in saved), *(w.double() for w in ws))
            far = [max(float((x.double() - q).abs().max()) for x, q in zip(r[1:], p64[1:])) for r in (fused, eight)]
            check(far[0] <= far[1], f"residual_tail_backward_fused {what}: dW, db {far[0]:.3g} from float64, the "
                  f"eight launches' {far[1]:.3g}")
            del p64, again
            for offset in (4, 1):
                got = canary(rt.residual_tail_fused, *kargs, keep=True, offset=offset)
                for a, q in zip(got, four):
                    e, tol = max_err(a, q)
                    check(e <= tol, f"canary residual_tail_fused {what} (offset {offset}): max|diff| {e:.3g}")
                got = canary(rt.residual_tail_backward_fused, gout, *saved, *ks, offset=offset)
                for a, q in zip(got, plain):
                    e, tol = max_err(a, q)
                    check(e <= tol, f"canary residual_tail_backward_fused {what} (offset {offset}): max|diff| {e:.3g}")
                del got
            print(f"[14] {what}: the fused forward == four conv3x3 launches bit for bit (out; out, pre11, x1, pre21 "
                  f"kept), max|diff| {e_fwd:.3g} against the plain version; the fused backward's dx0 == the eight "
                  f"launches' bit for bit, max|diff| {e_bwd:.3g} against the plain chain, dW, db from float64 "
                  f"{far[0]:.3g} (eight launches {far[1]:.3g}); two runs alike; the NaN canary finite and within "
                  f"tolerance", flush=True)
            (fb, fby), (bb, bby) = tail_bounds(B, hw, c, pk)
            f = dict(ms=time_ms(lambda: rt.residual_tail_fused(*kargs))[0],
                     four_ms=time_ms(lambda: rt.residual_tail_four(*kargs))[0],
                     plain_ms=time_ms(lambda: rt.residual_tail_plain(*args))[0],
                     cudnn_ms=time_ms(lambda: cudnn_tail_nhwc(*args))[0], bound_ms=fb, bound_by=fby, max_abs_err=e_fwd)
            k = dict(ms=time_ms(lambda: rt.residual_tail_backward_fused(gout, *saved, *ks))[0],
                     eight_ms=time_ms(lambda: rt.residual_tail_backward_eight(gout, *saved, *ks))[0],
                     plain_ms=time_ms(lambda: rt.residual_tail_backward_plain(gout, *saved, *ws))[0],
                     bound_ms=bb, bound_by=bby, max_abs_err=e_bwd)
            leaves = [t.clone().requires_grad_() for t in args]
            with torch.enable_grad(), training_numerics():
                lib_out = cudnn_tail_nhwc(*leaves)
                k["library_chain_ms"] = time_ms(lambda: torch.autograd.grad(lib_out, leaves, gout, retain_graph=True))[0]
            del leaves, lib_out, args, gout, saved, kargs, four, kept, alone, fused, eight, plain
        fwd[hw], bwd[hw] = f, k
        print(f"[14] residual_tail {what} [fused]: {f['ms']:.4f} ms against four conv3x3 launches "
              f"{f['four_ms']:.4f} ms ({f['four_ms'] / f['ms']:.3f}x), plain {f['plain_ms']:.4f} ms, cuDNN chain "
              f"{f['cudnn_ms']:.4f} ms, bound {fb:.5f} ms ({fby}), {fb / f['ms']:.1%} of bound", flush=True)
        print(f"[14] residual_tail_backward {what} [fused]: {k['ms']:.4f} ms against the eight launches "
              f"{k['eight_ms']:.4f} ms ({k['eight_ms'] / k['ms']:.3f}x), plain {k['plain_ms']:.4f} ms, cuDNN's chain "
              f"by autograd {k['library_chain_ms']:.4f} ms, bound {bb:.5f} ms ({bby}), {bb / k['ms']:.1%} of bound",
              flush=True)
    keys = {"residual_tail": {}, "residual_tail_backward_fused": {}}
    for hw, _ in PAD_FUSED_SHAPES:
        f, k = fwd[hw], bwd[hw]
        keys["residual_tail"].update({f"ms_{hw}": f["ms"], f"four_launch_ms_{hw}": f["four_ms"],
                                      f"plain_ms_{hw}": f["plain_ms"], f"bound_ms_{hw}": f["bound_ms"],
                                      f"cudnn_ms_{hw}": f["cudnn_ms"], f"max_abs_err_{hw}": f["max_abs_err"]})
        keys["residual_tail_backward_fused"].update({
            f"ms_{hw}": k["ms"], f"eight_launch_ms_{hw}": k["eight_ms"], f"plain_ms_{hw}": k["plain_ms"],
            f"bound_ms_{hw}": k["bound_ms"], f"library_chain_ms_{hw}": k["library_chain_ms"],
            f"max_abs_err_{hw}": k["max_abs_err"]})
    return keys


def grads_of(model, x, hebb, mask, generator=None):
    """(loss, activ, every parameter's gradient or None) of one train-mode forward and backward."""
    from plastic_unet_tpu_torch.ops.losses import bce_logits

    model.zero_grad(set_to_none=True)
    out = model.train()(x, hebb, generator=generator)
    loss = bce_logits(out.activ, mask)
    loss.backward()
    return loss.detach(), out, [p.grad for p in model.parameters()]


def same_bits(a, b) -> bool:
    return len(a) == len(b) and all((x is None and y is None) or (x is not None and y is not None
                                                                  and bool(torch.equal(x, y))) for x, y in zip(a, b))


def phase_model_options(dev, smi, name, serving_tiles_s):
    """Phase 14: the UNetPRes options at full width (neurons=16, nbf=101, 101x101 tiles, seeded
    weights). Returns ({kernel: keys for its entry}, {path: launches})."""
    import torch.nn.functional as F

    from plastic_unet_tpu_torch.eval.evaluate import predict_masks
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3_plain, conv3x3_same, hwio
    from plastic_unet_tpu_torch.ops.residual_tail import tail_bwd_plan, tail_plan
    from plastic_unet_tpu_torch.train.loop import create_train_state, make_train_step
    from plastic_unet_tpu_torch.utils.precision import matmul_precision, training_numerics

    t0 = time.time()
    pk = peaks(name)
    counts = {}
    keys = phase_padded_tails(dev, pk)

    def model(seed=14, **options):
        return UNetPRes(neurons=16, nbf=101, generator=torch.Generator().manual_seed(seed), **options)

    # (1) trunk_pad=128 with coord_conv: serving, the forward against the CPU port, training
    padded = dict(trunk_pad=PAD, coord_conv=True)
    pm = model(**padded).to(dev).eval()
    xs = np.random.default_rng(14).random((OPTION_TILES, 101, 101, 1), dtype=np.float32)
    predict_masks(pm, xs[:B], device=dev)  # builds nothing new; warms cuDNN's plans for the padded shapes
    torch.cuda.synchronize()
    reset_counts()
    masks = predict_masks(pm, xs, device=dev)
    torch.cuda.synchronize()
    chunks = OPTION_TILES // B
    counts["pad128_chunk"] = {k: v // chunks for k, v in expect_launches(
        f"MAIN PATH (trunk_pad={PAD}, coord_conv): serving {OPTION_TILES} tiles at chunk {B}",
        scaled(chunk_counts(16, B, PAD_LEVELS), chunks), 14).items()}
    check(tuple(masks.shape) == (OPTION_TILES, 101, 101) and bool(torch.isfinite(masks).all()),
          f"trunk_pad={PAD}: masks {tuple(masks.shape)} or non-finite")
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        predict_masks(pm, xs, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
    pad_tiles_s = OPTION_TILES / float(np.median(secs))
    fb, _ = bound_ms(forward_flops(16, PAD, 101) * B, 0.0, pk)
    print(f"[14] serving trunk_pad={PAD} + coord_conv, neurons=16, chunk {B}: {pad_tiles_s:.1f} tiles/s (host clock, "
          f"median of 3, {OPTION_TILES} tiles; the default model in phase 6: {serving_tiles_s:.1f}, "
          f"{pad_tiles_s / serving_tiles_s:.3f}x); forward bound forward_flops(16, {PAD}, 101) = "
          f"{forward_flops(16, PAD, 101) / 1e9:.3f} GFLOP/tile -> {fb:.3f} ms a chunk at the fp32 peak "
          f"({forward_flops(16, PAD, 101) / forward_flops(16):.3f}x the default's); card: {smi}", flush=True)

    rng = np.random.default_rng(15)
    x4 = torch.from_numpy(rng.random((4, 101, 101, 1), dtype=np.float32))
    h4 = torch.from_numpy((rng.standard_normal((4, 101, 101)) * 0.05).astype(np.float32))
    cpu = copy.deepcopy(pm).cpu()
    with torch.inference_mode(), matmul_precision("parity"):
        got, ref = pm(x4.to(dev), h4.to(dev)), cpu(x4, h4)
    errs = {}
    for what, a, r in zip(("activ", "activout", "hebb"), got, ref):
        a = a.cpu()
        check(bool(torch.isfinite(a).all()) and tuple(a.shape) == (4, 101, 101), f"trunk_pad: bad {what}")
        errs[what] = float((a - r).abs().max())
        tol = 1e-5 * max(1.0, float(r.abs().max()))
        check(errs[what] <= tol, f"trunk_pad={PAD} coord_conv: {what} card vs CPU port max|diff| {errs[what]:.3g} > {tol:.3g}")
    print(f"[14] trunk_pad={PAD} + coord_conv forward, 4 tiles, card vs CPU port: max|diff| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + " (atol 1e-5 x max(1, max|ref|))", flush=True)
    del pm, cpu, masks

    X, Y = train_stream(TRAIN_STEPS, 1, seed=31)
    reset_counts()
    e_state, e_losses = train_run("oja", dev, X, Y, graph=False, **padded)
    torch.cuda.synchronize()
    per_step = lane_step_counts(1, 16, PAD_LEVELS)
    check(read_counts() == scaled(per_step, TRAIN_STEPS), f"trunk_pad B=1: launches {read_counts()} != "
          f"{scaled(per_step, TRAIN_STEPS)}")
    counts["pad128_step_b1"] = per_step
    g_state, g_losses = train_run("oja", dev, X, Y, graph=None, **padded)
    check(bool(torch.isfinite(e_losses).all()) and bool(torch.equal(g_losses, e_losses))
          and same_bits(list(g_state.model.parameters()), list(e_state.model.parameters()))
          and bool(torch.equal(g_state.hebb, e_state.hebb)),
          f"trunk_pad={PAD} B=1: the graph's losses, parameters or trace differ from eager")
    print(f"[14] trunk_pad={PAD} + coord_conv, B=1, {TRAIN_STEPS} steps: the CUDA graph == eager bit for bit (losses "
          f"{[round(v, 6) for v in e_losses.tolist()]}, parameters, trace); launches per eager step "
          f"{({k: v for k, v in per_step.items() if v})}", flush=True)
    del e_state, g_state

    Xl, Yl = train_stream(2, B, seed=32)
    Xl, Yl = Xl.to(dev), Yl.to(dev)
    step = make_train_step()
    lane = {}
    for label, opts in (("default", {}), (f"trunk_pad={PAD} + coord_conv", padded)):
        st = create_train_state(model(3, dropout_ratio=0.0, **opts), TRAIN_LR, TRAIN_GAMMA, 1e6, lanes=B, device=dev)
        step(st, (Xl[0], Yl[0]))
        torch.cuda.synchronize()
        reset_counts()
        step(st, (Xl[1], Yl[1]))
        torch.cuda.synchronize()
        c = read_counts()
        secs = []
        for _ in range(3):
            t = time.perf_counter()
            for i in range(4):
                step(st, (Xl[i % 2], Yl[i % 2]))
            torch.cuda.synchronize()
            secs.append((time.perf_counter() - t) / 4)
        lane[label] = (float(np.median(secs)) * 1e3, c)
        del st
    pad_ms, c = lane[f"trunk_pad={PAD} + coord_conv"]
    want = lane_step_counts(B, 16, PAD_LEVELS)
    check(c == want, f"trunk_pad lanes={B}: launches of one eager step {c} != {want}")
    counts["pad128_step_lanes"] = c
    sb, _ = bound_ms((forward_flops(16, PAD, 101) + backward_flops(16, PAD, 101)) * B, 0.0, pk)
    print(f"[14] lanes={B} eager step, neurons=16 (host clock, 4 steps, median of 3): trunk_pad={PAD} + coord_conv "
          f"{pad_ms:.2f} ms ({B / pad_ms * 1e3:.1f} samples/s; bound {sb:.2f} ms) against the default model "
          f"{lane['default'][0]:.2f} ms in this phase: {pad_ms / lane['default'][0]:.3f}x; "
          f"launches per step {({k: v for k, v in c.items() if v})}", flush=True)

    # (2) remat_trunk: the same loss and gradients bit for bit, less memory
    mem = {}
    with training_numerics():
        for lanes, seed in ((B, 33), (1, 34)):
            xb, yb = train_stream(1, lanes, seed=seed)
            xb, yb = xb[0].to(dev), yb[0].to(dev)
            runs = {}
            for remat in (False, True):
                m = model(3, dropout_ratio=0.5, remat_trunk=remat).to(dev)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                reset_counts()
                res = grads_of(m, xb, m.initial_zero_hebb(lanes, device=dev), yb,
                               torch.Generator(device=dev).manual_seed(seed))
                torch.cuda.synchronize()
                runs[remat] = res
                mem[(lanes, remat)] = (torch.cuda.max_memory_allocated(dev) - base) / 2 ** 20
                counts[f"{'remat' if remat else 'plain'}_step_{'lanes' if lanes > 1 else 'b1'}"] = read_counts()
                del m
            (l0, o0, g0), (l1, o1, g1) = runs[False], runs[True]
            check(bool(torch.equal(l0, l1)) and bool(torch.equal(o0.activ, o1.activ)) and same_bits(g0, g1),
                  f"remat_trunk lanes={lanes}, dropout 0.5: loss, activ or gradients differ from the plain step's")
            plain_c, remat_c = counts[f"plain_step_{'lanes' if lanes > 1 else 'b1'}"], \
                counts[f"remat_step_{'lanes' if lanes > 1 else 'b1'}"]
            for k in ("residual_tail", "residual_tail_fused", "conv3x3"):  # the backward recomputes every tail
                check(remat_c[k] == 2 * plain_c[k], f"remat_trunk lanes={lanes}: {k} {remat_c[k]} != 2 x {plain_c[k]}")
            print(f"[14] remat_trunk lanes={lanes}, dropout 0.5 (explicit generator): loss, activ and all "
                  f"{sum(g is not None for g in g0)} gradients == the plain step's bit for bit; peak memory above "
                  f"the model {mem[(lanes, True)]:.1f} MiB against {mem[(lanes, False)]:.1f} MiB "
                  f"({mem[(lanes, True)] / mem[(lanes, False)]:.3f}x; torch.cuda.max_memory_allocated); launches "
                  f"{({k: v for k, v in remat_c.items() if v})} (plain {({k: v for k, v in plain_c.items() if v})})",
                  flush=True)
            del runs, l0, o0, g0, l1, o1, g1
    p_state, p_losses = train_run("oja", dev, X, Y, graph=False, dropout=0.5, drop_seed=35)
    r_state, r_losses = train_run("oja", dev, X, Y, graph=False, dropout=0.5, drop_seed=35, remat_trunk=True)
    rg_state, rg_losses = train_run("oja", dev, X, Y, graph=None, dropout=0.5, drop_seed=35, remat_trunk=True)
    for label, (st, ls) in (("eager", (r_state, r_losses)), ("graph", (rg_state, rg_losses))):
        check(bool(torch.equal(ls, p_losses)) and bool(torch.equal(st.hebb, p_state.hebb))
              and same_bits(list(st.model.parameters()), list(p_state.model.parameters())),
              f"remat_trunk B=1 {label}: losses, parameters or trace differ from the plain eager run")
    print(f"[14] remat_trunk B=1, dropout 0.5, {TRAIN_STEPS} steps: eager and the CUDA graph == the plain eager run "
          f"bit for bit (losses, parameters, trace); graph == eager", flush=True)
    del p_state, r_state, rg_state

    # (3) batch_norm: the single-conv wrapper on the card, the BN model against the CPU port
    g = torch.Generator(device=dev).manual_seed(36)
    worst = 0.0
    for b, hw, c in ((B, 101, 16), (B, 50, 32), (2, 12, 128), (1, 6, 256)):
        x = torch.randn(b, hw, hw, c, generator=g, device=dev)
        w = torch.randn(c, c, 3, 3, generator=g, device=dev) / (3 * c ** 0.5)
        bias = torch.randn(c, generator=g, device=dev) * 0.1
        gout = torch.randn(b, hw, hw, c, generator=g, device=dev)
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        ref_leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        with matmul_precision("parity"):
            out = conv3x3_same(*leaves)
            got = (out,) + torch.autograd.grad(out, leaves, gout)
            ref_out = conv3x3_plain(ref_leaves[0], hwio(ref_leaves[1]), ref_leaves[2])
            ref = (ref_out,) + torch.autograd.grad(ref_out, ref_leaves, gout)
        for what, a, r in zip(("out", "dx", "dW", "db"), got, ref):
            e, tol = max_err(a.detach(), r.detach())
            check(e <= tol, f"conv3x3_same B={b} {hw}^2x{c} {what}: max|diff| {e:.3g} > {tol:.3g}")
            worst = max(worst, e)
        del leaves, ref_leaves, out, got, ref, ref_out
    print(f"[14] conv3x3_same (the BN trunks' differentiable conv: conv3x3 forward, conv3x3_dgrad and conv3x3_wgrad "
          f"backward) against autograd of the plain conv, out, dx, dW, db at 4 shapes: max|diff| {worst:.3g}",
          flush=True)

    bn = model(37, dropout_ratio=0.0, batch_norm=True)
    cpu = copy.deepcopy(bn)
    bn = bn.to(dev)
    xb, yb = train_stream(1, B, seed=38)
    xb, yb = xb[0].to(dev), yb[0].to(dev)
    with matmul_precision("parity"):
        reset_counts()
        loss, out, grads = grads_of(bn, xb, bn.initial_zero_hebb(B, device=dev), yb)
        torch.cuda.synchronize()
        bn_counts = read_counts()
        check(bool(torch.isfinite(out.activ).all()) and all(g_ is None or bool(torch.isfinite(g_).all()) for g_ in grads),
              "batch_norm B=128: non-finite outputs or gradients")
        # the 5 BN trunks: 4 convs each on conv3x3_same; the 4 UpRes middles (no BN) by the tail routes;
        # the 8 routed entry convs on conv3x3_same
        ups = [(hw, 16 * 2 ** i) for i, (hw, _) in enumerate(LEVELS[:4])]
        fused_f = sum(tail_plan(B, hw, hw, c).family == "fused" for hw, c in ups)
        fused_b = sum(tail_bwd_plan(B, hw, hw, c).family == "fused" for hw, c in ups)
        convs = 20 + entry_counts()
        want = dict.fromkeys(COUNTED, 0)
        want.update({"plastic_head": 1, "residual_tail": 4, "residual_tail_fused": fused_f,
                     "conv3x3": convs + 4 * (4 - fused_f), "residual_tail_backward": 4,
                     "residual_tail_backward_fused": fused_b, "conv3x3_dgrad": convs + 4 * (4 - fused_b),
                     "conv3x3_wgrad": convs + 4 * (4 - fused_b)})
        check(bn_counts == want, f"batch_norm B={B}: launches {bn_counts} != {want}")
        counts["bn_step_b128"] = bn_counts
        bn_ms = time_ms(lambda: grads_of(bn, xb, bn.initial_zero_hebb(B, device=dev), yb), reps=5, warmup=1)[0]
    print(f"[14] batch_norm B={B}, train mode, forward and backward: finite, {bn_ms:.2f} ms (device time); launches "
          f"{({k: v for k, v in bn_counts.items() if v})} (20 convs of the 5 BN trunks and 8 entry convs on "
          f"conv3x3_same, the 4 UpRes middles by the tail routes)", flush=True)
    del loss, out, grads
    bn.load_state_dict(cpu.state_dict())  # the running statistics as they were: the same start on both sides
    x2, y2 = xb[:2].cpu(), yb[:2].cpu()
    h2 = (torch.randn(2, 101, 101, generator=torch.Generator().manual_seed(39)) * 0.05)
    with matmul_precision("parity"):
        sides = [grads_of(m, xx.to(d), h2.to(d), y2.to(d)) for m, xx, d in ((bn, x2, dev), (cpu, x2, "cpu"))]
    (lc, oc, gc), (lr, orf, gr) = sides
    e_out = {}
    for what, a, r in zip(("activ", "activout", "hebb"), oc, orf):
        e_out[what] = float((a.detach().cpu() - r.detach()).abs().max())
        check(e_out[what] <= 1e-5 * max(1.0, float(r.detach().abs().max())), f"batch_norm train B=2: {what} card vs CPU "
              f"{e_out[what]:.3g}")
    e_stats = max(float((a.cpu() - r).abs().max()) for (k, a), r in zip(bn.state_dict().items(), cpu.state_dict().values())
                  if "running" in k)
    check(e_stats <= 1e-5, f"batch_norm: running statistics card vs CPU {e_stats:.3g}")
    e_grad = 0.0
    for a, r in zip(gc, gr):
        if r is None:
            continue
        e = float((a.cpu() - r).abs().max())
        check(e <= 1e-4 * max(1.0, float(r.abs().max())), f"batch_norm: a gradient card vs CPU {e:.3g}")
        e_grad = max(e_grad, e)
    with torch.inference_mode(), matmul_precision("parity"):
        ev = bn.eval()(x2.to(dev), h2.to(dev))
        ev_ref = cpu.eval()(x2, h2)
    e_eval = max(float((a.cpu() - r).abs().max()) / max(1.0, float(r.abs().max())) for a, r in zip(ev, ev_ref))
    check(e_eval <= 1e-5, f"batch_norm eval B=2: card vs CPU {e_eval:.3g}")
    print(f"[14] batch_norm B=2 card vs CPU port: train forward " + ", ".join(f"{k} {v:.3g}" for k, v in e_out.items())
          + f"; running statistics {e_stats:.3g}; gradients {e_grad:.3g} (atol 1e-4 x max(1, max|ref|)); eval forward "
          f"{e_eval:.3g} (over max(1, max|ref|))", flush=True)
    del bn, cpu, sides, ev, ev_ref

    # (4) the TPU lowerings: the default model's bits
    xb8, yb8 = train_stream(1, 8, seed=40)
    xb8, yb8 = xb8[0].to(dev), yb8[0].to(dev)
    with training_numerics():
        runs = []
        for opts in ({}, dict(fold_hires=True), dict(patch_conv=32), dict(fast_dw=True)):
            m = model(41, dropout_ratio=0.5, **opts).to(dev)
            runs.append(grads_of(m, xb8, m.initial_zero_hebb(8, device=dev), yb8,
                                 torch.Generator(device=dev).manual_seed(42)))
            del m
    for (l_, o_, g_) in runs[1:]:
        check(bool(torch.equal(l_, runs[0][0])) and bool(torch.equal(o_.activ, runs[0][1].activ))
              and same_bits(g_, runs[0][2]), "fold_hires / patch_conv / fast_dw: differ from the default model")
    print(f"[14] fold_hires, patch_conv=32, fast_dw: B=8 train-mode loss, activ and gradients (dropout 0.5) == the "
          f"default model's bit for bit; phase 14 took {time.time() - t0:.1f}s", flush=True)
    return keys, counts


# --------------------------------------------------------------------------- phase 15

CLASSIC_NBF = 128  # UNetP's working geometry: 128-px tiles, nbf = 128
CLASSIC_SERVE_TILES = 4 * B  # the timed request: 4 chunks
COORD_SIZE, COORD_TILES, COORD_EPOCHS, COORD_BATCH = 128, 80, 3, 8  # 72 train (9 batches) / 8 validation tiles
COORD_LOSS_ATOL = 2e-4  # CoordConv per-epoch losses, card against the CPU port (27 Adam steps, fp32)
COORD_PROB_ATOL = 1e-4  # CoordConv probabilities, card against the CPU port
COORD_RATE_TILES = 320  # the steady-state rate: fit_epoch over 40 batches, after a warm-up epoch


def classic_tiles(n: int, seed: int, size: int = CLASSIC_NBF):
    """(images (N, size, size, 1) NHWC with the channel's stride 0, as numpy's newaxis gives, masks (N, size, size))."""
    from plastic_unet_tpu_torch.data.synthetic import synthetic_tiles

    x, y = synthetic_tiles(n, size=size, seed=seed)
    return x[:, 0, :, :, None], y[:, 0]


def classic_model(rule: str, seed: int, **kw):
    from plastic_unet_tpu_torch.models.unet_classic import UNetP

    return UNetP(nbf=CLASSIC_NBF, rule=rule, generator=torch.Generator().manual_seed(seed), **kw)


def phase_other_families(dev, smi, name):
    """The classic UNetP and the CoordConv U-Net at full width. UNetP (nbf=128,
    128-px tiles, seeded weights, hebb and oja, ConvTranspose and bilinear):
    B=128 chunks against the CPU port, 1 head launch a chunk and nothing else,
    tiles/s, tta4 folded == one pass a view, the exported identity artifact ==
    the live path, MaskPredictor.from_pth(arch="unet"); 8 B=1 training steps
    eager and as a CUDA graph against the CPU port; start_train(arch="unet")
    with resume, start_inference and submission.csv; cli.train --arch unet on
    101-px tiles raising the geometry error; the head at n=128 timed.
    CoordConvUNet (128 px, batch 8): the forward against the CPU port, 3
    epochs of do_training against the CPU port, cli.coord_conv to
    submission-6.csv. Returns (the head's extra keys, the launch counts of a
    classic chunk and of a classic eager step)."""
    import pickle

    from plastic_unet_tpu_torch.cli import coord_conv as cli_coord
    from plastic_unet_tpu_torch.cli import train as cli_train
    from plastic_unet_tpu_torch.config import TrainConfig
    from plastic_unet_tpu_torch.data.synthetic import synthetic_split
    from plastic_unet_tpu_torch.eval.evaluate import predict_masks
    from plastic_unet_tpu_torch.ops.augment import TTA_VIEWS_4
    from plastic_unet_tpu_torch.ops.plastic_head import head_plan, plastic_head, plastic_head_plain
    from plastic_unet_tpu_torch.ops.rle import rle_decode
    from plastic_unet_tpu_torch.submit.export import export_predictor, load_predictor
    from plastic_unet_tpu_torch.submit.inference import predict_masks_tta, start_inference
    from plastic_unet_tpu_torch.submit.server import MaskPredictor
    from plastic_unet_tpu_torch.train import coord_trainer
    from plastic_unet_tpu_torch.train.driver import start_train
    from plastic_unet_tpu_torch.train.loop import create_train_state, make_epoch_fn
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    t_phase = time.time()
    n = CLASSIC_NBF
    tiles, _ = classic_tiles(CLASSIC_SERVE_TILES, seed=81)
    X = torch.from_numpy(tiles[:B]).to(dev)
    counts = {}

    # -- serving: each variant's chunk on the card against the CPU port, and its launches
    rates = {}
    for label, rule, kw in (("hebb", "hebb", {}), ("oja", "oja", {}), ("oja bilinear", "oja",
                                                                      {"bilinear_upsample": True})):
        model = classic_model(rule, 0, **kw)
        cpu = copy.deepcopy(model).eval()
        card = model.to(dev).eval()
        hebb = card.initial_zero_hebb(B, device=dev)
        with torch.inference_mode(), matmul_precision("parity"):
            card(X, hebb)  # builds and loads the kernels before the counted chunk
            torch.cuda.synchronize()
            reset_counts()
            got = card(X, hebb)
            torch.cuda.synchronize()
            c = expect_launches(f"MAIN PATH (classic UNetP {label}): one B={B} chunk at {n}x{n}",
                                {"plastic_head": HEAD_PER_CHUNK}, 15)
            counts.setdefault("unet_chunk", c)
            ref = cpu(torch.from_numpy(tiles[:B]), cpu.initial_zero_hebb(B))
        errs = []
        for what, g_, r_ in zip(("activ", "activout", "hebb"), got, ref):
            g_ = g_.cpu()
            check(bool(torch.isfinite(g_).all()) and tuple(g_.shape) == (B, n, n), f"UNetP {label}: bad {what}")
            e = float((g_ - r_).abs().max())
            if what != "activ":
                check(e <= 1e-4, f"UNetP {label}: {what} card vs CPU max|diff| {e:.3g} > 1e-4")
            errs.append(f"{what} {e:.3g}")
        print(f"[15] UNetP {label} nbf={n} B={B}, card vs CPU port (activout and the trace within 1e-4): "
              + ", ".join(errs), flush=True)
        pred = MaskPredictor(card, device=None if dev.type == "cuda" else dev)
        pred.predict_probs(tiles[:B])
        secs = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pred.predict_probs(tiles)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        rates[label] = CLASSIC_SERVE_TILES / float(np.median(secs))
    print(f"[15] UNetP serving (NVIDIA card: {smi}), chunk {B}, {CLASSIC_SERVE_TILES} tiles of {n}x{n}, host "
          f"clock, median of 3: " + ", ".join(f"{k} {v:.1f} tiles/s" for k, v in rates.items()), flush=True)

    # -- tta4 folded against one pass a view; the exported artifact; from_pth (the oja ConvTranspose model)
    model = classic_model("oja", 0).to(dev).eval()
    Xt = torch.from_numpy(tiles[:B]).to(dev)
    seq = predict_masks_tta(model, Xt, transforms=TTA_VIEWS_4, device=dev)
    folded = predict_masks_tta(model, Xt, transforms=TTA_VIEWS_4, batch_views=True, device=dev)
    check(bool(torch.equal(seq, folded)), f"UNetP tta4: folded differs from one pass a view, max|diff| "
          f"{float((seq - folded).abs().max()):.3g}")
    live = predict_masks(model, Xt, device=dev).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        art = export_predictor(model, os.path.join(tmp, "unetp"), platforms=(dev.type,))
        t_export = time.perf_counter() - t0
        loaded = load_predictor(art, device=None if dev.type == "cuda" else dev)
        check(loaded.meta["model"] == "UNetP" and loaded.meta["neurons"] is None, f"UNetP manifest {loaded.meta}")
        got = loaded.predict(tiles[:B])
        check(np.array_equal(got, live), f"UNetP identity artifact vs live max|diff| {float(np.abs(got - live).max()):.3g}")
        pth = os.path.join(tmp, "unetp.pth")
        torch.save(model.state_dict(), pth)
        p = MaskPredictor.from_pth(pth, arch="unet", nbf=n, rule="oja", device=None if dev.type == "cuda" else dev)
        check(bool(torch.equal(p.predict_probs(tiles[:B]).cpu(), torch.from_numpy(live))),
              "MaskPredictor.from_pth(arch='unet') differs from the model it was saved from")
    print(f"[15] UNetP oja: tta4 folded == one pass a view (torch.equal, {B} tiles); the exported identity artifact "
          f"(chunk {B}, export {t_export:.2f} s) == the live path; MaskPredictor.from_pth(arch='unet') of the port's "
          f".pth == the live path", flush=True)

    # -- training: 8 B=1 steps eager and as a CUDA graph against the CPU port
    x8, y8 = classic_tiles(TRAIN_STEPS, seed=82)
    Xs, Ys = torch.from_numpy(np.ascontiguousarray(x8))[:, None], torch.from_numpy(y8)[:, None]
    graph_ms = None
    for rule in ("hebb", "oja"):
        runs = {}
        for where, graph in (("cpu", False), ("eager", False), ("graph", True)):
            d = torch.device("cpu") if where == "cpu" else dev
            state = create_train_state(classic_model(rule, 3), TRAIN_LR, TRAIN_GAMMA, TRAIN_STEP_SIZE, device=d)
            if where != "cpu":
                torch.cuda.synchronize()
                reset_counts()
            state, losses = make_epoch_fn(graph=graph and d.type == "cuda")(state, Xs.to(d), Ys.to(d))
            if where == "eager":
                torch.cuda.synchronize()
                c = read_counts()
                want = scaled(dict.fromkeys(COUNTED, 0) | {"plastic_head": 1}, TRAIN_STEPS)
                check(c == want, f"UNetP {rule} eager steps: launches {c} != {want}")
                counts.setdefault("unet_step", {k: v // TRAIN_STEPS for k, v in c.items()})
            if where == "graph":
                torch.cuda.synchronize()
                c = read_counts()
                want = scaled(dict.fromkeys(COUNTED, 0) | {"plastic_head": 1}, TRAIN_STEPS + 2)
                check(c == want, f"UNetP {rule} graph: launches {c} != {want} (2 warm-up steps and a replay a step)")
            runs[where] = (state, losses.cpu())
        (cs, cl), (es, el), (gs, gl) = runs["cpu"], runs["eager"], runs["graph"]
        e_loss = float((el - cl).abs().max())
        e_par = max(float((p.detach().cpu() - q.detach()).abs().max())
                    for p, q in zip(es.model.parameters(), cs.model.parameters()))
        e_tr = float((es.hebb.cpu() - cs.hebb).abs().max())
        check(e_loss <= 5e-5 and e_par <= 5e-4 and e_tr <= 1e-4,
              f"UNetP {rule} training card vs CPU: losses {e_loss:.3g}, parameters {e_par:.3g}, trace {e_tr:.3g}")
        check(float(es.model.eta.detach()) == float(np.float32(0.01)) and float(cs.model.eta.detach())
              == float(np.float32(0.01)), "UNetP training: eta moved from 0.01")
        check(bool(torch.equal(gl, el)) and all(bool(torch.equal(p, q)) for p, q in
                                               zip(gs.model.parameters(), es.model.parameters()))
              and bool(torch.equal(gs.hebb, es.hebb)), f"UNetP {rule}: the CUDA graph differs from eager")
        print(f"[15] UNetP {rule} training, 8 B=1 steps at {n}x{n}: card eager vs CPU port losses {e_loss:.3g} "
              f"(<= 5e-5), parameters {e_par:.3g} (<= 5e-4), trace {e_tr:.3g} (<= 1e-4), eta exactly 0.01; the "
              f"CUDA graph == eager bit for bit (losses, parameters, trace)", flush=True)
        if graph_ms is None:  # the graph step's time: 48 more steps on the captured graph
            xs48, ys48 = classic_tiles(48, seed=83)
            X48 = torch.from_numpy(np.ascontiguousarray(xs48))[:, None].to(dev)
            Y48 = torch.from_numpy(ys48)[:, None].to(dev)
            epoch = make_epoch_fn()
            epoch(gs, X48[:2], Y48[:2])  # the capture at this state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epoch(gs, X48, Y48)
            torch.cuda.synchronize()
            graph_ms = (time.perf_counter() - t0) / 48 * 1e3
    print(f"[15] UNetP B=1 training step as a CUDA graph (NVIDIA card: {smi}): {graph_ms:.3f} ms per step, "
          f"{1e3 / graph_ms:.1f} steps/s (host clock, 48 steps)", flush=True)

    # -- the driver: start_train(arch="unet"), .pth resume, start_inference; cli.train on 101-px tiles
    x_train, x_valid, y_train, y_valid = synthetic_split(32, 8, size=n, seed=84)
    on = None if dev.type == "cuda" else dev
    with tempfile.TemporaryDirectory() as tmp:
        kw = dict(arch="unet", lr=3e-4, val_every=1, steplr=1e5, im_width=n, im_height=n, im_chan=1,
                  matmul_precision="parity", loss_space="probs")
        res = start_train(x_train, x_valid, y_train, y_valid,
                          TrainConfig(out_dir=os.path.join(tmp, "a"), epochs=2, save_every=2, **kw), device=on)
        check(type(res.model).__name__ == "UNetP" and len(res.all_losses) == 64
              and bool(np.isfinite(res.all_losses).all()) and len(res.val_accuracies) == 2, "UNetP driver: bad run")
        prefix = os.path.join(tmp, "a", "train")
        res2 = start_train(x_train, x_valid, y_train, y_valid,
                           TrainConfig(out_dir=os.path.join(tmp, "b"), epochs=1, save_every=1, load=True,
                                       model_path=prefix + "_net.pth", **kw), device=on)
        check(len(res2.all_losses) == 32 and bool(np.isfinite(res2.all_losses).all()), "UNetP driver: bad resume")
        test_imgs, _ = classic_tiles(20, seed=85)
        ids = [f"syn{i}" for i in range(20)]
        subm = start_inference(res.model, ids, test_imgs, x_valid, y_valid, out_dir=os.path.join(tmp, "a"),
                               img_width=n, img_height=n, img_chan=1, device=on)
        lines = open(subm).read().splitlines()
        check(lines[0] == "id,rle_mask" and [ln.split(",")[0] for ln in lines[1:]] == ids, "UNetP submission.csv")
        for ln in lines[1:]:
            check(rle_decode(ln.split(",", 1)[1], (n, n)).shape == (n, n), "UNetP submission.csv: bad RLE")
        try:
            cli_train.main(["--synthetic", "40", "-o", os.path.join(tmp, "c"), "-e", "1", "--arch", "unet"]
                           + ([] if on is None else ["--device", str(on)]))
        except ValueError as e:
            check("divisible by 16" in str(e), f"cli.train --arch unet on 101-px tiles raised another error: {e}")
            geometry = str(e)
        else:
            raise RuntimeError("check failed: cli.train --arch unet on 101-px tiles did not raise")
    print(f"[15] start_train(arch='unet') {n}x{n}: 2 epochs of 32 tiles (losses finite, 2 validations, last val "
          f"loss {res.val_test_losses[-1]:.5f}), .pth resume 1 epoch, start_inference -> submission.csv with "
          f"{len(lines) - 1} rows; cli.train --arch unet --synthetic 40 (101 px) raised: {geometry!r}", flush=True)

    # -- CoordConvUNet: the forward and 3 epochs of do_training against the CPU port; the CLI
    xc, yc = classic_tiles(COORD_TILES, seed=86, size=COORD_SIZE)
    xc = np.ascontiguousarray(xc * 255.0, dtype=np.float32)  # the Keras path's 0..255 range
    yc = np.ascontiguousarray(yc[..., None], dtype=np.float32)
    cm = coord_trainer.construct_model(COORD_SIZE, COORD_SIZE, 1, with_r=True)
    with torch.no_grad(), matmul_precision("parity"):
        got = copy.deepcopy(cm).to(dev).eval()(torch.from_numpy(xc[:COORD_BATCH]).to(dev)).cpu()
        ref = copy.deepcopy(cm).eval()(torch.from_numpy(xc[:COORD_BATCH]))
    e_fwd = float((got - ref).abs().max())
    check(tuple(got.shape) == (COORD_BATCH, COORD_SIZE, COORD_SIZE, 1) and e_fwd <= COORD_PROB_ATOL,
          f"CoordConvUNet forward card vs CPU max|diff| {e_fwd:.3g} > {COORD_PROB_ATOL}")
    with tempfile.TemporaryDirectory() as tmp:
        hist = {}
        for where in ("cpu", "card"):
            mf = os.path.join(tmp, f"{where}.ckpt")
            _, hist[where] = coord_trainer.do_training(copy.deepcopy(cm), xc, yc, epochs=COORD_EPOCHS,
                                                       max_train_time=-1, model_file=mf, batch_size=COORD_BATCH,
                                                       device="cpu" if where == "cpu" else on)
            for f in (mf, mf + "_final", mf + "_final_history.pickle"):
                check(os.path.exists(f), f"do_training: {f} not written")
            with open(mf + "_final_history.pickle", "rb") as f:
                check(pickle.load(f) == hist[where], "do_training: the history pickle differs from the history")
        e_loss = max(abs(a - b) for key in ("loss", "val_loss") for a, b in zip(hist["card"][key], hist["cpu"][key]))
        check(e_loss <= COORD_LOSS_ATOL, f"CoordConv do_training card vs CPU: per-epoch losses {e_loss:.3g} > "
              f"{COORD_LOSS_ATOL}")
        n_train = (COORD_TILES - int(COORD_TILES * 0.1)) // COORD_BATCH * COORD_BATCH
        # the steady-state rate: do_training's epoch loop alone (no transfer, validation or checkpoint),
        # 3 timed epochs after a warm-up one, host clock, median
        xr, yr = classic_tiles(COORD_RATE_TILES, seed=87, size=COORD_SIZE)
        Xr = torch.from_numpy(np.ascontiguousarray(xr * 255.0, dtype=np.float32)).to(dev)
        Yr = torch.from_numpy(np.ascontiguousarray(yr[..., None], dtype=np.float32)).to(dev)
        rm = copy.deepcopy(cm).to(dev).train()
        opt = torch.optim.Adam(rm.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
        g_perm = torch.Generator().manual_seed(87)
        secs = []
        for i in range(4):
            perm = torch.randperm(COORD_RATE_TILES, generator=g_perm).to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses, _ = coord_trainer.fit_epoch(rm, opt, Xr, Yr, perm, COORD_BATCH)
            torch.cuda.synchronize()
            if i:
                secs.append(time.perf_counter() - t0)
        check(bool(torch.isfinite(torch.stack(losses)).all()), "CoordConv fit_epoch: non-finite loss")
        coord_rate = COORD_RATE_TILES / float(np.median(secs))
        data = write_tgs_dir(os.path.join(tmp, "tgs"))
        subm = cli_coord.main(["--data", data, "--out", os.path.join(tmp, "cli"), "--train", "--inference",
                               "--short-run", "--epochs", "2"] + ([] if on is None else ["--device", str(on)]))
        lines = open(subm).read().splitlines()
        check(lines[0] == "id,rle_mask" and sorted(ln.split(",")[0] for ln in lines[1:]) == [f"t{j}" for j in range(7)],
              "cli.coord_conv: submission-6.csv header or ids")
    print(f"[15] CoordConvUNet {COORD_SIZE}x{COORD_SIZE} (with_r): B={COORD_BATCH} forward card vs CPU port max|diff| "
          f"{e_fwd:.3g} (<= {COORD_PROB_ATOL}); do_training {COORD_EPOCHS} epochs of {n_train} tiles (batch "
          f"{COORD_BATCH}) card vs CPU port per-epoch loss/val_loss max|diff| {e_loss:.3g} (<= {COORD_LOSS_ATOL}): "
          f"card {hist['card']['loss']} / {hist['card']['val_loss']}; the checkpoint, _final and the history "
          f"pickle written; on the card {coord_rate:.1f} training samples/s (NVIDIA card: {smi}; fit_epoch over "
          f"{COORD_RATE_TILES} tiles, batch {COORD_BATCH}, median of 3 epochs after a warm-up one, host clock); "
          f"cli.coord_conv --train --inference "
          f"--short-run --epochs 2 -> submission-6.csv with {len(lines) - 1} rows", flush=True)

    # -- the head at n=128, as UNetP runs it: B=128 serving and B=1 training
    pk = peaks(name)
    g = torch.Generator(device=dev).manual_seed(15)
    keys = {}
    with torch.inference_mode(), matmul_precision("parity"):
        w = torch.randn((n, n), generator=g, device=dev) * 0.01
        a = torch.rand((n, n), generator=g, device=dev) * 0.01
        eta = torch.full((1,), 0.01, device=dev)
        for b, sfx in ((B, "_n128"), (1, "_n128_b1")):
            x = torch.randn((b, n, n), generator=g, device=dev)
            hebb = torch.randn((b, n, n), generator=g, device=dev) * 0.1
            eff = w + a * hebb
            e, tol = max_err(plastic_head(w, a, eta, x, hebb, rule="oja")[1],
                             plastic_head_plain(w, a, eta, x, hebb, rule="oja")[1])
            check(e <= tol, f"plastic_head B={b} nbf={n}: activout max|diff| {e:.3g} > {tol:.3g}")
            t = dict(ms=time_ms(lambda: plastic_head(w, a, eta, x, hebb, rule="oja"))[0],
                     plain_ms=time_ms(lambda: plastic_head_plain(w, a, eta, x, hebb, rule="oja"))[0],
                     bmm_ms=time_ms(lambda: torch.bmm(x, eff))[0])
            t["bound_ms"], t["bound_by"] = bound_ms(2 * b * n ** 3 + 8 * b * n * n, 4 * (5 * b * n * n + 2 * n * n + 1),
                                                    pk)
            keys.update({k + sfx: v for k, v in t.items()})
            keys["max_abs_err" + sfx] = e
            print(f"[15] plastic_head B={b} nbf={n} ({head_plan(b, n).family}, oja free; NVIDIA card: {smi}): kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, torch.bmm of the product alone {t['bmm_ms']:.4f} "
                  f"ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}), {t['bound_ms'] / t['ms']:.1%} of bound; "
                  f"activout max|diff| {e:.3g} (<= {tol:.3g})", flush=True)
    keys["classic_tiles_s"] = rates
    print(f"[15] phase 15 took {time.time() - t_phase:.1f}s", flush=True)
    return {"plastic_head": keys}, counts


# --------------------------------------------------------------------------- phase 16

DP_LANE_STEPS = 4  # steps at lanes=B (phase 8's count)
DP_PMEAN_LANES = 4
DP_SERVE_TILES = 512
DP_RATE_STEPS = {1: 48, B: 8}  # steps a timing, median of 3 (phase 10's rate)


def step_rate(step_fn, state, xs, ys, steps):
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


def world_one(tmp: str, name: str, device):
    """A process group of one rank over a file store in ``tmp`` (the backend
    from the device: Gloo for the CPU, NCCL for CUDA) and its 1-D mesh."""
    from datetime import timedelta

    from plastic_unet_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(device, init_method="file://" + os.path.join(tmp, name), rank=0, world_size=1,
                     timeout=timedelta(seconds=120))
    return make_mesh(1, device=device)


def same_state(a, b) -> bool:
    return all(bool(torch.equal(p, q)) for p, q in zip(a.model.parameters(), b.model.parameters())) \
        and bool(torch.equal(a.hebb, b.hebb))


def collective_rows(prof, steps: int) -> tuple:
    """(host ops of the all-reduce a step, {NCCL kernel: device us a step}) from a torch.profiler run."""
    rows = prof.key_averages()
    host = {e.key: e.count / steps for e in rows if "allreduce" in e.key.lower().replace("_", "")
            and e.device_type == torch.autograd.DeviceType.CPU}
    kernels = {e.key: e.device_time_total / steps for e in rows
               if e.device_type == torch.autograd.DeviceType.CUDA and "nccl" in e.key.lower()}
    return host, kernels


def phase_data_parallel(dev, smi, name):
    """Phase 16: the data-parallel path at world size 1 over NCCL (one card),
    with the CPU port's Gloo world-1 run as the pmean reference."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from plastic_unet_tpu_torch.config import TrainConfig
    from plastic_unet_tpu_torch.data.synthetic import synthetic_split
    from plastic_unet_tpu_torch.eval.evaluate import predict_masks
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.ops.augment import draw_augment_choices, parse_tta
    from plastic_unet_tpu_torch.parallel import dp
    from plastic_unet_tpu_torch.parallel.mesh import BACKENDS
    from plastic_unet_tpu_torch.submit.inference import predict_masks_tta
    from plastic_unet_tpu_torch.train.driver import RESUME_STATE, make_generators, start_train
    from plastic_unet_tpu_torch.train.loop import GraphTrainStep, create_train_state, make_train_step

    t_phase = time.time()
    Xp, Yp = train_stream(4, DP_PMEAN_LANES, seed=27)
    with tempfile.TemporaryDirectory() as tmp:
        # the reference of check 3: the CPU port's pmean run in a Gloo group of one rank
        mesh = world_one(tmp, "gloo", "cpu")
        try:
            t0 = time.time()
            cpu_state, cpu_losses = train_run("oja", "cpu", Xp, Yp, graph=False, lanes=DP_PMEAN_LANES, mesh=mesh,
                                              trace_mode="pmean")
            t_cpu = time.time() - t0
        finally:
            dist.destroy_process_group()

        mesh = world_one(tmp, "nccl", dev)
        check(dist.get_backend() == BACKENDS[dev.type] and mesh.size() == 1, f"phase 16: {dist.get_backend()}")
        print(f"[16] {dist.get_backend()} process group of one rank on {name} (NVIDIA card: {smi}); mesh {mesh}",
              flush=True)
        try:
            # 1 and 2: DP == the single-device step bit for bit, graph and eager; launches a step
            streams = {1: train_stream(TRAIN_STEPS, 1, seed=28), B: train_stream(DP_LANE_STEPS, B, seed=29)}
            dp_counts = None
            for rule in ("hebb", "oja"):
                for lanes, (X, Y) in streams.items():
                    steps = X.shape[0]
                    per_step = lane_step_counts(lanes) if lanes > 1 else dict(STEP_COUNTS)
                    for graph in (None, False):
                        ref_state, ref_losses = train_run(rule, dev, X, Y, graph=graph, lanes=lanes)
                        reset_counts()
                        state, losses = train_run(rule, dev, X, Y, graph=graph, lanes=lanes, mesh=mesh)
                        torch.cuda.synchronize()
                        runs = steps if graph is False else steps + 2  # eager steps, or 2 warm-up steps + the replays
                        counts = read_counts()
                        check(counts == scaled(per_step, runs) and all_reduces() == runs,
                              f"DP {rule} lanes={lanes} graph={graph}: launches {counts} != {scaled(per_step, runs)} "
                              f"or {all_reduces()} all-reduces != {runs}")
                        check(bool(torch.equal(losses, ref_losses)) and same_state(state, ref_state),
                              f"DP {rule} lanes={lanes} graph={graph}: differs from make_epoch_fn: losses max|diff| "
                              f"{(losses - ref_losses).abs().max().item():.3g}")
                        if lanes == B and graph is False:
                            dp_counts = {k: v // steps for k, v in counts.items()}
                        del ref_state, state
                    print(f"[16] DP world 1, {rule}, lanes={lanes}, {steps} steps: losses, parameters and trace equal "
                          f"make_epoch_fn's bit for bit, as a CUDA graph and eager; an eager step "
                          f"{per_step['plastic_head']} head, {per_step['residual_tail']} tails ({per_step['residual_tail_fused']} fused), "
                          f"{per_step['residual_tail_backward']} tail backwards "
                          f"({per_step['residual_tail_backward_fused']} fused) and 1 gradient all-reduce; the graph "
                          f"run counts them for 2 warm-up steps and each replay", flush=True)
            print(f"[16] MAIN PATH (data parallel): launches per eager DP step, lanes={B}: "
                  f"{({k: v for k, v in dp_counts.items() if v})} and 1 all-reduce", flush=True)

            # the collective in the profiler: one eager DP step and one graph replay, lanes=B
            X, Y = (t.to(dev) for t in streams[B])
            reducer = dp.MeshReducer(mesh)

            def fresh(lanes):
                model = UNetPRes(neurons=16, nbf=101, rule="oja", dropout_ratio=0.0,
                                 generator=torch.Generator().manual_seed(3))
                return create_train_state(model, TRAIN_LR, TRAIN_GAMMA, 1e6, lanes=lanes, device=dev)

            st = fresh(B)
            eager = make_train_step(reducer=reducer)
            eager(st, (X[0], Y[0]))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                eager(st, (X[1], Y[1]))
                torch.cuda.synchronize()
            host, kernels = collective_rows(prof, 1)
            check(sum(host.values()) >= 1, f"torch.profiler saw no all-reduce in a DP step: {sorted(host)}")
            g = GraphTrainStep(st, X.shape[1:], Y.shape[1:], reducer=reducer)
            g(st, (X[0], Y[0]))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for i in range(4):
                    g(st, (X[i % X.shape[0]], Y[i % Y.shape[0]]))
                torch.cuda.synchronize()
            _, graph_kernels = collective_rows(prof, 4)
            print(f"[16] torch.profiler, one eager DP step lanes={B}: host ops of the all-reduce {host}; NCCL kernels "
                  f"{kernels or 'none'} ({sum(kernels.values()):.1f} us of device time); a graph replay: NCCL kernels "
                  f"{graph_kernels or 'none'} ({sum(graph_kernels.values()):.1f} us a step)", flush=True)
            del st, g, eager

            # 3: pmean at lanes 4: every lane is the lanes' mean; the losses against the CPU port's Gloo run
            one_ref, _ = train_run("oja", dev, Xp[:1], Yp[:1], graph=False, lanes=DP_PMEAN_LANES)
            reset_counts()
            one, _ = train_run("oja", dev, Xp[:1], Yp[:1], graph=False, lanes=DP_PMEAN_LANES, mesh=mesh,
                               trace_mode="pmean")
            check(all_reduces() == 2, f"pmean: {all_reduces()} all-reduces in a step, want 2 (gradients, trace)")
            check(bool(torch.equal(one.hebb, one_ref.hebb.mean(dim=0, keepdim=True).expand_as(one_ref.hebb))),
                  "pmean: the trace after a step is not the mean of the lanes' traces")
            state, losses = train_run("oja", dev, Xp, Yp, graph=None, lanes=DP_PMEAN_LANES, mesh=mesh,
                                      trace_mode="pmean")
            check(all(bool(torch.equal(state.hebb[0], lane)) for lane in state.hebb), "pmean: the lanes' traces differ")
            e_loss = float((losses.cpu() - cpu_losses).abs().max())
            e_tr = float((state.hebb.cpu() - cpu_state.hebb).abs().max())
            check(e_loss <= 5e-5 and e_tr <= 1e-4, f"pmean: card vs the CPU port's Gloo run: losses {e_loss:.3g} "
                  f"(5e-5), trace {e_tr:.3g} (1e-4)")
            print(f"[16] pmean, lanes={DP_PMEAN_LANES}, 4 steps (CUDA graph): every lane's trace is the lanes' mean "
                  f"(after one step, bit for bit the mean of the single-device lanes); card vs the CPU port's Gloo "
                  f"world-1 run ({t_cpu:.1f}s): losses max|diff| {e_loss:.3g}, trace {e_tr:.3g}", flush=True)
            del one, one_ref, state

            # 4: two epochs in one dispatch == two one-epoch dispatches, shuffle, augment, dropout 0.5
            Xk, Yk = (t.to(dev) for t in train_stream(4, DP_PMEAN_LANES, seed=30))
            runs = []
            for per in (2, 1):
                dropout, gens = make_generators(TrainConfig(seed=13), dev)
                model = UNetPRes(neurons=16, nbf=101, rule="hebb", dropout_ratio=0.5,
                                 generator=torch.Generator().manual_seed(3))
                st = create_train_state(model, TRAIN_LR, TRAIN_GAMMA, TRAIN_STEP_SIZE, lanes=DP_PMEAN_LANES,
                                        generator=dropout, device=dev)
                run = dp.make_dp_multi_epoch_fn(mesh, shuffle=True, augment=True)
                rows = []
                for _ in range(2 // per):
                    perms = dp.shard_perms(Xk, gens["shuffle"], per)
                    choices = torch.stack([draw_augment_choices(Xk.shape[0] * Xk.shape[1], gens["augment"])
                                           for _ in range(per)])
                    st, losses = run(st, Xk, Yk, perms, dp.shard_choices(choices, DP_PMEAN_LANES, mesh), epochs=per)
                    rows.append(losses)
                runs.append((st, torch.cat(rows), dropout.get_state()))
            (a, la, ga), (b, lb, gb) = runs
            check(bool(torch.equal(la, lb)) and same_state(a, b) and bool(torch.equal(ga, gb)),
                  "DP: 2 epochs in one dispatch differ from 2 one-epoch dispatches")
            print(f"[16] DP K-epoch dispatch, lanes={DP_PMEAN_LANES}, shuffle, augment, dropout 0.5: 2 epochs in one "
                  f"dispatch == 2 one-epoch dispatches bit for bit (losses "
                  f"{[round(v, 5) for v in la.reshape(-1).tolist()]})", flush=True)
            del runs, a, b, st

            # 5: the driver's DP route (a mesh handed to start_train): 2 epochs + a resume for 2 == 4 straight
            split = synthetic_split(32, 8, size=101)
            res = {}
            for key, epochs, resume in (("straight", 4, ""), ("first", 2, ""), ("resumed", 2, "first")):
                cfg = TrainConfig(out_dir=os.path.join(tmp, key), epochs=epochs, neurons=16, dropout_ratio=0.5,
                                  shuffle=True, augment=True, val_every=2, save_every=2, matmul_precision="parity",
                                  resume_orbax=os.path.join(tmp, resume, RESUME_STATE) if resume else "")
                res[key] = start_train(*split, cfg, device=dev, mesh=mesh)
                res[key + "_file"] = torch.load(os.path.join(tmp, key, RESUME_STATE), weights_only=True)
            s4, s2, r2 = res["straight"], res["first"], res["resumed"]
            check(s2.all_losses + r2.all_losses == s4.all_losses and r2.val_test_losses == s4.val_test_losses[1:]
                  and r2.val_accuracies == s4.val_accuracies[1:] and same_state(r2.state, s4.state)
                  and bool(torch.equal(r2.state.generator.get_state(), s4.state.generator.get_state())),
                  "the driver's DP route: 2 epochs + a resume differ from 4 straight")
            fs, fr = res["straight_file"], res["resumed_file"]
            check(fs["world_size"] == 1 and tuple(fs["hebb"].shape) == (1, 101, 101)
                  and all(bool(torch.equal(fs["generators"][k][0], fr["generators"][k][0])) for k in fs["generators"]),
                  "the driver's DP route: the resume-state files differ")
            written = sorted(os.listdir(os.path.join(tmp, "straight")))
            check({"train_net.pth", "train_parameters.dat", RESUME_STATE} <= set(written), f"driver wrote {written}")
            print(f"[16] the driver's DP route (start_train with a mesh of one rank, neurons=16, 32 tiles, dropout "
                  f"0.5, shuffle, augment): 2 epochs + a resume for 2 == 4 straight bit for bit (losses, parameters, "
                  f"trace, validation {s4.val_test_losses}, every generator through the NCCL gather into {RESUME_STATE}); "
                  f"wrote {written}", flush=True)
            del res, s4, s2, r2

            # 6: sharded inference == unsharded
            model = UNetPRes(neurons=16, nbf=101, rule="hebb", generator=torch.Generator().manual_seed(3))
            xs = torch.from_numpy(np.ascontiguousarray(np.transpose(
                synthetic_split(DP_SERVE_TILES, 0, size=101, seed=31)[0], (0, 2, 3, 1)))).to(dev)
            tta4 = parse_tta("tta4")
            for label, fn in (("identity", lambda **k: predict_masks(model, xs, chunk=B, device=dev, **k)),
                              ("tta4", lambda **k: predict_masks_tta(model, xs, transforms=tta4, chunk=B, device=dev,
                                                                     **k))):
                check(bool(torch.equal(fn(mesh=mesh), fn())), f"sharded {label} differs from unsharded")
            print(f"[16] predict_masks and predict_masks_tta(tta4) with the mesh, {DP_SERVE_TILES} tiles at chunk {B}: "
                  f"equal to the unsharded calls bit for bit", flush=True)
            del model, xs

            # 7: times: the graph step with and without the all-reduce, in turns; a replay's device time;
            # at lanes=1 the kernels the DP replay adds, by name (torch.profiler, 4 replays each)
            rates, device, by_name = {}, {}, {}
            for lanes, (X, Y) in streams.items():
                X, Y = X.to(dev), Y.to(dev)
                for red in (None, reducer, reducer, None):
                    st = fresh(lanes)
                    g = GraphTrainStep(st, X.shape[1:], Y.shape[1:], reducer=red)
                    g(st, (X[0], Y[0]))
                    key = (lanes, red is not None)
                    rates.setdefault(key, []).append(step_rate(g, st, X, Y, DP_RATE_STEPS[lanes]))
                    device.setdefault(key, []).append(time_ms(lambda: g(st, (X[0], Y[0])), reps=10, warmup=1)[0])
                    if lanes == 1 and key not in by_name:
                        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                            for _ in range(4):
                                g(st, (X[0], Y[0]))
                            torch.cuda.synchronize()
                        by_name[key] = {e.key: e.device_time_total / 4 for e in prof.key_averages()
                                        if e.device_type == torch.autograd.DeviceType.CUDA}
                    del st, g
                    torch.cuda.empty_cache()
            for lanes in streams:
                single, multi = (float(np.mean(rates[(lanes, k)])) for k in (False, True))
                unit = "steps/s" if lanes == 1 else "samples/s"
                print(f"[16] graph step lanes={lanes} (host clock, {DP_RATE_STEPS[lanes]} steps, median of 3, in turns "
                      f"single / DP / DP / single; NVIDIA card: {smi}): make_epoch_fn's "
                      f"{[round(lanes / s, 1) for s in rates[(lanes, False)]]} {unit}, DP world 1 "
                      f"{[round(lanes / s, 1) for s in rates[(lanes, True)]]} {unit}; DP / single rate "
                      f"{single / multi:.4f}; a replay's device time (CUDA events, median of 10): single "
                      f"{[round(v, 4) for v in device[(lanes, False)]]} ms, DP "
                      f"{[round(v, 4) for v in device[(lanes, True)]]} ms", flush=True)
            one, many = by_name[(1, False)], by_name[(1, True)]
            added = sorted(((k, many.get(k, 0.0) - one.get(k, 0.0)) for k in set(one) | set(many)),
                           key=lambda kv: -abs(kv[1]))
            print(f"[16] lanes=1, what the DP replay adds by kernel name (torch.profiler, device us a step, DP - "
                  f"single; total {sum(many.values()) - sum(one.values()):.1f} of {sum(one.values()):.1f}): "
                  + "; ".join(f"{d:+.1f} {k[:90]}" for k, d in added[:6]), flush=True)
        finally:
            dist.destroy_process_group()
    print(f"[16] phase 16 took {time.time() - t_phase:.1f}s", flush=True)
    return dp_counts


# --------------------------------------------------------------------------- phase 17

BF16_TILES = 512  # the bf16 serving request: 4 chunks of B
BF16_ATOL = 2e-2  # bf16 probabilities against fp32 (the JAX bound, tests/test_export.py:224)
BF16_CPU_TILES = 32  # the tiles held against the CPU port in bf16
BF16_LOSS_RTOL = 3e-2  # bf16 training losses, card against the CPU port in bf16 (tests/test_patch_conv.py:233)
BF16_INT8_ATOL = 0.05  # int8 under bf16 against fp32 (tests/test_quant.py:134-142)
BF16_TTA_TILES = 128
# "perf" (TF32 in cuDNN and cuBLAS) against "parity": TF32 keeps 10 of fp32's 23 mantissa bits, 3 more than
# bf16's 7, so its bound is a quarter of the bf16 one on the probabilities and on the step's loss
TF32_ATOL, TF32_LOSS_RTOL = BF16_ATOL / 4, BF16_LOSS_RTOL / 4


def bf16_counts(k: int = 1) -> dict:
    """Launches of k bf16 chunks or B=1 steps: the plastic head (B1, fp32) once each and no trunk kernel, since
    the bf16 trunk is cuDNN's bf16 convs, as the JAX package runs no Pallas trunk in bf16."""
    want = dict.fromkeys(COUNTED, 0)
    want["plastic_head"] = k
    return want


def phase_bf16(dev, smi):
    """compute_dtype bfloat16 at full width (UNetPRes neurons=16, nbf=101, phase 3's seeded weights): serving
    against the card's fp32 forward and the CPU port in bf16, repeatable bits, the launches a chunk, tiles/s
    against fp32; the bf16 artifact against the live forward; tta8 folded against one pass a view; int8 under
    bf16; 8 B=1 training steps eager and as a CUDA graph against the CPU port in bf16, the graph step's ms and
    a lanes=B step's samples/s against fp32; the precision policy ("perf" against "parity") on one B=1 graph
    step and one serving chunk. Returns the launch counts of one bf16 chunk and of one bf16 B=1 step."""
    from plastic_unet_tpu_torch.data.synthetic import synthetic_tiles
    from plastic_unet_tpu_torch.eval.evaluate import predict_masks
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.ops.augment import TTA_VIEWS_8
    from plastic_unet_tpu_torch.submit.export import export_predictor, load_predictor
    from plastic_unet_tpu_torch.submit.inference import predict_masks_tta
    from plastic_unet_tpu_torch.submit.quant import quantize_for_serving
    from plastic_unet_tpu_torch.submit.server import MaskPredictor
    from plastic_unet_tpu_torch.train.loop import GraphTrainStep, create_train_state, make_train_step
    from plastic_unet_tpu_torch.utils.precision import matmul_precision, serving_numerics

    t_phase = time.time()
    bf16 = "bfloat16"

    def model_of(dtype, rule="oja"):
        m = UNetPRes(neurons=16, nbf=101, rule=rule, compute_dtype=dtype)
        m.load_state_dict(seeded_model(16, rule, 0).state_dict(), strict=True)
        return m

    imgs, _ = synthetic_tiles(BF16_TILES, size=101, seed=81)
    tiles = np.ascontiguousarray(imgs[:, 0, :, :, None])  # (512, 101, 101, 1) NHWC
    X = torch.from_numpy(tiles).to(dev)
    m32, mb = model_of(None).to(dev).eval(), model_of(bf16).to(dev).eval()
    chunks = BF16_TILES // B

    # -- serving
    p32 = predict_masks(m32, X, device=dev)
    reset_counts()
    pb = predict_masks(mb, X, device=dev)
    torch.cuda.synchronize()
    chunk_launches = expect_launches(f"MAIN PATH (bf16 serving): {BF16_TILES} tiles = {chunks} chunks",
                                     bf16_counts(chunks), 17)
    chunk_launches = {k: v // chunks for k, v in chunk_launches.items()}
    check(pb.dtype == torch.float32 and tuple(pb.shape) == (BF16_TILES, 101, 101) and bool(torch.isfinite(pb).all()),
          "bf16 serving: bad probabilities")
    e32 = float((pb - p32).abs().max())
    check(0 < e32 <= BF16_ATOL, f"bf16 serving against the card's fp32: max|diff| {e32:.3g} (want in (0, {BF16_ATOL}])")
    again = predict_masks(mb, X, device=dev)
    check(bool(torch.equal(again, pb)), "bf16 serving: two runs differ")
    ref = predict_masks(model_of(bf16).eval(), tiles[:BF16_CPU_TILES], chunk=BF16_CPU_TILES, device="cpu")
    ecpu = float((pb[:BF16_CPU_TILES].cpu() - ref).abs().max())
    check(ecpu <= BF16_ATOL, f"bf16 serving against the CPU port in bf16: max|diff| {ecpu:.3g} > {BF16_ATOL}")
    print(f"[17] bf16 serving, neurons=16 oja, chunk {B}, {BF16_TILES} tiles: against the card's fp32 forward "
          f"max|diff| {e32:.3g} (bound {BF16_ATOL}), against the CPU port in bf16 ({BF16_CPU_TILES} tiles) "
          f"{ecpu:.3g}; two runs equal bit for bit", flush=True)

    preds = {"fp32": MaskPredictor(m32, device=dev), "bf16": MaskPredictor(mb, device=dev)}
    host = tiles[:, :, :, 0]

    def serve_rate(pred):
        """tiles/s of a 512-tile request from the host, host clock, median of 3."""
        pred.predict_probs(host[:B])
        torch.cuda.synchronize()
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            pred.predict_probs(host)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return BF16_TILES / float(np.median(secs))

    turns = [(k, serve_rate(preds[k])) for k in ("fp32", "bf16", "bf16", "fp32")]
    rate = {k: float(np.mean([r for kk, r in turns if kk == k])) for k in preds}
    xc = X[:B]
    h0 = m32.initial_zero_hebb(B, device=dev)
    with torch.inference_mode(), serving_numerics():  # the serving path's deterministic cuDNN
        fwd_ms = {k: time_ms(lambda m=m: m(xc, h0))[0] for k, m in (("fp32", m32), ("bf16", mb))}
    print(f"[17] serving tiles/s (NVIDIA card: {smi}), neurons=16, chunk {B}, {BF16_TILES} tiles from the host, "
          f"host clock, median of 3, in turns fp32, bf16, bf16, fp32: {[(k, round(r, 1)) for k, r in turns]}; "
          f"bf16 {rate['bf16']:.1f} against fp32 {rate['fp32']:.1f} ({rate['bf16'] / rate['fp32']:.3f}x); forward "
          f"device time per chunk bf16 {fwd_ms['bf16']:.3f} ms, fp32 {fwd_ms['fp32']:.3f} ms", flush=True)

    # -- the bf16 artifact
    with tempfile.TemporaryDirectory() as tmp:
        path = export_predictor(mb, os.path.join(tmp, "bf16"), platforms=(dev.type,))
        with open(os.path.join(path, "meta.json")) as f:
            check(json.load(f)["compute_dtype"] == bf16, "bf16 artifact: meta.json does not say bfloat16")
        art = load_predictor(path, device=None if dev.type == "cuda" else dev).warmup()
        reset_counts()
        got = art.predict(tiles)
        torch.cuda.synchronize()
        expect_launches(f"the bf16 artifact, {BF16_TILES} tiles", bf16_counts(chunks), 17)
        check(np.array_equal(got, pb.cpu().numpy()), "the bf16 artifact differs from the live bf16 forward")
    print(f"[17] the bf16 artifact (export_predictor, load_predictor): meta.json says bfloat16; {BF16_TILES} tiles "
          f"equal to the live bf16 forward bit for bit", flush=True)

    # -- tta8 folded against one pass a view (reported, not held: the JAX package does not require it)
    xt = X[:BF16_TTA_TILES]
    folded = predict_masks_tta(mb, xt, transforms=TTA_VIEWS_8, batch_views=True, device=dev)
    passes = predict_masks_tta(mb, xt, transforms=TTA_VIEWS_8, device=dev)
    print(f"[17] bf16 tta8, {BF16_TTA_TILES} tiles: views folded into the batch equal to one pass a view: "
          f"{bool(torch.equal(folded, passes))}, max|diff| {float((folded - passes).abs().max()):.3g}", flush=True)

    # -- int8 under bf16
    qb = quantize_for_serving(mb, tiles[:2 * B], device=dev)
    reset_counts()
    pq = predict_masks(qb, X, device=dev)
    torch.cuda.synchronize()
    expect_launches(f"int8 under bf16, {BF16_TILES} tiles", bf16_counts(chunks), 17)
    eq = float((pq - p32).abs().max())
    check(bool(torch.isfinite(pq).all()) and eq <= BF16_INT8_ATOL,
          f"int8 under bf16 against fp32: max|diff| {eq:.3g} > {BF16_INT8_ATOL}")
    print(f"[17] int8 under bf16 (calibrated on {2 * B} tiles): against fp32 max|diff| {eq:.3g} "
          f"(bound {BF16_INT8_ATOL})", flush=True)
    del m32, mb, preds, qb, art, X

    # -- training, B=1, hebb, dropout 0
    Xs, Ys = train_stream(TRAIN_STEPS, 1, seed=21)
    cpu_state, cpu_losses = train_run("hebb", "cpu", Xs, Ys, graph=False, compute_dtype=bf16)
    reset_counts()
    state, losses = train_run("hebb", dev, Xs, Ys, graph=False, compute_dtype=bf16)
    torch.cuda.synchronize()
    step_launches = expect_launches(f"MAIN PATH (bf16 training): {TRAIN_STEPS} eager B=1 steps",
                                    bf16_counts(TRAIN_STEPS), 17)
    step_launches = {k: v // TRAIN_STEPS for k, v in step_launches.items()}
    check(bool(torch.isfinite(losses).all()), "bf16 training: non-finite losses")
    rel = float(((losses.cpu() - cpu_losses).abs() / cpu_losses.abs()).max())
    check(rel <= BF16_LOSS_RTOL, f"bf16 training losses against the CPU port in bf16: relative {rel:.3g}")
    check(all(p.dtype == torch.float32 for p in state.model.parameters())
          and float(state.model.eta.detach()) == float(np.float32(0.01)), "bf16 training: parameters not fp32 or eta")
    reset_counts()
    g_state, g_losses = train_run("hebb", dev, Xs, Ys, graph=None, compute_dtype=bf16)
    torch.cuda.synchronize()
    expect_launches("bf16 training as a CUDA graph (2 warm-up steps and a replay a step)", bf16_counts(TRAIN_STEPS + 2),
                    17)
    check(bool(torch.equal(g_losses, losses)) and same_state(g_state, state), "bf16 training: graph differs from eager")
    print(f"[17] bf16 training neurons=16 hebb B=1, {TRAIN_STEPS} steps: losses {[round(v, 6) for v in losses.tolist()]}"
          f", relative max|diff| against the CPU port in bf16 {rel:.3g} (bound {BF16_LOSS_RTOL}); the CUDA graph "
          f"equal to eager bit for bit (losses, parameters, trace); parameters fp32, eta == 0.01", flush=True)
    del state, g_state, cpu_state

    Xd, Yd = train_stream(16, 1, seed=23)
    Xd, Yd = Xd.to(dev), Yd.to(dev)
    Xl, Yl = train_stream(2, B, seed=24)
    Xl, Yl = Xl.to(dev), Yl.to(dev)

    def fresh(dtype, lanes=1):
        m = UNetPRes(neurons=16, nbf=101, rule="oja", dropout_ratio=0.0, compute_dtype=dtype,
                     generator=torch.Generator().manual_seed(3))
        return create_train_state(m, TRAIN_LR, TRAIN_GAMMA, 1e6, lanes=lanes, device=dev)

    def graph_of(dtype):
        st = fresh(dtype)
        step = GraphTrainStep(st, Xd.shape[1:], Yd.shape[1:])
        step(st, (Xd[0], Yd[0]))
        return step, st

    eager = make_train_step()
    graphs = {k: graph_of(dt) for k, dt in (("fp32", None), ("bf16", bf16))}
    lanes = {k: fresh(dt, B) for k, dt in (("fp32", None), ("bf16", bf16))}
    for st in lanes.values():
        eager(st, (Xl[0], Yl[0]))
    g_turns, l_turns = [], []
    for k in ("fp32", "bf16", "bf16", "fp32"):
        step, st = graphs[k]
        g_turns.append((k, step_rate(step, st, Xd, Yd, 48) * 1e3))
        l_turns.append((k, B / step_rate(eager, lanes[k], Xl, Yl, 4)))
    g_ms = {k: float(np.mean([v for kk, v in g_turns if kk == k])) for k in graphs}
    l_rate = {k: float(np.mean([v for kk, v in l_turns if kk == k])) for k in graphs}
    print(f"[17] training (NVIDIA card: {smi}), neurons=16, host clock, median of 3, in turns fp32, bf16, bf16, fp32: "
          f"the B=1 graph step {[(k, round(v, 4)) for k, v in g_turns]} ms, bf16 {g_ms['bf16']:.4f} against fp32 "
          f"{g_ms['fp32']:.4f} ms ({g_ms['fp32'] / g_ms['bf16']:.3f}x); the eager lanes={B} step "
          f"{[(k, round(v, 1)) for k, v in l_turns]} samples/s, bf16 {l_rate['bf16']:.1f} against fp32 "
          f"{l_rate['fp32']:.1f} ({l_rate['bf16'] / l_rate['fp32']:.3f}x)", flush=True)
    del graphs, lanes

    # -- the precision policy: one fp32 B=1 graph step and one fp32 serving chunk under "perf" and "parity"
    m32 = model_of(None).to(dev).eval()
    h0 = m32.initial_zero_hebb(B, device=dev)
    res, times = {}, {}
    for policy in ("parity", "perf", "perf", "parity"):
        with matmul_precision(policy):
            st = fresh(None)
            step = GraphTrainStep(st, Xd.shape[1:], Yd.shape[1:])
            _, loss = step(st, (Xd[0], Yd[0]))
            loss = float(loss)  # the graph's static output: read before the timed replays
            params = torch.cat([p.detach().reshape(-1) for p in st.model.parameters()])
            chunk = predict_masks(m32, xc, device=dev)
            times.setdefault(policy, []).append((step_rate(step, st, Xd, Yd, 48) * 1e3,
                                                 time_ms(lambda: predict_masks(m32, xc, device=dev))[0]))
        res.setdefault(policy, []).append((loss, params, chunk))
        del step, st
    for policy, runs in res.items():
        (l1, w1, c1), (l2, w2, c2) = runs
        check(l1 == l2 and bool(torch.equal(w1, w2)) and bool(torch.equal(c1, c2)),
              f"matmul_precision({policy!r}): the graph step or the chunk differs between two runs")
    (lp, wp, cp), (lf, wf, cf) = res["parity"][0], res["perf"][0]
    e_chunk, e_loss = float((cf - cp).abs().max()), abs(lf - lp) / abs(lp)
    check(not torch.equal(wf, wp) and not torch.equal(cf, cp), '"perf" gives the bits of "parity": TF32 not engaged')
    check(e_chunk <= TF32_ATOL and e_loss <= TF32_LOSS_RTOL,
          f'"perf" against "parity": chunk max|diff| {e_chunk:.3g} (bound {TF32_ATOL}), step loss relative '
          f'{e_loss:.3g} (bound {TF32_LOSS_RTOL})')
    t = {k: (float(np.mean([a for a, _ in v])), float(np.mean([b for _, b in v]))) for k, v in times.items()}
    print(f'[17] precision policy (NVIDIA card: {smi}), fp32 model: "perf" and "parity" each repeat their bits run '
          f'to run (the B=1 graph step\'s loss and parameters, a {B}-tile chunk); "perf" differs from "parity" (TF32 '
          f'engaged): chunk max|diff| {e_chunk:.3g} (bound {TF32_ATOL}), step loss relative {e_loss:.3g} (bound '
          f'{TF32_LOSS_RTOL}); the graph step {t["perf"][0]:.4f} ms under "perf" against {t["parity"][0]:.4f} ms '
          f'under "parity", a chunk\'s device time {t["perf"][1]:.3f} against {t["parity"][1]:.3f} ms (in turns '
          f'parity, perf, perf, parity)', flush=True)
    print(f"[17] phase 17 took {time.time() - t_phase:.1f} s", flush=True)
    return chunk_launches, step_launches


PROFILE_DIR = os.path.join(REPO, "out", "profile")  # --profile's trace (out/ is not committed)
HOST_TILES = 512  # phase 18's predict() request (phase 12's model): 4 chunks
RLE_MASKS = 18000  # the TGS test set's tile count: phase 18's encoder comparison
PROFILE_STEPS = 2  # phase 18: B=1 eager steps under profile_to


def dihedral_masks(n: int, seed: int) -> np.ndarray:
    """(n, 101, 101) uint8 salt-like masks: synthetic tiles' masks in their 8 dihedral views."""
    from plastic_unet_tpu_torch.data.synthetic import synthetic_tiles

    base = (synthetic_tiles(-(-n // 8), size=101, seed=seed)[1][:, 0] > 0).astype(np.uint8)
    views = [np.rot90(base, k, axes=(1, 2)) for k in range(4)]
    views += [v[:, :, ::-1] for v in views]
    return np.ascontiguousarray(np.concatenate(views)[:n])


def phase_host_tools(dev, smi):
    """Phase 18: the port's host tools. The native host library's status (built, loaded, or the compiler's
    or loader's reason); the host seconds of ops.rle.encode over RLE_MASKS masks; where it loaded: predict()
    on HOST_TILES tiles writes the same submission.csv bytes with the native and the numpy encoder, the native
    RLE of the masks equals ops.rle.encode string for string (and its host seconds), the native PNG loader equals data.images.load_image within 1e-6, the
    native IoU sweep equals ops.iou.iou_metric_batch within 1e-6. profile_to around PROFILE_STEPS B=1 eager
    steps in trace("step") ranges writes a trace holding the ranges and B1's kernel. predict(visualize=True)
    raises ImportError naming matplotlib where matplotlib is absent. Returns the launch counts of the
    predict() request."""
    from importlib.util import find_spec

    from plastic_unet_tpu_torch.data.images import load_image
    from plastic_unet_tpu_torch.data.synthetic import synthetic_split, synthetic_tiles
    from plastic_unet_tpu_torch.eval.evaluate import predict_masks
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.ops import native, rle
    from plastic_unet_tpu_torch.ops.iou import iou_metric_batch
    from plastic_unet_tpu_torch.submit import inference
    from plastic_unet_tpu_torch.submit.server import MaskPredictor
    from plastic_unet_tpu_torch.train.loop import create_train_state, make_train_step
    from plastic_unet_tpu_torch.utils.profiling import profile_to, trace

    t_phase = time.time()
    status = native.native_status()
    loaded = native.load() is not None
    print(f"[18] native host library (native/plasticnet_native.cc, g++ {' '.join(native.CXX_FLAGS)} "
          f"{' '.join(native.LDLIBS)}): {status}", flush=True)
    if not loaded:
        import ctypes.util

        print(f"[18] libpng's runtime library on this host: {ctypes.util.find_library('png')}", flush=True)

    imgs, _ = synthetic_tiles(HOST_TILES, size=101, seed=78)
    tiles = np.ascontiguousarray(imgs[:, 0, :, :, None])  # NHWC, phase 12's request
    model = seeded_model(SERVE_NEURONS, "oja", 0).to(dev).eval()
    probs = predict_masks(model, tiles[:B], device=dev)
    thr = float(probs.median())  # about half the pixels set: long RLE strings
    ids = [f"h{i:04d}" for i in range(HOST_TILES)]
    rp = {"img_height": 101, "img_width": 101, "img_chan": 1, "mask_threshold": thr, "subm_file": "submission.csv"}
    with tempfile.TemporaryDirectory() as tmp:
        subs = {}
        torch.cuda.synchronize()
        reset_counts()
        subs["native" if loaded else "numpy"] = inference.predict(
            model, ids, tiles, dict(rp, out_dir=tmp), device=dev)
        torch.cuda.synchronize()
        counts = expect_launches(f"MAIN PATH (predict, {HOST_TILES} tiles -> submission.csv, "
                                 f"{'native' if loaded else 'numpy'} RLE)",
                                 scaled(chunk_counts(), HOST_TILES // B), phase=18)
        if loaded:
            real = inference.encode_batch
            inference.encode_batch = lambda masks: [rle.encode(m) for m in masks]
            try:
                os.makedirs(os.path.join(tmp, "numpy"))
                subs["numpy"] = inference.predict(model, ids, tiles, dict(rp, out_dir=os.path.join(tmp, "numpy")),
                                                  device=dev)
            finally:
                inference.encode_batch = real
            body = {k: open(v, "rb").read() for k, v in subs.items()}
            check(body["native"] == body["numpy"], "submission.csv: the native encoder's bytes differ from numpy's")
        lines = open(subs["numpy"], "rb").read().splitlines()
        rles = [ln.split(b",", 1)[1] for ln in lines[1:]]
        check(len(lines) == HOST_TILES + 1 and len(set(rles)) > HOST_TILES // 2,
              "submission.csv: bad row count, or fewer than half the masks distinct")
        print(f"[18] predict() on {HOST_TILES} tiles at threshold {thr:.6f}: submission.csv "
              f"{sum(len(ln) + 1 for ln in lines)} bytes, "
              + ("native == numpy encoder, byte for byte" if loaded else "numpy encoder (no native library)"),
              flush=True)

        masks = dihedral_masks(RLE_MASKS, seed=18)
        t0 = time.perf_counter()
        want = [rle.encode(m) for m in masks]
        t_numpy = time.perf_counter() - t0
        what = (f"RLE of {RLE_MASKS} 101x101 masks (salt-like, {int(masks.sum())} pixels set); host CPU time, not "
                f"device time ({os.cpu_count()} cores): numpy {t_numpy:.4f} s")
        if not loaded:
            print(f"[18] {what}; card: {smi}", flush=True)
        else:
            t0 = time.perf_counter()
            got = native.rle_encode_batch_native(masks)
            t_native = time.perf_counter() - t0
            check(got == want, f"native RLE of {RLE_MASKS} masks != ops.rle.encode "
                  f"({sum(a != b for a, b in zip(got, want))} strings differ)")
            print(f"[18] {what}, native {t_native:.4f} s ({t_numpy / t_native:.1f}x), native == numpy string for "
                  f"string; card: {smi}", flush=True)

            data = write_tgs_dir(os.path.join(tmp, "tgs"))
            paths = sorted(os.path.join(data, sub, f) for sub in ("train/images", "train/masks", "test/images")
                           for f in os.listdir(os.path.join(data, sub)))
            from PIL import Image

            rgb = os.path.join(tmp, "rgb.png")
            Image.fromarray((np.random.default_rng(18).random((101, 101, 3)) * 255).astype(np.uint8)).save(rgb)
            paths.append(rgb)
            worst = 0.0
            for h, w in ((101, 101), (128, 128)):
                got = native.load_png_gray_batch_native(paths, h, w)
                worst = max(worst, max(float(np.abs(g - load_image(p, (h, w))).max()) for g, p in zip(got, paths)))
            check(worst <= 1e-6, f"native PNG loader vs load_image max|diff| {worst:.3g} > 1e-6")
            print(f"[18] native PNG loader == load_image on {len(paths)} tiles (8-bit, 16-bit masks, RGB) at "
                  f"101x101 and resized to 128x128: max|diff| {worst:.3g} (<= 1e-6)", flush=True)

            _, xv, _, yv = synthetic_split(0, 64, size=101, seed=77, hard=True)
            full = MaskPredictor(seeded_model(16, "oja", 0), threshold=0.5)
            preds = full.predict_probs(xv[:, 0]).cpu().numpy()
            thresholds = np.linspace(0.05, 0.95, 31).astype(np.float32)
            got = native.iou_threshold_sweep_native(yv, preds, thresholds)
            want = np.array([iou_metric_batch(yv, preds > t) for t in thresholds])
            e = float(np.abs(got - want).max())
            check(e <= 1e-6, f"native IoU sweep vs ops.iou max|diff| {e:.3g} > 1e-6")
            print(f"[18] native IoU sweep == ops.iou.iou_metric_batch on the neurons=16 predictor's 64 "
                  f"validation predictions, 31 thresholds: max|diff| {e:.3g} (<= 1e-6)", flush=True)

        X, Y = train_stream(PROFILE_STEPS + 1, 1, seed=23)
        X, Y = X.to(dev), Y.to(dev)
        net = UNetPRes(neurons=16, nbf=101, rule="oja", dropout_ratio=0.0, generator=torch.Generator().manual_seed(3))
        state = create_train_state(net, TRAIN_LR, TRAIN_GAMMA, 1e6, device=dev)
        step = make_train_step()
        step(state, (X[0], Y[0]))
        torch.cuda.synchronize()
        log_dir = os.path.join(tmp, "profile")
        with profile_to(log_dir):
            for i in range(1, PROFILE_STEPS + 1):
                with trace("step", i=i):
                    step(state, (X[i], Y[i]))
        files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
        check(len(files) == 1, f"profile_to wrote {files}")
        with open(os.path.join(log_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        ranges = [e for e in events if e.get("name") == "step" and e.get("cat") == "user_annotation"]
        heads = [e for e in events if e.get("cat") == "kernel" and "plastic_head" in e.get("name", "")]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        check(len(ranges) == PROFILE_STEPS, f"profile_to's trace holds {len(ranges)} 'step' ranges")
        check(len(heads) >= PROFILE_STEPS, f"profile_to's trace holds {len(heads)} B1 kernel events")
        with open(os.path.join(log_dir, files[0].replace(".pt.trace.json", ".spans.json"))) as f:
            spans = json.load(f)
        launched = [r for r in spans["records"] if r["name"].startswith("port.kernel.")]
        want = PROFILE_STEPS * sum(STEP_COUNTS[k] for k in ("plastic_head", "conv3x3", "conv3x3_dgrad", "conv3x3_wgrad"))
        check(len(launched) == want and spans["counters"].get("kernel.head.all") == PROFILE_STEPS,
              f"profile_to's spans hold {len(launched)} kernel launches (want {want}), counters {spans['counters']}")
        print(f"[18] profile_to over {PROFILE_STEPS} B=1 eager steps: {files[0]}, {len(events)} events, "
              f"{len(ranges)} 'step' ranges, {len(kernels)} device kernels of which {len(heads)} B1 "
              f"({(heads or [{'name': 'none'}])[0]['name'][:60]}); beside it {len(launched)} kernel spans", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        if find_spec("matplotlib") is None:
            try:
                inference.predict(model, ids[:4], tiles[:4], dict(rp, out_dir=tmp), visualize=True, device=dev)
            except ImportError as e:
                check("matplotlib" in str(e) and not os.listdir(tmp),
                      f"predict(visualize=True) raised {e!r}, not naming matplotlib, or wrote {os.listdir(tmp)}")
                print(f"[18] no matplotlib on this host: predict(visualize=True) raises {e!r}", flush=True)
            else:
                check(False, "predict(visualize=True) ran without matplotlib")
        else:
            inference.predict(model, ids[:4], tiles[:4], dict(rp, out_dir=tmp), visualize=True, device=dev)
            print("[18] matplotlib is installed: predict(visualize=True) drew 4 tiles", flush=True)
    print(f"[18] phase 18 took {time.time() - t_phase:.1f} s", flush=True)
    return counts


def time_bare_epoch(dev):
    """Seconds of one TIMED_TRAIN-step epoch of make_epoch_fn alone (the CUDA graph step, the loss copies,
    no permutation, augmentation or driver), at cli.train's model, rate and dropout under TIMED_ARGS."""
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.train.loop import create_train_state, make_epoch_fn

    X, Y = train_stream(TIMED_TRAIN, 1, seed=26)
    X, Y = X.to(dev), Y.to(dev)
    model = UNetPRes(neurons=16, nbf=101, rule="hebb", dropout_ratio=0.5, generator=torch.Generator().manual_seed(5))
    state = create_train_state(model, 3e-5, 0.666, 1e6, generator=torch.Generator(device=dev).manual_seed(6),
                               device=dev)
    epoch = make_epoch_fn()
    state, _ = epoch(state, X[:2], Y[:2])  # the capture
    torch.cuda.synchronize()
    t = time.perf_counter()
    state, losses = epoch(state, X, Y)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    check(bool(torch.isfinite(losses).all()), "bare epoch: non-finite losses")
    return seconds


def profile_training_step(dev, steps: int = 5, compute_dtype=None):
    """``--profile [bfloat16]``: the B=1 eager training step (in the compute dtype) under
    utils.profiling.profile_to, each step a trace("step") range; device time by kernel name. The trace
    (Chrome/TensorBoard JSON) is written under PROFILE_DIR."""
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.train.loop import create_train_state, make_train_step
    from plastic_unet_tpu_torch.utils.profiling import profile_to, trace

    X, Y = train_stream(steps, 1, seed=23)
    X, Y = X.to(dev), Y.to(dev)
    model = UNetPRes(neurons=16, nbf=101, rule="oja", dropout_ratio=0.0, compute_dtype=compute_dtype,
                     generator=torch.Generator().manual_seed(3))
    state = create_train_state(model, TRAIN_LR, TRAIN_GAMMA, 1e6, device=dev)
    step = make_train_step()
    step(state, (X[0], Y[0]))
    torch.cuda.synchronize()
    with profile_to(PROFILE_DIR) as prof:
        for i in range(steps):
            with trace("step", i=i):
                step(state, (X[i], Y[i]))
    print(f"[profile] trace written to {PROFILE_DIR}", flush=True)
    rows = [(e.key, e.device_time_total / steps, e.count / steps) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0
            and not e.is_user_annotation]  # an annotation's span (Optimizer.step) repeats its kernels' time
    check(bool(rows), "torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"[profile] B=1 eager training step, neurons=16, {compute_dtype or 'float32'}: {total / 1e3:.3f} ms of "
          f"kernels per step "
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
    if sys.argv[1:2] == ["--profile"]:
        profile_training_step(dev, compute_dtype=(sys.argv[2:] or [None])[0])
        return 0
    errs = phase_kernels(dev)
    phase_model(dev)
    main_counts, full = phase_serving(dev)
    kernels, fwd_table = phase_times(dev, name, full, main_counts, errs)
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    with matmul_precision("parity"):
        bwd_errs = phase_backward_kernels(dev)
    step_counts, lane_counts = phase_training(dev)
    for entry in kernels:  # the serving kernels are on the training path too
        entry["launches_train_step"] = step_counts[entry.get("counter", entry["name"])]
    more, graph_step_s = phase_training_times(dev, name, bwd_errs, step_counts, lane_counts, fwd_table)
    kernels += more
    driver_counts = phase_driver(dev, smi, graph_step_s)
    for entry in kernels:  # launches of the driver's first run (phase 11)
        entry["launches_driver"] = driver_counts[entry.get("counter", entry["name"])]
    serving_counts = phase_serving_features(dev, smi)
    for entry in kernels:  # launches of phase 12's paths
        for path in ("tta8_batched", "calib", "int8"):
            entry[f"launches_{path}"] = serving_counts[path][entry.get("counter", entry["name"])]
    export_counts = phase_export(dev, smi, fwd_table["serving_tiles_s"])
    for entry in kernels:  # launches of phase 13's identity artifact
        entry["launches_export"] = export_counts[entry.get("counter", entry["name"])]
    option_keys, option_counts = phase_model_options(dev, smi, name, fwd_table["serving_tiles_s"])
    for entry in kernels:  # phase 14: the padded track's times, and the launches of each option's path
        entry.update(option_keys.get(entry["name"], {}))
        for path, counts in option_counts.items():
            entry[f"launches_{path}"] = counts[entry.get("counter", entry["name"])]
    family_keys, family_counts = phase_other_families(dev, smi, name)
    for entry in kernels:  # phase 15: the head at n=128, and the launches of the classic chunk and step
        entry.update(family_keys.get(entry["name"], {}))
        for path, counts in family_counts.items():
            entry[f"launches_{path}"] = counts[entry.get("counter", entry["name"])]
    dp_counts = phase_data_parallel(dev, smi, name)
    for entry in kernels:  # phase 16: the launches of one eager data-parallel step at lanes=B
        entry["launches_dp_step"] = dp_counts[entry.get("counter", entry["name"])]
    bf16_chunk, bf16_step = phase_bf16(dev, smi)
    for entry in kernels:  # phase 17: the launches of one bf16 serving chunk and of one bf16 B=1 step
        entry["launches_bf16_chunk"] = bf16_chunk[entry.get("counter", entry["name"])]
        entry["launches_bf16_step"] = bf16_step[entry.get("counter", entry["name"])]
    host_counts = phase_host_tools(dev, smi)
    for entry in kernels:  # phase 18: the launches of predict() on HOST_TILES tiles
        entry["launches_host_tools"] = host_counts[entry.get("counter", entry["name"])]
    listed = sorted(e["name"] for e in kernels)
    check(listed == sorted(KERNELS) and all(set(KERNEL_KEYS) <= set(e) for e in kernels),
          f"the kernels line lists {listed}, want every kernel {sorted(KERNELS)} with {KERNEL_KEYS}")
    print(f"[done] {time.time() - t0:.1f}s; card: {smi}", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
