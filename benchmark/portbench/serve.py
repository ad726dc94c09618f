"""Traffic kind ``serve``: a closed loop of one client scoring numpy tiles
through the port's ``submit/server.py::MaskPredictor``.

Set-up makes a pool of ``pool_tiles`` seeded tiles on the device and brings
it to the host (the client holds numpy), builds the predictor on the
seed's weights, and warms it with ``warm_requests`` requests of the
timed size. Each request is ``predict`` on ``request_tiles`` contiguous
tiles of the pool from an offset drawn from the seed: numpy in, numpy
masks out, its latency on the host clock. The window sends the next
request when the last returns, until ``--seconds`` have passed. With
``--trace 1`` the window is ``trace_requests`` requests under the
profiler, with ``bench.chunk`` around each model call and the tail ranges.

A reservoir of ``check_requests`` finished requests, drawn from the seed,
keeps their answers; after the window the program is freed and the plain
reference scores the same tiles.
"""

from __future__ import annotations

import math
import time
import traceback

import numpy as np
import torch

from portbench import check, tracing
from portbench.tiles import make_generator, synthetic_tiles
from portbench.tracing import free_cache, note, peak_bytes, sync
from portbench.weights import arch_file, build_port_model, build_reference, make_state_dict

DATA_STREAM, OFFSET_STREAM, SAMPLE_STREAM = 0, 3, 4


def make_pool(cell, seed: int, device) -> np.ndarray:
    x, _ = synthetic_tiles(cell.workload["pool_tiles"], cell.config["image_size"],
                           make_generator(seed, DATA_STREAM, device), device)
    return x.cpu().numpy()


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from a seeded generator."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = np.random.default_rng([int(seed) % (2 ** 63), SAMPLE_STREAM])

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def reference_masks(cell, sd: dict, tiles: list, device, tf32: bool = False, chunk: int = 128) -> list:
    """The plain reference's masks (eval, each chunk from the arch's initial
    state: a plastic model's zero trace) of each (N, H, W) array, on the host."""
    from reference.common import numerics

    out = []
    with numerics(tf32), torch.no_grad():
        ref = build_reference(cell.config, sd, device).eval()
        initial_state = arch_file(cell.config["arch"]).initial_state
        for arr in tiles:
            x = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
            parts = []
            for lo in range(0, x.shape[0], chunk):
                xb = x[lo:lo + chunk, None]
                parts.append(ref(xb, initial_state(ref, xb.shape[0], device))[1])
            out.append(torch.cat(parts).cpu().numpy())
    return out


def setup(cell, seed: int, device, t_start: float | None = None):
    from plastic_unet_tpu_torch.submit.server import MaskPredictor

    wl = cell.workload
    pool = make_pool(cell, seed, device)
    if t_start is not None:
        note(t_start, "tile pool made")
    sd = make_state_dict(cell.config, seed, device)
    if t_start is not None:
        sync(device)
        note(t_start, "weights made")
    model = build_port_model(cell.config, sd, device)
    predictor = MaskPredictor(model, chunk=wl["chunk"], device=device)
    if t_start is not None:
        sync(device)
        note(t_start, "weights and predictor made")
    r = wl["request_tiles"]
    for i in range(wl["warm_requests"]):
        predictor.predict(pool[i * r % (len(pool) - r + 1):][:r])
    return pool, sd, predictor


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from plastic_unet_tpu_torch.utils.precision import matmul_precision

    wl = cell.workload
    r, chunk, size = wl["request_tiles"], wl["chunk"], cell.config["image_size"]
    out = {"counters": {"chunk": chunk, "request_tiles": r}}
    offsets = np.random.default_rng([int(seed) % (2 ** 63), OFFSET_STREAM])
    kept = Reservoir(wl["check_requests"], seed)
    latencies, failed = [], 0
    with matmul_precision(cell.config["precision"]):
        pool, sd, predictor = setup(cell, seed, device, t_start)
        sync(device)
        note(t_start, "warm requests answered: set-up ends")
        out["setup_s"] = time.perf_counter() - t_start

        def request() -> None:
            nonlocal failed
            off = int(offsets.integers(0, len(pool) - r + 1))
            t = time.perf_counter()
            try:
                masks = predictor.predict(pool[off:off + r])
            except Exception:  # a request that fails counts as failed, and the window goes on
                latencies.append(time.perf_counter() - t)
                failed += 1
                if failed == 1:
                    traceback.print_exc()
                return
            latencies.append(time.perf_counter() - t)
            if masks.shape != (r, size, size):  # the values are judged on the sample after the window
                failed += 1
            kept.offer((off, masks))

        if not trace:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                request()
            wall = time.perf_counter() - t0
        else:
            model = predictor.model
            with tracing.chunk_ranges(model), tracing.tail_ranges(model, backward=False), \
                    tracing.profiled() as held:
                t0 = time.perf_counter()
                for _ in range(wl["trace_requests"]):
                    request()
                wall = time.perf_counter() - t0
            out["trace"] = held.trace
        n = len(latencies)
        lat = np.asarray(latencies) * 1e3
        thirds = [f"{len(p) * r / (p.sum() / 1e3):.1f}" for p in np.array_split(lat, 3) if len(p)]
        note(t_start, f"window: {n} requests, latency ms p50 {np.percentile(lat, 50):.2f} p95 "
                      f"{np.percentile(lat, 95):.2f} max {lat.max():.2f}; tiles/s by thirds {' '.join(thirds)}")
        out["counters"].update(requests=n, tiles=n * r, chunks=n * math.ceil(r / chunk), window_s=wall)
        out["tiles_per_s"] = n * r / wall
        out["p95_ms"] = float(np.percentile(np.asarray(latencies) * 1e3, 95))
        out["memory_peak_bytes"] = peak_bytes(device)
    out["attempted"], out["failed"] = n, failed
    note(t_start, "window closed")
    del predictor
    free_cache(device)
    served = [m for _, m in kept.items]
    ref = reference_masks(cell, sd, [pool[off:off + r] for off, _ in kept.items], device)
    out["numbers"] = {"mask_gap": check.mask_gap(served, ref) if served else math.inf}
    note(t_start, "reference compared")
    return out
