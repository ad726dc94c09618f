"""What the per-layer metric files read (each ``metrics/<name>.py`` binds
one of these as its ``read``). A reader takes the run (``counters``, the
traced window's ``trace``, the eager ``attribution`` trace of a train
cell, the architecture's ``flops``, the card's ``peaks``, the port's
kernel symbols) and returns a number, or None where it finds nothing to
read; a share of a roofline or of a peak is never read as 0."""

from __future__ import annotations

from portbench.tracing import is_port_kernel


def step_ms(run):
    """Device-clock ms a training step: CUDA events around the traced
    window's steps (its calls, the per-epoch trace re-zero and the host's
    gaps between replays included) over the steps."""
    c = run.counters
    if not c.get("steps") or c.get("event_ms") is None:
        return None
    return c["event_ms"] / c["steps"]


def host_issue_ms(run):
    """Host ms to issue one chunk: the mean length of the ``bench.chunk``
    ranges (one around each model call)."""
    tr = run.trace
    spans = [(b - a) / 1e6 for name, a, b, _ in tr.ranges if name == "bench.chunk"] if tr else []
    return sum(spans) / len(spans) if spans else None


def _mfu(run, flops_each: float, count: str):
    c = run.counters
    if not c.get(count) or not c.get("window_s"):
        return None
    return 100.0 * flops_each * c[count] / c["window_s"] / run.peaks["fp32_flops"]


def train_mfu(run):
    """The counted FLOPs (forward and backward) of every sample the traced
    window trained, over its wall time, as a share of the card's float32
    peak outside the tensor cores."""
    return _mfu(run, run.flops.train_flops(run.config), "samples")


def serve_mfu(run):
    """The counted forward FLOPs of every tile the traced window served
    (padding not counted), over its wall time, as a share of the card's
    float32 peak outside the tensor cores."""
    return _mfu(run, run.flops.forward_flops(run.config), "tiles")


def _tails_roofline(run, tr, units: int, batch: int, train: bool):
    if tr is None or not units:
        return None
    busy_ns = sum(o.end - o.start for o in tr.in_range("bench.tail.") if o.kind == "kernel")
    work, nbytes = run.flops.tail_work(run.config, batch, train)
    if not busy_ns or not work:
        return None
    bound_s = max(work / run.peaks["fp32_flops"], nbytes / run.peaks["bytes_per_s"])
    return 100.0 * bound_s * units / (busy_ns / 1e9)


def train_tails_roofline(run):
    """The nine residual tails' training work (36 3x3 convs forward, input
    and weight gradients) at the roofline (operations over the float32 peak
    or bytes over the HBM rate, the larger), over the device time of the
    kernels launched inside the tail ranges. A CUDA graph's kernels carry no
    range, so this reads the eager steps of the same shapes taken after the
    window."""
    return _tails_roofline(run, run.attribution, run.counters.get("attribution_steps"), run.counters["lanes"], True)


def serve_tails_roofline(run):
    """The nine residual tails' forward work a chunk at the roofline, over
    the device time of the kernels launched inside the ``bench.tail.fwd``
    ranges of the traced window."""
    return _tails_roofline(run, run.trace, run.counters.get("chunks"), run.counters.get("chunk"), False)


def _library_ms(run, count: str):
    tr, n = run.trace, run.counters.get(count)
    if tr is None or not n:
        return None
    ns = sum(o.end - o.start for o in tr.kernels() if not is_port_kernel(o.name, run.port_kernels))
    return ns / 1e6 / n


def library_ms_per_step(run):
    """Device ms a step of the kernels whose names hold none of the port's
    symbols (data/port_kernels.txt): cuDNN, cuBLAS, ATen, Adam's included."""
    return _library_ms(run, "steps")


def library_ms_per_chunk(run):
    """Device ms a chunk of the kernels whose names hold none of the port's symbols."""
    return _library_ms(run, "chunks")


def device_idle_pct(run):
    """The share of the traced window in which no operation (kernel, copy,
    set) ran on the card: the union of their intervals."""
    tr = run.trace
    if tr is None or tr.window_s <= 0 or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
