"""The traced run's instruments: a torch.profiler session over a window,
the benchmark's own ranges (``record_function``) opened and closed by hooks
on the port's modules, and the reduction of the profiler's raw events to
what the metric readers read.

Ranges (all registered from here; the program carries none):

  * ``bench.chunk``: around each call of the model (forward pre/post hooks
    on the top module): one serving chunk's host issue.
  * ``bench.tail.fwd``: a residual tail's forward, from the return of its
    trunk's entry conv (that conv module's forward hook) to the return of
    the trunk module (DownRes, Middle): only the tail runs between them.
  * ``bench.tail.bwd``: a residual tail's backward, from the gradient of
    the trunk module's output (its full backward pre-hook) to the gradient
    of its entry conv's output (that conv's full backward pre-hook).

A device operation belongs to a range when the runtime call that launched
it (matched by correlation id) started inside the range on the same host
thread. Kernels replayed from a CUDA graph are launched by one graph
launch, so no range finer than the one around the replay sees them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
import warnings
from collections import defaultdict
from pathlib import Path

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_PREFIX = "bench."


def port_kernel_names(bench_dir: Path) -> list[str]:
    """The port's kernel symbols (``data/port_kernels.txt``, one a line, # comments)."""
    lines = (bench_dir / "data" / "port_kernels.txt").read_text().splitlines()
    return [s.split("#")[0].strip() for s in lines if s.split("#")[0].strip()]


def is_port_kernel(name: str, symbols: list[str]) -> bool:
    """A kernel's demangled name holds one of the port's symbols as a whole identifier."""
    for s in symbols:
        i = name.find(s)
        while i >= 0:
            before = name[i - 1] if i > 0 else " "
            after = name[i + len(s)] if i + len(s) < len(name) else " "
            if not (before.isalnum() or before == "_") and not (after.isalnum() or after == "_"):
                return True
            i = name.find(s, i + 1)
    return False


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # kernel, gpu_memcpy, gpu_memset
    start: int  # ns
    end: int
    ranges: tuple  # the bench.* ranges around its launch, outermost first


@dataclasses.dataclass
class Trace:
    """One profiled window, reduced."""

    window: tuple  # (start, end) ns of the window's own range
    ops: list  # DeviceOp inside the window
    ranges: list  # (name, start, end, thread) of bench.* ranges
    host: list  # (name, start, end) of host events on the window's thread, for the idle gaps

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> list:
        return [o for o in self.ops if o.kind == "kernel"]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of their intervals)."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def busy_intervals(self) -> list:
        spans = sorted((max(o.start, self.window[0]), min(o.end, self.window[1])) for o in self.ops)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def in_range(self, prefix: str) -> list:
        return [o for o in self.ops if any(r.startswith(prefix) for r in o.ranges)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps labelled by the innermost host event around the gap's start."""
        by_name = defaultdict(int)
        for o in self.ops:
            by_name[o.name] += o.end - o.start
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = defaultdict(int), self.window[0]
        host = sorted(self.host, key=lambda h: h[1])
        for a, b in self.busy_intervals() + [[self.window[1], self.window[1]]]:
            if a > prev:
                gaps[_label(host, prev)] += a - prev
            prev = max(prev, b)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops], "idle_gaps": [[n, t / 1e9] for n, t in idle]}


def _label(host: list, t: int) -> str:
    """The shortest host event that holds time ``t``, or "host: outside any op"."""
    best = None
    for name, a, b in host:
        if a > t:
            break
        if b >= t and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "host: outside any op"


def note(t_start: float, what: str) -> None:
    """One line of set-up progress on standard error: seconds since the process started."""
    print(f"benchmark: {time.perf_counter() - t_start:8.3f} s  {what}", file=sys.stderr, flush=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The process's peak of allocated device memory (0 off the card)."""
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def free_cache(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class DeviceClock:
    """Milliseconds on the device's clock between entering and leaving the
    block (CUDA events; the host clock off the card)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ms = None

    def __enter__(self):
        if self.cuda:
            self.a, self.b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            self.ms = self.a.elapsed_time(self.b)
        else:
            self.ms = (time.perf_counter() - self.t) * 1e3


@contextlib.contextmanager
def profiled(window_name: str = "bench.window"):
    """Profile the block, the card synchronised before the profiler stops.
    Yields a holder whose ``trace`` is set after the block."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    holder = type("Holder", (), {"trace": None})()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        with record_function(window_name):
            yield holder
            if cuda:
                torch.cuda.synchronize()
    holder.trace = reduce_events(prof.profiler.kineto_results.events(), window_name)


def _kind(e, launches: dict, host_names: set) -> str | None:
    """"kernel", "gpu_memcpy" or "gpu_memset" for an operation on the card,
    else None. Without ``activity_type`` (older torch), a card-side event
    is an operation when a runtime call (``cu*``) launched it and it is not
    the card-side copy of a host range (a GPU user annotation, which
    carries the host range's name)."""
    if hasattr(e, "activity_type"):
        kind = e.activity_type()
        return kind if kind in DEVICE_KINDS else None
    if e.device_type() != torch.autograd.DeviceType.CUDA or e.name() in host_names:
        return None
    if e.correlation_id() not in launches:
        return None
    name = e.name()
    return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"


def reduce_events(events, window_name: str) -> Trace:
    events = list(events)
    cpu = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    launches = {e.correlation_id(): (e.start_ns(), e.start_thread_id()) for e in cpu if e.name().startswith("cu")}
    host_names = {e.name() for e in cpu if not e.name().startswith("cu")}
    ranges, host_all, window = [], [], None
    for e in cpu:
        name, start = e.name(), e.start_ns()
        end, tid = start + e.duration_ns(), e.start_thread_id()
        if name == window_name:
            window = (start, end, tid)
        elif name.startswith(RANGE_PREFIX):
            ranges.append((name, start, end, tid))
        host_all.append((name, start, end, tid))
    if window is None:
        raise RuntimeError(f"the profile holds no {window_name!r} range")
    by_thread = defaultdict(list)
    for r in ranges:
        by_thread[r[3]].append(r)
    ops = []
    for e in events:
        kind = _kind(e, launches, host_names)
        if kind is None:
            continue
        start = e.start_ns()
        end = start + e.duration_ns()
        if end <= window[0] or start >= window[1]:
            continue
        launch = launches.get(e.correlation_id())
        around = ()
        if launch is not None:
            t, tid = launch[0], launch[1]
            around = tuple(r[0] for r in sorted(by_thread[tid], key=lambda r: r[1]) if r[1] <= t <= r[2])
        ops.append(DeviceOp(e.name(), kind, start, end, around))
    host = [(n, a, b) for n, a, b, tid in host_all if tid == window[2] and n != window_name]
    return Trace((window[0], window[1]), ops, ranges, host)


class _Span:
    """A record_function range opened in one hook and closed in another."""

    def __init__(self):
        self.open: dict = {}

    def enter(self, key, name: str) -> None:
        from torch.profiler import record_function

        rf = record_function(name)
        rf.__enter__()
        self.open.setdefault(key, []).append(rf)

    def exit(self, key) -> None:
        stack = self.open.get(key)
        if stack:
            stack.pop().__exit__(None, None, None)


def trunk_modules(model: torch.nn.Module) -> list:
    """(trunk module, its entry conv) for every residual trunk of the model:
    the modules whose first child list is [entry conv, block, block, ReLU]."""
    out = []
    for m in model.modules():
        seq = getattr(m, "dconv", None) if type(m).__name__ == "DownRes" else getattr(m, "mconv", None)
        if type(m).__name__ in ("DownRes", "Middle") and isinstance(seq, torch.nn.ModuleList):
            out.append((m, seq[0]))
    return out


@contextlib.contextmanager
def tail_ranges(model: torch.nn.Module, backward: bool):
    """``bench.tail.fwd`` (and with ``backward`` ``bench.tail.bwd``) around
    every residual tail of ``model`` while the block runs."""
    span, handles = _Span(), []
    warnings.filterwarnings("ignore", message="Full backward hook is firing")  # the image needs no gradient
    for trunk, entry in trunk_modules(model):
        key = id(trunk)
        handles.append(entry.register_forward_hook(lambda *a, k=key: span.enter(k, "bench.tail.fwd")))
        handles.append(trunk.register_forward_hook(lambda *a, k=key: span.exit(k)))
        if backward:
            bkey = ("bwd", key)
            handles.append(trunk.register_full_backward_pre_hook(
                lambda *a, k=bkey: span.enter(k, "bench.tail.bwd")))
            handles.append(entry.register_full_backward_pre_hook(lambda *a, k=bkey: span.exit(k)))
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        for key in list(span.open):
            while span.open[key]:
                span.exit(key)


@contextlib.contextmanager
def chunk_ranges(model: torch.nn.Module):
    """``bench.chunk`` around every call of ``model`` while the block runs."""
    span = _Span()
    handles = [model.register_forward_pre_hook(lambda *a: span.enter("chunk", "bench.chunk")),
               model.register_forward_hook(lambda *a: span.exit("chunk"))]
    try:
        yield
    finally:
        for h in handles:
            h.remove()
