"""The port's one recorder of spans and counters (counterpart of
plastic_unet_tpu.utils.profiling's ``trace`` and ``profile_to``).

  * :func:`trace` ``(name, **attrs)``: a span. With no torch profiler
    running and no CUDA graph being captured it reads the profiler's flag
    and returns a shared no-op context: no ``record_function``, no record,
    no clock read.
    While a profiler runs it opens a ``record_function(name)`` range, so the
    span sits in the profiler's timeline, and keeps a record: id, parent
    id, request id (shared by the spans of one serving request, opened by a
    ``port.serve.request`` span), name, thread, start and end in the
    profiler's own clock (Unix-epoch ns, ``time.time_ns``) and ``attrs``.
  * :func:`count` ``(name, n=1)``: integer counters, counted always
    (``kernel.<family>.<route>`` for the port's kernel launches).
  * :func:`capture`: what the body of a CUDA graph records while it is
    captured (spans, always; counter increments, held back). Python does
    not run when a graph replays, so ``train.loop.GraphTrainStep`` calls
    :meth:`Capture.replayed` at each replay: the held increments are added
    then, so the counters count what ran, and a replayed step's span names
    its capture by id (``graph=``).
  * :func:`records`, :func:`counters`, :func:`captures`, :func:`dropped`,
    :func:`reset`: the readout. Records are kept up to :data:`CAP`; beyond
    it they are counted as dropped.
  * :func:`profile_to`: a ``torch.profiler`` trace of the enclosed region,
    written into a directory as a Chrome/TensorBoard trace JSON
    (``<host>_<pid>.<ns>.pt.trace.json``: CPU activity always, CUDA kernels
    when a card is present), with the region's records and counters beside
    it (``<host>_<pid>.<ns>.spans.json``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import json
import os
import socket
import threading
import time

from torch.autograd import profiler as _autograd_profiler

CAP = 1 << 17  # records kept; later ones are counted in dropped()
REQUEST_SPAN = "port.serve.request"  # a span of this name opens a request: its id is its spans' request id

_clock = time.time_ns  # the profiler stamps its host events in Unix-epoch ns
_ids = itertools.count(1)
_parent: contextvars.ContextVar = contextvars.ContextVar("port_span", default=None)
_request: contextvars.ContextVar = contextvars.ContextVar("port_request", default=None)
_records: list = []  # (id, parent, request, name, thread, start, end, attrs)
_dropped = 0
_counters: dict = {}
_capturing: list = []  # the captures open now, innermost last
_captures: dict = {}  # id -> Capture, for every graph captured in this process


class _Off:
    """The shared no-op context of a span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "rf", "id", "parent", "request", "start", "tokens")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        self.id = next(_ids)
        self.parent = _parent.get()
        self.tokens = [_parent.set(self.id)]
        if self.name == REQUEST_SPAN:
            self.tokens.append(_request.set(self.id))
        self.request = _request.get()
        self.start = _clock()
        return self

    def __exit__(self, *exc):
        end = _clock()
        if len(self.tokens) > 1:
            _request.reset(self.tokens[1])
        _parent.reset(self.tokens[0])
        rec = (self.id, self.parent, self.request, self.name, threading.get_ident(), self.start, end, self.attrs)
        if _capturing:
            _capturing[-1].records.append(rec)
        if self.rf is not None:
            _keep(rec)
            self.rf.__exit__(None, None, None)
        return False


def _keep(rec) -> None:
    global _dropped
    if len(_records) < CAP:
        _records.append(rec)
    else:
        _dropped += 1


def trace(name: str, **attrs):
    """A span named ``name`` (``port.<layer>.<what>``) with ``attrs``; see
    the module docstring. Off-profile and outside a capture it reads the
    profiler's flag and the list of open captures, and returns a shared
    no-op context."""
    if not (_autograd_profiler._is_profiler_enabled or _capturing):
        return _OFF
    return _Span(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (inside a capture: to the capture's
    increments, added at each replay)."""
    c = _capturing[-1].counts if _capturing else _counters
    c[name] = c.get(name, 0) + n


class Capture:
    """What the body of one captured CUDA graph recorded: its spans (the
    kernel launches, with their shapes) and its counter increments."""

    def __init__(self):
        self.id = next(_ids)
        self.records: list = []
        self.counts: dict = {}

    def replayed(self) -> None:
        """One replay ran: add the held increments to the counters."""
        for name, n in self.counts.items():
            _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def capture():
    """Hold what the block records for a graph's replays; yields the :class:`Capture`."""
    cap = Capture()
    _captures[cap.id] = cap
    _capturing.append(cap)
    try:
        yield cap
    finally:
        _capturing.remove(cap)


def _as_dict(rec) -> dict:
    keys = ("id", "parent", "request", "name", "thread", "start_ns", "end_ns")
    return dict(zip(keys, rec[:7]), attrs=dict(rec[7]))


def records() -> list:
    """The kept records, in the order they ended, as dicts."""
    return [_as_dict(r) for r in list(_records)]


def captures() -> dict:
    """{capture id: the records its body made}, for every graph captured in this process."""
    return {i: [_as_dict(r) for r in cap.records] for i, cap in list(_captures.items())}


def counters() -> dict:
    return dict(_counters)


def dropped() -> int:
    """Records not kept because :data:`CAP` were."""
    return _dropped


def reset() -> None:
    """Forget the records, the dropped count and the counters (the captures stay: their graphs may replay)."""
    global _dropped
    _records.clear()
    _counters.clear()
    _dropped = 0


def _jsonable(v):
    if dataclasses.is_dataclass(v):
        return dataclasses.asdict(v)
    if hasattr(v, "_asdict"):
        return v._asdict()
    return str(v)


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Profile the enclosed region and write its trace into ``log_dir``,
    with the region's records and counters beside it. Yields the
    ``torch.profiler.profile`` (``key_averages()`` and the like after the
    block). With a card present, the card is synchronized before the
    profiler stops, so every kernel the region launched is in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    stems = []

    def write_trace(prof) -> None:
        stem = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}")
        prof.export_chrome_trace(stem + ".pt.trace.json")
        stems.append(stem)

    first, before, lost = next(_ids), counters(), dropped()
    with profile(activities=activities, on_trace_ready=write_trace) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    region = [r for r in records() if r["id"] > first]
    graphs = {r["attrs"].get("graph") for r in region} - {None}
    after = counters()
    spans = {"records": region, "dropped": dropped() - lost,
             "counters": {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)},
             "captures": {str(i): recs for i, recs in captures().items() if i in graphs}}
    for stem in stems:
        with open(stem + ".spans.json", "w") as f:
            json.dump(spans, f, default=_jsonable)
