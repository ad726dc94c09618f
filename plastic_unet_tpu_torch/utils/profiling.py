"""Timing and tracing (counterpart of plastic_unet_tpu.utils.profiling).

  * :class:`EpochTimer`: the reference's wall-clock budget bookkeeping
    (elapsed, predicted end of the next epoch, the stop decision).
  * :class:`StepTimer`: per-step host time for throughput reports.
  * :func:`trace`: a named range (``torch.profiler.record_function``) that
    shows in a profile; costs next to nothing when no profiler runs. A
    range recorded while a CUDA graph is captured does not show when the
    graph replays, so none sits inside ``train.loop.GraphTrainStep``.
  * :func:`profile_to`: a ``torch.profiler`` trace of the enclosed region,
    written into a directory as a Chrome/TensorBoard trace JSON
    (``<host>_<pid>.<ns>.pt.trace.json``): CPU activity always, CUDA
    kernels when a card is present.

torch.profiler is imported inside the functions.
"""

from __future__ import annotations

import contextlib
import time


class EpochTimer:
    """Wall-clock budget bookkeeping (reference train.py:85,118-122).

    The stop decision is predictive: training stops when the estimated end
    of the next epoch (the last epoch's duration + now) would pass the
    budget."""

    def __init__(self, max_train_time: float = -1):
        self.stop_time = time.time() + max_train_time if max_train_time > 0 else -1.0
        self.epoch_start = time.time()
        self.last_epoch_time = 0.0

    def start_epoch(self) -> None:
        self.epoch_start = time.time()

    def end_epoch(self) -> float:
        self.last_epoch_time = time.time() - self.epoch_start
        return self.last_epoch_time

    @property
    def next_epoch_finish_time(self) -> float:
        return self.last_epoch_time + time.time()

    def should_stop(self) -> bool:
        return self.stop_time > 0 and self.next_epoch_finish_time >= self.stop_time


@contextlib.contextmanager
def trace(name: str, **kwargs):
    """A named range in the profile; ``kwargs`` go to ``record_function``
    as its ``args`` string of ``k=v`` pairs."""
    from torch.profiler import record_function

    args = ",".join(f"{k}={v}" for k, v in kwargs.items()) or None
    with record_function(name, args):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Profile the enclosed region and write its trace into ``log_dir``.
    Yields the ``torch.profiler.profile`` (``key_averages()`` and the like
    after the block). With a card present, the card is synchronized before
    the profiler stops, so every kernel the region launched is in the
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()


class StepTimer:
    """Per-step host-side timing accumulator for throughput reporting."""

    def __init__(self):
        self.times: list[float] = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self.times.append(time.time() - self._t0)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    def images_per_sec(self, images_per_step: int) -> float:
        return images_per_step / self.mean if self.mean else 0.0
