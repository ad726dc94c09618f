"""The port's timing and tracing (plastic_unet_tpu_torch.utils.profiling):
EpochTimer and StepTimer against the JAX package's under the same patched
clock, and profile_to / trace writing a Chrome trace that holds the range."""

import glob
import json
import time

import pytest
import torch

from plastic_unet_tpu.utils import profiling as jprof
from plastic_unet_tpu_torch.utils import profiling as tprof


class _Clock:
    """time.time that returns the given readings in order."""

    def __init__(self, readings):
        self.readings = list(readings)

    def __call__(self):
        return self.readings.pop(0)


READINGS = [100.0, 100.0, 103.5, 110.0, 110.25, 111.0, 140.0, 141.0, 150.0, 152.0, 153.0, 154.0, 155.0, 160.0]


def _drive_epoch_timer(mod, max_train_time):
    timer = mod.EpochTimer(max_train_time)  # two readings: stop_time (when budgeted) and epoch_start
    out = [timer.stop_time, timer.epoch_start, timer.last_epoch_time]
    for _ in range(3):
        timer.start_epoch()
        out += [timer.end_epoch(), timer.next_epoch_finish_time, timer.should_stop()]
    return out


@pytest.mark.parametrize("max_train_time", [-1, 0, 45.0, 100.0])
def test_epoch_timer_matches_jax(monkeypatch, max_train_time):
    runs = []
    for mod in (tprof, jprof):
        monkeypatch.setattr(time, "time", _Clock(READINGS))
        runs.append(_drive_epoch_timer(mod, max_train_time))
    assert runs[0] == runs[1]
    assert runs[0][-1] is (max_train_time == 45.0)  # the budget ends at 145.0: the last epoch predicts 161.0


def test_step_timer_matches_jax(monkeypatch):
    runs = []
    for mod in (tprof, jprof):
        monkeypatch.setattr(time, "time", _Clock(READINGS))
        st = mod.StepTimer()
        empty = (st.mean, st.images_per_sec(8))
        for _ in range(4):
            with st as entered:
                assert entered is st
        runs.append((empty, st.times, st.mean, st.images_per_sec(8)))
    assert runs[0] == runs[1]
    assert runs[0][0] == (0.0, 0.0) and len(runs[0][1]) == 4


def test_profile_to_writes_a_trace_with_the_range(tmp_path):
    with tprof.trace("outside_any_profile", step=0):  # a no-op off-profile
        pass
    with tprof.profile_to(str(tmp_path)) as prof:
        with tprof.trace("x", step=3):
            torch.ones(64).cumsum(0)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("name") == "x"]
    assert ranges and ranges[0]["cat"] == "user_annotation" and ranges[0]["dur"] > 0
    assert not any(e.get("name") == "outside_any_profile" for e in events)
    assert any(e.key == "x" for e in prof.key_averages())
