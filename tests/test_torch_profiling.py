"""The port's recorder (plastic_unet_tpu_torch.utils.profiling): spans that
cost a flag read off-profile, records that nest and share a serving
request's id, stamped on the profiler's clock; counters; the capture and
replay bookkeeping of a CUDA graph's launches (driven without a card); and
profile_to writing a Chrome trace with the region's records beside it."""

import glob
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import profile

from plastic_unet_tpu_torch.utils import profiling as tprof

NBF = 21  # UNetPRes at neurons=2 on 21-px tiles: a request of 300 tiles is under a second here


def entry(forwards: int) -> dict:
    """The entry convs' route counters of ``forwards`` forwards of UNetPRes at
    neurons=2: Cin 16, 32 and 16 on the kernel, the other six on cuDNN."""
    return {"kernel.entry.kernel": 3 * forwards, "kernel.entry.library": 6 * forwards}


@pytest.fixture(autouse=True)
def fresh():
    tprof.reset()
    yield
    tprof.reset()


def _predictor(**kw):
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.submit.server import MaskPredictor

    model = UNetPRes(neurons=2, nbf=NBF, generator=torch.Generator().manual_seed(0))
    return MaskPredictor(model, chunk=128, device="cpu", **kw)


def _tiles(n):
    return np.random.default_rng(n).random((n, NBF, NBF), dtype=np.float32)


def test_trace_off_profile_is_a_flag_read(monkeypatch):
    """No profiler and no capture: trace enters no record_function, reads no
    clock and keeps no record, and returns the one shared no-op context;
    the counters count all the same."""
    def refuse(*a, **k):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(tprof, "_clock", refuse)
    assert tprof.trace("port.a", b=1) is tprof.trace("port.b") is tprof._OFF
    with tprof.trace("port.a", b=1) as s:
        assert s is None
    x = _tiles(20)
    out = _predictor().predict(x)
    assert tprof.records() == [] and tprof.dropped() == 0
    assert tprof.counters() == {"serve.bytes_in": x.nbytes, "serve.bytes_out": out.nbytes} | entry(1)


@pytest.mark.parametrize("threshold", [None, 0.5])
def test_request_spans_nest_and_share_the_request_id(threshold):
    """One predict of 300 tiles at chunk 128 under the profiler: request ->
    stage_in -> chunk x3 -> to_host, children of the request and with its
    id; the chunks' rows and padded rows; the bytes equal the arrays'."""
    pred, x = _predictor(threshold=threshold), _tiles(300)
    with profile():
        out = pred.predict(x)
    recs = sorted(tprof.records(), key=lambda r: r["start_ns"])
    assert [r["name"] for r in recs] == ["port.serve.request", "port.serve.stage_in"] + ["port.serve.chunk"] * 3 + [
        "port.serve.to_host"]
    req = recs[0]
    assert req["parent"] is None and req["request"] == req["id"] and req["attrs"] == {"tiles": 300, "views": 1}
    assert all(r["parent"] == req["id"] and r["request"] == req["id"] for r in recs[1:])
    assert [(r["attrs"]["rows"], r["attrs"]["padded"]) for r in recs[2:5]] == [(128, 0), (128, 0), (44, 84)]
    assert all(req["start_ns"] <= r["start_ns"] <= r["end_ns"] <= req["end_ns"] for r in recs[1:])
    assert recs[1]["attrs"]["bytes"] == x.nbytes and recs[-1]["attrs"]["bytes"] == out.nbytes
    assert out.dtype == (np.float32 if threshold is None else bool)
    assert tprof.counters() == {"serve.bytes_in": x.nbytes, "serve.bytes_out": 300 * NBF * NBF * (
        4 if threshold is None else 1)} | entry(3)


def test_records_are_on_the_profilers_clock():
    """Each record starts within 50 us of its own record_function event."""
    with profile() as prof:
        with tprof.trace("port.warm"):  # the first range of a session costs more
            pass
        for i in range(12):
            with tprof.trace(f"port.t{i}", i=i):
                with tprof.trace(f"port.t{i}.inner"):
                    torch.ones(8).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    recs = [r for r in tprof.records() if r["name"] != "port.warm"]
    assert len(recs) == 24
    for r in recs:
        e = events[r["name"]]
        assert abs(r["start_ns"] - e.start_ns()) < 50_000, (r["name"], r["start_ns"] - e.start_ns())
        assert r["end_ns"] <= e.start_ns() + e.duration_ns() + 50_000
    inner = {r["name"]: r for r in recs}
    assert all(inner[f"port.t{i}.inner"]["parent"] == inner[f"port.t{i}"]["id"] for i in range(12))


def test_spans_of_another_thread_have_their_own_parents():
    seen = {}

    def other():
        with tprof.trace("port.thread.outer"):
            with tprof.trace("port.thread.inner"):
                seen["tid"] = threading.get_ident()

    with profile():
        with tprof.trace("port.main"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
    recs = {r["name"]: r for r in tprof.records()}
    assert recs["port.thread.outer"]["parent"] is None
    assert recs["port.thread.inner"]["parent"] == recs["port.thread.outer"]["id"]
    assert recs["port.thread.inner"]["thread"] == seen["tid"] != recs["port.main"]["thread"]


def test_capture_holds_spans_and_counts_for_the_replays():
    """Inside capture(), with no profiler: spans are kept by the capture
    (not as records), counter increments are held back and added at each
    replay; a profiled step names the capture, whose records captures() gives."""
    tprof.count("kernel.x.y", 2)
    with tprof.capture() as cap:
        for _ in range(3):
            with tprof.trace("port.kernel.conv3x3", b=1, h=4, w=4, cin=16, cout=16, kernels=1):
                tprof.count("kernel.conv3x3.fwd")
        tprof.count("collective.all_reduce")
    assert tprof.counters() == {"kernel.x.y": 2} and tprof.records() == []
    assert cap.counts == {"kernel.conv3x3.fwd": 3, "collective.all_reduce": 1}
    with profile():
        for step in range(4):
            with tprof.trace("port.train.step", lanes=1, step=step, graph=cap.id):
                cap.replayed()
    assert tprof.counters() == {"kernel.x.y": 2, "kernel.conv3x3.fwd": 12, "collective.all_reduce": 4}
    steps = tprof.records()
    assert [r["attrs"]["graph"] for r in steps] == [cap.id] * 4
    launches = tprof.captures()[cap.id]
    assert [r["name"] for r in launches] == ["port.kernel.conv3x3"] * 3
    assert launches[0]["attrs"] == {"b": 1, "h": 4, "w": 4, "cin": 16, "cout": 16, "kernels": 1}
    assert not tprof._capturing


def test_graph_train_step_replays_count_what_ran(monkeypatch):
    """make_epoch_fn through GraphTrainStep's replay (its own __call__) with
    the capture made as GraphTrainStep makes it and a graph whose replay runs
    the step's body eagerly: 2 warm-up steps count, the capture holds its
    launches back, each replay adds them, and each step names the capture."""
    from types import SimpleNamespace

    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.train import loop

    class FakeGraph(loop.GraphTrainStep):
        def __init__(self, state, batch_shape, mask_shape, **kw):
            self.state, self.hebb = state, state.hebb
            self.img, self.mask = torch.zeros(batch_shape), torch.zeros(mask_shape)
            for _ in range(2):  # the warm-up steps' launches
                tprof.count("kernel.head.all")
            with tprof.capture() as self.capture:  # the captured body's launch
                tprof.count("kernel.head.all")
                with tprof.trace("port.kernel.head", b=1, n=NBF, kernels=1):
                    pass
            body = lambda: setattr(self, "loss", loop._step_body(state, loop._loss_fn("logits"), self.img, self.mask))
            self.graph = SimpleNamespace(replay=body)

    monkeypatch.setattr(loop, "GraphTrainStep", FakeGraph)
    model = UNetPRes(neurons=2, nbf=NBF, dropout_ratio=0.0, generator=torch.Generator().manual_seed(1))
    state = loop.create_train_state(model, 1e-3, device="cpu")
    X, Y = torch.rand(3, 1, NBF, NBF, 1), (torch.rand(3, 1, NBF, NBF) > 0.5).float()
    with profile():
        state, losses = loop.make_epoch_fn(graph=True)(state, X, Y)
    assert tprof.counters() == {"kernel.head.all": 2 + 3} | entry(3)  # the fake replays run the body eagerly
    recs = tprof.records()
    epoch = next(r for r in recs if r["name"] == "port.train.epoch")
    steps = [r for r in recs if r["name"] == "port.train.step"]
    cap_id = epoch["attrs"]["graph"]
    assert epoch["attrs"] == {"lanes": 1, "steps": 3, "graph": cap_id} and cap_id in tprof.captures()
    assert [(r["attrs"]["step"], r["attrs"]["graph"], r["parent"]) for r in steps] == [
        (s, cap_id, epoch["id"]) for s in range(3)]
    assert [r["name"] for r in tprof.captures()[cap_id]] == ["port.kernel.head"]


def test_eager_epoch_spans():
    from plastic_unet_tpu_torch.models.unet_res import UNetPRes
    from plastic_unet_tpu_torch.train import loop

    model = UNetPRes(neurons=2, nbf=NBF, dropout_ratio=0.0, generator=torch.Generator().manual_seed(2))
    state = loop.create_train_state(model, 1e-3, lanes=2, device="cpu")
    X, Y = torch.rand(2, 2, NBF, NBF, 1), (torch.rand(2, 2, NBF, NBF) > 0.5).float()
    with profile():
        loop.make_multi_epoch_fn()(state, X, Y, epochs=2)
    recs = tprof.records()
    epochs = [r for r in recs if r["name"] == "port.train.epoch"]
    steps = [r for r in recs if r["name"] == "port.train.step"]
    assert [r["attrs"] for r in epochs] == [{"lanes": 2, "steps": 2, "graph": None}] * 2
    assert [r["attrs"]["step"] for r in steps] == [0, 1, 2, 3]
    assert all(r["attrs"]["graph"] is None and r["attrs"]["lanes"] == 2 for r in steps)
    assert [r["parent"] for r in steps] == [epochs[0]["id"]] * 2 + [epochs[1]["id"]] * 2


def test_records_past_the_cap_are_counted_as_dropped(monkeypatch):
    monkeypatch.setattr(tprof, "CAP", 5)
    with profile():
        for i in range(8):
            with tprof.trace("port.x", i=i):
                pass
    assert [r["attrs"]["i"] for r in tprof.records()] == [0, 1, 2, 3, 4] and tprof.dropped() == 3
    tprof.reset()
    assert tprof.records() == [] and tprof.dropped() == 0 and tprof.counters() == {}


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


def test_profile_to_writes_the_regions_records_beside_the_trace(tmp_path):
    """<stem>.spans.json beside <stem>.pt.trace.json: the region's records
    (not those of an earlier profile), its counter increments, and the
    captures its steps name."""
    with profile():
        with tprof.trace("port.before"):
            pass
    tprof.count("serve.bytes_in", 7)
    with tprof.capture() as cap:
        with tprof.trace("port.kernel.head", b=2, n=NBF, kernels=1):
            tprof.count("kernel.head.all")
    x = _tiles(10)
    with tprof.profile_to(str(tmp_path)):
        out = _predictor().predict(x)
        with tprof.trace("port.train.step", graph=cap.id, lanes=2, step=0):
            cap.replayed()
    (trace_file,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(trace_file.replace(".pt.trace.json", ".spans.json")) as f:
        spans = json.load(f)
    names = [r["name"] for r in spans["records"]]
    assert "port.before" not in names and names.count("port.serve.chunk") == 1 and "port.train.step" in names
    assert spans["counters"] == {"serve.bytes_in": x.nbytes, "serve.bytes_out": out.nbytes, "kernel.head.all": 1} | entry(1)
    assert spans["dropped"] == 0
    assert [r["name"] for r in spans["captures"][str(cap.id)]] == ["port.kernel.head"]
