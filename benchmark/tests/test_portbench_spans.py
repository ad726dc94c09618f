"""The readers of the program's records (portbench/spans.py) on a synthetic
run: kernels named by the port's symbols in a window, and the records the
program's recorder keeps (a replayed graph's launches expanded from its
capture); and the work a launch counts (flops/launches.py) against the
benchmark's tail formulas."""

from types import SimpleNamespace

import pytest
import torch
from torch.profiler import profile

from portbench import spans, spec
from portbench.tracing import DeviceOp, Trace, is_port_kernel, port_kernel_names

PEAKS = {"fp32_flops": 60e12, "bytes_per_s": 3.0e12}
CONV = dict(b=1, h=50, w=50, cin=32, cout=32, flip=False, bias=True, res=False, gate=False, in_gate=False, kernels=1)


@pytest.fixture
def prof():
    from plastic_unet_tpu_torch.utils import profiling

    profiling.reset()
    yield profiling
    profiling.reset()


def _window(recs, ops, pad=1000):
    a = min(r["start_ns"] for r in recs) - pad
    b = max(r["end_ns"] for r in recs) + pad
    return SimpleNamespace(trace=Trace((a, b), ops, [], []), peaks=PEAKS)


def _op(name, ns, kind="kernel"):
    return DeviceOp(name, kind, 0, ns, ())


def test_families_partition_the_port_kernels():
    fams = spans.families()
    symbols = [s for syms in fams.values() for s in syms]
    assert sorted(symbols) == sorted(port_kernel_names(spec.BENCH_DIR)) and len(set(symbols)) == len(symbols)
    assert set(fams) == set(spans.launch_work().WORK)


def test_roofline_reads_eager_and_replayed_launches(prof):
    """Two eager launches and two replays of a capture holding three: eight
    launches' bounds over the family's kernel time; a record outside the
    window and kernels of other families are not read."""
    with prof.capture() as cap:
        for _ in range(3):
            with prof.trace("port.kernel.conv3x3", **CONV):
                pass
    with profile():
        with prof.trace("port.kernel.conv3x3", **dict(CONV, cin=16)):
            pass
    with profile():
        for i in range(2):
            with prof.trace("port.kernel.conv3x3", **CONV):
                pass
        for step in range(2):
            with prof.trace("port.train.step", lanes=1, step=step, graph=cap.id):
                cap.replayed()
        with prof.trace("port.kernel.wgrad", b=1, h=50, w=50, cin=32, cout=32, kernels=1):
            pass
    recs = prof.records()[1:]  # the first profile's launch lies outside the window
    kernels = [_op("void (anonymous namespace)::conv3x3_split_kernel<32, 3>(SpArgs)", 5000)] * 8 + [
        _op("void (anonymous namespace)::wgrad_kernel<32, 32>(Params, int)", 7000),
        _op("void cudnn::engine_x(...)", 90000)]
    run = _window(recs, kernels)
    assert len(spans.launches(run, "conv3x3")) == 8 and len(spans.family_kernels(run, "conv3x3")) == 8
    ops, nbytes = spans.launch_work().work("conv3x3", CONV)
    bound = max(ops / PEAKS["fp32_flops"], nbytes / PEAKS["bytes_per_s"])
    assert spans.conv3x3_roofline(run) == pytest.approx(100 * 8 * bound / (8 * 5000e-9))
    ops, nbytes = spans.launch_work().work("wgrad", dict(b=1, h=50, w=50, cin=32, cout=32))
    assert spans.wgrad_roofline(run) == pytest.approx(100 * max(ops / 60e12, nbytes / 3e12) / 7000e-9)
    assert spans.tail_fwd_roofline(run) is None and spans.head_roofline(run) is None  # nothing launched


def test_readers_find_nothing_without_the_recorder(prof, monkeypatch):
    with profile():
        with prof.trace("port.kernel.head", b=4, n=101, kernels=1):
            pass
        with prof.trace("port.serve.stage_in", bytes=100):
            pass
    run = _window(prof.records(), [_op("plastic_head_staged<true>", 100), _op("Memcpy HtoD (Pageable -> Device)", 10,
                                                                              "gpu_memcpy")])
    assert spans.head_roofline(run) is not None and spans.copy_gb_per_s(run) is not None
    monkeypatch.delattr(prof, "records")  # a program whose recorder keeps no records
    assert spans.program_records() is None
    assert spans.head_roofline(run) is None and spans.copy_gb_per_s(run) is None
    assert spans.launches(SimpleNamespace(trace=None), "head") is None


def test_copy_rate_reads_the_staged_bytes_over_the_copies(prof):
    with profile():
        for _ in range(2):
            with prof.trace("port.serve.request", tiles=512, views=1):
                with prof.trace("port.serve.stage_in", bytes=20_000_000):
                    pass
                with prof.trace("port.serve.to_host", bytes=10_000_000):
                    pass
    ops = [_op("Memcpy HtoD (Pageable -> Device)", 2_000_000, "gpu_memcpy"),
           _op("Memcpy DtoH (Device -> Pageable)", 4_000_000, "gpu_memcpy"),
           _op("Memcpy DtoD (Device -> Device)", 9_000_000, "gpu_memcpy"),  # not a host copy
           _op("Memset (Device)", 9_000_000, "gpu_memset")]
    assert spans.copy_gb_per_s(_window(prof.records(), ops)) == pytest.approx(60e6 / 6e-3 / 1e9)
    assert spans.copy_gb_per_s(_window(prof.records(), ops[2:])) is None


def _route_launches(monkeypatch, b, train):
    """The launches the port's tail routes make for one batch of b at each of
    the configuration's nine tails, as the kernel spans record them: the tail
    forward (and with ``train`` the backward) run on meta tensors through
    ops.residual_tail's own routing, with the launch functions replaced by
    recorders of the attributes each span carries."""
    from plastic_unet_tpu_torch.ops import residual_tail as rt

    got = []

    def conv(x, k, bias=None, residual=None, **flags):
        got.append(("conv3x3", dict(b=x.shape[0], h=x.shape[1], w=x.shape[2], cin=x.shape[3], cout=k.shape[3],
                                    bias=bias is not None, res=residual is not None, gate=False, in_gate=False)))
        return torch.empty(x.shape[:3] + (k.shape[3],), device="meta")

    def dgrad(d, k, residual=None, *, gate=None, in_gate=None):
        got.append(("conv3x3", dict(b=d.shape[0], h=d.shape[1], w=d.shape[2], cin=d.shape[3], cout=k.shape[2],
                                    bias=False, res=residual is not None, gate=gate is not None,
                                    in_gate=in_gate is not None)))
        return torch.empty(d.shape[:3] + (k.shape[2],), device="meta"), None if in_gate is None else torch.empty_like(d)

    def wgrad(x, d, **kw):
        got.append(("wgrad", dict(b=x.shape[0], h=x.shape[1], w=x.shape[2], cin=x.shape[3], cout=d.shape[3])))
        return None, None

    def fused(x0, *args, keep=False):
        b, h, w, c = x0.shape
        got.append(("tail_fwd", dict(b=b, h=h, w=w, c=c, keep=keep)))
        return (torch.empty_like(x0),) + tuple(torch.empty_like(x0) if keep else None for _ in range(3))

    def fused_bwd(g, *args):
        b, h, w, c = g.shape
        got.append(("tail_bwd", dict(b=b, h=h, w=w, c=c)))
        return (torch.empty_like(g),) + (None,) * 8

    monkeypatch.setattr(rt, "conv3x3", conv)
    monkeypatch.setattr(rt, "conv3x3_dgrad", dgrad)
    monkeypatch.setattr(rt, "conv3x3_wgrad", wgrad)
    monkeypatch.setattr(rt, "residual_tail_fused", fused)
    monkeypatch.setattr(rt, "residual_tail_backward_fused", fused_bwd)
    cfg = spec.load_cell("unetpres-n16.serve-r512").config
    f = spec.load_file(spec.BENCH_DIR / "flops" / "unet_res.py", "test_spans_unet_res")
    extra = 0  # bytes the four (eight) launch routes move beyond the fused kernels' count: the intermediates
    for s, c in f.tails(cfg):
        ws = [torch.empty((c, c, 3, 3), device="meta") for _ in range(4)]
        bs = [torch.empty((c,), device="meta") for _ in range(4)]
        x0 = torch.empty((b, s, s, c), device="meta")
        n0 = len(got)
        out, kept, ks = rt._launch_forward(x0, ws[0], bs[0], ws[1], bs[1], ws[2], bs[2], ws[3], bs[3], keep=train)
        act = b * s * s * c * 4
        if got[n0][0] == "conv3x3":  # 10 activations read or written, where the fused kernel's count 5 (2 unkept)
            extra += (10 - (5 if train else 2)) * act
        if train:
            n1 = len(got)
            rt.residual_tail_backward(torch.empty_like(x0), *kept, out, *ks)
            if got[n1][0] == "conv3x3":  # 24 activations where the fused backward's are 7; no bias read by dgrad
                extra += 17 * act - 4 * c * 4
    return got, f.tail_work(cfg, b, train), extra


@pytest.mark.parametrize("b,train", [(128, False), (128, True), (1, True)])
def test_launch_work_sums_to_the_tail_work(monkeypatch, b, train):
    """The launches tail_plan (and tail_bwd_plan) route for a chunk of 128,
    a lanes=128 step and a B=1 step, summed by flops/launches.py: their
    operations equal unet_res.tail_work's; their bytes too where a tail is
    one fused launch, and more by the four (eight) launches' intermediates
    and their weights read again where it is not."""
    launches, (ops, nbytes), extra = _route_launches(monkeypatch, b, train)
    w = spans.launch_work()
    fams = {fam for fam, _ in launches}
    assert fams == ({"tail_fwd", "conv3x3"} | ({"tail_bwd", "wgrad"} if train else set()) if b == 128
                    else {"conv3x3", "wgrad"})
    work = [w.work(fam, a) for fam, a in launches]
    assert sum(o for o, _ in work) == pytest.approx(ops, rel=1e-12)
    assert sum(n for _, n in work) == pytest.approx(nbytes + extra, rel=1e-12)


def test_metric_files_read_the_spans():
    """Each new metric of BENCHMARK.json binds its reader in portbench.spans."""
    cell = spec.load_cell("unetpres-n16.train-l128")
    readers = cell.readers()
    for fam in ("conv3x3", "wgrad", "tail_fwd", "tail_bwd"):
        assert readers[f"train.{fam}_roofline"] is getattr(spans, f"{fam}_roofline")
    assert spec.load_cell("unetp-128.serve-r512").readers()["serve_unetp.copy_gb_per_s"] is spans.copy_gb_per_s
    assert is_port_kernel("void (anonymous namespace)::tail_backward_reduce(const float*)",
                          spans.families()["tail_bwd"])
