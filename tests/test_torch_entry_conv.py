"""The trunks' entry convs (models.blocks.EntryConv) on the CPU: the routed
conv (ops.conv3x3.conv3x3_same, Cin a multiple of the kernel's 16-channel
slice) and the cuDNN route against F.conv2d with autograd, the route
counters, the benchmark's tail ranges around the routed module (its
forward hook and full-backward pre-hook fire once a call, in order), the
export op, and a reference-layout init checkpoint loading strictly."""

import os
import sys

import pytest
import torch
import torch.nn.functional as F

from plastic_unet_tpu_torch.models.blocks import EntryConv
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmark"))
from portbench import tracing  # noqa: E402  (the benchmark's own hooks, as a traced run registers them)

INIT_PTH = os.path.join(REPO, "results", "showdown_r5", "sd_torch_hebb_250h.json.init.pth")
ROUTES = ("kernel.entry.kernel", "kernel.entry.library")

torch.set_num_threads(2)


def entry_counts() -> dict:
    return {k: profiling.counters().get(k, 0) for k in ROUTES}


@pytest.mark.parametrize("cin, c, route", [(16, 32, "kernel"), (64, 32, "kernel"), (1, 16, "library")],
                         ids=["cin_half", "cin_double", "cin_1_cudnn"])
def test_entry_conv_matches_conv2d(cin, c, route):
    """Forward and the gradients of x, weight and bias against F.conv2d with
    autograd (NCHW, float64), on the route the input's Cin picks."""
    g = torch.Generator().manual_seed(cin)
    conv = EntryConv(cin, c)
    x = torch.randn((2, 9, 7, cin), generator=g)
    d = torch.randn((2, 9, 7, c), generator=g)
    xr = x.double().permute(0, 3, 1, 2).requires_grad_()
    wr, br = (p.detach().double().requires_grad_() for p in (conv.weight, conv.bias))
    ref = F.conv2d(xr, wr, br, padding=1).permute(0, 2, 3, 1)
    ref.backward(d.double())
    profiling.reset()
    xg = x.clone().requires_grad_()
    out = conv(xg)
    out.backward(d)
    assert entry_counts() == {f"kernel.entry.{route}": 1} | {k: 0 for k in ROUTES if not k.endswith(route)}
    assert out.shape == (2, 9, 7, c) and out.is_contiguous()
    for got, want in ((out, ref), (xg.grad, xr.grad.permute(0, 2, 3, 1)), (conv.weight.grad, wr.grad),
                      (conv.bias.grad, br.grad)):
        torch.testing.assert_close(got.double(), want.detach(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("neurons, dtype, want", [(16, None, (8, 1)), (8, None, (7, 2)), (2, None, (3, 6)),
                                                  (16, torch.bfloat16, (0, 9))])
def test_route_counters(neurons, dtype, want):
    """kernel.entry.kernel / .library a forward: every entry conv whose Cin is
    a multiple of 16 in fp32 on the kernel, the stem and bf16 on cuDNN."""
    size = 24
    m = UNetPRes(neurons=neurons, nbf=size, compute_dtype=dtype, generator=torch.Generator().manual_seed(1)).eval()
    x = torch.rand((1, size, size, 1), generator=torch.Generator().manual_seed(2))
    profiling.reset()
    with torch.no_grad():
        m(x, m.initial_zero_hebb(1))
    assert tuple(entry_counts().values()) == want


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_tail_ranges_fire_once_per_trunk_in_order(monkeypatch, train):
    """The benchmark's tail ranges open on each entry conv's forward hook and
    close on its trunk's (backward: open on the trunk's full-backward
    pre-hook, close on the entry conv's), once a trunk, in the order the
    trunks run, with nothing left open."""
    log = []
    enter, exit_ = tracing._Span.enter, tracing._Span.exit

    def logged_enter(self, key, name):
        log.append(("enter", key, name))
        enter(self, key, name)

    def logged_exit(self, key):
        log.append(("exit", key, bool(self.open.get(key))))
        exit_(self, key)

    monkeypatch.setattr(tracing._Span, "enter", logged_enter)
    monkeypatch.setattr(tracing._Span, "exit", logged_exit)
    size, b = 32, 2
    g = torch.Generator().manual_seed(3)
    m = UNetPRes(neurons=16, nbf=size, generator=g).train(train)
    x = torch.rand((b, size, size, 1), generator=g)
    trunks = tracing.trunk_modules(m)
    assert [type(e) for _, e in trunks] == [EntryConv] * 9
    with tracing.tail_ranges(m, backward=train):
        out = m(x, m.initial_zero_hebb(b), generator=g if train else None)
        if train:
            out.activ.sum().backward()
    keys = [id(t) for t, _ in trunks]
    want = [e for k in keys for e in (("enter", k, "bench.tail.fwd"), ("exit", k, True))]
    if train:
        want += [e for k in reversed(keys) for e in (("enter", ("bwd", k), "bench.tail.bwd"),
                                                     ("exit", ("bwd", k), True))]
    assert log == want


def test_export_op_equals_eager():
    """Under torch.export the routed entry conv is the custom op
    entry_conv_forward, and the program gives the eager bits."""
    conv = EntryConv(32, 16).eval()
    x = torch.randn((2, 8, 8, 32), generator=torch.Generator().manual_seed(4))
    program = torch.export.export(conv, (x,))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("plastic_unet_tpu_torch.entry_conv_forward.default") == 1
    with torch.no_grad():
        assert torch.equal(program.module()(x), conv(x))


def test_showdown_init_loads_strictly():
    """The reference-layout init checkpoint (neurons=8) keeps its keys: it
    loads with strict=True, and 7 of its 9 entry convs take the kernel."""
    m = UNetPRes(neurons=8, nbf=101)
    m.load_state_dict(torch.load(INIT_PTH, map_location="cpu", weights_only=True), strict=True)
    assert isinstance(m.conv1.dconv[0], torch.nn.Conv2d) and isinstance(m.uconv1.uconv[1].mconv[0], EntryConv)
    x = torch.rand((1, 101, 101, 1), generator=torch.Generator().manual_seed(5))
    profiling.reset()
    with torch.no_grad():
        out = m.eval()(x, m.initial_zero_hebb(1))
    assert tuple(entry_counts().values()) == (7, 2) and bool(torch.isfinite(out.activout).all())
