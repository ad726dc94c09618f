"""The port's bfloat16 UNetPRes (``compute_dtype``; CPU, plain versions)
against the JAX module with ``compute_dtype=jnp.bfloat16``, on the same
numpy-seeded inputs and the same weights (a seeded port model's, carried
to flax by the JAX package's own ``state_dict_to_flax_params``).

The bound: the port's bf16 activ, activout and hebb are no farther from the
JAX bf16 module than the JAX bf16 module is from the JAX fp32 module on the
same inputs. Measured on an x86 CPU at neurons=4, B=4, SIZE=16 (the ratio
port-to-JAX-bf16 over JAX-bf16-to-JAX-fp32, largest of the three outputs):
the plain model, both rules, plastic=False, trunk_pad=32 and coord_conv
0.001 (the same rounding points: the port's bf16 outputs are within 6e-8
of JAX's); BN in eval mode 0.004; BN in train mode 0.85 (the batch
statistics are fp32 sums in another order, and a last-bit difference there
moves bf16 roundings downstream); int8 + bf16 0.001 against the JAX module
applied op by op. Under ``jax.jit`` XLA fuses the int8 dequant with the
cast to bf16 (tests/test_torch_quant.py), which moves JAX's own int8 + bf16
output by 1.5e-4 on activ, as far as bf16 is from fp32; the port follows
the unfused ops, as the fp32 int8 tests do. remat_trunk is held to the
plain bf16 model's gradients bit for bit (its forward is the plain one).

The JAX side runs in parity precision (true fp32 where it is fp32)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.submit.quant import quantize_for_serving as jax_quantize_for_serving
from plastic_unet_tpu.utils import torch_interop as jti
from plastic_unet_tpu.utils.precision import matmul_precision as jax_precision
from plastic_unet_tpu_torch.models import blocks as tblocks
from plastic_unet_tpu_torch.models import unet_res as tunet
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.submit.quant import calibrate
from plastic_unet_tpu_torch.utils.torch_interop import (
    quant_ranges_from_jax,
    unetp_res_batch_stats_map,
    unetp_res_name_map,
)

torch.set_num_threads(2)

SIZE, NEURONS, B = 16, 4, 4
OUTPUTS = ("activ", "activout", "hebb")


def _inputs(seed=0, b=B):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, SIZE, SIZE, 1)).astype(np.float32)
    hebb = (rng.standard_normal((b, SIZE, SIZE)) * 0.1).astype(np.float32)
    return x, hebb


def _port(seed=1, **opts):
    """A seeded fp32 port model (BN: with running statistics away from their
    initial values), the same weights in a bf16 port model, and the flax
    variables of those weights."""
    m32 = UNetPRes(neurons=NEURONS, nbf=SIZE, dropout_ratio=0.0, generator=torch.Generator().manual_seed(seed),
                   **opts)
    bn = opts.get("batch_norm", False)
    if bn:
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            for k, buf in m32.named_buffers():
                if k.endswith("running_mean"):
                    buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
                elif k.endswith("running_var"):
                    buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    mb = UNetPRes(neurons=NEURONS, nbf=SIZE, dropout_ratio=0.0, compute_dtype="bfloat16", **opts)
    mb.load_state_dict(m32.state_dict(), strict=True)
    sd = m32.state_dict()
    names = unetp_res_name_map(batch_norm=bn)
    if not opts.get("plastic", True):
        names = {k: v for k, v in names.items() if k not in (("w",), ("alpha",), ("eta",))}
    variables = {"params": jti.state_dict_to_flax_params(sd, names)}
    if bn:
        variables["batch_stats"] = jti.state_dict_to_flax_params(
            sd, {k: (v, None) for k, v in unetp_res_batch_stats_map().items()})
    return m32.eval(), mb.eval(), variables


def _jax(variables, x, hebb, train=False, **opts):
    """(JAX bf16 outputs, JAX fp32 outputs), the module applied op by op."""
    out = []
    with jax_precision("parity"):
        for dt in (jnp.bfloat16, None):
            jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=NEURONS, dropout_ratio=0.0, nbf=SIZE,
                             compute_dtype=dt, **opts)
            if train:
                res, _ = jm.apply(variables, jnp.asarray(x), jnp.asarray(hebb), train=True, mutable=["batch_stats"])
            else:
                res = jm.apply(variables, jnp.asarray(x), jnp.asarray(hebb))
            out.append([np.asarray(r) for r in res])
    return out


def _assert_within_bf16_distance(got, jb, j32):
    for name, g, b, f in zip(OUTPUTS, got, jb, j32):
        g = g.detach().numpy()
        assert g.dtype == np.float32 and g.shape == b.shape, name
        port, ref = float(np.abs(g - b).max()), float(np.abs(b - f).max())
        assert port <= ref, f"{name}: port to JAX bf16 {port:.3g} > JAX bf16 to JAX fp32 {ref:.3g}"


CASES = [pytest.param(dict(rule="hebb"), False, id="hebb"),
         pytest.param(dict(rule="oja"), False, id="oja"),
         pytest.param(dict(plastic=False), False, id="no_plastic"),
         pytest.param(dict(trunk_pad=32), False, id="pad32"),
         pytest.param(dict(coord_conv=True), False, id="coord"),
         pytest.param(dict(batch_norm=True), False, id="bn_eval"),
         pytest.param(dict(batch_norm=True), True, id="bn_train")]


@pytest.mark.parametrize("opts,train", CASES)
def test_bf16_forward_matches_jax(opts, train):
    _, mb, variables = _port(**opts)
    x, hebb = _inputs()
    jb, j32 = _jax(variables, x, hebb, train=train, **opts)
    with torch.no_grad():
        got = mb.train(train)(torch.from_numpy(x), torch.from_numpy(hebb))
    _assert_within_bf16_distance(got, jb, j32)


def test_int8_bf16_matches_jax():
    """Calibration in bf16 records the bf16 activations' ranges, equal to
    the JAX calib mode's under a bf16 model; the int8 forward with those
    ranges (the dequantized convs return bf16) within the bound, whose fp32
    side is the JAX fp32 int8 module on the same ranges."""
    m32, mb, variables = _port()
    calib = np.random.default_rng(7).standard_normal((8, SIZE, SIZE, 1)).astype(np.float32)
    x, hebb = _inputs(seed=3)
    with jax_precision("parity"):
        jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=NEURONS, dropout_ratio=0.0, nbf=SIZE,
                         compute_dtype=jnp.bfloat16)
        qm, qvars = jax_quantize_for_serving(jm, variables["params"], jnp.asarray(calib), chunk=4)
        out = [[np.asarray(r) for r in m.apply(qvars, jnp.asarray(x), jnp.asarray(hebb))]
               for m in (qm, qm.clone(compute_dtype=None))]
    jax_ranges = quant_ranges_from_jax(qvars["quant"])
    ranges = calibrate(mb, calib, chunk=4, device="cpu")
    assert set(ranges) == set(jax_ranges) and len(ranges) == 49
    assert all(torch.equal(ranges[k], jax_ranges[k]) for k in ranges)
    fp32_ranges = calibrate(m32, calib, chunk=4, device="cpu")
    assert any(not torch.equal(ranges[k], fp32_ranges[k]) for k in ranges)
    mb.quant = "int8"
    mb.load_quant_ranges(jax_ranges)
    with torch.no_grad():
        got = mb(torch.from_numpy(x), torch.from_numpy(hebb))
    _assert_within_bf16_distance(got, *out)


def test_bf16_dtypes_and_output():
    """The trunk's activations are bf16 (a forward hook on every trunk
    module), the head's input fp32, every parameter and its gradient fp32,
    and the bf16 output is not the fp32 output."""
    m32, mb, _ = _port()
    x, hebb = _inputs()
    seen, heads = {}, []
    trunk = [(n, m) for n, m in mb.named_modules() if isinstance(m, (tblocks.DownRes, tblocks.Middle, tblocks.UpRes))]
    assert len(trunk) == 13  # 4 DownRes, the Middle, 4 UpRes and their Middles
    hooks = [m.register_forward_hook(lambda mod, a, out, n=n: seen.__setitem__(n, out.dtype)) for n, m in trunk]
    real_head = tunet.plastic_head

    def head(w, alpha, eta, activin, h, **kw):
        heads.append(activin.dtype)
        return real_head(w, alpha, eta, activin, h, **kw)

    tunet.plastic_head = head
    try:
        out = mb.train()(torch.from_numpy(x), torch.from_numpy(hebb))
    finally:
        tunet.plastic_head = real_head
        for h in hooks:
            h.remove()
    assert seen == {n: torch.bfloat16 for n, _ in trunk} and heads == [torch.float32]
    out.activout.mean().backward()
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32 for p in mb.parameters() if p.grad is not None)
    assert all(p.dtype == torch.float32 for p in mb.parameters()) and mb.compute_dtype == torch.bfloat16
    with torch.no_grad():
        ref = m32(torch.from_numpy(x), torch.from_numpy(hebb))
        got = mb.eval()(torch.from_numpy(x), torch.from_numpy(hebb))
    assert not torch.equal(got.activ, ref.activ) and not torch.equal(got.activout, ref.activout)
    assert all(o.dtype == torch.float32 for o in got)


@pytest.mark.parametrize("opts", [dict(), dict(batch_norm=True), dict(quant="calib")], ids=["plain", "bn", "calib"])
def test_bf16_route_runs_no_fp32_kernel(opts, monkeypatch):
    """The bf16 trunk is picked by the dtype, not reached by a kernel
    wrapper giving way: the fp32 tail, its calibration form and the BN
    trunks' conv are not called, forward or backward."""
    def refuse(*a, **k):
        raise AssertionError("an fp32 kernel wrapper was called on the bf16 path")

    for name in ("residual_tail", "residual_tail_ranges", "residual_tail_forward", "conv3x3_same"):
        monkeypatch.setattr(tblocks, name, refuse)
    quant = opts.pop("quant", "")
    _, mb, _ = _port(**opts)
    mb.quant = quant
    x, hebb = _inputs()
    out = mb.train(not quant)(torch.from_numpy(x), torch.from_numpy(hebb))
    if not quant:
        out.activ.sum().backward()
    assert torch.isfinite(out.activ).all()


def test_remat_bf16_gradients_equal_plain():
    """remat_trunk in bf16, with dropout: the same gradients as the plain
    bf16 step, bit for bit (the recompute replays the same bf16 ops and the
    same masks)."""
    x, hebb = _inputs(seed=5, b=2)
    tgt = torch.from_numpy((np.random.default_rng(6).random((2, SIZE, SIZE)) > 0.5).astype(np.float32))
    grads = []
    for remat in (False, True):
        m = UNetPRes(neurons=NEURONS, nbf=SIZE, dropout_ratio=0.5, compute_dtype=torch.bfloat16, remat_trunk=remat,
                     generator=torch.Generator().manual_seed(4)).train()
        out = m(torch.from_numpy(x), torch.from_numpy(hebb), generator=torch.Generator().manual_seed(8))
        ((out.activout - tgt) ** 2).mean().backward()
        grads.append({n: p.grad.clone() for n, p in m.named_parameters() if p.grad is not None})
    assert list(grads[0]) == list(grads[1]) and len(grads[0]) > 0
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


@pytest.mark.parametrize("value,want", [(None, None), ("float32", None), (torch.float32, None),
                                        ("bfloat16", torch.bfloat16), (torch.bfloat16, torch.bfloat16)])
def test_compute_dtype_values(value, want):
    assert UNetPRes(neurons=2, nbf=SIZE, compute_dtype=value).compute_dtype == want


@pytest.mark.parametrize("value", ["float16", torch.float16, jnp.bfloat16, "bf16"])
def test_other_compute_dtypes_raise(value):
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        UNetPRes(neurons=2, nbf=SIZE, compute_dtype=value)


def test_float32_names_keep_the_fp32_bits():
    m32, _, _ = _port()
    x, hebb = _inputs()
    named = UNetPRes(neurons=NEURONS, nbf=SIZE, dropout_ratio=0.0, compute_dtype=torch.float32).eval()
    named.load_state_dict(m32.state_dict(), strict=True)
    with torch.no_grad():
        for a, b in zip(named(torch.from_numpy(x), torch.from_numpy(hebb)), m32(torch.from_numpy(x),
                                                                                torch.from_numpy(hebb))):
            assert torch.equal(a, b)
