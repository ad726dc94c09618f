"""The port's int8 serving (ops.quant, the quant modes of models.unet_res,
submit.quant, utils.torch_interop.quant_ranges_from_jax) on the CPU against
the JAX package: the quantization math bit for bit, calibration's 49 ranges,
and the int8 forward with JAX's ranges carried across. UNetPRes at nbf=32,
neurons=2 (JAX init weights), inputs from a numpy seed.

The int8 forward's tolerance: probabilities within 1e-5. The port's int8
convs equal the JAX package's op by op bit for bit (the tests below), but
inside jit XLA fuses the dequant ``acc * s + bias`` (an FMA among others),
which moves ~1/4 of the outputs by an ulp (test_jit_moves_the_dequant_bits); where
that moves a value across a .5 step of the next conv's quantization, round()
gives the next integer, one quantum on that conv's input."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plastic_unet_tpu.eval.evaluate import predict_masks as jax_predict_masks
from plastic_unet_tpu.models import UNetPRes as JaxUNetPRes
from plastic_unet_tpu.ops import quant as jq
from plastic_unet_tpu.submit.quant import calibrate as jax_calibrate
from plastic_unet_tpu.submit.quant import quantize_for_serving as jax_quantize_for_serving
from plastic_unet_tpu_torch.eval.evaluate import predict_masks
from plastic_unet_tpu_torch.models.unet_res import UNetPRes
from plastic_unet_tpu_torch.ops import quant as tq
from plastic_unet_tpu_torch.submit.inference import predict_masks_tta
from plastic_unet_tpu_torch.submit.quant import calibrate, quantize_for_serving
from plastic_unet_tpu_torch.utils.torch_interop import load_pth, quant_ranges_from_jax, state_dict_from_jax_params

torch.set_num_threads(2)

SIZE, N_QUANT_CONVS, ATOL = 32, 49, 1e-5
CKPT = "results/showdown_r5/sd_torch_oja_250h.json.ckpt.pth"


@pytest.fixture(scope="module")
def models():
    jm = JaxUNetPRes(n_channels=1, n_classes=1, neurons=2, nbf=SIZE)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)), jm.initial_zero_hebb(1))["params"]
    tm = UNetPRes(neurons=2, nbf=SIZE)
    tm.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jm, params, tm


@pytest.fixture(scope="module")
def calib_data():
    return np.random.default_rng(7).random((12, SIZE, SIZE, 1), dtype=np.float32)


@pytest.fixture(scope="module")
def jax_int8(models, calib_data):
    jm, params, _ = models
    qmodel, variables = jax_quantize_for_serving(jm, params, jnp.asarray(calib_data[:8]), chunk=5)
    return qmodel, variables


def _conv_case(seed, b, h, cin, cout, transpose):
    """Seeded operands with saturation (amax below max|x|), an all-zero output
    channel and a channel whose weights are all one value."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, h, cin)).astype(np.float32)
    k = rng.standard_normal((3, 3, cout, cin) if transpose else (3, 3, cin, cout)).astype(np.float32)
    cax = 2 if transpose else 3
    zero = [slice(None)] * 4
    zero[cax] = 0
    k[tuple(zero)] = 0.0
    same = list(zero)
    same[cax] = cout - 1
    k[tuple(same)] = 0.25
    bias = rng.standard_normal(cout).astype(np.float32)
    amax = np.float32(0.6 * np.abs(x).max())
    # torch layouts: Conv2d (Cout, Cin, 3, 3), ConvTranspose2d (Cin, Cout, 3, 3); both flax->torch are (3, 2, 0, 1)
    tw = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    return x, k, bias, amax, tw


def test_quantize_act_matches_jax():
    x = np.concatenate([np.random.default_rng(1).standard_normal(500).astype(np.float32) * 3,
                        np.array([-10.0, -1.0, 0.0, 1.0, 10.0, 0.5 / 127, 1.5 / 127, -2.5 / 127], np.float32)])
    for amax in (np.float32(1.0), np.float32(2.7), np.float32(0.0)):
        q, s = tq.quantize_act(torch.from_numpy(x), torch.tensor(amax))
        jqx, js = jq.quantize_act(jnp.asarray(x), jnp.asarray(amax))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jqx))
        assert s.item() == float(js)
    q, _ = tq.quantize_act(torch.tensor([-10.0, -1.0, 0.0, 1.0, 10.0]), torch.tensor(1.0))
    assert q.tolist() == [-127, -127, 0, 127, 127]


def test_act_qparams_divide_as_jax():
    """The scales of 4096 ranges equal JAX's bit for bit and the correctly
    rounded float32 of the divisions: 127 / amax and amax / 127 divide two
    tensors (ROADMAP.md, C6), where ``127.0 / t`` would be
    ``t.reciprocal() * 127`` in torch, an ulp off in 1 of 4 values."""
    amax = np.random.default_rng(3).random(4096, dtype=np.float32) * 20 + np.float32(1e-3)
    inv, scale = tq.act_qparams(torch.from_numpy(amax))
    jinv, jscale = jq.act_qparams(jnp.asarray(amax))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(inv.numpy(), (127.0 / amax.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(scale.numpy(), (amax.astype(np.float64) / 127.0).astype(np.float32))


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "convT"])
def test_quantize_weight_matches_jax(transpose):
    _, k, _, _, tw = _conv_case(2, 1, 3, 5, 6, transpose)
    q, s = tq.quantize_weight(tw, cout_axis=1 if transpose else 0)
    jqw, js = jq.quantize_weight(jnp.asarray(k), cout_axis=2 if transpose else 3)
    np.testing.assert_array_equal(q.permute(2, 3, 1, 0).numpy(), np.asarray(jqw))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s[0].item() == 0.0 and bool((q.select(1 if transpose else 0, 0) == 0).all())


@pytest.mark.parametrize("shape", [(2, 9, 4, 8), (3, 6, 2, 3), (1, 5, 16, 16), (2, 4, 1, 2)])
@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "convT"])
def test_qconv_matches_jax_bit_for_bit(shape, transpose):
    """qconv3_same / qconvT3_s2_valid against the JAX functions (op by op)
    and against the port's float64 plain versions, bit for bit."""
    x, k, bias, amax, tw = _conv_case(3, *shape, transpose)
    jfn, tfn, plain = ((jq.qconvT3_s2_valid, tq.qconvT3_s2_valid, tq.qconvT3_s2_valid_plain) if transpose
                       else (jq.qconv3_same, tq.qconv3_same, tq.qconv3_same_plain))
    args = (torch.from_numpy(x), tw, torch.from_numpy(bias), torch.tensor(amax))
    got = tfn(*args)
    ref = np.asarray(jfn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), jnp.asarray(amax)))
    b, h, _, _ = shape
    assert got.shape == ((b, 2 * h + 1, 2 * h + 1, shape[3]) if transpose else (b, h, h, shape[3]))
    np.testing.assert_array_equal(got.numpy(), ref)
    torch.testing.assert_close(got, plain(*args), rtol=0, atol=0)


def test_qconv3_integer_exact(rng):
    """Inputs and weights on the quantization grid (scales exactly 1): the
    int8 conv equals the fp32 conv bit for bit (tests/test_quant.py's case)."""
    x = rng.integers(-127, 128, (2, 9, 9, 4)).astype(np.float32)
    k = rng.integers(-127, 128, (3, 3, 4, 8)).astype(np.float32)
    k[0, 0, 0, :] = 127.0
    b = rng.standard_normal(8).astype(np.float32)
    tw = torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
    got = tq.qconv3_same(torch.from_numpy(x), tw, torch.from_numpy(b), torch.tensor(127.0))
    want = torch.nn.functional.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), tw, torch.from_numpy(b), padding=1)
    torch.testing.assert_close(got, want.permute(0, 2, 3, 1), rtol=0, atol=0)


def test_int8_matmul_pads_to_the_cuda_shape_rules():
    rng = np.random.default_rng(4)
    for m, k, n in ((5, 9, 3), (17, 16, 8), (40, 13, 10)):
        a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
        b = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
        got = tq.int8_matmul(a, b)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        torch.testing.assert_close(got, (a.long() @ b.long()).int(), rtol=0, atol=0)


def test_jit_moves_the_dequant_bits():
    """The cause of the int8 forward's tolerance: the port equals the JAX
    conv run op by op, and jit moves some of the JAX conv's outputs by a
    few ulps (XLA fuses the dequant, with an FMA among others)."""
    x, k, bias, amax, tw = _conv_case(5, 4, 12, 8, 8, False)
    args = (jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), jnp.asarray(amax))
    eager, jitted = np.asarray(jq.qconv3_same(*args)), np.asarray(jax.jit(jq.qconv3_same)(*args))
    port = tq.qconv3_same(torch.from_numpy(x), tw, torch.from_numpy(bias), torch.tensor(amax)).numpy()
    np.testing.assert_array_equal(port, eager)
    assert 0 < np.mean(jitted != eager) < 0.5
    np.testing.assert_allclose(jitted, eager, rtol=0, atol=4 * 2.0 ** -23 * np.abs(eager).max())


def test_calibrate_matches_jax(models, calib_data, jax_int8):
    """The 49 ranges under JAX's names (carried by quant_ranges_from_jax),
    values within rtol=1e-5; the stem's range is max|X| over every chunk."""
    _, _, tm = models
    _, variables = jax_int8
    ref = quant_ranges_from_jax(variables["quant"])
    got = calibrate(tm, calib_data[:8], chunk=5, device="cpu")  # a ragged last chunk, as the JAX run
    assert len(ref) == N_QUANT_CONVS and set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].item(), ref[name].item(), rtol=1e-5, err_msg=name)
    assert got["conv1.dconv.0"].item() == float(np.abs(calib_data[:8]).max())
    jq_ranges = jax_calibrate(models[0], models[1], jnp.asarray(calib_data[:8]), chunk=5)
    assert len(jax.tree_util.tree_leaves(jq_ranges)) == N_QUANT_CONVS
    assert tm.quant == "" and not tm.quant_ranges()  # calibration left the model as it was


def test_int8_forward_with_jax_ranges_matches_jax(models, calib_data, jax_int8):
    jm, params, tm = models
    qmodel, variables = jax_int8
    ref = np.asarray(jax_predict_masks(qmodel, variables, jnp.asarray(calib_data), chunk=8))
    tq_model = UNetPRes(neurons=2, nbf=SIZE, quant="int8")
    tq_model.load_state_dict(tm.state_dict(), strict=True)
    tq_model.load_quant_ranges(quant_ranges_from_jax(variables["quant"]))
    got = predict_masks(tq_model, calib_data, chunk=8, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert not np.array_equal(got, predict_masks(tm, calib_data, chunk=8, device="cpu").numpy())  # not fp32
    tta = predict_masks_tta(tq_model, calib_data, transforms=("identity", "hflip"), chunk=8, device="cpu")
    tta_b = predict_masks_tta(tq_model, calib_data, transforms=("identity", "hflip"), chunk=8, batch_views=True,
                              device="cpu")
    torch.testing.assert_close(tta, tta_b, rtol=0, atol=0)


def test_quantize_for_serving_tracks_fp32(models, calib_data):
    _, _, tm = models
    qmodel = quantize_for_serving(tm, calib_data[:8], chunk=8, device="cpu")
    assert qmodel.quant == "int8" and len(qmodel.quant_ranges()) == N_QUANT_CONVS
    want = predict_masks(tm, calib_data, chunk=8, device="cpu").numpy()
    got = predict_masks(qmodel, calib_data, chunk=8, device="cpu").numpy()
    assert np.abs(got - want).max() < 5e-3  # the JAX package's bound (tests/test_quant.py)


def test_int8_without_calibration_raises(models):
    _, _, tm = models
    qmodel = UNetPRes(neurons=2, nbf=SIZE, quant="int8")
    qmodel.load_state_dict(tm.state_dict(), strict=True)
    with pytest.raises(RuntimeError, match="calibrated"):
        predict_masks(qmodel, np.zeros((1, SIZE, SIZE, 1), np.float32), device="cpu")
    with pytest.raises(KeyError, match="missing"):
        qmodel.load_quant_ranges({"conv1.dconv.0": 1.0})


def test_rejects_unknown_quant_mode(models):
    _, _, tm = models
    bad = UNetPRes(neurons=2, nbf=SIZE, quant="int4")
    with pytest.raises(ValueError, match="quant must be"):
        predict_masks(bad, np.zeros((1, SIZE, SIZE, 1), np.float32), device="cpu")


def test_reference_pth_loads_strict_in_every_quant_mode():
    """amax is not part of the reference state_dict: the committed checkpoint
    loads with strict=True, and the state_dict keys are the reference's."""
    sd = load_pth(CKPT, "model")
    for mode in ("", "calib", "int8"):
        m = UNetPRes(neurons=8, nbf=101, rule="oja", quant=mode)
        m.load_state_dict(sd, strict=True)
        assert set(m.state_dict()) == set(sd)
    m.load_quant_ranges({name: 1.0 for name in calibrate_names()})
    assert set(m.state_dict()) == set(sd) and len(m.quant_ranges()) == N_QUANT_CONVS


def calibrate_names():
    return [name for name, mod in UNetPRes(neurons=2, nbf=SIZE).named_modules() if "amax" in mod._buffers]
