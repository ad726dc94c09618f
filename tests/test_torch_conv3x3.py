"""The port's 3x3 conv (plain version, as a CPU tensor takes it), with every
fused flag, against the JAX package's Pallas conv3x3_flat in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plastic_unet_tpu.ops.pallas_conv import conv3x3_flat, flatten_hw, pack_weights, unflatten_hw
from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3, hwio

torch.set_num_threads(2)

SHAPES = [(13, 16, 16), (25, 8, 16), (101, 16, 16), (12, 32, 8)]  # (hw, cin, cout)
# (relu_in, residual: None | "plain" | "relu", relu_out)
FLAGS = [(False, None, False), (True, None, False), (False, None, True),
         (True, "plain", False), (False, "relu", True), (True, "relu", True)]


def _jax_ref(x, w_oihw, b, res, relu_in, res_mode, relu_out):
    """One sample through conv3x3_flat, the other flags composed around it."""
    hw = x.shape[0]
    xin = np.maximum(x, 0) if relu_in else x
    w = jnp.asarray(np.transpose(w_oihw, (2, 3, 1, 0)))
    y = unflatten_hw(conv3x3_flat(flatten_hw(jnp.asarray(xin)), pack_weights(w), jnp.asarray(b), hw, hw), hw, hw)
    y = np.asarray(y)
    if res_mode == "plain":
        y = y + res
    elif res_mode == "relu":
        y = y + np.maximum(res, 0)
    return np.maximum(y, 0) if relu_out else y


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("hw,cin,cout", SHAPES)
def test_conv3x3_matches_pallas(hw, cin, cout, flags):
    relu_in, res_mode, relu_out = flags
    rng = np.random.default_rng(hw * 100 + cin + cout)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    w = (rng.standard_normal((cout, cin, 3, 3)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    res = rng.standard_normal((2, hw, hw, cout)).astype(np.float32)
    launches = conv3x3.launches
    got = conv3x3(torch.from_numpy(x), hwio(torch.from_numpy(w)), torch.from_numpy(b),
                  None if res_mode is None else torch.from_numpy(res),
                  relu_in=relu_in, relu_res=res_mode == "relu", relu_out=relu_out).numpy()
    assert conv3x3.launches == launches  # CPU tensors never launch the kernel
    for i in range(2):
        ref = _jax_ref(x[i], w, b, res[i], relu_in, res_mode, relu_out)
        np.testing.assert_allclose(got[i], ref, atol=1e-5)


def test_hwio_layout():
    w = torch.arange(2 * 3 * 9, dtype=torch.float32).reshape(2, 3, 3, 3)
    k = hwio(w)
    assert k.shape == (3, 3, 3, 2) and k.is_contiguous()
    assert k[1, 2, 0, 1] == w[1, 0, 1, 2]
