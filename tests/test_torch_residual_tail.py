"""The port's residual tail (plain version, as a CPU tensor takes it) against
the JAX package's fused Pallas tail in interpret mode, batched B=2 against
B=1 per sample."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plastic_unet_tpu.ops.pallas_trunk import residual_tail_apply
from plastic_unet_tpu_torch.ops.conv3x3 import conv3x3
from plastic_unet_tpu_torch.ops.residual_tail import residual_tail

torch.set_num_threads(2)

NAMES = ("11", "12", "21", "22")


def _make(h, w, c, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((2, h, w, c)).astype(np.float32)
    p = {}
    for name in NAMES:
        p["w" + name] = (rng.standard_normal((3, 3, c, c)) * (0.5 / (3 * np.sqrt(c)))).astype(np.float32)
        p["b" + name] = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x0, p


def _torch_args(p):
    args = []
    for name in NAMES:
        args.append(torch.from_numpy(np.ascontiguousarray(np.transpose(p["w" + name], (3, 2, 0, 1)))))
        args.append(torch.from_numpy(p["b" + name]))
    return args


@pytest.mark.parametrize("h,w,c", [(13, 13, 16), (10, 11, 32), (5, 5, 128)])
def test_tail_matches_pallas(h, w, c):
    x0, p = _make(h, w, c, seed=h * w + c)
    launches = (residual_tail.launches, conv3x3.launches)
    got = residual_tail(torch.from_numpy(x0), *_torch_args(p)).numpy()
    assert (residual_tail.launches, conv3x3.launches) == launches
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    for i in range(2):
        ref = np.asarray(residual_tail_apply(jnp.asarray(x0[i]), jp, h, w, c))
        np.testing.assert_allclose(got[i], ref, atol=2e-5)
        single = residual_tail(torch.from_numpy(x0[i : i + 1]), *_torch_args(p)).numpy()
        np.testing.assert_allclose(got[i], single[0], atol=2e-5)
