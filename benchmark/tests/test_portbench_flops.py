"""The FLOP counts against the figures the port's records give."""

import pytest

from portbench import spec


@pytest.fixture
def flops():
    return lambda arch: spec.load_file(spec.BENCH_DIR / "flops" / f"{arch}.py", f"test_flops_{arch}")


def test_unet_res_counts(flops):
    f = flops("unet_res")
    cfg = spec.load_cell("unetpres-n16.train-b1").config
    assert f.forward_flops(cfg) == pytest.approx(2.169e9, rel=5e-4)
    assert f.train_flops(cfg) == pytest.approx(6.503e9, rel=5e-4)
    fwd, _ = f.tail_work(cfg, 1, False)
    assert fwd == pytest.approx(1.623e9, rel=5e-4)
    train, _ = f.tail_work(cfg, 1, True)
    assert train == pytest.approx(3 * fwd)


def test_tail_work_scales_with_batch(flops):
    f = flops("unet_res")
    cfg = spec.load_cell("unetpres-n16.serve-r512").config
    ops1, bytes1 = f.tail_work(cfg, 1, False)
    ops128, bytes128 = f.tail_work(cfg, 128, False)
    assert ops128 == pytest.approx(128 * ops1)
    assert bytes1 < bytes128 < 128 * bytes1  # the weights are read once a launch


def test_unet_classic_counts(flops):
    f = flops("unet")
    cfg = spec.load_cell("unetp-128.serve-r512").config
    assert f.forward_flops(cfg) == pytest.approx(0.2559e9, rel=5e-4)
    assert f.tail_work(cfg, 128, True) == (0.0, 0.0)


def test_counts_match_the_reference_modules(flops):
    """Each count equals the sum over the reference's conv modules at their shapes."""
    import torch
    from torch import nn

    from portbench.weights import arch_file

    for cell, arch in (("unetpres-n16.train-b1", "unet_res"), ("unetp-128.serve-r512", "unet")):
        cfg = spec.load_cell(cell).config
        ref = arch_file(arch).Reference(**cfg["model"])
        total, hooks = [0], []

        def count(m, inp, out):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                total[0] += 2 * inp[0].numel() * w.shape[1] * w.shape[2] * w.shape[3]
            else:
                total[0] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        for m in ref.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                hooks.append(m.register_forward_hook(count))
        s, nbf = cfg["image_size"], cfg["model"]["nbf"]
        with torch.no_grad():
            ref.eval()(torch.zeros(1, 1, s, s), arch_file(arch).initial_state(ref, 1, "cpu"))
        assert flops(arch).forward_flops(cfg) == pytest.approx(total[0] + 2 * nbf ** 3)
