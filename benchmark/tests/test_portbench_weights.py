"""What the cells read, held bit for bit: the weights ``make_state_dict``
makes for each configuration, and each reference's outputs on one seeded
input from its initial state.

The digests were computed on the CPU (x86-64, PyTorch 2.13.0+cpu) by the
harness as it was before the arch files, with the same :func:`digest`: the
weights at each seed of ``SEEDS``; the outputs of ``build_reference(config,
make_state_dict(config, SEEDS[1], "cpu"), "cpu").eval()`` under ``no_grad``
on ``synthetic_tiles(2, image_size, make_generator(SEEDS[1], 0, "cpu"))``
with a zero (2, nbf, nbf) trace, on one CPU thread (threads split the
convolutions' sums, which moves their last bits).
"""

import hashlib

import pytest
import torch

from portbench import spec
from portbench.tiles import make_generator, synthetic_tiles
from portbench.weights import arch_file, build_reference, make_state_dict

SEEDS = (7, 2 ** 31 + 24, 2 ** 40 + 5)
WEIGHTS = {
    "unetpres-n16": ("88a1b6867c0c48046b3c548234c296eae4492f651e0940c96d1f538344fa7122",
                     "585f9e10d03ac18ceaf8691537510a929a2e6d0e67bf01efa508ab0ece35c3b1",
                     "297074ce336b37df37f9bc18d7b75a623b6268e5849c741db2a2e39867ba39ec"),
    "unetp-128": ("991aaf689ce37bc4f745235a0f0f8cc5ea6fab845a51fa6713e071285f10245d",
                  "6a9d46acc63c60dedebb37b433a0da7f26895804983e8f11812b78765aef117b",
                  "62ab6d889ed6319742d0073289851d6f20815b112ff96b753d4fd08c7c67798c"),
}
OUTPUTS = {
    "unetpres-n16": "dc31300d5ed701b8f66b3b6a9448adf7896578848f6d969858ad4dce85c8970c",
    "unetp-128": "0862fbe70fb8bdea742039831f04933f30e91b6f8fed9a7fc6081f81f087e7c9",
}


def digest(named) -> str:
    """sha256 over (name, shape, dtype, bytes) of each (name, tensor), in the order given."""
    h = hashlib.sha256()
    for k, t in named:
        t = t.detach().cpu().contiguous()
        h.update(f"{k}:{tuple(t.shape)}:{t.dtype}\n".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def config(name: str) -> dict:
    bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
    return spec.load_json(spec.ROOT / next(c["file"] for c in bench["configs"] if c["name"] == name))


@pytest.mark.parametrize("name,i", [(n, i) for n in WEIGHTS for i in range(len(SEEDS))])
def test_weights_are_the_parents(name, i):
    sd = make_state_dict(config(name), SEEDS[i], "cpu")
    assert digest(sorted(sd.items())) == WEIGHTS[name][i]


@pytest.mark.parametrize("name", OUTPUTS)
def test_reference_outputs_are_the_parents(name):
    cfg = config(name)
    ref = build_reference(cfg, make_state_dict(cfg, SEEDS[1], "cpu"), "cpu").eval()
    x, _ = synthetic_tiles(2, cfg["image_size"], make_generator(SEEDS[1], 0, "cpu"), "cpu")
    state = arch_file(cfg["arch"]).initial_state(ref, 2, "cpu")
    assert torch.equal(state, torch.zeros(2, cfg["model"]["nbf"], cfg["model"]["nbf"]))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            out = ref(x[:, None], state)
    finally:
        torch.set_num_threads(threads)
    assert digest(zip(("logits", "probs", "state"), out)) == OUTPUTS[name]
