"""The traffic generator: seeded, in range, and another seed is other traffic."""

import torch

from portbench.tiles import make_generator, synthetic_tiles

BIG_SEED = 2 ** 31 + 977


def tiles(seed, n=20, size=33):
    return synthetic_tiles(n, size, make_generator(seed, 0, "cpu"), "cpu")


def test_same_seed_same_tiles():
    a, b = tiles(BIG_SEED), tiles(BIG_SEED)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_other_seed_other_tiles():
    a, b = tiles(BIG_SEED), tiles(BIG_SEED + 1)
    assert not torch.equal(a[0], b[0])
    assert not torch.equal(a[1], b[1])


def test_streams_of_one_seed_differ():
    g0, g1 = make_generator(5, 0, "cpu"), make_generator(5, 1, "cpu")
    assert not torch.equal(torch.rand(8, generator=g0), torch.rand(8, generator=g1))


def test_tiles_in_range_and_masks_binary():
    x, m = tiles(11, n=600, size=25)  # more than one block of tiles
    assert x.shape == m.shape == (600, 25, 25)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert set(torch.unique(m).tolist()) <= {0.0, 1.0}
    cover = m.mean(dim=(1, 2))
    assert float((cover == 0).float().mean()) > 0.1  # tiles without salt, as a count of 0 ellipses gives
    assert float((cover > 0).float().mean()) > 0.5
    assert float(x[m > 0].mean()) > float(x[m == 0].mean()) + 0.1  # salt is brighter
