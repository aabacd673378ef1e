"""The generator: deterministic by seed, exactly the requested distinct
nonzeros, the hub share on its mode, duplicates' values summed."""

import numpy as np
import pytest
import torch

from _tiny import SEED


def _draw(seed=SEED, **kw):
    from tuckerbench import gen

    args = dict(shape=(60, 50, 80, 30), nnz=20_000,
                alphas=(1.4, 1.4, 1.1, 0.8), hub_fraction=0.09,
                hub_modes=(0,), seed=seed, device="cpu")
    args.update(kw)
    return gen.draw_tensor(**args)


def test_deterministic_by_seed():
    c1, v1 = _draw()
    c2, v2 = _draw()
    c3, _ = _draw(seed=SEED + 1)
    assert np.array_equal(c1, c2) and np.array_equal(v1, v2)
    assert not np.array_equal(c1, c3)


@pytest.mark.parametrize("nnz", [1, 5_000, 20_000, 150_000])
def test_exactly_the_distinct_nonzeros_asked(nnz):
    c, v = _draw(nnz=nnz)
    flat = np.ravel_multi_index(tuple(c.T), (60, 50, 80, 30))
    assert c.shape == (nnz, 4) and v.shape == (nnz,)
    assert len(np.unique(flat)) == nnz
    assert np.all(np.diff(flat) > 0), "sorted by linear index"
    assert c.dtype == np.int64 and v.dtype == np.float64


def test_the_hub_share_lies_on_its_mode():
    c, _ = _draw(alphas=(0.0, 0.0, 0.0, 0.0), shape=(400, 300, 300, 200),
                 nnz=50_000)
    share = np.bincount(c[:, 0]).max() / len(c)
    # 9% of the draws in one slice, against 1/400 of a uniform mode
    assert 0.08 <= share <= 0.10
    for m in (1, 2, 3):
        assert np.bincount(c[:, m]).max() / len(c) < 0.02


def test_more_draws_than_distinct_when_skewed():
    """The skewed modes repeat coordinates: the values of repeated draws
    are summed, so their spread exceeds a standard normal's."""
    # every coordinate of (8, 8) held: the head ones are drawn many times
    _, v = _draw(nnz=64, shape=(8, 8), alphas=(1.0, 1.0), hub_fraction=0.0,
                 hub_modes=())
    assert np.var(v) > 3.0


def test_refuses_what_cannot_be_held():
    from tuckerbench import gen

    with pytest.raises(ValueError):
        gen.draw_tensor((3, 3), 10, 1.0, device="cpu")
    assert torch.get_default_dtype() == torch.float32


# FROSTT nell-1: its index space, 1.586e20, is past 2**63
NELL1 = (2902330, 2143368, 25495389)


@pytest.mark.parametrize("shape,alphas,hub,digest", [
    ((60, 50, 80, 30), (1.4, 1.4, 1.1, 0.8), 0.09,
     "92ccbee2cd3ae3ac552bf57ab8cc4685abcab1bd"),
    ((200, 150, 300), (0.9, 0.9, 1.0), 0.0,
     "5b25c74a4fd60cb51477ef0751bdb5af3cee2eb8"),
], ids=["four_modes", "three_modes"])
def test_one_word_draws_keep_their_bits(shape, alphas, hub, digest):
    """Below 2**63 the draw is the one-word generator's, bit for bit (the
    digests were taken with it, before keys could take two words)."""
    import hashlib

    c, v = _draw(shape=shape, alphas=alphas, hub_fraction=hub,
                 hub_modes=(0,) if hub else ())
    h = hashlib.sha1()
    h.update(c.tobytes())
    h.update(v.tobytes())
    assert h.hexdigest() == digest


@pytest.fixture(scope="module")
def nell1_draws():
    """nell-1's shape under the nell1-s skew: two draws of one seed and one
    of another, at each count."""
    out = {}
    for nnz in (5_000, 50_000):
        kw = dict(shape=NELL1, nnz=nnz, alphas=(1.2, 1.2, 1.4),
                  hub_fraction=0.0, hub_modes=())
        out[nnz] = (_draw(**kw), _draw(**kw), _draw(seed=SEED + 1, **kw))
    return out


@pytest.mark.parametrize("nnz", [5_000, 50_000])
def test_past_a_64_bit_index_exactly_the_distinct_nonzeros(nell1_draws, nnz):
    (c, v), _, _ = nell1_draws[nnz]
    assert c.shape == (nnz, 3) and v.shape == (nnz,)
    assert c.dtype == np.int64 and v.dtype == np.float64
    assert np.all(c >= 0) and np.all(c < np.array(NELL1))
    # strictly increasing in linear order: lexicographic on the coordinates
    d = np.diff(c, axis=0)
    lead = np.where(d != 0, np.arange(3), 3).min(axis=1)
    assert np.all(lead < 3), "no coordinate twice"
    assert np.all(d[np.arange(nnz - 1), lead] > 0), "sorted by linear index"


@pytest.mark.parametrize("nnz", [5_000, 50_000])
def test_past_a_64_bit_index_deterministic_by_seed(nell1_draws, nnz):
    (c1, v1), (c2, v2), (c3, _) = nell1_draws[nnz]
    assert np.array_equal(c1, c2) and v1.tobytes() == v2.tobytes()
    assert not np.array_equal(c1, c3)


@pytest.mark.parametrize("mode", [0, 2])
def test_past_a_64_bit_index_the_hub_share_lies_on_its_mode(mode):
    """A hub in the head word's modes and one in the tail word's."""
    c, _ = _draw(shape=NELL1, nnz=50_000, alphas=(0.0, 0.0, 0.0),
                 hub_fraction=0.09, hub_modes=(mode,))
    assert len(np.unique(c, axis=0)) == len(c)
    for m in range(3):
        share = np.unique(c[:, m], return_counts=True)[1].max() / len(c)
        assert (0.08 <= share <= 0.10) if m == mode else share < 0.01


def test_past_a_64_bit_index_the_duplicates_are_summed():
    """Under the skew the head coordinates are drawn many times: their
    summed values spread wider than a standard normal's."""
    _, v = _draw(shape=NELL1, nnz=5_000, alphas=(2.0, 2.0, 2.0),
                 hub_fraction=0.0, hub_modes=())
    assert np.var(v) > 3.0


@pytest.mark.parametrize("shape", [(2 ** 32, 2 ** 32, 2 ** 32),
                                   (2 ** 40, 2 ** 20, 2 ** 30, 2 ** 40)])
def test_a_shape_past_two_words_is_refused(shape):
    from tuckerbench import gen

    with pytest.raises(ValueError, match="two 64-bit words"):
        gen.draw_tensor(shape, 10, 0.0, device="cpu")

