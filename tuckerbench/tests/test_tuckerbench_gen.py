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
