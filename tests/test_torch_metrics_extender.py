"""The port's ``MetricsExtender`` ≡ a recompute ≡ the reference's extender.

Twin of ``tests/test_metrics_extender.py``. The scheduler's repartition rung
folds each appended batch into the §4 metrics in O(batch)
(``MetricsExtender.extend``) instead of recomputing over the full tensor.
Both packages are numpy, so the port's incremental metrics must equal, field
by field, the port's ``scheme_metrics`` on the extended tensor and the
reference's ``MetricsExtender`` fed the same batches, for lite, coarse and
medium, with duplicate coordinates among the appends.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import coo as ref_coo
from repro.core import distribution as ref_distribution
from repro.core import metrics as ref_metrics
from repro.core import plan as ref_plan
from repro_torch.core.coo import SparseTensor
from repro_torch.core.distribution import build_scheme, row_owner_map
from repro_torch.core.metrics import MetricsExtender, scheme_metrics
from repro_torch.core.plan import extend_scheme

P = 8
CORE = (4, 3, 3)


def _coords(rng, shape, n):
    return np.stack([rng.integers(0, L, n) for L in shape], axis=1)


def _tensor(coords, shape, cls=SparseTensor):
    return cls(coords=coords, values=np.ones(len(coords)), shape=shape)


def _asdict(m):
    return dataclasses.asdict(m)


def _pair(prefix_coords, shape, scheme_name):
    """The port's and the reference's extender on the same prefix."""
    prefix = _tensor(prefix_coords, shape)
    scheme = build_scheme(prefix, scheme_name, P)
    rprefix = _tensor(prefix_coords, shape, ref_coo.SparseTensor)
    rscheme = ref_distribution.build_scheme(rprefix, scheme_name, P)
    for n in range(prefix.ndim):
        np.testing.assert_array_equal(scheme.policy(n), rscheme.policy(n))
    maps = tuple(row_owner_map(prefix, scheme.policy(n), n, P)
                 for n in range(prefix.ndim))
    return (MetricsExtender(prefix, scheme, CORE),
            ref_metrics.MetricsExtender(rprefix, rscheme, CORE),
            scheme, rscheme, maps)


@pytest.mark.parametrize("scheme_name", ["lite", "coarse", "medium"])
def test_extend_matches_recompute_and_reference(scheme_name):
    rng = np.random.default_rng(7)
    shape = (30, 24, 20)
    prefix_coords = _coords(rng, shape, 500)
    ext, rext, scheme, rscheme, maps = _pair(prefix_coords, shape,
                                             scheme_name)
    assert _asdict(ext.metrics()) == _asdict(rext.metrics())
    all_coords = prefix_coords
    for batch_size in (1, 37, 200):
        new_coords = _coords(rng, shape, batch_size)
        # a third of each batch repeats earlier coordinates (value updates)
        k = batch_size // 3
        new_coords[:k] = all_coords[rng.integers(0, len(all_coords), k)]
        scheme = extend_scheme(scheme, maps, new_coords)
        rscheme = ref_plan.extend_scheme(rscheme, maps, new_coords)
        m_inc = ext.extend(new_coords, scheme)
        m_ref_inc = rext.extend(new_coords, rscheme)
        all_coords = np.concatenate([all_coords, new_coords])
        m_full = scheme_metrics(_tensor(all_coords, shape), scheme, CORE)
        assert _asdict(m_inc) == _asdict(m_full)
        assert _asdict(m_inc) == _asdict(m_ref_inc)
    assert ext.nnz == rext.nnz == len(all_coords)


def test_extend_with_duplicate_coords():
    """Half duplicates of existing coordinates, half fresh: both paths count
    duplicates as distinct elements, as the reference does."""
    rng = np.random.default_rng(3)
    shape = (16, 12, 10)
    prefix_coords = _coords(rng, shape, 300)
    ext, rext, scheme, rscheme, maps = _pair(prefix_coords, shape, "medium")
    dup = prefix_coords[rng.integers(0, len(prefix_coords), 40)]
    new_coords = np.concatenate([dup, _coords(rng, shape, 40)])
    scheme2 = extend_scheme(scheme, maps, new_coords)
    m_inc = ext.extend(new_coords, scheme2)
    m_ref = scheme_metrics(
        _tensor(np.concatenate([prefix_coords, new_coords]), shape),
        scheme2, CORE)
    assert _asdict(m_inc) == _asdict(m_ref)
    assert _asdict(m_inc) == _asdict(
        rext.extend(new_coords,
                    ref_plan.extend_scheme(rscheme, maps, new_coords)))


def test_extender_state_accumulates_across_batches():
    rng = np.random.default_rng(11)
    shape = (20, 20, 20)
    prefix_coords = _coords(rng, shape, 400)
    ext, _, scheme, _, maps = _pair(prefix_coords, shape, "coarse")
    assert ext.nnz == len(prefix_coords)
    total = prefix_coords
    for _ in range(3):
        batch = _coords(rng, shape, 60)
        scheme = extend_scheme(scheme, maps, batch)
        ext.extend(batch, scheme)
        total = np.concatenate([total, batch])
    assert ext.nnz == len(total)
    assert _asdict(ext.metrics()) == _asdict(
        scheme_metrics(_tensor(total, shape), scheme, CORE))


def test_extend_rejects_non_extension_scheme():
    rng = np.random.default_rng(5)
    shape = (12, 10, 8)
    prefix = _tensor(_coords(rng, shape, 200), shape)
    scheme = build_scheme(prefix, "medium", P)
    ext = MetricsExtender(prefix, scheme, CORE)
    with pytest.raises(ValueError, match="not the extension"):
        ext.extend(_coords(rng, shape, 25), scheme)
