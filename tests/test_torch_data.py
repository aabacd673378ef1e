"""The port's host data layer is bitwise the reference's.

``repro_torch.data.tensors.synth_tensor`` and ``SparseTensor.dedup`` are
copies of the reference's numpy code; the same seed must give the same
coordinates and values bit for bit, or the parity tests and the on-card run
would not be running the reference's tensors.
"""

import numpy as np
import pytest

from repro.core.coo import SparseTensor as RefSparseTensor
from repro.data import tensors as ref_tensors
from repro_torch.core.coo import SparseTensor
from repro_torch.data import tensors


def _assert_same(port, ref):
    assert port.shape == ref.shape
    assert port.coords.dtype == ref.coords.dtype
    assert port.values.dtype == ref.values.dtype
    np.testing.assert_array_equal(port.coords, ref.coords)
    np.testing.assert_array_equal(port.values, ref.values)


@pytest.mark.parametrize("kw", [
    dict(shape=(30, 80, 80), nnz=5_000, alphas=(1.2, 1.0, 1.0),
         hub_fraction=0.3, hub_modes=(0,), seed=7),  # the skewed fixture
    dict(shape=(20, 25, 30), nnz=900, alphas=0.8, seed=5),
    dict(shape=(15, 15, 15), nnz=500, alphas=0.0, seed=6),  # uniform
    dict(shape=(120, 90, 280), nnz=7_700, alphas=(0.9, 0.9, 1.0), seed=0),
])
def test_synth_tensor_bitwise(kw):
    _assert_same(tensors.synth_tensor(**kw), ref_tensors.synth_tensor(**kw))


def test_suite_specs_match_reference():
    assert [dataclass_tuple(s) for s in tensors.SUITE_SPECS] == \
        [dataclass_tuple(s) for s in ref_tensors.SUITE_SPECS]
    spec = next(s for s in tensors.SUITE_SPECS if s.name == "enron-s")
    kw = dict(shape=spec.shape, nnz=spec.nnz // 10, alphas=spec.alphas,
              hub_fraction=spec.hub_fraction, hub_modes=spec.hub_modes,
              seed=3)
    _assert_same(tensors.synth_tensor(**kw), ref_tensors.synth_tensor(**kw))


def dataclass_tuple(spec):
    return (spec.name, spec.shape, spec.nnz, spec.alphas, spec.hub_fraction,
            spec.hub_modes, spec.mirror_of)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dedup_bitwise(seed):
    rng = np.random.default_rng(seed)
    shape = (9, 7, 5)
    coords = np.stack([rng.integers(0, L, 600) for L in shape], axis=1)
    values = rng.standard_normal(600)
    port = SparseTensor(coords, values, shape).dedup()
    ref = RefSparseTensor(coords, values, shape).dedup()
    _assert_same(port, ref)
    assert port.nnz < 600  # duplicates were really merged


def test_sparse_tensor_helpers_match_reference():
    t = tensors.synth_tensor((12, 10, 8), 300, alphas=1.0, seed=1)
    r = ref_tensors.synth_tensor((12, 10, 8), 300, alphas=1.0, seed=1)
    for n in range(3):
        np.testing.assert_array_equal(t.slice_sizes(n), r.slice_sizes(n))
        _assert_same(t.sorted_by_mode(n), r.sorted_by_mode(n))
    np.testing.assert_array_equal(t.todense(), r.todense())
    _assert_same(SparseTensor.fromdense(t.todense()),
                 RefSparseTensor.fromdense(r.todense()))
    assert (t.ndim, t.nnz) == (r.ndim, r.nnz)


def test_sparse_tensor_validation():
    with pytest.raises(ValueError):
        SparseTensor(np.zeros((3, 2), np.int64), np.zeros(3), (4, 4, 4))
    with pytest.raises(ValueError):
        SparseTensor(np.array([[0, 5]]), np.zeros(1), (4, 4))
    with pytest.raises(ValueError):
        SparseTensor(np.array([[0, -1]]), np.zeros(1), (4, 4))
