"""The port's TTM layer against the reference's and against dense oracles.

Twins of the ``tests/test_hooi.py`` TTM cases: the same numpy tensors and
the reference's ``random_factors`` (passed over as numpy) go through
``repro_torch.core.ttm``; f32 tolerance rtol = atol = 2e-4. The port's core
is ``F_0ᵀ Z_(0)`` rather than the reference's (nnz, ∏K) sum, so it is also
held against ``repro.core.ttm.core_from_factors`` directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ttm as ref_ttm
from repro.core.coo import SparseTensor
from repro.core.hooi import random_factors
from repro_torch.core import ttm

TOL = dict(rtol=2e-4, atol=2e-4)


def _small_tensor(seed=0, shape=(7, 6, 5), frac=0.3):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal(shape) * (rng.random(shape) < frac)
    return SparseTensor.fromdense(dense), dense


def _factors(shape, core, seed):
    """Reference factors, and the same numbers as port tensors."""
    facs = random_factors(shape, core, jax.random.PRNGKey(seed))
    return facs, [torch.from_numpy(np.array(f)) for f in facs]


def _coo(t):
    return (torch.from_numpy(t.coords.astype(np.int32)),
            torch.from_numpy(t.values.astype(np.float32)))


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_penultimate_matches_dense(mode):
    t, dense = _small_tensor()
    _, factors = _factors(t.shape, (3, 3, 3), 1)
    mats = {j: factors[j].T for j in range(3) if j != mode}
    dense_t = torch.from_numpy(dense.astype(np.float32))
    Z_dense = ttm.unfold(ttm.dense_ttm_chain(dense_t, mats), mode)
    coords, values = _coo(t)
    Z_sparse = ttm.penultimate(coords, values, factors, mode, t.shape[mode])
    np.testing.assert_allclose(Z_sparse.numpy(), Z_dense.numpy(), **TOL)


def test_penultimate_4d():
    rng = np.random.default_rng(3)
    shape = (5, 4, 3, 6)
    dense = rng.standard_normal(shape) * (rng.random(shape) < 0.4)
    t = SparseTensor.fromdense(dense)
    jf, factors = _factors(shape, (2, 2, 2, 2), 0)
    coords, values = _coo(t)
    for mode in range(4):
        mats = {j: factors[j].T for j in range(4) if j != mode}
        Z_dense = ttm.unfold(ttm.dense_ttm_chain(
            torch.from_numpy(dense.astype(np.float32)), mats), mode)
        Z_sp = ttm.penultimate(coords, values, factors, mode, shape[mode])
        np.testing.assert_allclose(Z_sp.numpy(), Z_dense.numpy(), **TOL)
        Z_ref = ref_ttm.penultimate(jnp.asarray(coords.numpy()),
                                    jnp.asarray(values.numpy()), jf, mode,
                                    shape[mode])
        np.testing.assert_allclose(Z_sp.numpy(), np.asarray(Z_ref), **TOL)


def test_ttm_chain_commutative():
    _, dense = _small_tensor(4)
    T = torch.from_numpy(dense.astype(np.float32))
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.standard_normal((2, 7)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((3, 6)).astype(np.float32))
    ab = ttm.dense_ttm(ttm.dense_ttm(T, 0, A), 1, B)
    ba = ttm.dense_ttm(ttm.dense_ttm(T, 1, B), 0, A)
    np.testing.assert_allclose(ab.numpy(), ba.numpy(), rtol=1e-5, atol=1e-5)
    ref = ref_ttm.dense_ttm(ref_ttm.dense_ttm(jnp.asarray(T.numpy()), 0,
                                              jnp.asarray(A.numpy())),
                            1, jnp.asarray(B.numpy()))
    np.testing.assert_allclose(ab.numpy(), np.asarray(ref), **TOL)


def test_unfold_fold_roundtrip_matches_reference():
    _, dense = _small_tensor(5)
    T = torch.from_numpy(dense.astype(np.float32))
    for mode in range(3):
        M = ttm.unfold(T, mode)
        np.testing.assert_array_equal(
            M.numpy(), np.asarray(ref_ttm.unfold(jnp.asarray(T.numpy()),
                                                 mode)))
        np.testing.assert_array_equal(ttm.fold(M, mode, T.shape).numpy(),
                                      T.numpy())


def test_kron_contribution_order():
    """Single-element tensor: contribution must match dense unfold exactly."""
    shape = (3, 4, 5)
    coords = np.array([[1, 2, 3]])
    vals = np.array([2.0])
    t = SparseTensor(coords, vals, shape)
    jf, factors = _factors(shape, (2, 3, 2), 5)
    dense = torch.from_numpy(t.todense().astype(np.float32))
    c_coords, c_vals = _coo(t)
    for mode in range(3):
        mats = {j: factors[j].T for j in range(3) if j != mode}
        Z_dense = ttm.unfold(ttm.dense_ttm_chain(dense, mats), mode)
        c = ttm.kron_contributions(c_coords, c_vals, factors, mode)
        np.testing.assert_allclose(Z_dense[coords[0, mode]].numpy(),
                                   c[0].numpy(), rtol=1e-5, atol=1e-6)
        ref = ref_ttm.kron_contributions(jnp.asarray(c_coords.numpy()),
                                         jnp.asarray(c_vals.numpy()), jf,
                                         mode)
        np.testing.assert_allclose(c.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


def test_core_from_factors_matches_dense():
    t, dense = _small_tensor(9)
    _, factors = _factors(t.shape, (3, 2, 4), 3)
    coords, values = _coo(t)
    g_sparse = ttm.core_from_factors(coords, values, factors)
    g_dense = ttm.dense_ttm_chain(torch.from_numpy(dense.astype(np.float32)),
                                  {n: factors[n].T for n in range(3)})
    assert tuple(g_sparse.shape) == (3, 2, 4)
    np.testing.assert_allclose(g_sparse.numpy(), g_dense.numpy(), **TOL)


@pytest.mark.parametrize("shape,core", [
    ((7, 6, 5), (3, 2, 4)),
    ((5, 4, 3, 6), (2, 3, 2, 2)),
    ((9, 8, 7), (1, 3, 2)),
])
def test_core_via_mode0_z_matches_reference_core(shape, core):
    """F_0ᵀ Z_(0) is the reference's element-wise core sum."""
    rng = np.random.default_rng(11)
    dense = rng.standard_normal(shape) * (rng.random(shape) < 0.4)
    t = SparseTensor.fromdense(dense)
    jf, factors = _factors(shape, core, 4)
    coords, values = _coo(t)
    got = ttm.core_from_factors(coords, values, factors)
    want = ref_ttm.core_from_factors(jnp.asarray(coords.numpy()),
                                     jnp.asarray(values.numpy()), jf)
    assert tuple(got.shape) == tuple(want.shape) == core
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_core_from_factors_empty_tensor():
    _, factors = _factors((6, 5, 4), (2, 2, 2), 0)
    g = ttm.core_from_factors(torch.zeros((0, 3), dtype=torch.int32),
                              torch.zeros((0,)), factors)
    np.testing.assert_array_equal(g.numpy(), np.zeros((2, 2, 2)))
