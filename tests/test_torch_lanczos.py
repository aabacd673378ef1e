"""The port's vector Golub–Kahan Lanczos against the reference's.

With the reference's ``jax.random`` draws injected through the port's draw
seam (``repro_torch.random``), the port's ``gk_bidiag`` walks the same
Krylov space as ``repro.core.lanczos.gk_bidiag``, so ``U`` and ``B`` agree
to f32 rounding (rtol = atol = 2e-4: the products sum in another order).
Also twins of ``tests/test_hooi.py``'s Lanczos cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lanczos as ref_lanczos
from repro_torch.core import lanczos
from repro_torch.random import Key, SeededDraws, make_key

TOL = dict(rtol=2e-4, atol=2e-4)


def jax_draws(seed):
    """The reference's draws along a fold_in path, through numpy."""
    root = jax.random.PRNGKey(seed)

    def draw(path, shape):
        k = root
        for p in path:
            k = jax.random.fold_in(k, p)
        return torch.from_numpy(np.array(
            jax.random.normal(k, shape, jnp.float32)))

    return draw


def _jax_key(seed, path):
    k = jax.random.PRNGKey(seed)
    for p in path:
        k = jax.random.fold_in(k, p)
    return k


def _operator(seed, m, n, k):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, m)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    r = min(m, n)
    s = np.concatenate([10.0 * 0.5 ** np.arange(k), 1e-3 * np.ones(r - k)])
    return ((u[:, :r] * s) @ v[:r, :]).astype(np.float32), u[:, :k], s[:k]


@pytest.mark.parametrize("m,n,niter", [(40, 12, 8), (12, 40, 8), (30, 30, 12)])
def test_gk_bidiag_matches_reference_with_injected_draws(m, n, niter):
    Z, _, _ = _operator(0, m, n, 4)
    path = (1000, 5)
    U_ref, B_ref = ref_lanczos.gk_bidiag(
        lambda x: jnp.asarray(Z) @ x, lambda y: y @ jnp.asarray(Z), m, n,
        niter, _jax_key(7, path))
    Zt = torch.from_numpy(Z)
    U, B = lanczos.gk_bidiag(lambda x: Zt @ x, lambda y: y @ Zt, m, n,
                             niter, Key(jax_draws(7), path), device="cpu")
    np.testing.assert_allclose(U.numpy(), np.asarray(U_ref), **TOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_ref), **TOL)


def test_svd_from_bidiag_completion_matches_reference():
    """Rank-deficient operator: the completion columns come from the
    ``+(1,)`` draw and match the reference's."""
    Z = np.zeros((10, 8), np.float32)
    Z[0, 0] = 3.0
    Zj, Zt = jnp.asarray(Z), torch.from_numpy(Z)
    key = _jax_key(3, (2,))
    res_ref = ref_lanczos.lanczos_bidiag(lambda x: Zj @ x,
                                         lambda y: y @ Zj, 10, 8, 4,
                                         niter=2, key=key)
    res = lanczos.lanczos_bidiag(lambda x: Zt @ x, lambda y: y @ Zt, 10, 8,
                                 4, niter=2, key=Key(jax_draws(3), (2,)),
                                 device="cpu")
    assert res.n_queries == res_ref.n_queries
    np.testing.assert_allclose(res.singular_values.numpy(),
                               np.asarray(res_ref.singular_values), **TOL)
    L, Lr = res.left_vectors.numpy(), np.asarray(res_ref.left_vectors)
    np.testing.assert_allclose(L @ L.T, Lr @ Lr.T, atol=1e-3)


@pytest.mark.parametrize("shape,k", [((40, 12), 4), ((12, 40), 4),
                                     ((30, 30), 6)])
def test_lanczos_matches_svd(shape, k):
    m, n = shape
    Z, u_true, s_true = _operator(1, m, n, k)
    res = lanczos.svd_via_lanczos(torch.from_numpy(Z), k, key=make_key(2))
    np.testing.assert_allclose(res.singular_values.numpy(), s_true, rtol=1e-3)
    L = res.left_vectors.numpy()
    proj_err = np.linalg.norm(L @ L.T - u_true @ u_true.T)
    assert float(proj_err) < 1e-2
    np.testing.assert_allclose(L.T @ L, np.eye(k), atol=1e-4)
    assert res.n_queries == 2 * min(2 * k, m, n)


def test_lanczos_rank_deficient():
    Z = torch.zeros((10, 8))
    Z[0, 0] = 3.0
    res = lanczos.svd_via_lanczos(Z, 4)
    L = res.left_vectors.numpy()
    np.testing.assert_allclose(L.T @ L, np.eye(4), atol=1e-4)
    np.testing.assert_allclose(res.singular_values[0].item(), 3.0, rtol=1e-4)


def test_niter_helpers_match_reference():
    for k, m, n, s in [(3, 24, 9, 1), (10, 28818, 100, 1), (4, 5, 100, 3),
                       (2, 12, 4, 8)]:
        assert lanczos.lanczos_niter(k, m, n, s) == \
            ref_lanczos.lanczos_niter(k, m, n, s)
        assert lanczos.effective_block_size(k, m, n, s) == \
            ref_lanczos.effective_block_size(k, m, n, s)


def test_default_draws_are_seeded_and_path_keyed():
    d = SeededDraws(5)
    a = d((1000, 3), (4, 2))
    np.testing.assert_array_equal(a.numpy(), SeededDraws(5)((1000, 3),
                                                              (4, 2)).numpy())
    assert not torch.equal(a, d((1000, 17), (4, 2)))
    assert not torch.equal(a, SeededDraws(6)((1000, 3), (4, 2)))
    key = make_key(5).fold_in(1000).fold_in(3)
    np.testing.assert_array_equal(key.normal((4, 2), "cpu").numpy(),
                                  a.numpy())


def test_sharded_u_space_is_refused():
    with pytest.raises(NotImplementedError):
        lanczos.gk_bidiag(lambda x: x, lambda y: y, 4, 4, 2, make_key(0),
                          axis="ranks", device="cpu")
