"""The port's Golub–Kahan Lanczos drivers against the reference's.

With the reference's ``jax.random`` draws injected through the port's draw
seam (``repro_torch.random``), the port's ``gk_bidiag`` and
``gk_block_bidiag`` walk the same Krylov space as
``repro.core.lanczos``'s, so ``U`` and ``B`` agree to f32 rounding (rtol =
atol = 2e-4: the products sum in another order). That holds for the
replicated u-space and for the sharded one, where the reference runs inside
``shard_map`` over P host devices and the port stacks the P ranks on one
device. Also twins of ``tests/test_hooi.py``'s and
``tests/test_roofline.py``'s Lanczos cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as PS

from repro.core import lanczos as ref_lanczos
from repro.jax_compat import make_mesh_auto, shard_map_compat
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


def _sharded_reference(Z, P, fn):
    """Run ``fn(Z_local, psum)`` in the reference's ``shard_map`` over P
    host devices, rows of Z sharded; outputs sharded on dim 0 then
    replicated."""
    mesh = make_mesh_auto((P,), ("ranks",), devices=jax.devices()[:P])
    smap = shard_map_compat(
        lambda Zl: fn(Zl, lambda x: jax.lax.psum(x, "ranks")), mesh,
        in_specs=(PS("ranks"),), out_specs=(PS("ranks"), PS()))
    return jax.jit(smap)(jnp.asarray(Z))


def _stacked_products(Z, P):
    """Z's rows split over P stacked ranks: ``Z @ x`` per rank, and
    ``Zᵀ y`` summed over the ranks (vectors and panels)."""
    Zs = torch.from_numpy(Z).reshape(P, -1, Z.shape[1])

    def rmatvec(y):
        return torch.einsum("pdn,pd->n" if y.dim() == 2 else "pdn,pds->ns",
                            Zs, y)

    return (lambda x: Zs @ x), rmatvec


@pytest.mark.parametrize("P,m,n,niter", [(4, 40, 12, 8), (2, 30, 30, 12)])
def test_sharded_gk_bidiag_matches_reference(P, m, n, niter):
    """The stacked-ranks u-space against the reference's ``axis="ranks"``
    u-space inside ``shard_map``; per-rank restart draws ``+(17, p)``."""
    Z, _, _ = _operator(4, m, n, 4)
    path = (1000, 2)
    U_ref, B_ref = _sharded_reference(
        Z, P, lambda Zl, ps: ref_lanczos.gk_bidiag(
            lambda x: Zl @ x, lambda y: ps(y @ Zl), m // P, n, niter,
            _jax_key(9, path), axis="ranks"))
    mv, rmv = _stacked_products(Z, P)
    U, B = lanczos.gk_bidiag(mv, rmv, m // P, n, niter,
                             Key(jax_draws(9), path), axis=P, device="cpu")
    assert tuple(U.shape) == (P, m // P, niter)
    np.testing.assert_allclose(U.reshape(m, niter).numpy(),
                               np.asarray(U_ref), **TOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_ref), **TOL)


@pytest.mark.parametrize("s", [2, 4])
def test_sharded_gk_block_bidiag_matches_reference(s):
    P, m, n, niter = 4, 48, 16, 3
    Z, _, _ = _operator(5, m, n, 4)
    path = (1003,)
    U_ref, B_ref = _sharded_reference(
        Z, P, lambda Zl, ps: ref_lanczos.gk_block_bidiag(
            lambda x: Zl @ x, lambda y: ps(Zl.T @ y), m // P, n, niter, s,
            _jax_key(2, path), axis="ranks"))
    mv, rmv = _stacked_products(Z, P)
    U, B = lanczos.gk_block_bidiag(mv, rmv, m // P, n, niter, s,
                                   Key(jax_draws(2), path), axis=P,
                                   device="cpu")
    np.testing.assert_allclose(U.reshape(m, niter * s).numpy(),
                               np.asarray(U_ref), **TOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_ref), **TOL)


def test_sharded_completion_matches_reference():
    """A rank-deficient operator on the sharded space: the completion
    columns come from the per-rank draws ``+(1, p)`` and are orthonormal
    over all ranks, as the reference's."""
    P, m, n, niter, k = 4, 16, 8, 2, 4
    Z = np.zeros((m, n), np.float32)
    Z[1, 0], Z[9, 2] = 3.0, 2.0
    path = (1007,)

    def ref_fn(Zl, ps):
        U, B = ref_lanczos.gk_bidiag(lambda x: Zl @ x, lambda y: ps(y @ Zl),
                                     m // P, n, niter, _jax_key(6, path),
                                     axis="ranks")
        return ref_lanczos.svd_from_bidiag(U, B, k, _jax_key(6, path),
                                           axis="ranks")

    L_ref, S_ref = _sharded_reference(Z, P, ref_fn)
    mv, rmv = _stacked_products(Z, P)
    key = Key(jax_draws(6), path)
    U, B = lanczos.gk_bidiag(mv, rmv, m // P, n, niter, key, axis=P,
                             device="cpu")
    L, S = lanczos.svd_from_bidiag(U, B, k, key, axis=P)
    L = L.reshape(m, k).numpy()
    np.testing.assert_allclose(S.numpy(), np.asarray(S_ref), **TOL)
    np.testing.assert_allclose(L.T @ L, np.eye(k), atol=1e-5)
    Lr = np.asarray(L_ref)
    np.testing.assert_allclose(L @ L.T, Lr @ Lr.T, atol=1e-4)


def test_rank_sum_adds_in_rank_order():
    x = torch.tensor([[1e8], [1.0], [-1e8], [1.0]], dtype=torch.float32)
    # ((1e8 + 1) - 1e8) + 1 in f32: the 1 is lost in the first add
    assert lanczos.rank_sum(x).item() == 1.0


def test_block_start_panel_matches_reference():
    key = Key(jax_draws(5), (1000, 4))
    got = lanczos.block_start_panel(key, 37, 8, device="cpu")
    want = ref_lanczos.block_start_panel(_jax_key(5, (1000, 4)), 37, 8)
    assert tuple(got.shape) == (37, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose((got.T @ got).numpy(), np.eye(8), atol=1e-5)


@pytest.mark.parametrize("s,fused", [(4, False), (4, True), (8, True)])
def test_gk_block_bidiag_matches_reference(s, fused):
    """Replicated block driver; ``fused`` hands the start panel and its
    product over through the ``first_panel``/``first_product`` seam, as the
    fused Z-build does, and must walk the very same Krylov space."""
    m, n = 60, 24
    Z, _, _ = _operator(2, m, n, 6)
    niter = lanczos.lanczos_niter(6, m, n, s)
    path = (1001,)
    Zj, Zt = jnp.asarray(Z), torch.from_numpy(Z)
    kw_ref, kw = {}, {}
    if fused:
        V1 = ref_lanczos.block_start_panel(_jax_key(8, path), n, s)
        kw_ref = dict(first_panel=V1, first_product=Zj @ V1)
        V1t = lanczos.block_start_panel(Key(jax_draws(8), path), n, s,
                                        device="cpu")
        kw = dict(first_panel=V1t, first_product=Zt @ V1t)
    U_ref, B_ref = ref_lanczos.gk_block_bidiag(
        lambda x: Zj @ x, lambda y: Zj.T @ y, m, n, niter, s,
        _jax_key(8, path), **kw_ref)
    U, B = lanczos.gk_block_bidiag(
        lambda x: Zt @ x, lambda y: Zt.T @ y, m, n, niter, s,
        Key(jax_draws(8), path), device="cpu", **kw)
    np.testing.assert_allclose(U.numpy(), np.asarray(U_ref), **TOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(B_ref), **TOL)
    if fused:  # the seam changes where the first product comes from only
        U0, B0 = lanczos.gk_block_bidiag(
            lambda x: Zt @ x, lambda y: Zt.T @ y, m, n, niter, s,
            Key(jax_draws(8), path), device="cpu")
        assert torch.equal(U0, U) and torch.equal(B0, B)


@pytest.mark.parametrize("s", [4, 8])
def test_block_driver_matches_full_svd(s):
    """Twin of ``test_roofline.py::test_block_driver_matches_full_svd``."""
    m, n, k = 200, 60, 8
    Z, _, s_true = _operator(7, m, n, k)
    Zt = torch.from_numpy(Z)
    niter = lanczos.lanczos_niter(k, m, n, block_size=s)
    U, B = lanczos.gk_block_bidiag(lambda x: Zt @ x, lambda y: Zt.T @ y, m,
                                   n, niter, s, make_key(1), device="cpu")
    left, sv = lanczos.svd_from_bidiag(U, B, k, make_key(1))
    np.testing.assert_allclose(sv.numpy(), s_true, rtol=1e-3)
    np.testing.assert_allclose((left.T @ left).numpy(), np.eye(k), atol=1e-5)
