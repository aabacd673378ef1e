"""The stochastic-refine rung: the port against the reference.

``sample_batch``, ``next_pow2`` and ``step_eta`` are numpy copies and must
be bit-identical; ``blend_factor`` runs its SVD and QR on the host and is
held within 1e-6 over a grid of ``eta``; the minibatch step's subspace
(``U Uᵀ``) within 1e-4; ``HooiExecutor.run_stochastic`` for P = 1 and
P = 4, tucker and completion, against the reference's with its draws
injected through the seam: fits within 1e-4 (as the energy share near a
fit of 1, ``test_torch_hooi.assert_fits_match``), the same stats fields,
and a rerun that compiles and uploads nothing with bitwise equal fits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stochastic as ref_stoch
from repro.core.hooi import random_factors as ref_random_factors
from repro.core.plan import plan as ref_plan
from repro.distributed.executor import HooiExecutor as RefExecutor
from repro.engine.objective import CompletionObjective as RefCompletion
from repro.engine.steps import make_stochastic_step_fn as ref_step_fn
from repro_torch import convert
from repro_torch.core import plan as port_plan
from repro_torch.core import stochastic
from repro_torch.distributed.executor import HooiExecutor
from repro_torch.engine.objective import CompletionObjective
from repro_torch.engine.steps import make_stochastic_step_fn
from repro_torch.random import Key
from test_torch_hooi import assert_fits_match, jax_draws

CORE = (3, 3, 3)


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


def _elements(seed, nnz, shape=(30, 20, 25)):
    r = np.random.default_rng(seed)
    coords = np.stack([r.integers(0, L, nnz) for L in shape], axis=1)
    return coords, r.standard_normal(nnz)


@pytest.mark.parametrize("covered,fraction,seed,replay", [
    (0, 1.0, 0, 1024), (1500, 0.25, 7, 1024), (1500, 0.5, 3, 0),
    (2999, 0.9, 11, 64), (3000, 0.3, 2, 5000),
])
def test_sample_batch_bit_identical(covered, fraction, seed, replay):
    coords, values = _elements(0, 3000)
    want = ref_stoch.sample_batch(coords, values, covered, fraction, seed,
                                  replay_nnz=replay)
    got = stochastic.sample_batch(coords, values, covered, fraction, seed,
                                  replay_nnz=replay)
    for f in ("indices", "coords", "values"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.sample_nnz, got.replay_nnz, got.padded_nnz) == \
        (want.sample_nnz, want.replay_nnz, want.padded_nnz)
    with pytest.raises(ValueError, match="fraction"):
        stochastic.sample_batch(coords, values, covered, 0.0, seed)


def test_step_eta_and_next_pow2_bit_identical():
    for base, decay, k in [(0.5, 0.5, 0), (0.5, 0.5, 3), (1.0, 0.0, 9),
                           (0.3, 2.0, -1)]:
        assert stochastic.step_eta(base, decay, k) == \
            ref_stoch.step_eta(base, decay, k)
    for n in [0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 613_798]:
        assert stochastic.next_pow2(n) == ref_stoch.next_pow2(n)


@pytest.mark.parametrize("L,K", [(40, 3), (200, 10)])
def test_blend_factor_matches_reference(L, K):
    r = np.random.default_rng(L)
    F_old = np.linalg.qr(r.standard_normal((L, K)))[0].astype(np.float32)
    F_hat = np.linalg.qr(r.standard_normal((L, K)))[0].astype(np.float32)
    for eta in np.linspace(0.0, 1.0, 11):
        want = np.asarray(ref_stoch.blend_factor(F_old, F_hat, eta))
        got = stochastic.blend_factor(torch.from_numpy(F_old),
                                      torch.from_numpy(F_hat), eta)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.T @ got, np.eye(K), atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_stochastic_step_matches_reference(mode):
    """The minibatch step's basis spans the reference's subspace (1e-4)."""
    shape = (30, 20, 25)
    coords, values = _elements(1, 900, shape)
    sb = ref_stoch.sample_batch(coords, values, 500, 0.5, 4, replay_nnz=64)
    factors = [np.asarray(f) for f in
               ref_random_factors(shape, CORE, jax.random.PRNGKey(2))]
    K, L = CORE[mode], shape[mode]
    path = (1000 + mode,)
    key = jax.random.PRNGKey(0)
    for p in path:
        key = jax.random.fold_in(key, p)
    left_ref, S_ref = ref_step_fn(mode, L, K, 1, K)(
        jnp.asarray(sb.coords, jnp.int32), jnp.asarray(sb.values, jnp.float32),
        [jnp.asarray(f) for f in factors], key)
    fn = make_stochastic_step_fn(mode, L, K, 1, K)
    left, S = fn({"coords": torch.from_numpy(sb.coords.astype(np.int32)),
                  "values": torch.from_numpy(sb.values.astype(np.float32))},
                 convert.factors(factors, "cpu"), Key(jax_draws(0), path))
    U, Ur = left.numpy(), np.asarray(left_ref)
    np.testing.assert_allclose(U @ U.T, Ur @ Ur.T, rtol=0, atol=1e-4)
    np.testing.assert_allclose(S.numpy(), np.asarray(S_ref), rtol=1e-4,
                               atol=1e-5)


def _append_tensor(objective):
    """A low-rank-plus-noise tensor with its last 10% as the append."""
    from repro.core.coo import SparseTensor

    r = np.random.default_rng(8)
    shape = (30, 20, 25)
    A = [r.standard_normal((L, 3)) for L in shape]
    coords = np.stack([r.integers(0, L, 2500) for L in shape], axis=1)
    vals = np.einsum("ea,eb,ec->e", *(A[n][coords[:, n]] for n in range(3)))
    t = SparseTensor(coords, vals + 0.1 * r.standard_normal(2500),
                     shape).dedup()
    return t, int(t.nnz * 0.9)


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("objective", ["tucker", "completion"])
def test_run_stochastic_matches_reference(P, objective):
    t, covered = _append_tensor(objective)
    ref_obj = RefCompletion(holdout_fraction=0.2) \
        if objective == "completion" else None
    obj = CompletionObjective(holdout_fraction=0.2) \
        if objective == "completion" else None
    init = [np.asarray(f) for f in
            ref_random_factors(t.shape, CORE, jax.random.PRNGKey(4))]
    kw = dict(init_factors=init, covered_nnz=covered, sample_fraction=0.5,
              sample_seed=7, replay_nnz=64, step_size=0.5, step_index=1,
              n_invocations=2, seed=3)
    ref = RefExecutor(P)
    rpl = ref_plan(ref_obj.prepare_tensor(t) if ref_obj else t, "lite", P,
                   core_dims=CORE, objective=ref_obj)
    rdec, rs = ref.run_stochastic(t, CORE, rpl, use_kernel=False,
                                  objective=ref_obj, **kw)
    ex = HooiExecutor(P, "cpu")
    pt = _port(t)
    pl = port_plan.plan(obj.prepare_tensor(pt) if obj else pt, "lite", P,
                        core_dims=CORE, objective=obj)
    dec, st = ex.run_stochastic(pt, CORE, pl, objective=obj,
                                draw=jax_draws(3), **kw)
    assert_fits_match(st.fits, rs.fits)
    for f in ("step_compilations", "step_cache_hits", "uploads",
              "upload_cache_hit", "sample_fraction", "sample_nnz",
              "replay_nnz", "step_size", "lanczos_block", "warm_start",
              "comm_backends", "objective", "precision", "scheme"):
        assert getattr(st, f) == getattr(rs, f), f
    if objective == "completion":
        np.testing.assert_allclose(
            st.objective_metrics["holdout_rmse"],
            rs.objective_metrics["holdout_rmse"], rtol=0, atol=1e-4)
    for F, Fr in zip(dec.factors, rdec.factors):
        F, Fr = F.numpy(), np.asarray(Fr)
        np.testing.assert_allclose(F @ F.T, Fr @ Fr.T, rtol=0, atol=1e-3)
    for k in ("runs", "step_compilations", "step_cache_hits", "uploads",
              "upload_cache_hits", "cached_steps", "cached_plans"):
        assert ex.stats()[k] == ref.stats()[k], k
    # the rerun: nothing compiled, nothing moved, the same bits
    _, again = ex.run_stochastic(pt, CORE, pl, objective=obj,
                                 draw=jax_draws(3), **kw)
    assert again.step_compilations == 0 and again.uploads == 0
    assert again.upload_cache_hit
    assert again.fits == st.fits


def test_run_stochastic_checks():
    t, covered = _append_tensor("tucker")
    pt = _port(t)
    pl = port_plan.plan(pt, "lite", 4, core_dims=CORE)
    init = [np.linalg.qr(np.random.default_rng(0).standard_normal((L, 3)))[0]
            for L in t.shape]
    ex = HooiExecutor(4, "cpu")
    kw = dict(covered_nnz=covered, sample_fraction=0.5)
    with pytest.raises(ValueError, match="carried factors"):
        ex.run_stochastic(pt, CORE, pl, init_factors=None, **kw)
    with pytest.raises(ValueError, match="P=4"):
        HooiExecutor(2, "cpu").run_stochastic(pt, CORE, pl,
                                              init_factors=init, **kw)
    with pytest.raises(ValueError, match="objective"):
        ex.run_stochastic(pt, CORE, pl, init_factors=init, objective="nn",
                          **kw)
    with pytest.raises(ValueError, match="core_dims"):
        ex.run_stochastic(pt, (2, 2, 2), pl, init_factors=init, **kw)
    # a rank change carries over: the factors are coerced (3 -> 4 wide)
    pl4 = port_plan.plan(pt, "lite", 4, core_dims=(4, 4, 4))
    dec, st = ex.run_stochastic(pt, (4, 4, 4), pl4, init_factors=init, **kw)
    assert [tuple(F.shape) for F in dec.factors] == \
        [(L, 4) for L in t.shape]
    assert 0.0 <= st.fits[-1] <= 1.0 and st.step_size == 0.5
