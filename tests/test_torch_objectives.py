"""The port's objectives, plan files and ``.tns`` readers against the
reference: twin of ``tests/test_objectives.py``.

Bars:

* bit-identical: ``holdout_mask`` and ``sample_unit``, the completion
  view's coordinates and values (held-out ones too), the cache tokens, and
  ``load_tns``/``iter_tns_batches`` output;
* within 1e-12 relative: ``predict_at_coords`` (the port runs it in torch
  f64 on the factors' device) against the reference's numpy;
* within 1e-6: ``admm_nonneg_factor``, fixed ρ and residual balance, and
  the NN objective's least-squares core;
* fits within 1e-4 (the energy-share bar near a fit of 1, ROADMAP Queue C)
  and held-out RMSE within 1e-5: ``hooi`` and ``dist_hooi`` (P = 4 on the
  psum and boundary backends) under each objective, with the reference's
  initial factors and draws; ``stats.objective`` equal to the reference's;
  ``dist_hooi`` at P = 1 equal to ``hooi`` within 1e-6;
* plan files: the plan cache keys on the objective, a plan file written by
  the reference loads in the port with the same partitions, and an
  objective mismatch is refused (on load and by the executor).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import stochastic as ref_stochastic
from repro.core.coo import SparseTensor as RefSparseTensor
from repro.core.coo import write_tns
from repro.core.hooi import hooi as ref_hooi
from repro.core.hooi import random_factors as ref_random_factors
from repro.core.plan import plan as ref_plan
from repro.data import frostt as ref_frostt
from repro.distributed.dist_hooi import dist_hooi as ref_dist_hooi
from repro.engine import objective as ref_obj
from repro_torch import convert
from repro_torch.core import plan as port_plan
from repro_torch.core import stochastic
from repro_torch.core.hooi import hooi
from repro_torch.data import frostt
from repro_torch.distributed.dist_hooi import HooiExecutor, dist_hooi
from repro_torch.engine import objective as obj
from test_torch_hooi import assert_fits_match, jax_draws

CORE = (3, 3, 3)


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


def _nonneg_block_tensor(seed=0, shape=(16, 14, 12), rank=3, nnz=700):
    """``tests/test_objectives.py``'s block-supported nonnegative low-rank
    data (the reference's generator, so both packages see one tensor)."""
    rng = np.random.default_rng(seed)
    us = []
    for L in shape:
        f = np.zeros((L, rank))
        for j in range(rank):
            lo, hi = j * L // rank, (j + 1) * L // rank
            f[lo:hi, j] = np.abs(rng.standard_normal(hi - lo)) + 0.1
        us.append(f)
    g = np.abs(rng.standard_normal((rank,) * len(shape)))
    coords = np.unique(
        np.stack([rng.integers(0, L, 2 * nnz) for L in shape], axis=1),
        axis=0)[:nnz]
    vals = ref_obj.predict_at_coords(g, us, coords)
    return RefSparseTensor(coords, vals / max(vals.max(), 1e-12), shape)


# ------------------------------------------------------- masks and tokens
def test_holdout_mask_and_sample_unit_match_reference():
    idx = np.arange(5000, dtype=np.uint64) * np.uint64(7919)
    for seed in (0, 1, 123456789, -3):
        for dom in (stochastic.HOLDOUT_DOMAIN, stochastic.SAMPLE_DOMAIN,
                    stochastic.RESERVOIR_DOMAIN):
            np.testing.assert_array_equal(
                stochastic.splitmix64(idx, seed, dom),
                ref_stochastic.splitmix64(idx, seed, dom))
            np.testing.assert_array_equal(
                stochastic.sample_unit(idx, seed, dom),
                ref_stochastic.sample_unit(idx, seed, dom))
    assert (stochastic.SAMPLE_DOMAIN, stochastic.RESERVOIR_DOMAIN) == \
        (ref_stochastic.SAMPLE_DOMAIN, ref_stochastic.RESERVOIR_DOMAIN)
    for nnz, frac, seed in [(0, 0.5, 0), (100, 0.0, 0), (100, 1.0, 0),
                            (20000, 0.2, 0), (20000, 0.2, 1),
                            (777, 0.35, 9)]:
        np.testing.assert_array_equal(obj.holdout_mask(nnz, frac, seed),
                                      ref_obj.holdout_mask(nnz, frac, seed))
    # prefix-stable under appends
    np.testing.assert_array_equal(obj.holdout_mask(800, 0.2, 0)[:500],
                                  obj.holdout_mask(500, 0.2, 0))


PAIRS = [(obj.TuckerObjective(), ref_obj.TuckerObjective()),
         (obj.CompletionObjective(), ref_obj.CompletionObjective()),
         (obj.CompletionObjective(0.3, 5),
          ref_obj.CompletionObjective(0.3, 5)),
         (obj.NNTuckerObjective(), ref_obj.NNTuckerObjective()),
         (obj.NNTuckerObjective(admm_iters=4, ridge=0.1),
          ref_obj.NNTuckerObjective(admm_iters=4, ridge=0.1)),
         (obj.NNTuckerObjective(residual_balance=True),
          ref_obj.NNTuckerObjective(residual_balance=True))]


def test_cache_tokens_match_reference():
    tokens = set()
    for mine, ref in PAIRS:
        assert mine.cache_token() == ref.cache_token()
        assert mine.name == ref.name
        tokens.add(mine.cache_token())
    assert len(tokens) == len(PAIRS)


def test_resolve_objective(monkeypatch):
    monkeypatch.delenv("REPRO_OBJECTIVE", raising=False)
    assert obj.resolve_objective(None) == obj.TUCKER
    for name in ("tucker", "completion", "nn"):
        assert obj.resolve_objective(name).name == name
    inst = obj.CompletionObjective(holdout_fraction=0.3)
    assert obj.resolve_objective(inst) is inst
    monkeypatch.setenv("REPRO_OBJECTIVE", "nn")
    assert obj.resolve_objective(None).name == "nn"
    with pytest.raises(ValueError, match="unknown objective"):
        obj.resolve_objective("ridge")
    with pytest.raises(TypeError, match="Objective"):
        obj.resolve_objective(42)


def test_completion_view_matches_reference(small_tensor):
    t = _port(small_tensor)
    for mine, ref in PAIRS[1:3]:
        view = mine.prepare_tensor(t)
        want = ref.prepare_tensor(small_tensor)
        for name in ("coords", "values", "_holdout_coords",
                     "_holdout_values"):
            got, exp = getattr(view, name), getattr(want, name)
            assert got.dtype == exp.dtype
            np.testing.assert_array_equal(got, exp)
        assert view.fingerprint() == want.fingerprint()
        # memoized per source, idempotent on the view
        assert mine.prepare_tensor(t) is view
        assert mine.prepare_tensor(view) is view
    assert obj.CompletionObjective(0.0).prepare_tensor(t) is t


# ----------------------------------------------------------- numerics
@pytest.mark.parametrize("shape,core", [((9, 7, 8), (3, 2, 4)),
                                        ((5, 6, 4, 7), (2, 3, 2, 2))])
def test_predict_at_coords_matches_reference(shape, core):
    rng = np.random.default_rng(len(shape))
    g = rng.standard_normal(core)
    fs = [rng.standard_normal((L, k)).astype(np.float32)
          for L, k in zip(shape, core)]
    coords = np.stack([rng.integers(0, L, 3001) for L in shape], axis=1)
    want = ref_obj.predict_at_coords(g, fs, coords, chunk=1000)
    tf = [torch.from_numpy(f) for f in fs]
    for c, chunk in ((coords, 1000), (torch.from_numpy(coords), None)):
        got = obj.predict_at_coords(torch.from_numpy(g), tf, c, chunk=chunk)
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("kw", [dict(), dict(iters=8, rho=100.0, ridge=0.1),
                                dict(residual_balance=True),
                                dict(residual_balance=True, iters=8,
                                     rho=100.0, ridge=0.1)],
                         ids=["fixed", "fixed_overdamped", "balanced",
                              "balanced_overdamped"])
def test_admm_nonneg_factor_matches_reference(kw):
    import jax.numpy as jnp

    key = jax.random.PRNGKey(3)
    F, _ = jnp.linalg.qr(jax.random.normal(key, (60, 5), jnp.float32))
    S = jnp.asarray([8.0, 4.0, 2.0, 1.0, 0.5], jnp.float32)
    want = np.asarray(ref_obj.admm_nonneg_factor(F, S, **kw))
    got = obj.admm_nonneg_factor(torch.from_numpy(np.array(F)),
                                 torch.from_numpy(np.array(S)), **kw)
    assert float(got.min()) >= 0.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_nn_core_and_fit_match_reference():
    """Same core and factors in: the NN least-squares core within 1e-6 of
    its largest entry, the residual-expansion fit within 1e-6."""
    t = _nonneg_block_tensor(1)
    rng = np.random.default_rng(4)
    core = rng.standard_normal(CORE).astype(np.float32)
    fs = [np.abs(rng.standard_normal((L, 3))).astype(np.float32)
          for L in t.shape]
    mine, ref = obj.NNTuckerObjective(), ref_obj.NNTuckerObjective()
    got = mine.finalize_core(torch.from_numpy(core),
                             [torch.from_numpy(f) for f in fs])
    want = np.asarray(ref.finalize_core(core, fs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert mine.fit(_port(t), got, [torch.from_numpy(f) for f in fs]) == \
        pytest.approx(ref.fit(t, want, fs), rel=0, abs=1e-6)


# ------------------------------------------------------- whole paths
@pytest.mark.parametrize("objective,warm", [("completion", "none"),
                                            ("nn", "none"),
                                            ("completion", "sketch"),
                                            ("nn", "auto")])
def test_hooi_objectives_match_reference(small_tensor, objective, warm):
    t = small_tensor if objective == "completion" \
        else _nonneg_block_tensor()
    ref_out, out = {}, {}
    _, ref_fits = ref_hooi(t, CORE, n_invocations=3, seed=0,
                           objective=objective, warm_start=warm,
                           metrics_out=ref_out)
    init = ref_random_factors(t.shape, CORE, jax.random.PRNGKey(0))
    dec, fits = hooi(_port(t), CORE, n_invocations=3, seed=0,
                     init=[np.asarray(f) for f in init], draw=jax_draws(0),
                     objective=objective, warm_start=warm,
                     metrics_out=out, device="cpu")
    assert_fits_match(fits, ref_fits)
    if objective == "completion":
        np.testing.assert_allclose(out["holdout_rmse"],
                                   ref_out["holdout_rmse"], rtol=0,
                                   atol=1e-5)
    else:
        assert out == ref_out == {}
        for F in dec.factors:
            assert float(F.min()) >= 0.0
        assert all(np.isfinite(fits)) and max(fits) > 0.0


@pytest.mark.parametrize("P,path", [(4, "baseline"), (4, "liteopt")])
@pytest.mark.parametrize("objective", ["completion", "nn"])
def test_dist_objectives_match_reference(small_tensor, P, path, objective):
    t = small_tensor if objective == "completion" \
        else _nonneg_block_tensor()
    _, ref_st = ref_dist_hooi(t, CORE, P, scheme="lite", n_invocations=2,
                              path=path, seed=0, use_kernel=False,
                              objective=objective)
    init = ref_random_factors(t.shape, CORE, jax.random.PRNGKey(0))
    dec, st = dist_hooi(_port(t), CORE, P, scheme="lite", n_invocations=2,
                        path=path, seed=0, device="cpu", draw=jax_draws(0),
                        init=[np.asarray(f) for f in init],
                        objective=objective)
    assert st.objective == ref_st.objective == objective
    assert st.comm_backends == ref_st.comm_backends
    assert st.e_pad == ref_st.e_pad and st.r_pad == ref_st.r_pad
    assert_fits_match(st.fits, ref_st.fits)
    if objective == "completion":
        np.testing.assert_allclose(
            st.objective_metrics["holdout_rmse"],
            ref_st.objective_metrics["holdout_rmse"], rtol=0, atol=1e-5)
    else:
        assert st.objective_metrics is ref_st.objective_metrics is None
        for F in dec.factors:
            assert float(F.min()) >= 0.0


@pytest.mark.parametrize("objective", ["completion", "nn"])
def test_p1_objective_trajectory_matches_single_process(small_tensor,
                                                        objective):
    """P = 1 runs the local backend over the identity partition, and the
    objective refines each factor after the row-perm restore, so the
    trajectory (and completion's held-out RMSE) is ``hooi``'s, which the
    test above holds to the reference."""
    t = _port(small_tensor if objective == "completion"
              else _nonneg_block_tensor())
    out = {}
    _, fits = hooi(t, CORE, n_invocations=3, seed=0, objective=objective,
                   metrics_out=out, device="cpu")
    _, st = dist_hooi(t, CORE, 1, n_invocations=3, seed=0,
                      objective=objective, device="cpu")
    assert st.objective == objective
    assert set(st.comm_backends.values()) == {"local"}
    np.testing.assert_allclose(st.fits, fits, rtol=0, atol=1e-6)
    if objective == "completion":
        np.testing.assert_allclose(st.objective_metrics["holdout_rmse"],
                                   out["holdout_rmse"], rtol=0, atol=1e-6)


def test_default_objective_is_tucker_exactly(small_tensor, monkeypatch):
    """The default, ``"tucker"``, a zero-holdout completion and the loop
    without objective hooks are one trajectory, bitwise, on both entry
    points."""
    from repro_torch import convert as conv
    from repro_torch.core.hooi import random_factors
    from repro_torch.engine.steps import local_mode_step
    from repro_torch.engine.sweep import run_hooi_sweeps
    from repro_torch.random import make_key

    monkeypatch.delenv("REPRO_OBJECTIVE", raising=False)
    t = _port(small_tensor)
    kw = dict(n_invocations=2, seed=0, device="cpu")
    d0, f0 = hooi(t, CORE, **kw)
    d1, f1 = hooi(t, CORE, objective="tucker", **kw)
    _, f2 = hooi(t, CORE, objective=obj.CompletionObjective(0.0), **kw)
    assert f0 == f1 == f2
    assert torch.equal(d0.core, d1.core)
    # the historical composition: no objective in the step or the loop
    key = make_key(0)
    factors = random_factors(t.shape, CORE, key, "cpu")
    coords, values = conv.device_coords(t, torch.device("cpu"))
    dh, fh = run_hooi_sweeps(
        coords, values, t, factors, key, 2,
        lambda n, facs, kk: local_mode_step(coords, values, facs, n,
                                            t.shape[n], kk))
    assert fh == f0 and torch.equal(dh.core, d0.core)
    assert all(torch.equal(a, b) for a, b in zip(dh.factors, d0.factors))
    _, s0 = dist_hooi(t, CORE, 4, **kw)
    _, s1 = dist_hooi(t, CORE, 4, objective="tucker", **kw)
    assert s0.fits == s1.fits and s0.objective == "tucker"
    assert s0.objective_metrics is None


# ------------------------------------------------------------ plan files
def test_plan_cache_keys_on_objective(small_tensor):
    t = _port(small_tensor)
    pl_t = port_plan.plan(t, "lite", 2, core_dims=CORE)
    pl_c = port_plan.plan(t, "lite", 2, core_dims=CORE,
                          objective="completion")
    pl_n = port_plan.plan(t, "lite", 2, core_dims=CORE, objective="nn")
    assert len({id(pl_t), id(pl_c), id(pl_n)}) == 3
    assert (pl_t.objective, pl_c.objective, pl_n.objective) == \
        ("tucker", "completion", "nn")
    assert port_plan.plan(t, "lite", 2, core_dims=CORE,
                          objective="completion") is pl_c
    # the completion plan partitions the view; the NN plan's cost carries
    # the ADMM flops
    ref_c = ref_plan(small_tensor, "lite", 2, core_dims=CORE,
                     objective="completion", use_cache=False)
    assert pl_c.fingerprint == ref_c.fingerprint
    assert pl_n.cost.svd_s > pl_t.cost.svd_s


def _same_parts(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if isinstance(u, np.ndarray):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


@pytest.mark.parametrize("objective", ["tucker", "completion"])
def test_reference_plan_file_loads_in_port(small_tensor, tmp_path,
                                           objective):
    ref_pl = ref_plan(small_tensor, "lite", 4, core_dims=CORE,
                      objective=objective, use_cache=False)
    f = str(tmp_path / "plan.npz")
    ref_pl.save(f)
    t = _port(small_tensor)
    pl = port_plan.load_plan(f, t, objective=objective)
    assert pl.objective == objective and pl.P == 4
    assert pl.fingerprint == ref_pl.fingerprint
    assert dataclasses.asdict(pl.cost) == dataclasses.asdict(ref_pl.cost)
    assert pl.core_dims == ref_pl.core_dims
    _same_parts(pl.parts, ref_pl.parts)
    other = "tucker" if objective == "completion" else "nn"
    with pytest.raises(ValueError, match="refusing"):
        port_plan.PartitionPlan.load(f, t, objective=other)
    # the loaded plan runs, and a port-written file loads in the reference
    _, st = dist_hooi(t, CORE, 4, scheme=pl, n_invocations=1, seed=0,
                      device="cpu", objective=objective)
    assert st.objective == objective
    g = str(tmp_path / "port.npz")
    pl.save(g)
    back = type(ref_pl).load(g, small_tensor, objective=objective)
    _same_parts(back.parts, ref_pl.parts)


def test_plan_file_refuses_stale_tensor_and_version(small_tensor, tmp_path):
    t = _port(small_tensor)
    pl = port_plan.plan(t, "lite", 2, core_dims=CORE)
    f = str(tmp_path / "plan.npz")
    pl.save(f)
    _same_parts(port_plan.load_plan(f, t).parts, pl.parts)
    other = convert.sparse_tensor(t.coords, t.values * 2.0, t.shape)
    with pytest.raises(ValueError, match="stale"):
        port_plan.load_plan(f, other)
    import json
    with np.load(f) as z:
        arrays = dict(z)
    meta = json.loads(str(arrays.pop("__meta__")))
    meta["version"] = 99
    g = str(tmp_path / "v99.npz")
    np.savez(g, __meta__=np.array(json.dumps(meta)), **arrays)
    with pytest.raises(ValueError, match="version"):
        port_plan.load_plan(g, t)


def test_executor_refuses_objective_mismatched_plan(small_tensor):
    t = _port(small_tensor)
    pl = port_plan.plan(t, "lite", 1, core_dims=CORE)
    with pytest.raises(ValueError, match="objective"):
        HooiExecutor(1, "cpu").run(t, CORE, pl, n_invocations=1,
                                   objective="nn")


# ------------------------------------------------------------ FROSTT layer
def test_tns_readers_match_reference(small_tensor, tmp_path):
    path = str(tmp_path / "t.tns")
    write_tns(path, small_tensor)
    for shape in (None, small_tensor.shape, (30, 30, 30)):
        got = frostt.load_tns(path, shape=shape)
        want = ref_frostt.load_tns(path, shape=shape)
        assert got.shape == want.shape
        for name in ("coords", "values"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for batch in (1, 150, 10_000):
        got = list(frostt.iter_tns_batches(path, batch_nnz=batch))
        want = list(ref_frostt.iter_tns_batches(path, batch_nnz=batch))
        assert len(got) == len(want)
        for (gc, gv), (wc, wv) in zip(got, want):
            np.testing.assert_array_equal(gc, wc)
            np.testing.assert_array_equal(gv, wv)


def test_tns_malformed_inputs(tmp_path):
    cases = {"zero.tns": ("0 1 1 3.0\n", "1-based"),
             "ragged.tns": ("1 1 1 3.0\n2 2 0.5\n", "inconsistent"),
             "empty.tns": ("# only a comment\n", "no elements")}
    for name, (text, match) in cases.items():
        p = tmp_path / name
        p.write_text(text)
        for load in (frostt.load_tns, ref_frostt.load_tns):
            with pytest.raises(ValueError, match=match):
                load(str(p))
    ok = tmp_path / "ok.tns"
    ok.write_text("# c\n% c\n\n1 1 1 3.0\n3 2 4 -1.5\n")
    assert frostt.load_tns(str(ok)).shape == (3, 2, 4)
    with pytest.raises(ValueError, match="batch_nnz"):
        list(frostt.iter_tns_batches(str(ok), batch_nnz=0))
    with pytest.raises(ValueError, match="modes"):
        frostt.load_tns(str(ok), shape=(4, 4))
