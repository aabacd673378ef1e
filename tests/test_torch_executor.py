"""The port's executor caches, calibration and factor coercion, against the
reference.

Twins of ``tests/test_executor.py`` and of ``tests/test_engine.py``'s
``test_rerun_contract_all_backends`` and
``test_executor_samples_carry_backend_label``: a rerun on a cached plan
compiles and uploads nothing, padded shapes and loaded plans share steps,
an ``auto`` plan shares its winner's upload, the step cache is LRU bounded,
``dist_hooi`` shares one executor, and every sweep leaves a calibration
sample. ``step_compilations``, ``step_cache_hits``, ``upload_cache_hit``
and the sample fields equal the reference's; ``uploads`` is the port's own
count, ``10 N + 2`` for a plan (``DistHooiStats``). Here on the CPU the
steps run eagerly and nothing is captured. Also: ``fit_cost_model`` and
``resolve_precision("auto")`` against the reference's, and
``_coerce_factors`` (truncation and completion) with the reference's
draws injected through the seam.
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.core.calibrate import CostModel as RefCostModel
from repro.core.calibrate import fit_cost_model as ref_fit_cost_model
from repro.core.calibrate import set_cost_model as ref_set_cost_model
from repro.core.hooi import random_factors as ref_random_factors
from repro.core.plan import plan as ref_plan
from repro.distributed.executor import HooiExecutor as RefExecutor
from repro.distributed.executor import _coerce_factors as ref_coerce
from repro.engine.zbuild import resolve_precision as ref_resolve_precision
from repro_torch import convert
from repro_torch.core import plan as port_plan
from repro_torch.core.calibrate import (CostModel, fit_cost_model,
                                        set_cost_model)
from repro_torch.distributed import executor as exmod
from repro_torch.distributed.dist_hooi import dist_hooi, shared_executor
from repro_torch.engine.oracle import ModeSpec
from repro_torch.engine.zbuild import resolve_precision
from repro_torch.random import Key
from test_calibrate import _phase_samples, _samples
from test_torch_hooi import assert_fits_match, jax_draws

CORE = (2, 2, 2)
N = 3
PLAN_UPLOADS = exmod.ARRAYS_PER_MODE * N + 2  # the port's count, 32


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


@pytest.fixture(autouse=True)
def _restore_models():
    yield
    set_cost_model(None)
    ref_set_cost_model(None)


@pytest.fixture
def executor():
    return exmod.HooiExecutor(4, "cpu")


# ------------------------------------------------------------ cache layers
@pytest.mark.parametrize("P,path,backend", [
    (1, "liteopt", "local"),
    (4, "baseline", "psum"),
    (4, "liteopt", "boundary"),
])
def test_rerun_contract_all_backends(lowrank_tensor, P, path, backend):
    """A cached-plan rerun compiles and uploads nothing, on every backend."""
    t = _port(lowrank_tensor)
    ex = exmod.HooiExecutor(P, "cpu")
    pl = port_plan.plan(t, "lite", P, core_dims=CORE, path=path)
    _, s1 = ex.run(t, CORE, pl, n_invocations=1, seed=0, path=path)
    assert set(s1.comm_backends.values()) == {backend}
    assert s1.step_compilations == N and s1.step_captures == 0
    assert s1.uploads == PLAN_UPLOADS and not s1.upload_cache_hit
    _, s2 = ex.run(t, CORE, pl, n_invocations=1, seed=1, path=path)
    assert s2.step_compilations == 0
    assert s2.uploads == 0
    assert s2.upload_cache_hit
    assert s2.step_cache_hits == N
    assert s2.executor["runs"] == 2
    assert s2.fits[-1] > 0.99


def test_counters_and_samples_equal_reference(lowrank_tensor):
    """Two runs and a profile on one executor each: every counter but
    ``uploads`` and every calibration-sample field but the seconds equal
    the reference's; fits within 1e-4 with the reference's draws."""
    t = lowrank_tensor
    ref = RefExecutor(4)
    ex = exmod.HooiExecutor(4, "cpu")
    rpl = ref_plan(t, "lite", 4, core_dims=CORE)
    pl = port_plan.plan(_port(t), "lite", 4, core_dims=CORE)
    init = [np.asarray(f) for f in
            ref_random_factors(t.shape, CORE, jax.random.PRNGKey(0))]
    for seed, inv in ((0, 2), (1, 1)):
        _, rs = ref.run(t, CORE, rpl, n_invocations=inv, seed=seed,
                        use_kernel=False, init_factors=init)
        _, st = ex.run(_port(t), CORE, pl, n_invocations=inv, seed=seed,
                       draw=jax_draws(seed), init_factors=init)
        for f in ("step_compilations", "step_cache_hits",
                  "upload_cache_hit", "comm_backends", "lanczos_block",
                  "z_passes", "warm_start", "precision", "scheme"):
            assert getattr(st, f) == getattr(rs, f), f
        assert_fits_match(st.fits, rs.fits)
    assert st.uploads == 0 and rs.uploads == 0
    ref.profile_phases(t, CORE, rpl, use_kernel=False, repeats=1)
    prof = ex.profile_phases(_port(t), CORE, pl, repeats=1)
    assert set(prof) == {"ttm_s", "full_s", "svd_s", "per_mode", "z_kernel"}
    assert prof["z_kernel"] == {0: False, 1: False, 2: False}
    got, want = ex.calibration_samples(), ref.calibration_samples()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k != "seconds"} == \
            {k: v for k, v in w.items() if k != "seconds"}
        assert g["seconds"] > 0
    stats, ref_stats = ex.stats(), ref.stats()
    for k in ("runs", "step_compilations", "step_cache_hits",
              "upload_cache_hits", "cached_steps", "cached_plans"):
        assert stats[k] == ref_stats[k], k


def test_identical_padded_shapes_share_steps(executor, lowrank_tensor):
    """A second tensor whose partitions pad to the same shapes reuses every
    step; only its arrays move."""
    t1 = _port(lowrank_tensor)
    t2 = convert.sparse_tensor(t1.coords, t1.values * 1.5, t1.shape)
    assert t1.fingerprint() != t2.fingerprint()
    _, s1 = executor.run(t1, CORE, "lite", n_invocations=1, seed=0)
    assert s1.step_compilations == N
    _, s2 = executor.run(t2, CORE, "lite", n_invocations=1, seed=0)
    assert s2.step_compilations == 0
    assert s2.uploads == PLAN_UPLOADS
    _, s3 = executor.run(t1, CORE, "lite", n_invocations=1, seed=1)
    assert s3.step_compilations == 0 and s3.uploads == 0
    assert s3.executor["cached_plans"] == 2


def test_loaded_plan_reuses_steps(executor, lowrank_tensor, tmp_path):
    """A saved and loaded plan skips partitioning and compilation; only its
    upload is paid."""
    t = _port(lowrank_tensor)
    pl = port_plan.plan(t, "lite", 4, core_dims=CORE)
    _, s1 = executor.run(t, CORE, pl, n_invocations=1, seed=0)
    path = str(tmp_path / "plan.npz")
    pl.save(path)
    loaded = port_plan.PartitionPlan.load(path, t)
    assert loaded is not pl
    _, s2 = executor.run(t, CORE, loaded, n_invocations=1, seed=0)
    assert s2.step_compilations == 0
    assert s2.uploads == PLAN_UPLOADS
    assert abs(s2.fits[-1] - s1.fits[-1]) < 1e-6


def test_auto_plan_shares_upload_with_winner(executor, lowrank_tensor):
    """An ``auto`` plan shares its winning candidate's parts: the arrays go
    up once."""
    t = _port(lowrank_tensor)
    _, s1 = executor.run(t, CORE, "auto", n_invocations=1, seed=0)
    assert s1.uploads == PLAN_UPLOADS
    _, s2 = executor.run(t, CORE, s1.scheme, n_invocations=1, seed=1)
    assert s2.uploads == 0
    assert s2.upload_cache_hit
    assert s2.step_compilations == 0


def test_step_cache_is_bounded(monkeypatch):
    """The step cache is LRU bounded; evicting a step forgets its shape
    signatures, so a re-made step counts its compilations again."""
    ex = exmod.HooiExecutor(4, "cpu")
    monkeypatch.setattr(exmod, "MAX_COMPILED_STEPS", 2)

    class FakeMP:  # only the static-signature fields are read
        P = 4

        def __init__(self, mode):
            self.mode, self.R_pad, self.Lp, self.S_pad = mode, 8, 3, 1

    spec = ModeSpec(backend="boundary", K_n=2, niter=4)
    k0, s0 = ex._get_step(FakeMP(0), spec)
    ex._seen_shapes.add((k0, ("fake",)))
    k1, _ = ex._get_step(FakeMP(1), spec)
    assert ex._get_step(FakeMP(0), spec)[1] is s0  # hit -> MRU
    k2, _ = ex._get_step(FakeMP(2), spec)  # evicts k1, not k0
    assert len(ex._steps) == 2
    assert k0 in ex._steps and k2 in ex._steps and k1 not in ex._steps
    assert ex._get_step(FakeMP(0), spec)[1] is s0
    assert (k0, ("fake",)) in ex._seen_shapes
    ex._get_step(FakeMP(3), spec)  # evicts k2; k0 is MRU
    ex._get_step(FakeMP(4), spec)  # now evicts k0
    assert k0 not in ex._steps
    assert (k0, ("fake",)) not in ex._seen_shapes


def test_dist_hooi_shares_engine(lowrank_tensor):
    """``dist_hooi`` runs on ``shared_executor(P, device)``: a repeated call
    compiles and uploads nothing."""
    t = _port(lowrank_tensor)
    assert shared_executor(4, "cpu") is shared_executor(4, "cpu")
    assert shared_executor(2, "cpu") is not shared_executor(4, "cpu")
    _, s1 = dist_hooi(t, CORE, 4, scheme="lite", n_invocations=1, seed=0,
                      device="cpu")
    _, s2 = dist_hooi(t, CORE, 4, scheme="lite", n_invocations=1, seed=1,
                      device="cpu")
    assert s2.plan_cache_hit
    assert s2.step_compilations == 0
    assert s2.uploads == 0
    assert s2.upload_cache_hit
    assert s2.executor["runs"] >= 2


def test_stage_upload_and_prepare(executor, lowrank_tensor):
    """``prepare`` builds the plan and stages its arrays; the following run
    uploads nothing, and staging again moves nothing."""
    t = _port(lowrank_tensor)
    pl, rep = executor.prepare(t, CORE, "lite")
    assert rep == {"uploads": PLAN_UPLOADS, "already_resident": False}
    assert executor.stage_upload(pl, t) == {"uploads": 0,
                                            "already_resident": True}
    _, st = executor.run(t, CORE, pl, n_invocations=1)
    assert st.uploads == 0 and st.upload_cache_hit
    with pytest.raises(ValueError, match="unknown path"):
        executor.prepare(t, CORE, "lite", path="nowhere")


def test_executor_rejects_mismatched_plan(executor, lowrank_tensor):
    t = _port(lowrank_tensor)
    pl = port_plan.plan(t, "lite", 2, core_dims=CORE)
    with pytest.raises(ValueError, match="P=2"):
        executor.run(t, CORE, pl, n_invocations=1)
    pl4 = port_plan.plan(t, "lite", 4, core_dims=CORE)
    other = convert.sparse_tensor(t.coords, t.values + 1.0, t.shape)
    with pytest.raises(ValueError, match="built for tensor"):
        executor.run(other, CORE, pl4, n_invocations=1)
    with pytest.raises(ValueError, match="core_dims"):
        executor.run(t, (3, 3, 3), pl4, n_invocations=1)
    with pytest.raises(ValueError, match="path"):
        executor.run(t, CORE, pl4, n_invocations=1, path="baseline")


# ------------------------------------------------------------- calibration
def test_executor_records_calibration_samples(executor, lowrank_tensor):
    t = _port(lowrank_tensor)
    executor.run(t, CORE, "lite", n_invocations=2, seed=0)
    executor.run(t, CORE, "lite", n_invocations=1, seed=1)
    samples = executor.calibration_samples()
    assert len(samples) == 3
    assert all(s["seconds"] > 0 for s in samples)
    assert samples[0]["warm"] is False  # the first sweep compiled
    assert all(s["warm"] for s in samples[1:])
    cm = fit_cost_model(samples)
    assert cm.flop_rate > 0 and cm.source.startswith("fitted:")


def test_executor_samples_carry_backend_label(executor, lowrank_tensor):
    t = _port(lowrank_tensor)
    executor.run(t, CORE, "lite", n_invocations=1, seed=0)
    executor.run(t, CORE, "lite", n_invocations=1, seed=0, path="baseline")
    labels = {s["comm_backend"] for s in executor.calibration_samples()}
    assert labels == {"boundary", "psum"}


def _fields(cm) -> dict:
    return dataclasses.asdict(cm)


@pytest.mark.parametrize("case", [
    "joint", "degenerate", "overpredicted", "cold", "phases",
    "phases_degenerate", "phases_comm_degenerate", "bf16_and_backends"])
def test_fit_cost_model_bit_identical(case):
    """The samples of ``tests/test_calibrate.py`` (and a bf16-labelled,
    backend-labelled set): the port's fit is the reference's, bit for
    bit."""
    bw = RefCostModel().net_bandwidth
    samples = {
        "joint": _samples(2.0e10, 5.0e9, [(1e9, 1e6), (4e9, 1e6),
                                          (1e9, 8e8), (2e9, 4e8)]),
        "degenerate": _samples(1.0e9, bw, [(1e9, 1e5), (1e9, 1e5)]),
        "overpredicted": [{"critical_path_flops": 1e7, "comm_bytes": 1e11,
                           "seconds": 1e-3} for _ in range(3)],
        "cold": _samples(1.0e10, 1.0e10, [(1e9, 1e6), (3e9, 5e8)]) + [
            {"critical_path_flops": 1e9, "comm_bytes": 1e6,
             "seconds": 50.0, "warm": False}],
        "phases": _phase_samples(4.0e10, 1.0e10, 5.0e9, [
            (1e9, 0.0, 0.0), (1e9, 2e9, 1e6), (3e9, 1e9, 8e8),
            (2e9, 4e9, 4e8)]),
        "phases_degenerate": _phase_samples(2.0e10, 2.0e10, bw, [
            (1e9, 2e9, 1e5), (2e9, 4e9, 2e5), (4e9, 8e9, 4e5)]),
        "phases_comm_degenerate": _phase_samples(4.0e10, 1.0e10, bw, [
            (1e9, 0.0, 0.0), (1e9, 2e9, 0.0), (3e9, 1e9, 0.0)]),
    }.get(case)
    if samples is None:
        samples = _phase_samples(4.0e10, 1.0e10, 5.0e9, [
            (1e9, 0.0, 0.0), (1e9, 2e9, 1e6), (3e9, 1e9, 8e8)])
        for s, b in zip(samples, ("psum", "boundary", "psum")):
            s.update(comm_backend=b, precision="f32", phase="sweep")
        samples.append({"ttm_flops": 1e9, "svd_flops": 0.0,
                        "critical_path_flops": 1e9, "comm_bytes": 0.0,
                        "seconds": 1e9 / 9e10, "precision": "bf16",
                        "phase": "ttm"})
    assert _fields(fit_cost_model(samples)) == \
        _fields(ref_fit_cost_model(samples))


def test_fit_on_port_samples_bit_identical(executor, lowrank_tensor):
    """The samples a port run and profile record fit to the same model
    under either package's fitter."""
    t = _port(lowrank_tensor)
    executor.run(t, CORE, "lite", n_invocations=2, seed=0)
    executor.profile_phases(t, CORE, "lite", repeats=2)
    executor.profile_phases(t, CORE, "lite", repeats=1, precision="bf16")
    samples = executor.calibration_samples()
    assert [s.get("phase") for s in samples[2:]] == ["ttm", "sweep"] * 2
    assert _fields(fit_cost_model(samples)) == \
        _fields(ref_fit_cost_model(samples))


@pytest.mark.parametrize("bf16_over_f32", [None, 1.0, 1.05, 1.06, 2.0])
def test_resolve_precision_auto_matches_reference(monkeypatch,
                                                  bf16_over_f32):
    monkeypatch.delenv("REPRO_PRECISION", raising=False)
    kw = dict(flop_rate=2e10, ttm_flop_rate=4e10, source="test")
    if bf16_over_f32 is not None:
        kw["ttm_flop_rate_bf16"] = 4e10 * bf16_over_f32
    set_cost_model(CostModel(**kw))
    ref_set_cost_model(RefCostModel(**kw))
    for p in ("auto", None, "f32", "bf16"):
        assert resolve_precision(p) == ref_resolve_precision(p)
    want = "bf16" if bf16_over_f32 and bf16_over_f32 > 1.05 else "f32"
    assert resolve_precision("auto") == want
    monkeypatch.setenv("REPRO_PRECISION", "bf16")
    assert resolve_precision("auto") == ref_resolve_precision("auto")


def test_precision_auto_runs_on_both_entry_points(lowrank_tensor):
    """With a fitted bf16 rate above 1.05x the f32 one, ``"auto"`` runs
    bf16 on ``dist_hooi`` as on the reference."""
    set_cost_model(CostModel(flop_rate=2e10, ttm_flop_rate=1e10,
                             ttm_flop_rate_bf16=2e10, source="test"))
    t = _port(lowrank_tensor)
    _, st = exmod.HooiExecutor(1, "cpu").run(t, CORE, "lite",
                                             n_invocations=1,
                                             precision="auto")
    assert st.precision == "bf16"


# -------------------------------------------------------- factor coercion
@pytest.mark.parametrize("k_in,k_out", [(3, 2), (2, 3), (3, 3)])
def test_coerce_factors_matches_reference(k_in, k_out):
    """Truncation and completion (a QR'd complement drawn at
    ``fold_in(key, 4100 + n)``) within 1e-6 of the reference's."""
    shape = (12, 10, 8)
    key = jax.random.PRNGKey(5)
    init = [np.asarray(f) for f in
            ref_random_factors(shape, (k_in,) * 3, jax.random.PRNGKey(1))]
    want = ref_coerce(init, shape, (k_out,) * 3, key)
    got = exmod._coerce_factors(init, shape, (k_out,) * 3,
                                Key(jax_draws(5)), exmod.resolve_device("cpu"))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (g.shape[0], k_out)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="rows"):
        exmod._coerce_factors([f[:-1] for f in init], shape, (k_out,) * 3,
                              Key(jax_draws(5)), exmod.resolve_device("cpu"))


@pytest.mark.parametrize("k_in", [4, 2])
def test_dist_hooi_coerces_init_factors(small_tensor, k_in):
    """``init`` factors wider (or narrower) than the core are truncated (or
    completed) as the reference does, so the run follows the reference's
    trajectory; passed through unchanged they would build Z from the wrong
    widths."""
    t = small_tensor
    core = (3, 3, 3)
    init = [np.asarray(f) for f in
            ref_random_factors(t.shape, (k_in,) * 3, jax.random.PRNGKey(9))]
    _, rs = RefExecutor(4).run(t, core, "lite", n_invocations=2, seed=0,
                          use_kernel=False, lanczos_block=4,
                          fused_zbuild=True, init_factors=init)
    dec, st = dist_hooi(_port(t), core, 4, scheme="lite", n_invocations=2,
                        seed=0, device="cpu", draw=jax_draws(0),
                        lanczos_block=4, fused_zbuild=True, init=init)
    assert [tuple(F.shape) for F in dec.factors] == \
        [(L, 3) for L in t.shape]
    assert_fits_match(st.fits, rs.fits)
