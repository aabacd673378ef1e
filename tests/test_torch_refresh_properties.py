"""Property tests of the port's refresh ladder, held to the reference's.

Twin of ``tests/test_refresh_properties.py`` (hypothesis when installed,
the seeded fallback otherwise):

* ``refresh_decision`` is monotone in drift (more load on the heaviest rank
  never moves a decision down the ladder) and in ``tol``, and on every
  drawn instance returns exactly the reference's decision and drift;
* ``extend_scheme`` is an extension: old elements keep their owners, new
  ones join their slice's owner, exactly as the reference extends;
* on streams, over fixed append schedules, the port's scheduler takes the
  reference's decision at every submit: ``reuse`` compiles, captures and
  uploads nothing; ``stochastic-refine`` never fires on an unchanged
  version; a fixed-seed schedule reproduces its own trajectory bitwise
  and the reference's within 1e-4 (its draws injected); sampling every
  appended element with a correction cadence lands within 5e-2 of the
  sampling-off trajectory.
"""

import numpy as np
from _hypothesis_compat import given, settings, st

from repro.core import plan as ref_plan
from repro.distributed.executor import HooiExecutor as RefExecutor
from repro.engine.scheduler import StreamScheduler as RefScheduler
from repro.streaming import StreamingTensor as RefStream
from repro_torch import convert
from repro_torch.core.plan import (extend_scheme, plan, refresh_decision,
                                   slice_owner_maps)
from repro_torch.distributed.executor import HooiExecutor
from repro_torch.engine.scheduler import StreamScheduler
from repro_torch.streaming import StreamingTensor
from test_torch_hooi import assert_fits_match, jax_draws

CORE = (2, 2, 2)
SHAPE = (20, 16, 12)
LADDER = {"stochastic-refine": 0, "repartition": 1, "reselect": 2}


def _tiny_plans(seed=0, nnz=120):
    from repro.core.coo import SparseTensor

    r = np.random.default_rng(seed)
    coords = np.stack([r.integers(0, L, nnz) for L in SHAPE], axis=1)
    t = SparseTensor(coords, r.standard_normal(nnz), SHAPE).dedup()
    pt = convert.sparse_tensor(t.coords, t.values, t.shape)
    return (t, ref_plan.plan(t, "lite", 2, core_dims=CORE),
            pt, plan(pt, "lite", 2, core_dims=CORE))


def _loads(rng, P, nmodes, lo=1, hi=200):
    return [rng.integers(lo, hi, size=P).astype(np.float64)
            for _ in range(nmodes)]


def _decide(pls, loads, **kw):
    """The port's decision, checked equal to the reference's."""
    rp, pp = pls
    got = refresh_decision(pp, loads, **kw)
    assert got == ref_plan.refresh_decision(rp, loads, **kw)
    return got


# ------------------------------------------------------ refresh_decision
@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       extra=st.integers(min_value=1, max_value=500))
def test_drift_monotone_under_hotspot_growth(seed, extra):
    _, rp, _, pp = _tiny_plans()
    rng = np.random.default_rng(seed)
    loads = _loads(rng, pp.P, pp.nmodes)
    baseline = [1.0 + rng.uniform(0.0, 0.5) for _ in range(pp.nmodes)]
    tol = float(rng.uniform(0.05, 0.5))
    dec0, drift0 = _decide((rp, pp), loads, tol=tol, baseline=baseline)
    hot = [lv.copy() for lv in loads]
    for n in range(pp.nmodes):
        hot[n][int(np.argmax(hot[n]))] += extra
    dec1, drift1 = _decide((rp, pp), hot, tol=tol, baseline=baseline)
    assert drift1["worst"] >= drift0["worst"] - 1e-12
    if dec0 == "reselect":
        assert dec1 == "reselect"


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_decision_monotone_in_tol(seed):
    _, rp, _, pp = _tiny_plans()
    rng = np.random.default_rng(seed)
    loads = _loads(rng, pp.P, pp.nmodes)
    baseline = [1.0] * pp.nmodes
    tols = sorted(float(x) for x in rng.uniform(0.01, 1.0, size=3))
    decisions, drifts = [], []
    for tol in tols:
        d, dr = _decide((rp, pp), loads, tol=tol, baseline=baseline)
        decisions.append(d)
        drifts.append(dr["worst"])
    assert len(set(drifts)) == 1
    for a, b in zip(decisions, decisions[1:]):
        if a == "repartition":
            assert b == "repartition"


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       extra=st.integers(min_value=1, max_value=500))
def test_four_rung_ladder_monotone_in_drift(seed, extra):
    _, rp, _, pp = _tiny_plans()
    rng = np.random.default_rng(seed)
    loads = _loads(rng, pp.P, pp.nmodes)
    baseline = [1.0 + rng.uniform(0.0, 0.5) for _ in range(pp.nmodes)]
    tol = float(rng.uniform(0.05, 0.5))
    stoch = {"sampled_nnz": 1, "total_nnz": 10_000}
    dec0, drift0 = _decide((rp, pp), loads, tol=tol, baseline=baseline,
                           stochastic=stoch)
    hot = [lv.copy() for lv in loads]
    for n in range(pp.nmodes):
        hot[n][int(np.argmax(hot[n]))] += extra
    dec1, drift1 = _decide((rp, pp), hot, tol=tol, baseline=baseline,
                           stochastic=stoch)
    assert drift1["worst"] >= drift0["worst"] - 1e-12
    assert LADDER[dec1] >= LADDER[dec0]


# --------------------------------------------------------- extend_scheme
@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000),
       batch=st.integers(min_value=1, max_value=64))
def test_extend_scheme_preserves_existing_owners(seed, batch):
    t, rp, pt, pp = _tiny_plans(seed=seed % 7)
    maps = slice_owner_maps(pp, pt)
    for a, b in zip(maps, ref_plan.slice_owner_maps(rp, t), strict=True):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(seed)
    new_coords = np.stack([rng.integers(0, L, batch) for L in SHAPE], axis=1)
    ext = extend_scheme(pp.scheme, maps, new_coords)
    want = ref_plan.extend_scheme(rp.scheme, maps, new_coords)
    assert ext.P == pp.scheme.P and ext.uni is False
    for n in range(pp.nmodes):
        old = np.asarray(pp.scheme.policy(n))
        new = np.asarray(ext.policy(n))
        np.testing.assert_array_equal(new, want.policy(n))
        assert len(new) == len(old) + batch
        np.testing.assert_array_equal(new[:len(old)], old)
        np.testing.assert_array_equal(new[len(old):],
                                      np.asarray(maps[n])[new_coords[:, n]])


# ------------------------------------------------------ stream schedules
def _schedule(port, appends, n0=150, seed=1234, steps=6, kw=None,
              submit_seed=None):
    """One append schedule through a scheduler on P = 2: ``appends(rng,
    step)`` returns the batch size to append before submit ``step`` (0 for
    none). Returns the results of every submit."""
    rng = np.random.default_rng(seed)
    stream = (StreamingTensor if port else RefStream)(SHAPE, name="prop")
    coords = np.stack([rng.integers(0, L, n0) for L in SHAPE], axis=1)
    stream.append(coords, rng.standard_normal(n0))
    ex = HooiExecutor(2, "cpu") if port else RefExecutor(2)
    sched_cls = StreamScheduler if port else RefScheduler
    out = []
    with sched_cls(ex, CORE, n_invocations=1, workers=2,
                   **(kw or {})) as sched:
        for step in range(steps + 1):
            b = appends(rng, step) if step else 0
            if b:
                c = np.stack([rng.integers(0, L, b) for L in SHAPE], axis=1)
                stream.append(c, rng.standard_normal(b))
            s = step if submit_seed is None else submit_seed(step)
            extra = dict(draw=jax_draws(s)) if port else {}
            out.append(sched.submit(stream, seed=s, **extra).result())
    return out


def _assert_same_trajectory(got, want):
    assert [r.decision for r in got] == [r.decision for r in want]
    for g, w in zip(got, want):
        assert g.drift == w.drift
        assert g.stats.sample_nnz == w.stats.sample_nnz
        assert_fits_match(g.fits, w.fits)


def _random_appends(rng, step):
    return int(rng.integers(5, 30)) if rng.random() < 0.5 else 0


def test_reuse_means_no_capture_no_uploads_random_schedule():
    kw = dict(pad_geometric=True)
    got = _schedule(True, _random_appends, kw=kw)
    _assert_same_trajectory(got, _schedule(False, _random_appends, kw=kw))
    assert "reuse" in [r.decision for r in got]
    for step, r in enumerate(got):
        if r.decision == "reuse":
            assert (r.stats.step_compilations, r.stats.step_captures,
                    r.stats.uploads) == (0, 0, 0), step


def test_stochastic_never_fires_on_unchanged_version():
    def appends(rng, step):
        return int(rng.integers(10, 30)) if step in (1, 3, 4) else 0

    kw = dict(sample_fraction=0.5, replay_nnz=32, stochastic_tol=0.25,
              correction_every=0)
    got = _schedule(True, appends, seed=7, steps=7, kw=kw,
                    submit_seed=lambda step: 0)
    _assert_same_trajectory(got, _schedule(False, appends, seed=7, steps=7,
                                           kw=kw, submit_seed=lambda s: 0))
    last = None
    for step, r in enumerate(got):
        if r.stream_version == last:
            assert r.decision != "stochastic-refine", step
        last = r.stream_version
    assert "stochastic-refine" in [r.decision for r in got]


def test_fixed_seed_schedule_reproduces_trajectory_bitwise():
    kw = dict(sample_fraction=0.5, sample_seed=9, replay_nnz=32,
              stochastic_tol=0.25, correction_every=3)

    def appends(rng, step):
        return 19 + step

    a = _schedule(True, appends, seed=42, steps=5, kw=kw)
    b = _schedule(True, appends, seed=42, steps=5, kw=kw)
    assert "stochastic-refine" in [r.decision for r in a]
    for x, y in zip(a, b, strict=True):
        assert (x.decision, x.stats.sample_nnz) == \
            (y.decision, y.stats.sample_nnz)
        assert x.fits == y.fits  # bitwise: no tolerance
    _assert_same_trajectory(a, _schedule(False, appends, seed=42, steps=5,
                                         kw=kw))


def test_fraction_one_with_correction_matches_full_sweep():
    kw = dict(sample_fraction=1.0, replay_nnz=64, stochastic_tol=0.25,
              correction_every=2)
    sampled = _schedule(True, lambda rng, step: 25, n0=300, seed=11, steps=4,
                        kw=kw)
    full = _schedule(True, lambda rng, step: 25, n0=300, seed=11, steps=4)
    assert "stochastic-refine" in [r.decision for r in sampled]
    assert abs(float(sampled[-1].fits[-1]) - float(full[-1].fits[-1])) <= 5e-2
