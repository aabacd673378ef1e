"""The port's ``StreamScheduler`` against the reference's.

Twin of ``tests/test_scheduler.py``. The reference runs on
``HooiExecutor(P)`` over the conftest's simulated host devices, the port on
P ranks stacked on the CPU, with the reference's draws injected through
each submit's ``draw`` (``test_torch_hooi.jax_draws`` of the submit's
seed). On the same submits and appends the two give the same decisions and
the same drift dicts (numpy on both sides, so equal), and fits within 1e-4
(the energy share near a fit of 1, ``assert_fits_match``). The port's own
contracts: a scheduled run is bitwise a direct ``HooiExecutor.run`` on the
same plan and seed; ``reuse`` compiles, captures and uploads nothing; a
producer failure or a cancelled future does not wedge the pipeline; a
closed scheduler refuses submits.
"""

import numpy as np
import pytest

from repro.distributed.executor import HooiExecutor as RefExecutor
from repro.engine.scheduler import StreamScheduler as RefScheduler
from repro.streaming import StreamingTensor as RefStream
from repro_torch import convert
from repro_torch.core.coo import SparseTensor
from repro_torch.distributed.executor import HooiExecutor
from repro_torch.engine.scheduler import (DECISIONS, MAX_RETAINED_FUTURES,
                                          ScheduledResult, StreamScheduler)
from repro_torch.streaming import StreamingTensor
from test_torch_hooi import assert_fits_match, jax_draws

CORE = (2, 2, 2)


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


@pytest.fixture
def executor():
    return HooiExecutor(4, "cpu")


@pytest.fixture
def scheduler(executor):
    with StreamScheduler(executor, CORE, n_invocations=1,
                         workers=2) as sched:
        yield sched


def test_pipeline_matches_reference_and_direct_runs(executor, scheduler,
                                                    lowrank_tensor,
                                                    small_tensor):
    tensors = {"a": lowrank_tensor, "b": small_tensor}
    futs = [scheduler.submit(_port(t), name=n, seed=s, draw=jax_draws(s))
            for s, (n, t) in enumerate(tensors.items())]
    res = scheduler.drain()
    assert [r.name for r in res] == ["a", "b"]
    assert [r.seq for r in res] == [0, 1]
    assert all(isinstance(r, ScheduledResult) for r in res)
    assert all(r.decision == r.stats.stream_decision == "plan"
               and r.drift is None and r.stream_version is None
               for r in res)
    assert futs[0].result() is res[0]
    with RefScheduler(RefExecutor(4), CORE, n_invocations=1,
                      workers=2) as ref:
        for s, (n, t) in enumerate(tensors.items()):
            ref.submit(t, name=n, seed=s)
        want = ref.drain()
    for got, w in zip(res, want, strict=True):
        assert_fits_match(got.fits, w.fits)
        assert got.plan.name == w.plan.name
        assert got.plan.candidates.keys() == w.plan.candidates.keys()
    # pipelining, not math: a direct run on the same plan and seed gives
    # the same bits
    _, direct = executor.run(_port(lowrank_tensor), CORE, res[0].plan,
                             n_invocations=1, seed=0, draw=jax_draws(0))
    assert direct.fits == res[0].fits
    st = scheduler.stats()
    assert st["completed"] == 2 and st["failed"] == 0
    assert st["host_s"] > 0 and st["device_s"] > 0 and st["wall_s"] > 0
    assert st["overlap_s"] >= 0
    assert st["decisions"] == {"plan": 2}
    assert scheduler.pending() == 0


def _ladder(sched_cls, stream_cls, executor, t, port):
    """plan -> reuse -> stochastic-refine -> repartition -> reuse ->
    reselect on one stream (the chip_smoke ladder at a small size)."""
    rng = np.random.default_rng(0)
    stream = stream_cls(t.shape, name="s")
    stream.append(t.coords, t.values)
    out = []
    with sched_cls(executor, CORE, n_invocations=1, workers=2,
                   sample_fraction=0.5, replay_nnz=32, stochastic_tol=0.25,
                   correction_every=2) as sched:
        def submit(seed):
            kw = dict(draw=jax_draws(seed)) if port else {}
            out.append(sched.submit(stream, seed=seed, **kw).result())

        submit(0)
        submit(1)
        c = np.stack([rng.integers(0, L, 20) for L in t.shape], axis=1)
        stream.append(c, rng.standard_normal(20))
        submit(2)
        idx = rng.integers(0, t.nnz, 25)
        stream.append(t.coords[idx], rng.standard_normal(25) * 0.1)
        submit(3)
        submit(4)
        hub = np.tile(t.coords[0], (4 * t.nnz, 1))
        stream.append(hub, rng.standard_normal(4 * t.nnz))
        submit(5)
        stats = sched.stats()
    return out, stats


def test_refresh_ladder_matches_reference(small_tensor):
    got, gstats = _ladder(StreamScheduler, StreamingTensor,
                          HooiExecutor(4, "cpu"), _port(small_tensor), True)
    want, _ = _ladder(RefScheduler, RefStream, RefExecutor(4), small_tensor,
                      False)
    assert [r.decision for r in got] == [
        "plan", "reuse", "stochastic-refine", "repartition", "reuse",
        "reselect"]
    for g, w in zip(got, want, strict=True):
        assert g.decision == w.decision == g.stats.stream_decision
        assert g.drift == w.drift  # every drift entry, exactly
        assert g.stats.stream_drift == g.drift
        assert g.stream_version == w.stream_version
        assert_fits_match(g.fits, w.fits)
        for f in ("step_compilations", "uploads", "sample_nnz",
                  "replay_nnz", "step_size"):
            assert getattr(g.stats, f) == getattr(w.stats, f), (g.decision, f)
        assert g.stats.prepare_s == g.prepare_s > 0
        assert g.stats.run_s == g.run_s > 0
        assert g.stats.queue_wait_s == g.queue_wait_s >= 0
    plan, reuse, refine, repart, reuse2, reselect = got
    for r, base in ((reuse, plan), (reuse2, repart)):
        assert r.plan is base.plan
        assert (r.stats.step_compilations, r.stats.step_captures,
                r.stats.uploads) == (0, 0, 0)
        assert r.stats.upload_cache_hit
    assert refine.plan is plan.plan and refine.stats.fit_delta is not None
    assert refine.stats.fit_delta == pytest.approx(
        refine.fits[-1] - reuse.fits[-1])
    assert repart.plan.candidates is None  # the selector did not rerun
    assert repart.plan.scheme.name == plan.plan.scheme.name
    assert repart.stats.step_compilations == 0  # geometric pads survived
    assert reselect.drift["worst"] > 1.25
    assert reselect.plan.candidates is not None
    assert gstats["decisions"] == {"plan": 1, "reuse": 2,
                                   "stochastic-refine": 1, "repartition": 1,
                                   "reselect": 1}
    assert set(gstats) >= {"host_s", "device_s", "wall_s", "overlap_s",
                           "queue_wait_s", "slo_hit", "slo_miss"}
    assert set(DECISIONS) == {r.decision for r in got}


def test_adopt_then_reuse_and_slo_accounting(executor, small_tensor):
    from repro_torch.core.plan import plan

    stream = StreamingTensor.from_tensor(_port(small_tensor))
    pl = plan(stream.snapshot(), "lite", 4, core_dims=CORE)
    with StreamScheduler(executor, CORE, n_invocations=1, lane=3) as sched:
        assert sched.adopted_plan(stream) is None
        assert sched.adopt(stream, pl)
        assert sched.adopted_plan(stream) is pl
        r = sched.submit(stream, seed=0, deadline_s=3600.0).result()
        assert r.decision == "reuse" and r.plan is pl
        assert r.stats.uploads == 0 and r.slo_met is True
        assert (r.stats.lane, r.stats.slo_deadline_s, r.stats.slo_met) == \
            (3, 3600.0, True)
        st = sched.stats()
        assert (st["slo_hit"], st["slo_miss"]) == (1, 0)
        # a plan of another history is refused
        other = StreamingTensor.from_tensor(_port(small_tensor))
        other.append(small_tensor.coords[:1], small_tensor.values[:1])
        assert not sched.adopt(other, pl)
    assert MAX_RETAINED_FUTURES == 4096


def test_producer_failure_does_not_wedge_pipeline(scheduler,
                                                  lowrank_tensor):
    bad = SparseTensor(np.zeros((1, 2), dtype=np.int64), np.ones(1), (3, 3))
    f_bad = scheduler.submit(bad, name="bad")
    f_ok = scheduler.submit(_port(lowrank_tensor), name="ok", seed=0)
    res = scheduler.drain(return_exceptions=True)
    assert isinstance(res[0], ValueError)
    assert res[1].fits and f_ok.result() is res[1]
    with pytest.raises(ValueError):
        f_bad.result()
    st = scheduler.stats()
    assert st["failed"] == 1 and st["completed"] == 1


def test_cancelled_future_does_not_wedge_pipeline(scheduler, lowrank_tensor,
                                                  small_tensor):
    f1 = scheduler.submit(_port(lowrank_tensor), name="a", seed=0)
    f2 = scheduler.submit(_port(small_tensor), name="b", seed=1)
    cancelled = f2.cancel()  # may lose the race; both outcomes are legal
    f3 = scheduler.submit(_port(lowrank_tensor), name="c", seed=2)
    assert f1.result().fits
    assert f3.result().fits
    st = scheduler.stats()
    if cancelled:
        assert f2.cancelled()
        assert st["completed"] == 2 and st["failed"] == 1
    else:
        assert f2.result().fits
        assert st["completed"] == 3 and st["failed"] == 0


def test_submit_after_close_raises(executor, lowrank_tensor):
    sched = StreamScheduler(executor, CORE, n_invocations=1)
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit(_port(lowrank_tensor))


def test_sample_fraction_validation(executor, monkeypatch):
    with pytest.raises(ValueError, match="sample_fraction"):
        StreamScheduler(executor, CORE, sample_fraction=1.5)
    monkeypatch.setenv("REPRO_SAMPLE_FRACTION", "0.25")
    with StreamScheduler(executor, CORE) as sched:
        assert sched.sample_fraction == 0.25
    with StreamScheduler(executor, CORE, sample_fraction=0) as sched:
        assert sched.sample_fraction is None  # explicit 0 = off
