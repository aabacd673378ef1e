"""Fault injection on the port's scheduler pipeline (``_chaos``).

Twins of ``tests/test_chaos.py``, on the port's ``HooiExecutor`` (P=2
ranks stacked on the CPU) through the same ``tests/_chaos.py::inject``,
which patches ``prepare``, ``run`` and ``run_stochastic`` on the instance.
Faults are keyed by tensor fingerprint, which the port computes byte for
byte as the reference does, so the same script hits the same faults. The
contracts are the reference's: a killed prepare or sweep surfaces on that
job's future only and the stream recovers on resubmit; injected delay
shows in SLO accounting; the fault script is deterministic, and its
per-submit outcomes and decisions equal the reference's.
"""

import numpy as np
import pytest

import _chaos
from repro.core.coo import SparseTensor as RefSparseTensor
from repro.distributed.executor import HooiExecutor as RefExecutor
from repro.engine.scheduler import StreamScheduler as RefScheduler
from repro.streaming import StreamingTensor as RefStream
from repro_torch.core.coo import SparseTensor
from repro_torch.distributed.executor import HooiExecutor
from repro_torch.engine.scheduler import StreamScheduler
from repro_torch.streaming import StreamingTensor
from test_torch_hooi import jax_draws

CORE = (2, 2, 2)
SHAPE = (24, 18, 15)


def _arrays(seed, nnz=250):
    r = np.random.default_rng(seed)
    coords = np.stack([r.integers(0, L, nnz) for L in SHAPE], axis=1)
    return coords, r.standard_normal(nnz)


def _tensor(seed, nnz=250, cls=SparseTensor):
    return cls(*_arrays(seed, nnz), SHAPE).dedup()


def _stream(seed, nnz=250, name="s"):
    return StreamingTensor.from_tensor(_tensor(seed, nnz), name=name)


@pytest.fixture
def executor():
    return HooiExecutor(2, "cpu")


@pytest.fixture
def scheduler(executor):
    with StreamScheduler(executor, CORE, n_invocations=1, workers=2) as s:
        yield s


def test_port_fingerprints_match_the_reference():
    """The faults are keyed by fingerprint: the port's tensors and
    stream snapshots must hash as the reference's do."""
    assert _tensor(1).fingerprint() == \
        _tensor(1, cls=RefSparseTensor).fingerprint()
    port = StreamingTensor.from_tensor(_tensor(5), name="chain")
    ref = RefStream.from_tensor(_tensor(5, cls=RefSparseTensor),
                                name="chain")
    assert port.snapshot().fingerprint() == ref.snapshot().fingerprint()


def test_kill_prepare_surfaces_and_stream_recovers(scheduler, executor):
    stream = _stream(0)
    fp = stream.snapshot().fingerprint()
    plan = _chaos.FaultPlan().at(fp, "prepare", _chaos.kill())

    with _chaos.inject(executor, plan):
        bad = scheduler.submit(stream, seed=0)
        with pytest.raises(_chaos.ChaosError):
            bad.result()
        # the fault consumed itself: the same stream recovers on resubmit,
        # and because the kill preceded adoption it re-plans from scratch
        good = scheduler.submit(stream, seed=0).result()
    assert good.decision == "plan"
    assert plan.fired == [(fp[:8], "prepare", "kill")]
    st = scheduler.stats()
    assert st["failed"] == 1 and st["completed"] == 1


def test_kill_sweep_recovers_and_does_not_poison_caches(scheduler, executor):
    victim, healthy = _tensor(1), _tensor(2)
    plan = _chaos.FaultPlan().at(victim.fingerprint(), "run", _chaos.kill())

    with _chaos.inject(executor, plan):
        futs = [scheduler.submit(victim, name="victim"),
                scheduler.submit(healthy, name="healthy")]
        out = scheduler.drain(return_exceptions=True)
        # one entry per submit, in submission order, failure in place
        assert len(out) == 2
        assert isinstance(out[0], _chaos.ChaosError)
        assert out[1].name == "healthy"
        # the killed sweep left no wreckage: the victim reruns clean, and
        # the healthy tensor's caches were never poisoned (a warm rerun)
        r2 = scheduler.submit(victim, name="victim").result()
        r3 = scheduler.submit(healthy, name="healthy").result()
    assert np.isfinite(r2.stats.fits[-1])
    assert (r3.stats.step_compilations, r3.stats.step_captures,
            r3.stats.uploads) == (0, 0, 0)
    assert futs[1].result() is out[1]


def test_delay_shows_up_as_slo_miss(scheduler, executor):
    t_slow, t_fast = _tensor(3), _tensor(4)
    plan = _chaos.FaultPlan().at(t_slow.fingerprint(), "run",
                                 _chaos.delay(0.4))

    with _chaos.inject(executor, plan):
        slow = scheduler.submit(t_slow, deadline_s=0.2)
        fast = scheduler.submit(t_fast, deadline_s=120.0)
        r_slow, r_fast = slow.result(), fast.result()
    assert r_slow.slo_met is False and r_slow.stats.slo_met is False
    assert r_slow.stats.slo_deadline_s == 0.2
    assert r_fast.slo_met is True
    # the delay cost time, not correctness
    assert np.isfinite(r_slow.stats.fits[-1])
    st = scheduler.stats()
    assert st["slo_miss"] == 1 and st["slo_hit"] == 1
    assert st["queue_wait_s"] >= 0.0


def test_stream_chain_recovers_past_mid_chain_kill(scheduler, executor):
    """Kill the prepare of one *version* of a stream; earlier and later
    versions still decompose, and the ladder resumes where it should."""
    rng = np.random.default_rng(7)
    stream = _stream(5, name="chain")
    first = scheduler.submit(stream, seed=0).result()
    assert first.decision == "plan"

    b = 20
    c = np.stack([rng.integers(0, L, b) for L in SHAPE], axis=1)
    stream.append(c, rng.standard_normal(b))
    fp_v2 = stream.snapshot().fingerprint()
    plan = _chaos.FaultPlan().at(fp_v2, "prepare", _chaos.kill())

    with _chaos.inject(executor, plan):
        dead = scheduler.submit(stream, seed=1)
        alive = scheduler.submit(stream, seed=2)  # same version, retried
        with pytest.raises(_chaos.ChaosError):
            dead.result()
        r = alive.result()
    # the retry saw the same appended batch and took a real ladder step
    assert r.decision in ("stochastic-refine", "repartition", "reselect",
                          "plan")
    assert r.stream_version == 2
    assert plan.fired == [(fp_v2[:8], "prepare", "kill")]


def test_kill_mid_stochastic_refine_recovers_via_correction_sweep(executor):
    """A fingerprint-keyed kill inside ``run_stochastic`` surfaces on that
    job's future only, leaves the step/upload caches healthy for other
    tensors, and the next submit of the stream recovers through a full
    correction sweep, with one drain entry per submit throughout."""
    rng = np.random.default_rng(21)
    stream = _stream(13, name="stoch")
    healthy = _tensor(14)

    def append(n=20):
        c = np.stack([rng.integers(0, L, n) for L in SHAPE], axis=1)
        stream.append(c, rng.standard_normal(n))

    with StreamScheduler(executor, CORE, n_invocations=1, workers=2,
                         sample_fraction=0.5, replay_nnz=32,
                         stochastic_tol=0.25, correction_every=0) as sched:
        assert sched.submit(stream, seed=0).result().decision == "plan"
        sched.submit(healthy, name="healthy").result()  # warm full caches
        # prove the rung is live on this schedule before injecting faults
        append()
        r1 = sched.submit(stream, seed=1).result()
        assert r1.decision == "stochastic-refine"
        assert r1.stats.sample_fraction == 0.5 and r1.stats.sample_nnz > 0

        append()
        fp_v3 = stream.snapshot().fingerprint()
        plan = _chaos.FaultPlan().at(fp_v3, "run", _chaos.kill())
        with _chaos.inject(executor, plan):
            sched.submit(stream, seed=2)  # the refine that dies mid-run
            sched.submit(healthy, name="healthy")
            out = sched.drain(return_exceptions=True)
            # one entry per submit, in order; the kill stayed in its lane
            assert len(out) == 5  # all submits so far, none dropped
            out = out[-2:]
            assert isinstance(out[0], _chaos.ChaosError)
            # the other tensor's caches were never poisoned: a warm rerun
            assert out[1].stats.step_compilations == 0
            assert out[1].stats.uploads == 0
            # recovery: same stream version, sampled rung now distrusted;
            # the scheduler routes a full correction sweep and re-anchors
            r2 = sched.submit(stream, seed=3).result()
        assert plan.fired == [(fp_v3[:8], "run", "kill")]
        assert r2.decision in ("repartition", "reselect")
        assert r2.stats.sample_fraction is None  # a full sweep, not sampled
        assert np.isfinite(r2.stats.fits[-1])
        # ...and the rung comes back once the stream is re-anchored
        append()
        r3 = sched.submit(stream, seed=4).result()
        assert r3.decision == "stochastic-refine"
        assert np.isfinite(r3.stats.fits[-1])
    st = sched.stats()
    assert st["failed"] == 1


def _fault_script(port: bool):
    """Two streams, three submits each, the first stream's first prepare
    killed and its second delayed."""
    if port:
        ex, sched_cls, stream_cls, sparse = (HooiExecutor(2, "cpu"),
                                             StreamScheduler,
                                             StreamingTensor, SparseTensor)
    else:
        ex, sched_cls, stream_cls, sparse = (RefExecutor(2), RefScheduler,
                                             RefStream, RefSparseTensor)
    s1 = stream_cls.from_tensor(_tensor(11, cls=sparse), name="a")
    s2 = stream_cls.from_tensor(_tensor(12, cls=sparse), name="b")
    fp1 = s1.snapshot().fingerprint()
    plan = _chaos.FaultPlan().at(fp1, "prepare",
                                 _chaos.kill(), _chaos.delay(0.05))
    outcomes = []
    with sched_cls(ex, CORE, n_invocations=1, workers=2) as sched:
        with _chaos.inject(ex, plan):
            for seed in range(3):
                kw = {"draw": jax_draws(seed)} if port else {}
                sched.submit(s1, seed=seed, **kw)
                sched.submit(s2, seed=seed, **kw)
            for r in sched.drain(return_exceptions=True):
                if isinstance(r, Exception):
                    outcomes.append(("fail", type(r).__name__))
                else:
                    outcomes.append((r.name, r.decision))
    return outcomes, sorted(plan.fired)


def test_fault_script_is_deterministic():
    """Same submissions + same fault plan on a fresh executor => same fired
    faults and identical per-submit outcomes/decisions, regardless of
    thread interleaving, and the reference's."""
    out_a, fired_a = _fault_script(True)
    out_b, fired_b = _fault_script(True)
    assert out_a == out_b
    assert fired_a == fired_b
    assert out_a[0] == ("fail", "ChaosError")  # s1's first prepare killed
    assert (out_a, fired_a) == _fault_script(False)
