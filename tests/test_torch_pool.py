"""The port's ``ExecutorPool`` and ``StreamRouter`` against the reference's.

Twins of ``tests/test_pool.py``. The reference's lanes are P=2 slices of
the conftest's simulated host devices; the port's lanes stack their P=2
ranks on the CPU (``devices=["cpu", "cpu"]``: the CPU may repeat, a CUDA
device may not). Both run on the same tensors, each port submit with the
reference's draws (``draw=jax_draws(seed)``). Lane choice depends on when
runs complete (``_on_done`` lowers a lane's backlog), so the lanes are held
(``_chaos.hold``) while the submits that are compared are made; then the
lanes, decisions, admission outcomes, ``PoolStats`` counters and
``backlog_s`` are compared exactly, and fits within the port's bars
(``assert_fits_match``: 1e-4, the energy share near a fit of 1).

On the CPU nothing is captured, so every ``step_captures`` is 0; the card
twin is ``tests/test_torch_cuda.py::test_pool_on_card``.
"""

import contextlib
import io
import threading
import time
import types

import numpy as np
import pytest
import torch

import _chaos
from repro.core.coo import SparseTensor as RefSparseTensor
from repro.core.plan import PartitionPlan as RefPartitionPlan
from repro.distributed.executor import HooiExecutor as RefExecutor
from repro.engine import ExecutorPool as RefPool
from repro.engine import PoolSaturated as RefSaturated
from repro.engine import StreamRouter as RefRouter
from repro.streaming import StreamingTensor as RefStream
from repro_torch.core.coo import SparseTensor
from repro_torch.core.plan import PartitionPlan
from repro_torch.core.plan import plan as build_plan
from repro_torch.distributed.executor import HooiExecutor
from repro_torch.engine import (ExecutorPool, PoolSaturated, PoolStats,
                                StreamRouter, device_slices)
from repro_torch.streaming import StreamingTensor
from test_torch_hooi import assert_fits_match, jax_draws

CORE = (2, 2, 2)
SHAPE = (24, 18, 15)
CPU = torch.device("cpu")


def _arrays(seed, nnz=250):
    r = np.random.default_rng(seed)
    coords = np.stack([r.integers(0, L, nnz) for L in SHAPE], axis=1)
    return coords, r.standard_normal(nnz)


def _impl(port: bool):
    """The names one scenario needs, from one package or the other."""
    sparse = SparseTensor if port else RefSparseTensor

    def tensor(seed, nnz=250):
        return sparse(*_arrays(seed, nnz), SHAPE).dedup()

    def stream(seed):
        return (StreamingTensor if port else RefStream).from_tensor(
            tensor(seed), name=f"s{seed}")

    def pool(n, **kw):
        if port:
            return ExecutorPool(n, 2, CORE, devices=["cpu"] * n, **kw)
        return RefPool(n, 2, CORE, **kw)

    def draw(seed):
        return {"draw": jax_draws(seed)} if port else {}

    return types.SimpleNamespace(
        port=port, tensor=tensor, stream=stream, pool=pool, draw=draw,
        Router=StreamRouter if port else RefRouter,
        Saturated=PoolSaturated if port else RefSaturated,
        Executor=(lambda: HooiExecutor(2, "cpu")) if port
        else (lambda: RefExecutor(2)),
        Plan=PartitionPlan if port else RefPartitionPlan)


PORT, REF = _impl(True), _impl(False)


@contextlib.contextmanager
def _held(pool, fingerprints):
    """Hold the first run of each fingerprint on every lane until the
    returned event is set (and on exit)."""
    gate = threading.Event()
    fault = _chaos.FaultPlan()
    for fp in fingerprints:
        fault.at(fp, "run", _chaos.hold(gate))
    with contextlib.ExitStack() as stack:
        for lane in pool.lanes:
            stack.enter_context(_chaos.inject(lane.executor, fault))
        try:
            yield gate
        finally:
            gate.set()


def _settled(router, timeout=30.0):
    """Wait for the lanes' done callbacks: ``drain`` returns when the
    futures resolve, and a future's waiters wake before its callbacks run
    on the lane's thread."""
    end = time.monotonic() + timeout
    while router.pending() and time.monotonic() < end:
        time.sleep(0.005)
    assert router.pending() == 0


def _alive_pipeline_threads():
    return [th for th in threading.enumerate()
            if th.is_alive() and th.name.startswith(("sched-prepare",
                                                     "sched-run"))]


_COUNTERS = ("n_lanes", "submitted", "completed", "failed", "slo_hit",
             "slo_miss", "decisions", "rejected", "rejected_by_priority",
             "rerouted", "backlog_s")


def _counters(st) -> dict:
    return {k: getattr(st, k) for k in _COUNTERS}


# ---------------------------------------------------------- device slices
def test_device_slices_cpu_lanes_may_repeat():
    assert device_slices(2, 4, devices=["cpu", "cpu"]) == [[CPU], [CPU]]
    assert device_slices(1, 2, devices=["cpu", "cpu", "cpu"]) == [[CPU]]
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        device_slices(3, 2, devices=["cpu", "cpu"])
    for n, P in ((0, 2), (2, 0)):
        with pytest.raises(ValueError, match="n_executors >= 1"):
            device_slices(n, P, devices=["cpu"])


@pytest.fixture
def two_cards(monkeypatch):
    """CUDA as a machine with two cards would report it, current device
    0: the slicing logic needs no card to run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    current = {"index": 0}
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: current["index"])
    return current


def test_device_slices_cuda_lanes_are_distinct_and_indexed(two_cards):
    cards = [torch.device("cuda", i) for i in range(2)]
    assert device_slices(2, 4) == [[cards[0]], [cards[1]]]
    assert device_slices(1, 4) == [[cards[0]]]
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        device_slices(3, 4)
    # "cuda" is the current device, given its index before the check
    assert device_slices(1, 4, devices=["cuda"]) == [[cards[0]]]
    for devs in (["cuda:0", "cuda:0"], ["cuda", "cuda:0"],
                 [torch.device("cuda"), torch.device("cuda", 0)]):
        with pytest.raises(ValueError, match="share a CUDA device"):
            device_slices(2, 4, devices=devs)
    assert device_slices(2, 4, devices=["cuda", "cuda:1"]) == [
        [cards[0]], [cards[1]]]
    two_cards["index"] = 1
    assert device_slices(2, 4, devices=["cuda", "cuda:0"]) == [
        [cards[1]], [cards[0]]]
    with pytest.raises(ValueError, match="share a CUDA device"):
        device_slices(2, 4, devices=["cuda", "cuda:1"])
    assert device_slices(3, 4, devices=["cpu", "cuda:0", "cpu"]) == [
        [CPU], [cards[0]], [CPU]]


def test_device_slices_without_cuda_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        device_slices(1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_slices(1, 4, devices=["cuda:0"])
    with pytest.raises(ValueError, match="needs 1 devices, have 0"):
        ExecutorPool(1, 4, CORE)


def test_pool_lanes_own_their_executors():
    with ExecutorPool(2, 2, CORE, devices=["cpu", "cpu"], workers=1,
                      n_invocations=1) as pool:
        assert pool.n_lanes == 2 and pool.P == 2
        for i, lane in enumerate(pool.lanes):
            assert pool.lane(i) is lane and lane.index == i
            assert lane.devices == (CPU,) and lane.executor.device == CPU
            assert lane.executor.P == 2
            assert lane.scheduler.executor is lane.executor
            assert lane.scheduler.lane == i
            assert lane.scheduler.n_invocations == 1
        assert pool.lanes[0].executor is not pool.lanes[1].executor
        st = pool.stats()
        assert isinstance(st, PoolStats)
        assert (st.n_lanes, st.submitted, st.decisions) == (2, 0, {})
    assert not _alive_pipeline_threads()


# ------------------------------------------------------------ routing
def _routing(impl):
    out = {}
    with impl.pool(2, workers=2, n_invocations=1, pad_geometric=True) as pool:
        router = impl.Router(pool, max_pending=32)
        streams = [impl.stream(i) for i in range(4)]
        with _held(pool, [s.snapshot().fingerprint()
                          for s in streams]) as gate:
            for s in streams:
                router.submit(s, deadline_s=120.0, **impl.draw(0))
            out["held"] = (router.pending(), router.stats().backlog_s)
            gate.set()
            first = router.drain()
        for s in streams:
            router.submit(s, **impl.draw(0))
        again = router.drain()
        _settled(router)
        out["first"] = [(r.name, r.stats.lane, r.decision, r.slo_met)
                        for r in first]
        out["again"] = [(r.name, r.stats.lane, r.decision,
                         r.stats.step_compilations, r.stats.uploads)
                        for r in again]
        out["fits"] = [r.fits for r in first + again]
        st = router.stats()
        out["stats"] = _counters(st)
        out["lane_completed"] = [ls["completed"] for ls in st.lane_stats]
        out["n_executors"] = len(st.lane_executors)
        out["as_dict_lanes"] = st.as_dict()["n_lanes"]
        router.close()
    return out


def test_routing_spreads_lanes_and_aggregates_stats():
    got, want = _routing(PORT), _routing(REF)
    for k in ("held", "first", "again", "stats", "lane_completed",
              "n_executors", "as_dict_lanes"):
        assert got[k] == want[k], k
    for g, w in zip(got["fits"], want["fits"], strict=True):
        assert_fits_match(g, w)
    # the reference test's own contract, on the port
    lanes = [lane for _, lane, _, _ in got["first"]]
    assert lanes == [0, 1, 0, 1]  # least-loaded routing uses both lanes
    assert got["held"] == (4, (0.1, 0.1))  # 2 x DEFAULT_COST_S x 1 each
    assert all(met for *_, met in got["first"])
    assert [a[1] for a in got["again"]] == lanes  # sticky
    assert all(a[2:] == ("reuse", 0, 0) for a in got["again"])
    st = got["stats"]
    assert (st["submitted"], st["completed"], st["failed"]) == (8, 8, 0)
    assert (st["slo_hit"], st["slo_miss"]) == (4, 0)
    assert st["decisions"] == {"plan": 4, "reuse": 4}
    assert st["backlog_s"] == (0.0, 0.0)
    assert sum(got["lane_completed"]) == 8


# -------------------------------------------------- concurrency stress
def _stress(impl):
    """10 streams from 4 threads into the 2-lane pool, two streams' first
    prepares killed."""
    n_streams, per_stream = 10, 2
    streams = [impl.stream(100 + i) for i in range(n_streams)]
    victims = streams[:2]
    fault = _chaos.FaultPlan()
    for v in victims:
        fault.at(v.snapshot().fingerprint(), "prepare", _chaos.kill())
    out = {}
    with impl.pool(2, workers=2, n_invocations=1,
                   pad_geometric=True) as pool:
        router = impl.Router(pool, max_pending=64)
        with contextlib.ExitStack() as stack:
            for lane in pool.lanes:
                stack.enter_context(_chaos.inject(lane.executor, fault))
            errs = []

            def worker(chunk):
                try:
                    for s in chunk:
                        for k in range(per_stream):
                            router.submit(s, seed=k, deadline_s=300.0,
                                          **impl.draw(k))
                except Exception as e:  # noqa: BLE001 - fails the test
                    errs.append(e)

            threads = [threading.Thread(target=worker, args=(streams[i::4],))
                       for i in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=120)
            assert not errs and not any(th.is_alive() for th in threads)
            res = router.drain(return_exceptions=True)
        out["n_results"] = len(res)
        out["failures"] = sorted(type(r).__name__ for r in res
                                 if isinstance(r, Exception))
        out["victims"] = [router.submit(v).result().decision
                          for v in victims]
        healthy = router.submit(streams[5]).result()
        out["healthy"] = (healthy.decision, healthy.stats.step_compilations,
                          healthy.stats.uploads)
        _settled(router)
        st = router.stats()
        out["stats"] = {k: getattr(st, k) for k in
                        ("submitted", "completed", "failed", "slo_hit",
                         "slo_miss", "rejected")}
        out["idle_backlog"] = all(b == pytest.approx(0.0, abs=1e-12)
                                  for b in st.backlog_s)
        router.close()  # closes the pool's lanes too
        out["leftover"] = _alive_pipeline_threads()
        with pytest.raises(RuntimeError, match="closed"):
            router.submit(streams[0])
    return out


def test_many_threads_many_streams_with_failures():
    got, want = _stress(PORT), _stress(REF)
    assert got == want
    assert got["idle_backlog"]
    assert got["n_results"] == 20  # one entry per submit
    assert got["failures"] == ["ChaosError", "ChaosError"]
    # the killed streams recovered during the stress itself, so they are
    # warm now; the healthy streams' caches were never poisoned
    assert got["victims"] == ["reuse", "reuse"]
    assert got["healthy"] == ("reuse", 0, 0)
    assert got["stats"]["failed"] == 2
    assert got["stats"]["completed"] == 20 - 2 + 3
    assert got["stats"]["slo_hit"] == 18  # deadlines were generous
    assert got["leftover"] == []


# -------------------------------------------- admission / backpressure
def _admission(impl):
    """Behind a held sweep the bounded queue fills: batch is refused
    first, normal next, interactive last."""
    held = impl.tensor(200)
    steps = []
    with impl.pool(1, workers=2, n_invocations=1) as pool:
        router = impl.Router(pool, max_pending=4)
        with _held(pool, [held.fingerprint()]) as gate:
            for seed, prio in ((200, "interactive"), (201, "normal"),
                               (202, "batch"), (203, "normal"),
                               (204, "normal"), (205, "interactive"),
                               (206, "interactive")):
                t = held if seed == 200 else impl.tensor(seed)
                try:
                    router.submit(t, priority=prio, seed=seed,
                                  **impl.draw(seed))
                    steps.append((prio, "admitted", router.pending()))
                except impl.Saturated as e:
                    steps.append((prio, "refused", e.priority, e.pending,
                                  e.limit))
            held_stats = _counters(router.stats())
            gate.set()
            res = router.drain()
        _settled(router)
        out = {"steps": steps, "held": held_stats,
               "results": [(r.name, r.decision) for r in res],
               "fits": [r.fits for r in res],
               "stats": _counters(router.stats())}
        router.close()
    return out


def test_admission_shares_and_backpressure():
    got, want = _admission(PORT), _admission(REF)
    for k in ("steps", "held", "results", "stats"):
        assert got[k] == want[k], k
    # after the drain the backlog keeps the residue of adding four
    # estimates and taking them away in another order
    assert got["stats"]["backlog_s"][0] == pytest.approx(0.0, abs=1e-12)
    for g, w in zip(got["fits"], want["fits"], strict=True):
        assert_fits_match(g, w)
    assert got["steps"] == [
        ("interactive", "admitted", 1), ("normal", "admitted", 2),
        # batch share: 0.5 * 4 = 2 -> full
        ("batch", "refused", "batch", 2, 2),
        # normal share: 0.85 * 4 -> 3; one more fits, then refused
        ("normal", "admitted", 3), ("normal", "refused", "normal", 3, 3),
        # interactive may use the full queue
        ("interactive", "admitted", 4),
        ("interactive", "refused", "interactive", 4, 4)]
    assert got["held"]["backlog_s"] == (0.2,)  # 4 x DEFAULT_COST_S x 1
    st = got["stats"]
    assert len(got["results"]) == 4
    assert st["rejected"] == 3
    assert st["rejected_by_priority"] == {
        "batch": 1, "normal": 1, "interactive": 1}
    assert (st["completed"], st["failed"]) == (4, 0)


# ----------------------------------------------------- warm-start path
def _warm_start(impl):
    """Save on executor A, load against the tensor, run on B, which has
    built steps of the same shapes for a tensor sharing the coords."""
    t = impl.tensor(300)
    ex_a, ex_b = impl.Executor(), impl.Executor()
    pl_a, _ = ex_a.prepare(t, CORE, "lite", pad_geometric=True)
    ex_a.run(t, CORE, pl_a, n_invocations=1, **impl.draw(0))
    warmup = type(t)(t.coords, t.values * 2.0 + 1.0, SHAPE)
    pl_w, _ = ex_b.prepare(warmup, CORE, "lite", pad_geometric=True)
    _, w_stats = ex_b.run(warmup, CORE, pl_w, n_invocations=1,
                          **impl.draw(0))
    buf = io.BytesIO()
    pl_a.save(buf)
    pl_loaded = impl.Plan.load(io.BytesIO(buf.getvalue()), t)
    staged = ex_b.stage_upload(pl_loaded, t)
    _, stats_b = ex_b.run(t, CORE, pl_loaded, n_invocations=1,
                          **impl.draw(0))
    _, stats_a = ex_a.run(t, CORE, pl_a, n_invocations=1, **impl.draw(0))
    return w_stats, staged, stats_b, stats_a


def test_warm_start_save_load_zero_jit_across_executors():
    w, staged, b, a = _warm_start(PORT)
    rw, rstaged, rb, ra = _warm_start(REF)
    assert w.step_compilations == rw.step_compilations > 0  # B built its own
    # the port moves 10 arrays a mode and 2 more (its upload layout,
    # ``executor.upload_mode``), the reference 9 a mode and 2 more
    assert staged == {"uploads": 10 * 3 + 2, "already_resident": False}
    assert rstaged == {"uploads": 9 * 3 + 2, "already_resident": False}
    # 0 compilations across executors, and 0 uploads: staged ahead
    assert (b.step_compilations, b.uploads) == \
        (rb.step_compilations, rb.uploads) == (0, 0)
    assert (w.step_captures, b.step_captures) == (0, 0)  # none on the CPU
    # same plan, same seed => the same trajectory as executor A, bitwise
    assert a.fits == b.fits
    assert_fits_match(b.fits, rb.fits)
    assert ra.fits == rb.fits


def _pad_mismatch(impl):
    t = impl.tensor(301)
    ex_a, ex_b = impl.Executor(), impl.Executor()
    pl_geo, _ = ex_b.prepare(t, CORE, "lite", pad_geometric=True)
    ex_b.run(t, CORE, pl_geo, n_invocations=1, **impl.draw(0))
    pl_tight, _ = ex_a.prepare(t, CORE, "lite", pad_geometric=False)
    buf = io.BytesIO()
    pl_tight.save(buf)
    pl_loaded = impl.Plan.load(io.BytesIO(buf.getvalue()), t)
    _, stats = ex_b.run(t, CORE, pl_loaded, n_invocations=1, **impl.draw(0))
    with pytest.raises(ValueError, match="fingerprint|built for"):
        impl.Plan.load(io.BytesIO(buf.getvalue()), impl.tensor(302))
    return stats


def test_warm_start_pad_mismatch_recompiles_cleanly():
    got, want = _pad_mismatch(PORT), _pad_mismatch(REF)
    assert got.step_compilations == want.step_compilations > 0
    assert np.isfinite(got.fits[-1])
    assert_fits_match(got.fits, want.fits)


def _reroute(impl):
    with impl.pool(2, workers=2, n_invocations=1, pad_geometric=True) as pool:
        router = impl.Router(pool, max_pending=16)
        s = impl.stream(400)
        first = router.submit(s, **impl.draw(0)).result()
        home = first.stats.lane
        new_lane = router.reroute(s)
        same = router.reroute(s, lane=new_lane)
        r = router.submit(s, **impl.draw(0)).result()
        _settled(router)
        out = {"home": home, "new_lane": new_lane, "same": same,
               "lane": r.stats.lane, "decision": r.decision,
               "uploads": r.stats.uploads,
               "adopted": pool.lane(new_lane).scheduler.adopted_plan(s)
               is not None,
               "stats": _counters(router.stats()),
               "fits": (first.fits, r.fits)}
        with pytest.raises(ValueError, match="outside pool"):
            router.reroute(s, lane=2)
        with pytest.raises(ValueError, match="no lane yet"):
            router.reroute(impl.stream(401))
        router.close()
    return out


def test_router_reroute_is_a_warm_start():
    got, want = _reroute(PORT), _reroute(REF)
    fits, ref_fits = got.pop("fits"), want.pop("fits")
    assert got == want
    for g, w in zip(fits, ref_fits, strict=True):
        assert_fits_match(g, w)
    assert got["new_lane"] != got["home"] and got["same"] == got["new_lane"]
    assert got["lane"] == got["new_lane"] and got["adopted"]
    assert got["decision"] == "reuse"
    assert got["uploads"] == 0  # adopt staged the loaded plan's arrays
    assert got["stats"]["rerouted"] == 1


def _one_lane_reroute(impl):
    with impl.pool(1, workers=1, n_invocations=1) as pool:
        router = impl.Router(pool)
        s = impl.stream(402)
        router.submit(s, **impl.draw(0)).result()
        with pytest.raises(ValueError):  # no other lane to move to
            router.reroute(s)
        assert router.reroute(s, lane=0) == 0  # already home: no move
        _settled(router)
        st = _counters(router.stats())
        router.close()
    return st


def test_reroute_on_a_one_lane_pool_raises():
    got = _one_lane_reroute(PORT)
    assert got == _one_lane_reroute(REF)
    assert got["rerouted"] == 0 and got["decisions"] == {"plan": 1}


# ------------------------------------- plan-cache-hit flag thread-safety
def test_plan_cache_hit_flag_is_per_thread():
    """Two threads build *different* cold plans simultaneously: neither
    may observe the other's activity as its own cache hit."""
    from repro_torch.core.plan import (last_plan_call_cache_hit,
                                       plan_cache_clear)

    plan_cache_clear()
    barrier = threading.Barrier(2)
    results = {}

    def build(key, seed):
        t = PORT.tensor(500 + seed, nnz=150)
        barrier.wait()
        build_plan(t, "lite", 2, core_dims=CORE)
        cold = last_plan_call_cache_hit()
        build_plan(t, "lite", 2, core_dims=CORE)
        warm = last_plan_call_cache_hit()
        results[key] = (cold, warm)

    threads = [threading.Thread(target=build, args=(k, k)) for k in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert results == {0: (False, True), 1: (False, True)}
    plan_cache_clear()


def test_executor_counters_consistent_under_concurrent_submit():
    """Concurrent runs on one executor keep stats()/calibration_samples()
    internally consistent: counter totals equal the per-call tallies."""
    ex = HooiExecutor(2, "cpu")
    tensors = [PORT.tensor(600 + i, nnz=180) for i in range(4)]
    out = [None] * len(tensors)

    def run(i):
        _, st = ex.run(tensors[i], CORE, "lite", n_invocations=1)
        out[i] = st

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(tensors))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert all(s is not None for s in out)
    st = ex.stats()
    assert st["step_compilations"] == sum(s.step_compilations for s in out)
    assert st["uploads"] == sum(s.uploads for s in out)
    assert len(ex.calibration_samples()) == len(tensors)
    assert all(s.step_compilations >= 0 and s.uploads >= 0 for s in out)
