"""``repro_torch.tracing``: spans and counters at the port's layer boundaries.

Off (no profiler, no ``recording()``) a span is one shared no-op that builds
no ``record_function`` and no CUDA event; on, it nests in the profiler's
timeline as opened and its record gives parents, call ids, self seconds and
counters in ``summary()``. A tiny ``hooi`` and a tiny P = 4 ``dist_hooi`` on
the CPU show the spans and counters the benchmark's readers rely on.
"""

import contextlib
import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core.coo import SparseTensor
from repro_torch.core.hooi import hooi, hooi_invocation, random_factors
from repro_torch.core.plan import plan
from repro_torch.distributed.dist_hooi import dist_hooi
from repro_torch.random import make_key

SHAPES = {3: (30, 20, 25), 4: (12, 10, 14, 8)}
NNZ = 1500
PLAN_PARTS = {"fingerprint", "scheme", "partition", "metrics", "cost"}


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


def _tensor(N: int, seed: int = 0) -> SparseTensor:
    rng = np.random.default_rng(seed)
    shape = SHAPES[N]
    lin = rng.choice(int(np.prod(shape)), NNZ, replace=False)
    coords = np.stack(np.unravel_index(lin, shape), 1).astype(np.int64)
    return SparseTensor(coords, rng.random(NNZ).astype(np.float32), shape)


def _refuse(*args, **kwargs):
    raise AssertionError("constructed while tracing is off")


def _fake_clock(monkeypatch):
    """Each clock reading of the store one second after the last."""
    ticks = itertools.count()
    monkeypatch.setattr(tracing, "time", SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))


# ------------------------------------------------------------------ off
def test_off_span_is_one_shared_no_op_and_builds_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    monkeypatch.setattr(torch.cuda, "Event", _refuse)
    monkeypatch.setattr(torch.cuda, "synchronize", _refuse)
    a, b = tracing.span("a"), tracing.span("b", device=True)
    assert a is b
    with a as call:
        tracing.count("bytes", 8)
    assert call is None
    t = _tensor(3)
    hooi(t, (3, 3, 3), n_invocations=1, device="cpu")
    dist_hooi(t, (3, 3, 3), 4, n_invocations=1, device="cpu")
    assert tracing.summary() == {}


@pytest.mark.parametrize("timings, syncs", [(None, 0), ({}, 2)])
def test_hooi_invocation_synchronises_only_for_timings(monkeypatch, timings,
                                                       syncs):
    """``local_mode_step`` waits for the device twice per mode only when
    the caller asked for timings; the factors are the same either way."""
    from repro_torch.engine import steps

    calls = []
    monkeypatch.setattr(steps, "_sync", lambda x: calls.append(x))
    t = _tensor(3)
    init = random_factors(t.shape, (3, 3, 3), make_key(5), "cpu")
    got = hooi_invocation(t, list(init), make_key(4), timings=timings,
                          device="cpu")
    want = hooi_invocation(t, list(init), make_key(4), device="cpu")
    assert len(calls) == syncs * t.ndim
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if timings is not None:
        assert set(timings) == {"ttm", "svd"}


# ------------------------------------------------------------------- on
def test_spans_nest_in_the_profiler_timeline_as_opened():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            with tracing.span("inner"):
                with tracing.span("leaf"):
                    torch.ones(4).sum()
    events = {e.name: e for e in prof.events()
              if e.name in ("outer", "inner", "leaf")}
    assert set(events) == {"outer", "inner", "leaf"}
    assert events["outer"].cpu_parent is None
    assert events["inner"].cpu_parent.name == "outer"
    assert events["leaf"].cpu_parent.name == "inner"
    # the store recorded under the profiler, without recording()
    got = tracing.summary()
    assert got["leaf"]["parents"] == ["inner"]
    assert got["inner"]["parents"] == ["outer"]


def test_summary_gives_parents_calls_self_seconds_and_counters(monkeypatch):
    _fake_clock(monkeypatch)
    calls = []
    with tracing.recording():
        for _ in range(2):  # two top spans: two calls
            with tracing.span("top") as call:  # opens at 0
                calls.append(call)
                with tracing.span("child"):  # 1 .. 2
                    tracing.count("bytes", 10)
                with tracing.span("child"):  # 3 .. 6
                    tracing.count("bytes", 5)
                    with tracing.span("grandchild"):  # 4 .. 5
                        pass
                tracing.count("top_items", 1)
            # closes at 7; the second call runs 8 .. 15
        tracing.count("loose", 3)  # no span open
    assert calls[0] is not None and calls[0] != calls[1]
    got = tracing.summary()
    assert got["top"]["count"] == 2 and got["top"]["calls"] == 2
    assert got["top"]["host_s"] == 2 * 7.0
    assert got["top"]["self_s"] == 2 * (7.0 - 1.0 - 3.0)
    assert got["top"]["counters"] == {"top_items": 2}
    assert got["child"]["count"] == 4
    assert got["child"]["host_s"] == 2 * (1.0 + 3.0)
    assert got["child"]["self_s"] == 2 * (1.0 + 2.0)
    assert got["child"]["counters"] == {"bytes": 30}
    assert got["child"]["parents"] == ["top"]
    assert got["grandchild"]["parents"] == ["child"]
    assert got["grandchild"]["self_s"] == 2 * 1.0
    assert got["top"]["device_s"] is None
    assert got["loose"]["count"] == 0
    assert got["loose"]["counters"] == {"loose": 3}
    one = tracing.summary(call=calls[1])
    assert one["top"]["count"] == 1 and one["child"]["count"] == 2
    assert one["child"]["counters"] == {"bytes": 15}
    assert "loose" not in one


def test_records_past_the_cap_fold_into_the_totals(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_RECORDS", 4)
    with tracing.recording():
        for _ in range(10):
            with tracing.span("s"):
                tracing.count("n", 1)
    assert len(tracing._STORE.records) == 4
    got = tracing.summary()["s"]
    assert got["count"] == 10 and got["counters"] == {"n": 10}


def test_recording_is_scoped_and_clear_empties_the_store():
    with tracing.recording():
        with tracing.span("a"):
            pass
    with tracing.span("b"):  # off again
        pass
    assert set(tracing.summary()) == {"a"}
    tracing.clear()
    assert tracing.summary() == {}


# -------------------------------------------------- the port's boundaries
@pytest.mark.parametrize("N", [3, 4])
def test_tiny_hooi_spans_and_counters(N):
    t = _tensor(N)
    core, sweeps = (3,) * N, 2
    with tracing.recording():
        hooi(t, core, n_invocations=sweeps, device="cpu")
    got = tracing.summary()
    assert got["hooi"]["count"] == 1 and got["hooi"]["parents"] == []
    assert got["hooi.setup"]["parents"] == ["hooi"]
    assert got["hooi.upload"]["parents"] == ["hooi.setup"]
    assert got["hooi.upload"]["counters"] == {
        "hooi.upload_bytes": t.nnz * (4 * N + 4)}
    assert got["sweep"]["count"] == sweeps
    for name in ("sweep.steps", "sweep.core", "sweep.fit"):
        assert got[name]["count"] == sweeps
        assert got[name]["parents"] == ["sweep"]
    assert got["sweep.norm2"]["count"] == sweeps
    assert got["sweep.norm2"]["parents"] == ["sweep.fit"]
    # N mode steps and the core, one range each
    assert got["zbuild"]["count"] == sweeps * (N + 1)
    assert got["zbuild"]["parents"] == ["sweep.core", "sweep.steps"]
    assert got["zbuild"]["device_s"] is None  # no events on the CPU
    assert got["lanczos"]["count"] == sweeps * N
    assert all(s["calls"] == 1 for s in got.values())


@pytest.mark.parametrize("recording", [True, False])
def test_tiny_dist_hooi_spans_and_plan_parts(recording):
    t = _tensor(3, seed=1)
    core, sweeps = (3, 3, 3), 2
    pl = plan(t, "lite", 4, core_dims=core, use_cache=False)
    assert set(pl.build_parts_s) == PLAN_PARTS
    assert all(v >= 0.0 for v in pl.build_parts_s.values())
    with tracing.recording() if recording else contextlib.nullcontext():
        _, st = dist_hooi(t, core, 4, scheme=pl, n_invocations=sweeps,
                          lanczos_block=8, fused_zbuild=True, device="cpu")
    if not recording:
        assert st.spans is None
        return
    got = st.spans
    assert got["dist_hooi"]["count"] == 1
    assert got["executor.setup"]["parents"] == ["dist_hooi"]
    assert got["sweep"]["count"] == sweeps
    assert got["sweep.norm2"]["count"] == sweeps
    assert got["zbuild"]["count"] == sweeps * (t.ndim + 1)
    assert got["graphs.cut"]["count"] >= sweeps * t.ndim
    assert got["graphs.cut"]["counters"]["graphs.cut_bytes"] > 0
    assert all(s["calls"] == 1 for s in got.values())
    assert got == tracing.summary()  # the one call recorded


def test_a_plan_built_inside_a_call_times_its_parts_under_it():
    t = _tensor(3, seed=2)
    with tracing.recording():
        _, st = dist_hooi(t, (3, 3, 3), 4, n_invocations=1, device="cpu",
                          plan_seed=7)
    for part in PLAN_PARTS:
        assert st.spans[f"plan.{part}"]["parents"] == ["executor.setup"]


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: device spans time CUDA events")


@pytest.mark.cuda
def test_device_span_times_the_stream_and_skips_a_capture(cuda):
    x = torch.randn(2048, 2048, device="cuda")
    y = x @ x  # the capture's warm-up
    g = torch.cuda.CUDAGraph()
    with tracing.recording():
        with tracing.span("mm", device=True):
            for _ in range(8):
                y = y @ x / 2048
        with torch.cuda.graph(g):
            with tracing.span("captured", device=True):
                y = x @ x
    g.replay()
    got = tracing.summary()
    assert got["mm"]["device_count"] == 1 and got["mm"]["device_s"] > 0
    assert got["captured"]["count"] == 1
    assert got["captured"]["device_s"] is None
