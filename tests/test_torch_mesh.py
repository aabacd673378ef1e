"""P ranks over a mesh of device groups: the port's ``make_ranks_mesh``,
``HooiExecutor(mesh=)``, ``dist_hooi(mesh=)`` and mesh lanes of
``ExecutorPool``, against the stacked port and the reference.

The reference runs its mesh on the conftest's 8 simulated host devices,
one rank each (``use_kernel=False``, as ``test_torch_dist.py``). The port's
mesh here is ``["cpu"] * G``: G device groups of P/G stacked ranks each,
every group's Z-build and Z products on its own (the CPU's) arrays, the
comm spaces and the Lanczos body at home. Draws go through the seam
(``jax_draws``).

Bars: against the stacked port run (G = 1) every case is bitwise, but the
vector driver's on G > 1: its ``Z @ x`` is the CPU BLAS's sgemv, whose
row blocking and tail loop depend on the row count, so a group's rows
round differently from the same rows of the stacked Z; that case is held
to the f32 bars below. Against the reference: fits within 1e-4 (the energy
share within 1e-6 relative where the fit is within 1e-3 of 1),
``F Fᵀ`` within 1e-3, final cores' energy share within 2e-6 relative.
"""

import functools
import io

import jax
import numpy as np
import pytest
import torch

from repro.core.hooi import random_factors as ref_random_factors
from repro.distributed.dist_hooi import dist_hooi as ref_dist_hooi
from repro.distributed.executor import make_ranks_mesh as ref_ranks_mesh
from repro.engine import ExecutorPool as RefPool
from repro.engine import StreamRouter as RefRouter
from repro.streaming import StreamingTensor as RefStream
from repro_torch import convert
from repro_torch.core.calibrate import fit_cost_model
from repro_torch.core.coo import SparseTensor
from repro_torch.core.plan import PartitionPlan
from repro_torch.core.plan import plan as build_plan
from repro_torch.distributed.dist_hooi import (HooiExecutor, dist_hooi,
                                               make_ranks_mesh,
                                               shared_executor)
from repro_torch.distributed.mesh import RankMesh
from repro_torch.engine import ExecutorPool, StreamRouter, device_slices
from repro_torch.graphs import StepGraph
from repro_torch.random import make_key
from repro_torch.streaming import StreamingTensor
from test_torch_hooi import (assert_core_energy_matches, assert_fits_match,
                             assert_subspaces_match, jax_draws)
from test_torch_pool import _counters, _held, _settled
from test_torch_pool import two_cards  # noqa: F401 — a fixture

P = 4
CPU = torch.device("cpu")
# knob set -> (fixture, core, invocations, port knobs); the reference runs
# the same knobs less use_fused_oracle (it keeps its plain products)
KNOBS = {
    "vector": ("lowrank_tensor", (2, 2, 2), 3, {}),
    "fused_block8": ("lowrank_tensor", (2, 2, 2), 3,
                     dict(lanczos_block=8, fused_zbuild=True,
                          use_fused_oracle=True)),
    "sketch": ("small_tensor", (3, 3, 3), 3,
               dict(lanczos_block=8, warm_start="sketch")),
    "completion": ("small_tensor", (3, 3, 3), 2,
                   dict(lanczos_block=8, fused_zbuild=True,
                        objective="completion")),
}
BACKENDS = {"baseline": "psum", "liteopt": "boundary"}


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


def _cpu_mesh(G: int) -> RankMesh:
    return make_ranks_mesh(P, devices=["cpu"] * G)


def _once(fn):
    """Memoize a run on (knob, path): its tensor is the knob's seeded
    fixture, the same in every test, so G = 1, 2, 4 share one run."""
    runs = {}

    @functools.wraps(fn)
    def run(knob, path, t):
        if (knob, path) not in runs:
            runs[knob, path] = fn(knob, path, t)
        return runs[knob, path]

    return run


@_once
def _reference(knob: str, path: str, t):
    _, core, inv, kw = KNOBS[knob]
    ref_kw = {k: v for k, v in kw.items() if k != "use_fused_oracle"}
    return ref_dist_hooi(t, core, P, scheme="lite", n_invocations=inv,
                         path=path, seed=0, mesh=ref_ranks_mesh(P),
                         use_kernel=False, **ref_kw)


def _port_run(knob: str, path: str, t, **where):
    _, core, inv, kw = KNOBS[knob]
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(0))
    return dist_hooi(_port(t), core, P, scheme="lite", n_invocations=inv,
                     path=path, seed=0, draw=jax_draws(0),
                     init=[np.asarray(f) for f in init], **kw, **where)


@_once
def _stacked(knob: str, path: str, t):
    return _port_run(knob, path, t, device="cpu")


def _bitwise(dec, st, want_dec, want_st) -> bool:
    return (st.fits == want_st.fits
            and all(torch.equal(a, b)
                    for a, b in zip(dec.factors, want_dec.factors))
            and torch.equal(dec.core, want_dec.core))


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("path", sorted(BACKENDS))
@pytest.mark.parametrize("G", [1, 2, 4])
def test_mesh_matches_stacked_and_reference(request, G, path, knob):
    t = request.getfixturevalue(KNOBS[knob][0])
    want_dec, want_st = _stacked(knob, path, t)
    dec, st = _port_run(knob, path, t, mesh=_cpu_mesh(G))
    assert st.groups == G and (st.group_bytes > 0) == (G > 1)
    assert set(st.comm_backends.values()) == {BACKENDS[path]}
    for f in ("comm_backends", "lanczos_block", "z_passes", "warm_start",
              "r_pad", "e_pad", "objective"):
        assert getattr(st, f) == getattr(want_st, f), f
    if knob == "vector" and G > 1:  # sgemv rounds a group's rows anew
        assert_fits_match(st.fits, want_st.fits)
        assert_subspaces_match(dec.factors, want_dec.factors)
        assert_core_energy_matches(t, dec.core, want_dec.core)
    else:
        assert _bitwise(dec, st, want_dec, want_st)
    ref_dec, ref_st = _reference(knob, path, t)
    assert st.comm_backends == ref_st.comm_backends
    assert st.z_passes == ref_st.z_passes
    assert_fits_match(st.fits, ref_st.fits)
    assert_subspaces_match(dec.factors, ref_dec.factors)
    if knob == "completion":
        # the completion twin's bars (``test_torch_objectives.py``): its
        # core is fitted to the training view, and the stacked port's lies
        # 2.3e-6 relative from the reference's in energy on this tensor
        np.testing.assert_allclose(
            st.objective_metrics["holdout_rmse"],
            ref_st.objective_metrics["holdout_rmse"], rtol=0, atol=1e-5)
    else:
        assert_core_energy_matches(t, dec.core, ref_dec.core)


# ----------------------------------------------------------- the executor
def test_mesh_executor_caches_uploads_and_steps(small_tensor):
    """``stage_upload`` puts each group's share up once (3 element arrays
    and one packed array of its boundary maps a mode a group, the maps,
    row perms and COO at home); the run then uploads nothing, and a rerun
    compiles nothing; reruns are bitwise."""
    t, core, G = _port(small_tensor), (3, 3, 3), 2
    ex = HooiExecutor(P, mesh=_cpu_mesh(G))
    assert ex.device == CPU and ex.groups == G and ex.mesh.G == G
    pl = build_plan(t, "lite", P, core_dims=core)
    staged = ex.stage_upload(pl, t)
    assert staged == {"uploads": t.ndim * (4 * G + 7) + 2,
                      "already_resident": False}
    assert ex.stage_upload(pl, t) == {"uploads": 0,
                                      "already_resident": True}
    up = ex._uploads[pl]
    for n, mp in enumerate(pl.parts):
        groups = up.arrs[n]["groups"]
        assert len(groups) == G and "coords" not in up.arrs[n]
        for g, ga in enumerate(groups):
            assert set(ga) == {"coords", "values", "rows"}
            assert ga["values"].shape == (P // G * mp.E_pad,)
            # local rows offset within the group, still sorted
            rows = ga["rows"].numpy()
            assert rows.min() >= 0 and rows.max() < P // G * mp.R_pad
            assert (np.diff(rows) >= 0).all()
            np.testing.assert_array_equal(
                ga["values"].numpy(),
                mp.values[g * P // G:(g + 1) * P // G].reshape(-1)
                .astype(np.float32))
    kw = dict(n_invocations=2, seed=1, lanczos_block=8, fused_zbuild=True)
    _, s1 = ex.run(t, core, pl, **kw)
    assert (s1.uploads, s1.upload_cache_hit, s1.step_compilations) == \
        (0, True, t.ndim)
    _, s2 = ex.run(t, core, pl, **kw)
    assert (s2.uploads, s2.step_compilations, s2.step_captures) == (0, 0, 0)
    assert s2.fits == s1.fits and s2.group_bytes == s1.group_bytes > 0
    stats = ex.stats()
    assert stats["groups"] == G and stats["group_bytes"] >= 2 * s1.group_bytes
    assert stats["uploads"] == staged["uploads"]


def test_mesh_calibration_samples_are_labelled(small_tensor):
    """A mesh's samples carry ``groups``; the stacked executor's carry no
    label (as the reference's); ``fit_cost_model`` fits either alone and
    refuses them mixed."""
    t, core = _port(small_tensor), (3, 3, 3)
    spread, stacked = HooiExecutor(P, mesh=_cpu_mesh(2)), \
        HooiExecutor(P, "cpu")
    for ex in (spread, stacked):
        ex.run(t, core, "lite", n_invocations=2, seed=0)
        ex.profile_phases(t, core, "lite", repeats=1)
    got, plain = spread.calibration_samples(), stacked.calibration_samples()
    assert len(got) == len(plain) == 4
    assert all(s["groups"] == 2 for s in got)
    assert not any("groups" in s for s in plain)
    assert [s.get("phase") for s in got] == [None, None, "ttm", "sweep"]
    for samples in (got, plain):
        assert fit_cost_model(samples).flop_rate > 0
    with pytest.raises(ValueError, match="groups"):
        fit_cost_model(got + plain)


def test_shared_executor_is_keyed_by_mesh_content():
    a = shared_executor(P, mesh=_cpu_mesh(2))
    assert shared_executor(P, mesh=_cpu_mesh(2)) is a
    assert shared_executor(P, mesh=_cpu_mesh(4)) is not a
    assert shared_executor(P, "cpu") is not a
    assert a.mesh.key() == (P, ("cpu", "cpu"))
    with pytest.raises(ValueError, match="mesh or a device"):
        shared_executor(P, "cpu", mesh=_cpu_mesh(2))


def test_mesh_refusals(small_tensor):
    t = _port(small_tensor)
    with pytest.raises(ValueError, match="do not split P=4"):
        make_ranks_mesh(P, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="do not split"):
        RankMesh(P, [])
    with pytest.raises(ValueError, match="mesh of P=2 ranks"):
        HooiExecutor(P, mesh=make_ranks_mesh(2, devices=["cpu"] * 2))
    with pytest.raises(ValueError, match="mesh or a device"):
        HooiExecutor(P, "cpu", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="mesh or a device"):
        dist_hooi(t, (3, 3, 3), P, device="cpu", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="executor has P=4, asked for 2"):
        dist_hooi(t, (3, 3, 3), 2, mesh=make_ranks_mesh(2, ["cpu"] * 2),
                  executor=HooiExecutor(P, mesh=_cpu_mesh(2)))
    # the captured-step machinery refuses a step over several groups
    with pytest.raises(ValueError, match="several device groups"):
        StepGraph.capture(None, lambda *a: None,
                          {"groups": ({}, {})}, [], make_key(0))


def test_make_ranks_mesh_needs_p_cards(monkeypatch):
    """``devices=None`` is one rank per CUDA device: without P cards it
    raises, and never stacks or falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="need 4 CUDA devices, have 0"):
        make_ranks_mesh(P)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ranks_mesh(P, devices=["cuda:0"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="need 4 CUDA devices, have 2"):
        make_ranks_mesh(P)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        RankMesh(P, ["cpu", "cuda:0"])


def test_device_slices_mesh_lanes(two_cards):  # noqa: F811
    """A lane given as a list is a mesh: a card may repeat within it, never
    across lanes; its group count divides P."""
    c0, c1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert device_slices(2, 4, devices=[["cpu"] * 2, ["cpu"] * 4]) == [
        [CPU] * 2, [CPU] * 4]
    assert device_slices(2, 4, devices=[["cuda:0", "cuda"], ["cuda:1"]]) \
        == [[c0, c0], [c1]]
    assert device_slices(2, 4, devices=[["cuda:0"] * 2, "cuda:1"]) == [
        [c0, c0], [c1]]
    for devs in ([["cuda:0", "cuda:1"], ["cuda:1"] * 2],
                 [["cuda:0"] * 2, "cuda"], [["cuda:1", "cuda:0"], "cuda:0"]):
        with pytest.raises(ValueError, match="share a CUDA device"):
            device_slices(2, 4, devices=devs)
    with pytest.raises(ValueError, match="does not split P=4"):
        device_slices(1, 4, devices=[["cpu"] * 3])
    with pytest.raises(ValueError, match="needs 3 devices, have 2"):
        device_slices(3, 4, devices=[["cpu"] * 2] * 2)


def test_pool_lane_of_one_group_is_the_stacked_executor():
    with ExecutorPool(2, P, (2, 2, 2), devices=[["cpu"], ["cpu"] * 2],
                      workers=1, n_invocations=1) as pool:
        stacked, spread = (lane.executor for lane in pool.lanes)
        assert stacked.mesh is None and stacked.groups == 1
        assert spread.mesh.G == 2 and spread.groups == 2
        assert [lane.devices for lane in pool.lanes] == [(CPU,), (CPU, CPU)]


# ---------------------------------------------------------- the pool twin
SHAPE, CORE = (24, 18, 15), (2, 2, 2)


def _tensor(sparse, seed, nnz=250):
    r = np.random.default_rng(seed)
    coords = np.stack([r.integers(0, L, nnz) for L in SHAPE], axis=1)
    return sparse(coords, r.standard_normal(nnz), SHAPE).dedup()


def _serve(port: bool):
    """Two lanes of P = 4 ranks: the reference's on four simulated devices
    each, the port's on a mesh of two CPU groups each. Four streams with
    the lanes held (least-loaded routing), a sticky resubmit of each, then
    one stream rerouted to the other lane and submitted there."""
    if port:
        pool = ExecutorPool(2, P, CORE, devices=[["cpu"] * 2] * 2,
                            workers=2, n_invocations=1, pad_geometric=True)
        Router, Stream = StreamRouter, StreamingTensor
    else:
        pool = RefPool(2, P, CORE, workers=2, n_invocations=1,
                       pad_geometric=True)
        Router, Stream = RefRouter, RefStream
    from repro.core.coo import SparseTensor as RefSparseTensor

    sparse = SparseTensor if port else RefSparseTensor
    draw = (lambda s: {"draw": jax_draws(s)}) if port else (lambda s: {})
    out = {}
    with pool:
        if port:
            out["lane_groups"] = [lane.executor.groups
                                  for lane in pool.lanes]
        router = Router(pool, max_pending=32)
        streams = [Stream.from_tensor(_tensor(sparse, i), name=f"s{i}")
                   for i in range(4)]
        with _held(pool, [s.snapshot().fingerprint() for s in streams]):
            for s in streams:
                router.submit(s, deadline_s=120.0, **draw(0))
        first = router.drain()
        for s in streams:
            router.submit(s, **draw(0))
        again = router.drain()
        home = first[0].stats.lane
        moved = router.reroute(streams[0])
        r = router.submit(streams[0], **draw(0)).result()
        _settled(router)
        out["first"] = [(x.name, x.stats.lane, x.decision) for x in first]
        out["again"] = [(x.name, x.stats.lane, x.decision,
                         x.stats.step_compilations, x.stats.uploads)
                        for x in again]
        out["reroute"] = (home, moved, r.stats.lane, r.decision,
                          r.stats.uploads)
        out["fits"] = [x.fits for x in first + again + [r]]
        out["stats"] = _counters(router.stats())
        router.close()
    return out


def test_pool_mesh_lanes_match_reference():
    got, want = _serve(True), _serve(False)
    assert got.pop("lane_groups") == [2, 2]
    fits, ref_fits = got.pop("fits"), want.pop("fits")
    assert got == want
    for g, w in zip(fits, ref_fits, strict=True):
        assert_fits_match(g, w)
    assert [lane for _, lane, _ in got["first"]] == [0, 1, 0, 1]
    assert all(a[2:] == ("reuse", 0, 0) for a in got["again"])
    home, moved, lane, decision, uploads = got["reroute"]
    assert moved != home and lane == moved
    assert (decision, uploads) == ("reuse", 0)  # adopt staged every group
    assert got["stats"]["rerouted"] == 1


def test_reroute_carries_plan_bytes_between_mesh_lanes(small_tensor):
    """A plan saved on one mesh lane and loaded on another of the same P
    stages every group there, and the run on it is bitwise the first
    lane's."""
    t, core = _port(small_tensor), (3, 3, 3)
    a, b = (HooiExecutor(P, mesh=_cpu_mesh(2)) for _ in range(2))
    pl = a.prepare(t, core, "lite")[0]
    _, sa = a.run(t, core, pl, n_invocations=2, seed=3)
    buf = io.BytesIO()
    pl.save(buf)
    loaded = PartitionPlan.load(io.BytesIO(buf.getvalue()), t)
    assert b.stage_upload(loaded, t)["uploads"] == t.ndim * (4 * 2 + 7) + 2
    _, sb = b.run(t, core, loaded, n_invocations=2, seed=3)
    assert sb.uploads == 0 and sb.fits == sa.fits


def test_mesh_runs_from_another_thread(small_tensor):
    """The executor's entry points and the groups' work need no state of
    the calling thread: a run from a worker thread is bitwise one from
    this thread."""
    import concurrent.futures

    t, core = _port(small_tensor), (3, 3, 3)
    ex = HooiExecutor(P, mesh=_cpu_mesh(2))
    _, here = ex.run(t, core, "lite", n_invocations=1, seed=2)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        _, there = pool.submit(ex.run, t, core, "lite", n_invocations=1,
                               seed=2).result(timeout=120)
    assert there.fits == here.fits and there.uploads == 0


def test_run_stochastic_on_a_mesh_runs_at_home(small_tensor):
    """The stochastic rung is single-device in the reference: on a mesh it
    runs at home, bitwise the stacked executor's refine, and a rerun moves
    and compiles nothing."""
    t, core = _port(small_tensor), (3, 3, 3)
    pl = build_plan(t, "lite", P, core_dims=core)
    init = [np.asarray(f) for f in
            ref_random_factors(t.shape, core, jax.random.PRNGKey(4))]
    kw = dict(init_factors=init, covered_nnz=int(t.nnz * 0.9),
              sample_fraction=0.5, sample_seed=7, replay_nnz=64,
              n_invocations=2, seed=3, draw=jax_draws(3))
    ex = HooiExecutor(P, mesh=_cpu_mesh(2))
    dec, st = ex.run_stochastic(t, core, pl, **kw)
    want_dec, want = HooiExecutor(P, "cpu").run_stochastic(t, core, pl, **kw)
    assert st.fits == want.fits and all(
        torch.equal(a, b) for a, b in zip(dec.factors, want_dec.factors))
    assert st.uploads == 4 and ex.stats()["group_bytes"] == 0
    _, again = ex.run_stochastic(t, core, pl, **kw)
    assert (again.uploads, again.step_compilations) == (0, 0)
    assert again.fits == st.fits
