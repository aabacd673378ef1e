"""A mesh's mode steps as a capture sees them, against the stacked step's.

On one card a mesh's steps are captured as CUDA graphs (``graphs.py``):
every draw the step makes is an upload slot, every host factorization a
cut between segments, and the bytes its crossings count are recorded per
segment and added again at each replay. None of that needs the card to be
checked: here each step runs on the CPU through a recording stub of the
``graphs`` seam (a ``StepGraph`` whose upload slots and cuts run eagerly),
over ``["cpu"] * G`` meshes (G = 2, 4) and the stacked ranks, and the
tests hold

* the mesh step's upload slots (shapes) and host calls (input shapes) to
  the stacked step's, in order, so its captured segments are the stacked
  step's;
* that it reads no device value outside the seam (``Tensor.item``,
  ``tolist``, ``cpu``, ``numpy`` and ``torch.cuda.synchronize`` raise there
  while it runs): a host read inside a segment would fail the capture;
* that the per-segment byte tally, added once per replay, gives the eager
  run's ``moved_by_kind``, and the eager warm-up counts nothing.

The captures themselves run on the card (``tests/test_torch_cuda.py``,
``test_mesh_captured_bitwise``).
"""

import collections
import sys

import numpy as np
import pytest
import torch

from repro_torch import graphs
from repro_torch.core.coo import SparseTensor
from repro_torch.core.hooi import random_factors
from repro_torch.core.plan import plan as build_plan
from repro_torch.distributed.dist_hooi import HooiExecutor, make_ranks_mesh
from repro_torch.distributed.executor import _tally
from repro_torch.engine.oracle import ModeSpec
from repro_torch.graphs import StepGraph
from repro_torch.random import make_key

P = 4
SHAPE, CORE = (40, 30, 25), (3, 3, 3)
CASES = {  # (path, knobs of ``run``)
    "fused_block8 psum": ("baseline", dict(lanczos_block=8,
                                            fused_zbuild=True)),
    "fused_block8 boundary": ("liteopt", dict(lanczos_block=8,
                                               fused_zbuild=True)),
    "vector boundary": ("liteopt", dict(lanczos_block=1)),
    "sketch boundary": ("liteopt", dict(lanczos_block=8,
                                        warm_start="sketch")),
}


def _tensor(seed: int = 0, nnz: int = 2000) -> SparseTensor:
    r = np.random.default_rng(seed)
    coords = np.stack([r.integers(0, L, nnz) for L in SHAPE], axis=1)
    return SparseTensor(coords, r.standard_normal(nnz).astype(np.float32),
                        SHAPE).dedup()


def _steps(ex: HooiExecutor, t: SparseTensor, pl, case: str) -> list:
    """Per mode, the executor's cached step and its arrays at ``case``'s
    knobs, as ``run`` resolves them."""
    path, kw = CASES[case]
    specs = ex._mode_specs(pl, CORE, path, ModeSpec(
        block_size=kw.get("lanczos_block", 1),
        fused_zbuild=kw.get("fused_zbuild", False),
        warm_start=kw.get("warm_start", "none"), use_fused=True))
    up = ex._get_upload(pl, t, _tally())
    out = []
    for mp, sp in zip(pl.parts, specs):
        _, step = ex._get_step(mp, sp)
        out.append((up.arrs[mp.mode], step))
    return out


class _Replayed:
    """A segment the stub ended: replaying it runs nothing (the stub ran
    the step eagerly as it went)."""

    def replay(self) -> None:
        pass


class _Seam(StepGraph):
    """The ``graphs`` seam as a capture drives it, run eagerly on the CPU:
    each upload slot and host call recorded (``events``), a cut ending a
    segment, and ``StepGraph``'s own per-segment byte tally. ``inside`` is
    set while the seam's host work runs (a draw, a factorization)."""

    def __init__(self, mesh=None):
        super().__init__(None, None, [], mesh)
        self.moved.append(collections.Counter())  # the first segment
        self.events: list = []
        self.inside = 0

    def _host(self, fn, *args):
        self.inside += 1
        try:
            return fn(*args)
        finally:
            self.inside -= 1

    def upload(self, make_host, dev):
        if self.inside:  # a draw inside another slot's host work
            return make_host().to(dev)
        val = self._host(make_host)
        self.events.append(("upload", tuple(val.shape)))
        return val.to(dev)

    def cut(self, fn, tensors):
        self.events.append(("host_call",
                            tuple(tuple(t.shape) for t in tensors)))
        self.segments.append(_Replayed())
        self.moved.append(collections.Counter())
        return self._host(lambda: fn(*(t.cpu() for t in tensors)))

    def end(self) -> None:
        self.segments.append(_Replayed())


@pytest.fixture
def seam(monkeypatch):
    """``_Seam``: the step code's ``upload`` and ``host_call`` go to the
    stub while ``graphs._recording`` holds one, and to ``graphs`` else."""

    def up(make_host, device):
        rec = graphs._recorder()
        if isinstance(rec, _Seam):
            return rec.upload(make_host, torch.device(device))
        return graphs.upload(make_host, device)

    def call(fn, *tensors):
        rec = graphs._recorder()
        if isinstance(rec, _Seam):
            return rec.cut(fn, tensors)
        return graphs.host_call(fn, *tensors)

    for mod in list(sys.modules.values()):
        if getattr(mod, "__name__", "").startswith("repro_torch.") \
                and mod is not graphs:
            if getattr(mod, "upload", None) is graphs.upload:
                monkeypatch.setattr(mod, "upload", up)
            if getattr(mod, "host_call", None) is graphs.host_call:
                monkeypatch.setattr(mod, "host_call", call)
    return _Seam


def _record(seam_obj, step, arrs, factors, key):
    with graphs._recording(seam_obj):
        out = step(arrs, factors, key)
    seam_obj.end()
    return out


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_step_makes_the_stacked_slots_and_cuts(seam, case, G):
    """The mesh step asks the seam for the stacked step's upload slots and
    host calls, in the same order and shapes: its capture has the stacked
    step's slots and segments."""
    t = _tensor()
    pl = build_plan(t, "lite", P, core_dims=CORE, path=CASES[case][0])
    factors = random_factors(t.shape, CORE, make_key(1), "cpu")
    mesh = make_ranks_mesh(P, devices=["cpu"] * G)
    stacked = _steps(HooiExecutor(P, "cpu"), t, pl, case)
    spread = _steps(HooiExecutor(P, mesh=mesh), t, pl, case)
    for n, ((sa, sstep), (ma, mstep)) in enumerate(zip(stacked, spread)):
        key = make_key(2).fold_in(1000 + n)
        want, got = seam(), seam(mesh)
        _record(want, sstep, sa, factors, key)
        _record(got, mstep, ma, factors, key)
        assert got.events == want.events, (case, n)
        assert any(e[0] == "upload" for e in got.events)
        assert len(got.segments) == len(want.segments) == 1 + sum(
            e[0] == "host_call" for e in got.events)


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_step_reads_no_device_value_outside_the_seam(seam, monkeypatch,
                                                         case, G):
    """While the mesh step runs, every host read (``item``, ``tolist``,
    ``cpu``, ``numpy``, ``torch.cuda.synchronize``) raises unless the seam's
    own host work makes it: the step is free of host reads, so each of its
    segments can be captured."""
    t = _tensor()
    pl = build_plan(t, "lite", P, core_dims=CORE, path=CASES[case][0])
    factors = random_factors(t.shape, CORE, make_key(1), "cpu")
    mesh = make_ranks_mesh(P, devices=["cpu"] * G)
    steps = _steps(HooiExecutor(P, mesh=mesh), t, pl, case)
    rec = seam(mesh)
    reads = []

    def guarded(name, real):
        def call(*a, **k):
            if not rec.inside:
                reads.append(name)
                raise AssertionError(f"{name} outside the seam")
            return real(*a, **k)
        return call

    with monkeypatch.context() as mp:
        for name in ("item", "tolist", "cpu", "numpy"):
            mp.setattr(torch.Tensor, name,
                       guarded(name, getattr(torch.Tensor, name)))
        mp.setattr(torch.cuda, "synchronize",
                   guarded("synchronize", torch.cuda.synchronize))
        for n, (arrs, step) in enumerate(steps):
            with graphs._recording(rec):
                F, S = step(arrs, factors, make_key(2).fold_in(1000 + n))
    assert not reads
    assert rec.events and S.shape == (CORE[-1],)


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_tally_gives_the_eager_bytes(seam, case, G):
    """What a capture records per segment, added once per replay, is what
    the eager step moves between the groups, by kind; the eager warm-up
    before a capture counts nothing. A boundary step's last segment (after
    the SVD) moves the small rotation out to the groups."""
    t = _tensor()
    pl = build_plan(t, "lite", P, core_dims=CORE, path=CASES[case][0])
    factors = random_factors(t.shape, CORE, make_key(1), "cpu")
    mesh = make_ranks_mesh(P, devices=["cpu"] * G)
    for n, (arrs, step) in enumerate(_steps(HooiExecutor(P, mesh=mesh), t,
                                            pl, case)):
        key = make_key(2).fold_in(1000 + n)
        before = mesh.moved_by_kind
        eager = step(arrs, factors, key)
        after = mesh.moved_by_kind
        moved = {k: after[k] - before[k] for k in after}
        assert sum(moved.values()) > 0

        with graphs._recording(graphs._Warmup()):
            step(arrs, factors, key)
        assert mesh.moved_by_kind == after  # the warm-up is not a run

        rec = seam(mesh)
        got = _record(rec, step, arrs, factors, key)
        captured = mesh.moved_by_kind
        assert {k: captured[k] - after[k] for k in after} == moved
        assert torch.equal(got[1], eager[1])
        tallied = collections.Counter()
        for seg in rec.moved:
            for (counter, kind), nbytes in seg.items():
                assert counter is mesh
                tallied[kind] += nbytes
        assert {k: tallied[k] for k in moved} == moved
        if CASES[case][0] == "liteopt":
            assert rec.moved[-1][mesh, "u"] > 0
        for _ in range(2):  # two replays
            for i in range(len(rec.segments)):
                rec._replay_segment(i)
        final = mesh.moved_by_kind
        assert {k: final[k] - captured[k] for k in after} == \
            {k: 2 * v for k, v in moved.items()}
