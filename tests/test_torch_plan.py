"""The port's host layer against the reference's: schemes, metrics, plans.

The port computes the reference's numpy host arrays (``core/distribution.py``,
``core/metrics.py``, ``core/plan.py``, ``distributed/partition.py``) by
counting where the reference sorts, its passes over the elements in PyTorch
on the plan's device (``core/tally.py``; here the CPU, on the card the same
code, ``tests/test_torch_cuda.py``), so the same tensor and the same scheme
must give exactly the same partitions: every
``ModePartition`` array, every ``SchemeMetrics`` field and every modeled
cost compare with ``np.array_equal``/``==``, for ``lite``, ``coarse`` and
``medium`` on the shared fixtures and on tensors shaped like the FROSTT
deployments: a four-mode hub, a hypersparse mode, P = 2 and P = 7, and a
shape past a 64-bit linear index.
"""

import dataclasses
import weakref

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import distribution as ref_distribution
from repro.core import metrics as ref_metrics
from repro.core import plan as ref_plan
from repro.core.coo import SparseTensor as RefSparseTensor
from repro.data.tensors import synth_tensor
from repro_torch import convert, tracing
from repro_torch.core import distribution, metrics, tally
from repro_torch.core import plan as port_plan
from repro_torch.core.distribution import build_scheme

# fixture -> (core dims, P)
CORE = {"small_tensor": ((3, 3, 3), 4), "lowrank_tensor": ((2, 2, 2), 4),
        "skewed_tensor": ((4, 4, 4), 4),
        "hub4_tensor": ((2, 2, 2, 2), 4),
        "hypersparse_tensor": ((3, 3, 3), 4),
        "p2_tensor": ((3, 3, 3), 2),
        "p7_tensor": ((3, 3, 3), 7),
        "past_2_63_tensor": ((2, 2, 2, 2), 4)}


@pytest.fixture
def hub4_tensor():
    """Four modes with a mode-0 hub slice, enron's skews."""
    return synth_tensor((20, 25, 60, 12), 3_000, alphas=(1.4, 1.4, 1.1, 0.8),
                        hub_fraction=0.09, hub_modes=(0,), seed=5)


@pytest.fixture
def hypersparse_tensor():
    """A last mode of 200,000 slices, of which at most 800 hold elements
    (nell-1's third mode: 25.5M slices, 1.8M of them non-empty)."""
    return synth_tensor((40, 30, 200_000), 800, alphas=(1.0, 1.0, 1.4),
                        seed=11)


@pytest.fixture
def p2_tensor():
    return synth_tensor((10, 30, 25), 500, alphas=(1.5, 1.0, 0.8),
                        hub_fraction=0.3, hub_modes=(0,), seed=3)


@pytest.fixture
def p7_tensor():
    """At P = 7 under Lite: a rank that owns no whole slice, a rank with
    more owned rows than its quota (rows spill) and ties in the owner's
    counts (``test_p7_tensor_has_splits_spills_and_ties``)."""
    return synth_tensor((3, 200, 30), 700, alphas=(2.0, 0.5, 0.5),
                        hub_fraction=0.3, hub_modes=(0,), seed=14)


@pytest.fixture
def past_2_63_tensor():
    """A shape whose linear index needs more than 63 bits."""
    shape = (70_001, 70_003, 65_537, 65_539)
    assert np.prod([float(L) for L in shape]) > 2.0 ** 63
    r = np.random.default_rng(63)
    # few distinct values a mode, so slices are shared and ranks tie
    coords = np.stack([r.choice(r.integers(0, L, 40), 600) for L in shape],
                      axis=1)
    coords = np.unique(coords, axis=0)
    return RefSparseTensor(coords, r.standard_normal(len(coords)), shape)


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


def _assert_same_fields(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif isinstance(b, tuple) and b and dataclasses.is_dataclass(b[0]):
            for x, y in zip(a, b, strict=True):
                _assert_same_fields(x, y)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("scheme", ["lite", "coarse", "medium"])
@pytest.mark.parametrize("fixture", sorted(CORE))
def test_plan_matches_reference_exactly(request, fixture, scheme):
    t = request.getfixturevalue(fixture)
    core, P = CORE[fixture]
    want = ref_plan.plan(t, scheme, P, core_dims=core, path="liteopt",
                         use_cache=False)
    got = port_plan.plan(_port(t), scheme, P, core_dims=core,
                         path="liteopt", use_cache=False)
    assert got.fingerprint == want.fingerprint
    assert got.scheme.uni == want.scheme.uni
    for a, b in zip(got.scheme.policies, want.scheme.policies, strict=True):
        assert np.array_equal(a, b)
    assert len(got.parts) == len(want.parts) == t.ndim
    for mp, mp_ref in zip(got.parts, want.parts):
        _assert_same_fields(mp, mp_ref)
    _assert_same_fields(got.metrics, want.metrics)
    for f in ("flops_s", "comm_s", "comm_bytes", "path", "ttm_s", "svd_s",
              "mode_backends", "backend_s"):
        assert getattr(got.cost, f) == getattr(want.cost, f), f
    for n in range(t.ndim):
        assert got.comm(n) == want.comm(n)


def test_auto_selection_matches_reference(skewed_tensor):
    t, core = skewed_tensor, CORE["skewed_tensor"][0]
    want = ref_plan.plan(t, "auto", 4, core_dims=core, path="auto",
                         use_cache=False)
    got = port_plan.plan(_port(t), "auto", 4, core_dims=core, path="auto",
                         use_cache=False)
    assert got.name == want.name
    assert got.candidates == want.candidates
    assert got.cost.mode_backends == want.cost.mode_backends


def test_plan_cache_returns_the_same_object(small_tensor):
    # another test file in this process may have cached these plans
    port_plan.plan_cache_clear()
    t = _port(small_tensor)
    first = port_plan.plan(t, "lite", 4, core_dims=(3, 3, 3))
    again = port_plan.plan(_port(small_tensor), "lite", 4,
                           core_dims=(3, 3, 3))
    assert again is first and port_plan.last_plan_call_cache_hit()
    other = port_plan.plan(t, "lite", 2, core_dims=(3, 3, 3))
    assert other is not first and not port_plan.last_plan_call_cache_hit()
    # a prebuilt Scheme is keyed on its content, not its identity
    s1 = build_scheme(t, "coarse", 4)
    s2 = build_scheme(t, "coarse", 4)
    assert port_plan.plan(t, s1, core_dims=(3, 3, 3)) is \
        port_plan.plan(t, s2, core_dims=(3, 3, 3))


def test_plan_refuses_other_objectives(small_tensor):
    """Every objective of the reference plans (ROADMAP Queue A item 9) and
    is stamped on its plan; unknown objectives and paths are refused."""
    pl = port_plan.plan(_port(small_tensor), "lite", 4, objective="nn")
    assert pl.objective == "nn"
    with pytest.raises(ValueError, match="unknown objective"):
        port_plan.plan(_port(small_tensor), "lite", 4, objective="ridge")
    with pytest.raises(ValueError):
        port_plan.plan(_port(small_tensor), "lite", 4, path="nowhere")


def test_p7_tensor_has_splits_spills_and_ties(p7_tensor):
    """The P = 7 case covers what the counting has to get right: a rank
    whose slices are all shared (it owns no whole slice), a rank owning
    more rows than Lp (rows spill to other ranks) and slices whose largest
    count two ranks share (the owner is the higher rank)."""
    t, P = _port(p7_tensor), 7
    s = build_scheme(t, "lite", P)
    seen = set()
    for n in range(t.ndim):
        counts = tally.pair_counts(t, s.policy(n), n, P)
        sizes = t.slice_sizes(n)
        if not all(((c == sizes) & (sizes > 0)).any() for c in counts):
            seen.add("rank without a whole slice")
        owner = distribution.row_owner_map(t, s.policy(n), n, P)
        if np.bincount(owner, minlength=P).max() > -(-t.shape[n] // P):
            seen.add("rows spill")
        top = counts.max(axis=0)
        tied = ((counts == top) & (top > 0)).sum(axis=0) >= 2
        if tied.any():
            seen.add("tied owner")
            ranks = np.arange(P)[:, None]
            assert np.array_equal(
                owner[tied], ((counts == top) * ranks).max(axis=0)[tied])
    assert seen == {"rank without a whole slice", "rows spill", "tied owner"}


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10_000))
def test_counting_replacements_match_what_they_replace(seed):
    """Each count or ordering the port uses returns exactly what the
    reference's ``np.unique``/``lexsort``/stable ``argsort`` returns, on
    random small tensors whose (slice, rank) counts tie."""
    r = np.random.default_rng(seed)
    N = int(r.integers(2, 5))
    shape = tuple(int(x) for x in r.integers(1, 12, N))
    P = int(r.integers(1, 8))
    nnz = int(r.integers(0, 120))
    coords = np.stack([r.integers(0, L, nnz) for L in shape], axis=1)
    rt = RefSparseTensor(coords, r.standard_normal(nnz), shape)
    t = _port(rt)
    pols = tuple(r.integers(0, P, nnz).astype(np.int32) for _ in range(N))
    for n in range(N):
        pol = pols[n]
        # the tally's nonzeros are np.unique's keys, its values the counts
        counts = tally.pair_counts(t, pol, n, P)
        key = coords[:, n].astype(np.int64) * P + pol
        uniq, cnt = np.unique(key, return_counts=True)
        flat = counts.T.reshape(-1)
        assert np.array_equal(np.flatnonzero(flat), uniq)
        assert np.array_equal(flat[uniq], cnt)
        assert np.array_equal(distribution.row_owner_map(t, pol, n, P),
                              ref_distribution.row_owner_map(rt, pol, n, P))
        assert np.array_equal(metrics._r_per_rank(t, pol, n, P),
                              ref_metrics._r_per_rank(rt, pol, n, P))
        _assert_same_fields(metrics.mode_metrics(t, pol, n, P),
                            ref_metrics.mode_metrics(rt, pol, n, P))
        assert np.array_equal(distribution.lite_policy(t, n, P),
                              ref_distribution.lite_policy(rt, n, P))
        # inside a scope the sizes are the host's bincount, and the device's
        # stable sort of the partition's keys is numpy's stable argsort
        with tally.scope(t, "cpu"):
            sizes = tally.slice_sizes(t, n)
        want_sizes = rt.slice_sizes(n)
        assert sizes.dtype == want_sizes.dtype
        assert np.array_equal(sizes, want_sizes)
        pkey = pol.astype(np.int64) * shape[n] + coords[:, n]
        got_order = torch.sort(torch.from_numpy(pkey.astype(np.int32)),
                               stable=True)[1].numpy()
        assert np.array_equal(got_order, np.argsort(pkey, kind="stable"))
    core = tuple(int(k) for k in r.integers(1, 4, N))
    assert metrics._fm_volume(t, distribution.Scheme("x", pols, False, P),
                              core) == ref_metrics._fm_volume(
        rt, ref_distribution.Scheme("x", pols, False, P), core)
    # stable orders of bounded keys with ties, packed and too wide to pack
    for bound in (1, 3, 1 << 20, 1 << 61):
        keys = r.integers(0, min(bound, 5), int(r.integers(0, 200)))
        order, ordered = tally.stable_order(keys * (bound // 5 or 1), bound)
        want = np.argsort(keys, kind="stable")
        assert np.array_equal(order, want)
        assert np.array_equal(ordered, keys[want] * (bound // 5 or 1))
    # inside a build's scope the shared tallies give the same plan
    with tally.scope(t):
        scoped = port_plan.plan(t, "lite", P, core_dims=core, use_cache=False)
    bare = ref_plan.plan(rt, "lite", P, core_dims=core, use_cache=False)
    for mp, mp_ref in zip(scoped.parts, bare.parts, strict=True):
        _assert_same_fields(mp, mp_ref)
    _assert_same_fields(scoped.metrics, bare.metrics)


def _counters(name):
    """The total of the counter ``name`` over the recorded spans, and
    whether any span counted it."""
    seen = [e["counters"][name] for e in tracing.summary().values()
            if name in e["counters"]]
    return sum(seen), bool(seen)


@pytest.mark.parametrize("fixture", ["p7_tensor", "past_2_63_tensor"])
def test_plan_on_the_cpu_moves_no_bytes(request, fixture, monkeypatch):
    """On the CPU the plan's transfers are counted, as 0 bytes each way;
    uploads in many small steps give the same plan as in one."""
    t = _port(request.getfixturevalue(fixture))
    core, P = CORE[fixture]
    whole = port_plan.plan(t, "lite", P, core_dims=core, device="cpu",
                           use_cache=False)
    monkeypatch.setattr(tally, "_CHUNK_BYTES", 100)
    tracing.clear()
    try:
        with tracing.recording():
            pl = port_plan.plan(t, "lite", P, core_dims=core, device="cpu",
                                use_cache=False)
        up, up_seen = _counters("plan.upload_bytes")
        down, down_seen = _counters("plan.download_bytes")
        spans = tracing.summary()
    finally:
        tracing.clear()
    assert up_seen and down_seen and up == 0 and down == 0
    assert spans["plan.upload"]["parents"] == ["plan.partition", "plan.scheme"]
    assert spans["plan.download"]["parents"] == [
        "plan.metrics", "plan.partition", "plan.scheme"]
    assert sorted(pl.build_parts_s) == sorted(whole.build_parts_s)
    for a, b in zip(pl.scheme.policies, whole.scheme.policies, strict=True):
        assert np.array_equal(a, b)
    for mp, mp_whole in zip(pl.parts, whole.parts, strict=True):
        _assert_same_fields(mp, mp_whole)
    _assert_same_fields(pl.metrics, whole.metrics)


def test_scope_leaves_no_device_copy(p7_tensor, monkeypatch):
    """Every tensor a build uploads or builds a policy in is gone once its
    scope ends: nothing but its own locals and the scope held them."""
    t, (core, P) = _port(p7_tensor), CORE["p7_tensor"]
    made = []
    upload, keep = tally.upload, tally.keep_policy

    def tracked_upload(*a, **kw):
        out = upload(*a, **kw)
        made.append(weakref.ref(out))
        return out

    def tracked_keep(t_, dev):
        made.append(weakref.ref(dev))
        return keep(t_, dev)

    monkeypatch.setattr(tally, "upload", tracked_upload)
    monkeypatch.setattr(tally, "keep_policy", tracked_keep)
    with tally.scope(t, "cpu"):
        s = build_scheme(t, "lite", P)
        inside = tally.device_policy(t, s.policy(0))
        assert inside is tally.device_policy(t, s.policy(0))
        assert any(r() is inside for r in made)
        del inside
    assert made and all(r() is None for r in made)
    made.clear()
    port_plan.plan(t, "medium", P, core_dims=core, device="cpu",
                   use_cache=False)
    assert made and all(r() is None for r in made)
    with pytest.raises(RuntimeError, match="no tally.scope"):
        tally.device_coords(t)
