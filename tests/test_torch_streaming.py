"""The port's streaming layer against the reference's: all numpy, so equal.

Twins of ``tests/test_streaming.py`` and ``tests/test_coo_io.py``. The
port's ``StreamingTensor`` keeps its accumulated values in numpy arrays
where the reference keeps a dict, so every result is held to the
reference's exactly: chain fingerprints, slice histograms,
``coords_since``, snapshots (coordinates, values, ``_stream_version`` and
``_true_norm2`` bitwise, duplicates across batches included), the plan's
streaming helpers (owner maps, ``extend_scheme``, ``refresh_decision`` with
every drift entry, ``stochastic_refine_seconds``, ``rescore_plan``), the
``.tns`` reader, writer and ``stream_tns`` chain, and the
``REPRO_SAMPLE_FRACTION`` knob. ``fit_score`` fed a reference snapshot's
``_true_norm2`` gives the reference's fit bitwise for the same core.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import envknobs as ref_envknobs
from repro.core import coo as ref_coo
from repro.core import plan as ref_plan
from repro.core.hooi import Decomposition as RefDecomposition
from repro.core.hooi import fit_score as ref_fit_score
from repro.data.frostt import stream_tns as ref_stream_tns
from repro.streaming import StreamingTensor as RefStream
from repro_torch import convert, envknobs
from repro_torch.core import coo
from repro_torch.core import plan as port_plan
from repro_torch.core.hooi import Decomposition, fit_score, hooi
from repro_torch.data.frostt import stream_tns
from repro_torch.streaming import StreamingTensor

SHAPE = (10, 8, 6)


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


def _batch(rng, shape, n):
    coords = np.stack([rng.integers(0, L, n) for L in shape], axis=1)
    return coords, rng.standard_normal(n)


def _batches(seed, shape=SHAPE, k=5, dup_share=0.5):
    """k batches whose later members repeat earlier coordinates."""
    rng = np.random.default_rng(seed)
    out = [_batch(rng, shape, int(rng.integers(20, 80)))]
    for _ in range(k - 1):
        c, v = _batch(rng, shape, int(rng.integers(1, 60)))
        seen = np.concatenate([b[0] for b in out])
        ndup = int(dup_share * len(c))
        if ndup:
            c[:ndup] = seen[rng.integers(0, len(seen), ndup)]
        out.append((c, v))
    return out


def _both(batches, shape=SHAPE):
    ref, port = RefStream(shape, name="s"), StreamingTensor(shape, name="s")
    for c, v in batches:
        assert port.append(c, v) == ref.append(c, v)
    return ref, port


# ------------------------------------------------------------ StreamingTensor
def test_append_validates_bounds_and_shapes():
    s = StreamingTensor((4, 5, 6))
    with pytest.raises(ValueError, match="out of bounds"):
        s.append([[0, 0, 6]], [1.0])
    with pytest.raises(ValueError, match="non-negative"):
        s.append([[0, -1, 0]], [1.0])
    with pytest.raises(ValueError, match="coords must be"):
        s.append([[0, 0]], [1.0])
    with pytest.raises(ValueError, match="values"):
        s.append([[0, 0, 0]], [1.0, 2.0])
    with pytest.raises(ValueError, match="invalid shape"):
        StreamingTensor((4, 0))
    assert s.version == 0 and s.nnz == 0


def test_empty_append_is_a_noop(rng):
    shape = (6, 5, 4)
    s = StreamingTensor(shape)
    c, v = _batch(rng, shape, 20)
    s.append(c, v)
    fp, ver, snap = s.fingerprint(), s.version, s.snapshot()
    assert s.append(np.zeros((0, 3), dtype=np.int64), []) == ver
    assert s.fingerprint() == fp and s.version == ver
    assert s.snapshot() is snap


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_fingerprint_matches_reference(seed):
    batches = _batches(seed)
    ref, port = _both(batches)
    assert port.fingerprint() == ref.fingerprint()
    assert port.version == ref.version and port.nnz == ref.nnz
    # order sensitive, as the reference's
    _, rev = _both(batches[::-1])
    assert rev.fingerprint() != port.fingerprint()
    # an empty stream's chain root too
    assert StreamingTensor(SHAPE).fingerprint() == \
        RefStream(SHAPE).fingerprint()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_snapshot_and_true_norm2_bitwise(seed):
    """Duplicates across batches: ``_true_norm2`` has the reference's bits
    (the same sorted-unique sum), and differs from sum(values**2)."""
    ref, port = _both(_batches(seed, dup_share=0.6))
    a, b = ref.snapshot(), port.snapshot()
    assert isinstance(b, coo.SparseTensor)
    np.testing.assert_array_equal(b.coords, a.coords)
    np.testing.assert_array_equal(b.values, a.values)
    assert (b.coords.dtype, b.values.dtype) == (a.coords.dtype,
                                                a.values.dtype)
    assert b.fingerprint() == a.fingerprint() == port.fingerprint()
    assert b._stream_version == a._stream_version == port.version
    assert b._true_norm2 == a._true_norm2
    merged = b.dedup()
    assert b._true_norm2 == pytest.approx(float(np.sum(merged.values**2)),
                                          rel=1e-12)
    assert b._true_norm2 != pytest.approx(float(np.sum(b.values**2)),
                                          rel=1e-6)
    assert port.snapshot() is b  # cached until the next append
    c, v = _batch(np.random.default_rng(seed), SHAPE, 3)
    port.append(c, v)
    ref.append(c, v)
    assert port.snapshot() is not b
    assert port.snapshot()._true_norm2 == ref.snapshot()._true_norm2


def test_incremental_histograms_and_coords_since(rng):
    batches = _batches(4, shape=(7, 9, 5), k=3)
    ref, port = _both(batches, shape=(7, 9, 5))
    t = port.snapshot()
    for n in range(3):
        np.testing.assert_array_equal(port.slice_hist(n), ref.slice_hist(n))
        np.testing.assert_array_equal(port.slice_hist(n), t.slice_sizes(n))
    for v in range(4):
        np.testing.assert_array_equal(port.coords_since(v),
                                      ref.coords_since(v))
    np.testing.assert_array_equal(port.coords_since(1),
                                  np.concatenate([b[0] for b in batches[1:]]))
    assert port.coords_since(3).shape == (0, 3)
    with pytest.raises(ValueError, match="outside"):
        port.coords_since(4)


def test_from_tensor_seeds_first_batch(small_tensor):
    s = StreamingTensor.from_tensor(_port(small_tensor))
    r = RefStream.from_tensor(small_tensor)
    assert s.version == 1 and s.nnz == small_tensor.nnz
    assert s.fingerprint() == r.fingerprint()
    t = s.snapshot()
    np.testing.assert_array_equal(t.coords, small_tensor.coords)
    assert t._true_norm2 == r.snapshot()._true_norm2


@pytest.mark.parametrize("k", [1, 3])
def test_snapshot_does_not_alias_appended_buffers(k):
    """A snapshot owns its arrays, as the reference's concatenation does:
    a caller reusing an appended buffer leaves it (and the cached tensor
    its fingerprint keys) unchanged, one batch or several."""
    s = StreamingTensor(SHAPE)
    batches = [(c.astype(np.int64), v.astype(np.float64))
               for c, v in _batches(7, k=k)]
    for c, v in batches:
        s.append(c, v)
    t = s.snapshot()
    want = t.coords.copy(), t.values.copy()
    for c, v in batches:
        assert not np.shares_memory(t.coords, c)
        assert not np.shares_memory(t.values, v)
        c[:] = 0
        v[:] = 0.0
    np.testing.assert_array_equal(t.coords, want[0])
    np.testing.assert_array_equal(t.values, want[1])


def _dyadic_core(seed, shape):
    # entries k/4: ||G||^2 is exact in f32 whatever the summation order, so
    # the two packages' fits can agree bitwise
    r = np.random.default_rng(seed)
    return (r.integers(-8, 9, shape) / 4.0).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_score_prefers_true_norm2(seed):
    """The repaired ``fit_score``: a snapshot's ``_true_norm2`` (here the
    reference's own) takes precedence over sum(values**2), giving the
    reference's fit bitwise."""
    ref, _ = _both(_batches(seed, dup_share=0.6))
    snap = ref.snapshot()
    t = _port(snap)
    object.__setattr__(t, "_true_norm2", snap._true_norm2)
    core = _dyadic_core(seed, (2, 2, 2))
    want = ref_fit_score(snap, RefDecomposition(core=jnp.asarray(core),
                                                factors=[]))
    got = fit_score(t, Decomposition(core=torch.from_numpy(core),
                                     factors=[]))
    assert got == want
    # without the attribute both fall back to sum(values**2), and that fit
    # is another number: the attribute is what decides
    plain = fit_score(_port(snap), Decomposition(
        core=torch.from_numpy(core), factors=[]))
    assert plain == ref_fit_score(ref_coo.SparseTensor(
        snap.coords, snap.values, snap.shape), RefDecomposition(
            core=jnp.asarray(core), factors=[]))
    assert plain != got


def test_streamed_fit_equals_deduplicated_fit(lowrank_tensor):
    """Twin of the reference's duplicate-append test on the port's
    ``hooi``: scored against the duplicated snapshot, a decomposition's
    fit is the de-duplicated tensor's."""
    t = _port(lowrank_tensor)
    s = StreamingTensor.from_tensor(t)
    s.append(t.coords[:30], t.values[:30])
    snap = s.snapshot()
    merged = snap.dedup()
    assert np.isclose(snap._true_norm2, float(np.sum(merged.values**2)))
    dec, _ = hooi(merged, (2, 2, 2), n_invocations=2, seed=0, device="cpu")
    assert np.isclose(fit_score(snap, dec), fit_score(merged, dec),
                      atol=1e-6)


# --------------------------------------------- the plan's streaming helpers
def _plans(t, P=4, core=(3, 3, 3)):
    # uncached: the shared fixtures' plans stay out of both plan caches
    return (ref_plan.plan(t, "lite", P, core_dims=core, use_cache=False),
            port_plan.plan(_port(t), "lite", P, core_dims=core,
                           use_cache=False))


def test_owner_maps_match_reference(small_tensor, skewed_tensor):
    rp, pp = _plans(small_tensor)
    want = ref_plan.slice_owner_maps(rp, small_tensor)
    got = port_plan.slice_owner_maps(pp, _port(small_tensor))
    for n, (a, b) in enumerate(zip(got, want, strict=True)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert a.shape == (small_tensor.shape[n],)
        assert ((a >= 0) & (a < 4)).all()
    with pytest.raises(ValueError, match="snapshot"):
        port_plan.slice_owner_maps(pp, _port(skewed_tensor))


def test_extend_scheme_matches_reference(small_tensor, rng):
    rp, pp = _plans(small_tensor)
    rmaps = ref_plan.slice_owner_maps(rp, small_tensor)
    pmaps = port_plan.slice_owner_maps(pp, _port(small_tensor))
    batch = small_tensor.coords[rng.integers(0, small_tensor.nnz, 40)]
    want = ref_plan.extend_scheme(rp.scheme, rmaps, batch)
    got = port_plan.extend_scheme(pp.scheme, pmaps, batch)
    assert (got.name, got.uni, got.P) == (want.name, want.uni, want.P)
    for n in range(3):
        a, b = got.policy(n), want.policy(n)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        np.testing.assert_array_equal(a[:len(pp.scheme.policy(n))],
                                      pp.scheme.policy(n))


def _loads(pl, maps, batch):
    base = [np.asarray(mp.e_per_rank) for mp in pl.parts]
    return [base[n] + np.bincount(maps[n][batch[:, n]], minlength=pl.P)
            for n in range(len(base))]


@pytest.mark.parametrize("kind", ["updates", "hub"])
def test_refresh_decision_matches_reference(small_tensor, rng, kind):
    rp, pp = _plans(small_tensor)
    maps = port_plan.slice_owner_maps(pp, _port(small_tensor))
    if kind == "updates":
        batch = small_tensor.coords[rng.integers(0, small_tensor.nnz, 60)]
    else:
        batch = np.tile(small_tensor.coords[0], (10 * small_tensor.nnz, 1))
    loads = _loads(pp, maps, batch)
    for kw in (dict(), dict(tol=0.1), dict(baseline=(1.0, 1.2, 1.5)),
               dict(stochastic={"sampled_nnz": 5, "total_nnz": 500}),
               dict(stochastic={"sampled_nnz": 5, "total_nnz": 500,
                                "tol": 0.5}, tol=0.6)):
        want = ref_plan.refresh_decision(rp, loads, **kw)
        got = port_plan.refresh_decision(pp, loads, **kw)
        assert got == want, kw  # the decision and every drift entry
    dec, drift = port_plan.refresh_decision(pp, loads)
    assert dec == ("repartition" if kind == "updates" else "reselect")
    assert set(drift) == {0, 1, 2, "worst"}


@pytest.mark.parametrize("seed", range(6))
def test_refresh_decision_random_loads_match_reference(small_tensor, seed):
    rp, pp = _plans(small_tensor)
    r = np.random.default_rng(seed)
    loads = [r.integers(1, 200, size=4).astype(np.float64) for _ in range(3)]
    baseline = [1.0 + r.uniform(0.0, 0.5) for _ in range(3)]
    tol = float(r.uniform(0.05, 0.5))
    stoch = {"sampled_nnz": int(r.integers(1, 400)), "total_nnz": 400}
    for kw in (dict(), dict(stochastic=stoch)):
        assert port_plan.refresh_decision(pp, loads, tol=tol,
                                          baseline=baseline, **kw) == \
            ref_plan.refresh_decision(rp, loads, tol=tol, baseline=baseline,
                                      **kw)


def test_decision_thresholds_exact(small_tensor):
    _, pp = _plans(small_tensor, P=2)
    base = [1.0] * 3
    loads = [np.array([3.0, 1.0])] * 3
    assert port_plan.refresh_decision(pp, loads, tol=0.5,
                                      baseline=base)[0] == "repartition"
    assert port_plan.refresh_decision(pp, loads, tol=0.49,
                                      baseline=base)[0] == "reselect"
    flat = [np.array([1.0, 1.0])] * 3
    cheap = {"sampled_nnz": 1, "total_nnz": 10_000}
    dec, drift = port_plan.refresh_decision(pp, flat, tol=0.5, baseline=base,
                                            stochastic=cheap)
    assert dec == "stochastic-refine"
    assert drift["stochastic_s"] < drift["full_sweep_s"]
    dec, _ = port_plan.refresh_decision(
        pp, flat, tol=0.5, baseline=base,
        stochastic={"sampled_nnz": 10_000, "total_nnz": 10_000})
    assert dec == "repartition"


def test_baseline_override_prevents_ratchet(small_tensor):
    _, pl = _plans(small_tensor)
    maps = port_plan.slice_owner_maps(pl, _port(small_tensor))
    selection = tuple(max(float(m.ttm_imbalance), 1.0)
                      for m in pl.metrics.per_mode)
    loads = [np.asarray(mp.e_per_rank).astype(np.int64) for mp in pl.parts]
    hub = [int(maps[n][small_tensor.coords[0][n]]) for n in range(3)]
    decisions = []
    for _ in range(12):
        step = max(int(0.15 * loads[0].max()), 1)
        for n in range(3):
            loads[n][hub[n]] += step
        decisions.append(port_plan.refresh_decision(
            pl, loads, baseline=selection)[0])
    assert decisions[0] == "repartition" and "reselect" in decisions


@pytest.mark.parametrize("sampled,total", [(0, 100), (10, 100), (1, 10_000),
                                           (500, 100), (7, 0)])
def test_stochastic_refine_seconds_matches_reference(small_tensor, sampled,
                                                     total):
    rp, pp = _plans(small_tensor)
    assert port_plan.stochastic_refine_seconds(pp, sampled, total) == \
        ref_plan.stochastic_refine_seconds(rp, sampled, total)


def test_rescore_plan_matches_reference(small_tensor):
    rp, pp = _plans(small_tensor)
    want = ref_plan.rescore_plan(rp, small_tensor, (4, 2, 3))
    got = port_plan.rescore_plan(pp, _port(small_tensor), (4, 2, 3))
    assert got.parts is pp.parts and got.core_dims == want.core_dims
    assert got.cache_key is None
    assert dataclasses.asdict(got.metrics) == dataclasses.asdict(want.metrics)
    assert got.cost.total_s == want.cost.total_s
    with pytest.raises(ValueError, match="entries"):
        port_plan.rescore_plan(pp, _port(small_tensor), (4, 2))


def test_same_version_snapshots_share_one_plan(small_tensor, tmp_path):
    s = StreamingTensor.from_tensor(_port(small_tensor))
    a = port_plan.plan(s.snapshot(), "lite", 4, core_dims=(3, 3, 3),
                       pad_geometric=True)
    assert a is port_plan.plan(s.snapshot(), "lite", 4, core_dims=(3, 3, 3),
                               pad_geometric=True)
    assert a.stream_version == 1 and a.fingerprint == s.fingerprint()
    s.append(small_tensor.coords[:5], small_tensor.values[:5])
    t = s.snapshot()
    pl = port_plan.plan(t, "lite", 4, core_dims=(3, 3, 3),
                        pad_geometric=True)
    path = str(tmp_path / "stream_plan.npz")
    pl.save(path)
    got = port_plan.PartitionPlan.load(path, t)
    assert (got.fingerprint, got.stream_version, got.pad_geometric) == \
        (s.fingerprint(), 2, True)
    # the reference loads the port's file for its own stream of that history
    r = RefStream.from_tensor(small_tensor)
    r.append(small_tensor.coords[:5], small_tensor.values[:5])
    assert ref_plan.PartitionPlan.load(path, r.snapshot()).stream_version == 2
    s.append(small_tensor.coords[:1], small_tensor.values[:1])
    with pytest.raises(ValueError, match="stale plan"):
        port_plan.PartitionPlan.load(path, s.snapshot())


# ------------------------------------------------------------- FROSTT IO
def test_tns_roundtrip_matches_reference(tmp_path):
    from repro.data.tensors import synth_tensor

    t = synth_tensor((10, 12, 8), 200, seed=0)
    p = str(tmp_path / "port.tns")
    coo.write_tns(p, _port(t))
    q = str(tmp_path / "ref.tns")
    ref_coo.write_tns(q, t)
    assert open(p).read() == open(q).read()
    got, want = coo.read_tns(p), ref_coo.read_tns(p)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(got.values, want.values)
    key1 = np.ravel_multi_index(tuple(t.coords.T), t.shape)
    key2 = np.ravel_multi_index(tuple(got.coords.T), t.shape)
    o1, o2 = np.argsort(key1), np.argsort(key2)
    np.testing.assert_array_equal(key1[o1], key2[o2])
    np.testing.assert_array_equal(t.values[o1], got.values[o2])


def test_permute_mode_and_dedup():
    from repro.data.tensors import synth_tensor

    t = synth_tensor((6, 7, 8), 100, seed=1)
    pt = _port(t)
    perm = np.random.default_rng(0).permutation(6)
    got, want = pt.permute_mode(0, perm), t.permute_mode(0, perm)
    np.testing.assert_array_equal(got.coords, want.coords)
    np.testing.assert_array_equal(
        got.permute_mode(0, np.argsort(perm)).coords, t.coords)
    d = coo.SparseTensor(np.array([[0, 0], [0, 0], [1, 1]]),
                         np.array([1.0, 2.0, 5.0]), (2, 2)).dedup()
    assert d.nnz == 2 and d.todense()[0, 0] == 3.0


@pytest.mark.parametrize("batch,shape", [(7, (6, 5, 4)), (1000, None)])
def test_stream_tns_chain_matches_reference(tmp_path, batch, shape):
    rng = np.random.default_rng(5)
    coords, values = _batch(rng, (6, 5, 4), 60)
    coords[40:] = coords[:20]  # duplicates: value updates
    p = str(tmp_path / "s.tns")
    with open(p, "w") as f:
        f.write("% a comment line\n")
        for c, v in zip(coords.tolist(), values.tolist()):
            f.write(" ".join(str(x + 1) for x in c) + f" {v!r}\n")
    got = stream_tns(p, batch_nnz=batch, shape=shape)
    want = ref_stream_tns(p, batch_nnz=batch, shape=shape)
    assert (got.shape, got.version, got.nnz, got.name) == \
        (want.shape, want.version, want.nnz, want.name)
    assert got.fingerprint() == want.fingerprint()
    assert got.snapshot()._true_norm2 == want.snapshot()._true_norm2
    np.testing.assert_array_equal(got.snapshot().values, values)


# ------------------------------------------------------------------ knobs
@pytest.mark.parametrize("raw", ["", "0.25", "1", "1.0", "0", "1.5", "-0.1",
                                 "x"])
def test_sample_fraction_knob_matches_reference(monkeypatch, raw):
    monkeypatch.setenv("REPRO_SAMPLE_FRACTION", raw)
    try:
        want = ref_envknobs.sample_fraction()
    except ValueError as e:
        with pytest.raises(ValueError, match="REPRO_SAMPLE_FRACTION"):
            envknobs.sample_fraction()
        assert "REPRO_SAMPLE_FRACTION" in str(e)
        return
    assert envknobs.sample_fraction() == want


def test_knob_registry_is_the_references_less_tpu_knobs(monkeypatch):
    for var in ref_envknobs.KNOBS:
        monkeypatch.delenv(var, raising=False)
    assert set(envknobs.KNOBS) == set(ref_envknobs.KNOBS) - {
        "REPRO_FORCE_KERNEL", "REPRO_VMEM_BUDGET"}
    for var, parse in envknobs.KNOBS.items():
        assert parse() == ref_envknobs.KNOBS[var]()


def test_dist_hooi_pad_geometric_matches_reference(small_tensor):
    """``dist_hooi(..., pad_geometric=True)`` plans with power-of-two pads
    (part of the plan-cache key), as the reference's does."""
    from repro.distributed.dist_hooi import dist_hooi as ref_dist_hooi
    from repro_torch.distributed.dist_hooi import dist_hooi
    from test_torch_hooi import assert_fits_match, jax_draws

    _, want = ref_dist_hooi(small_tensor, (3, 3, 3), 4, n_invocations=2,
                            pad_geometric=True)
    _, got = dist_hooi(_port(small_tensor), (3, 3, 3), 4, n_invocations=2,
                       pad_geometric=True, device="cpu", draw=jax_draws(0))
    assert (got.e_pad, got.r_pad) == (want.e_pad, want.r_pad)
    assert all(e & (e - 1) == 0 for e in got.e_pad.values())
    assert_fits_match(got.fits, want.fits)
