"""The port's sketch warm start against ``repro.core.sketch`` and the
reference's ``warm_start`` paths: twin of ``tests/test_sketch.py``.

The reference's ``jax.random`` draws go through the port's draw seam
(``repro_torch.random``): normals along ``fold_in`` paths, and below a
``jax.random.split`` the SRHT's ``choice`` and ``bernoulli`` draws, each
split child named by its position. Bars:

* bit-identical: ``sketch_niter``, ``sketch_block_size``,
  ``count_z_passes``, ``choose_warm_start`` and ``adapt_rank`` (over grids);
* within 1e-6 of the largest entry: ``test_matrix`` (both kinds) and
  ``seeded_start_panel`` (also when the panel is wider than the seed and
  draws at fold 41);
* subspaces ``U Uᵀ`` within 1e-4: ``range_finder``;
* fits within 1e-4 (the captured energy share within 1e-6 relative where
  the fit is within 1e-3 of 1, ROADMAP Queue C), ``F Fᵀ`` within 1e-3 and
  the final cores' energy within 2e-6 relative: ``hooi`` and ``dist_hooi``
  (P = 4 on the psum and boundary backends) under ``warm_start="sketch"``
  and ``"auto"``, with ``stats.warm_start`` and ``stats.z_passes`` equal to
  the reference's; ``dist_hooi`` at P = 1 equal to ``hooi`` within 1e-6.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sketch as ref_sketch
from repro.core.hooi import hooi as ref_hooi
from repro.core.hooi import random_factors as ref_random_factors
from repro.core.lanczos import effective_block_size as ref_effective_block
from repro.core.lanczos import lanczos_niter as ref_lanczos_niter
from repro.distributed.dist_hooi import dist_hooi as ref_dist_hooi
from repro.engine import oracle as ref_oracle
from repro_torch import convert
from repro_torch.core import sketch
from repro_torch.core.hooi import hooi
from repro_torch.distributed.dist_hooi import dist_hooi
from repro_torch.engine import oracle
from repro_torch.random import Key, SeededDraws, make_key
from test_torch_hooi import (assert_core_energy_matches, assert_fits_match,
                             assert_subspaces_match)

CORE = {"small_tensor": (3, 3, 3), "lowrank_tensor": (2, 2, 2)}


def _jax_key(root, path):
    k = root
    for p in path:
        k = jax.random.split(k)[p[1]] if isinstance(p, tuple) \
            else jax.random.fold_in(k, p)
    return k


def jax_draws(seed):
    """The reference's draws along a path of ``fold_in``s and ``split``
    children, through numpy, for every kind of draw the seam asks for."""
    root = jax.random.PRNGKey(seed)

    def draw(path, shape, kind="normal", **params):
        k = _jax_key(root, path)
        if kind == "normal":
            out = jax.random.normal(k, shape, jnp.float32)
        elif kind == "choice":
            out = jax.random.choice(k, params["n"], shape, replace=False)
        else:
            out = jax.random.bernoulli(k, params["p"], shape)
        return torch.from_numpy(np.array(out))

    return draw


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


GEOMETRIES = list(itertools.product((1, 2, 3, 10), (1, 3, 6, 120),
                                    (1, 4, 9, 100), (1, 2, 4, 8, 16)))


# ------------------------------------------------------ counting & widths
def test_budgets_and_widths_match_reference():
    for k, nr, nc, s in GEOMETRIES:
        assert sketch.sketch_niter(k, nr, nc, s) == \
            ref_sketch.sketch_niter(k, nr, nc, s)
        assert sketch.sketch_block_size(k, nr, nc, s) == \
            ref_sketch.sketch_block_size(k, nr, nc, s)
    assert sketch.DEFAULT_POWER_ITERS == ref_sketch.DEFAULT_POWER_ITERS
    assert sketch.SKETCH_KINDS == ref_sketch.SKETCH_KINDS


def test_count_z_passes_and_choose_warm_start_match_reference():
    for niter, fz, ws, pw in itertools.product(
            (1, 2, 20), (False, True), ("none", "sketch"), (0, 1, 2)):
        assert oracle.count_z_passes(niter, fz, warm_start=ws,
                                     power_iters=pw) == \
            ref_oracle.count_z_passes(niter, fz, warm_start=ws,
                                      power_iters=pw)
    seen = set()
    for (k, nr, nc, s), fz, ws in itertools.product(
            GEOMETRIES, (False, True), ("none", "sketch", "auto")):
        s_eff = ref_effective_block(k, nr, nc, s)
        got = oracle.choose_warm_start(ws, k, nr, nc, s_eff, fz)
        assert got == ref_oracle.choose_warm_start(ws, k, nr, nc, s_eff, fz)
        seen.add((ws, got))
    # auto settles both ways on this grid
    assert {("auto", "sketch"), ("auto", "none")} <= seen
    # the nell-2 widths: 6 passes against 41, and the fused block-8
    # configuration keeps "none" (6 against 6)
    assert oracle.choose_warm_start("auto", 10, 12092, 100) == "sketch"
    assert oracle.choose_warm_start("auto", 10, 12092, 100, 8, True) == "none"


def test_resolve_warm_start(monkeypatch):
    monkeypatch.delenv("REPRO_WARM_START", raising=False)
    assert oracle.resolve_warm_start(None) == "none"
    for ws in ("none", "sketch", "auto"):
        assert oracle.resolve_warm_start(ws) == ws
    monkeypatch.setenv("REPRO_WARM_START", "auto")
    assert oracle.resolve_warm_start(None) == "auto"
    with pytest.raises(ValueError, match="warm_start"):
        oracle.resolve_warm_start("random")


def test_adapt_rank_matches_reference():
    rng = np.random.default_rng(5)
    spectra = [[], [0.0, 0.0], [np.nan, 1.0], [1.0, 0.9, 0.8],
               [1.0, 0.5, 1e-4, 1e-5], [1.0, 1e-9, 1e-9]]
    for _ in range(60):
        k = int(rng.integers(1, 8))
        s = np.sort(rng.uniform(0.0, 1.0, k) ** 3)[::-1]
        spectra.append(list(s * rng.uniform(0.1, 10.0)))
    for s, (k, kw) in itertools.product(spectra, [
            (3, {}), (4, dict(grow_thresh=0.5, k_max=8)),
            (5, dict(grow_thresh=0.4, shrink_thresh=0.1, k_max=12)),
            (2, dict(shrink_thresh=0.5, k_min=3, k_max=9, grow_step=3))]):
        assert sketch.adapt_rank(s, k, **kw) == \
            ref_sketch.adapt_rank(s, k, **kw)


# ----------------------------------------------------- sketch primitives
@pytest.mark.parametrize("kind", ["gauss", "srht"])
@pytest.mark.parametrize("n,s", [(37, 5), (64, 8), (9, 9), (100, 14)])
def test_test_matrix_matches_reference(kind, n, s):
    path = (1000, 2)
    got = sketch.test_matrix(Key(jax_draws(3), path), n, s, kind)
    want = np.asarray(ref_sketch.test_matrix(
        _jax_key(jax.random.PRNGKey(3), path), n, s, kind))
    assert got.shape == (n, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_test_matrix_default_draws_and_kinds():
    """The port's own draws: SRHT columns are distinct Hadamard columns
    (entries ±1), reruns equal, split children independent."""
    key = make_key(4).fold_in(7)
    om = sketch.test_matrix(key, 37, 5, "srht")
    again = sketch.test_matrix(key, 37, 5, "srht")
    assert torch.equal(om, again)
    assert set(om.abs().unique().tolist()) == {1.0}
    assert int(torch.linalg.matrix_rank(om.T @ om)) == 5
    sign, sel = key.split()
    assert sign.path == key.path + (("split", 0),)
    assert sel.path == key.path + (("split", 1),)
    d = SeededDraws(4)
    assert not torch.equal(d(sign.path, (40,)), d(sel.path, (40,)))
    c = sel.choice(64, 10, "cpu")
    assert c.dtype == torch.int64 and len(set(c.tolist())) == 10
    assert sign.bernoulli(0.5, (30, 1), "cpu").dtype == torch.bool
    with pytest.raises(ValueError, match="unknown sketch kind"):
        sketch.test_matrix(key, 8, 2, "rademacher")


@pytest.mark.parametrize("w,s", [(3, 3), (3, 5), (5, 2)])
def test_seeded_start_panel_matches_reference(w, s):
    rng = np.random.default_rng(w * 10 + s)
    seed = rng.standard_normal((20, w)).astype(np.float32)
    path = (1000, 1)
    got = sketch.seeded_start_panel(torch.from_numpy(seed),
                                    Key(jax_draws(7), path), 20, s)
    want = np.asarray(ref_sketch.seeded_start_panel(
        jnp.asarray(seed), _jax_key(jax.random.PRNGKey(7), path), 20, s))
    assert got.shape == (20, s) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose((got.T @ got).numpy(), np.eye(s), atol=1e-5)


def test_power_refine_matches_reference():
    rng = np.random.default_rng(2)
    Z = rng.standard_normal((30, 12)).astype(np.float32)
    q0 = np.linalg.qr(rng.standard_normal((12, 4)))[0].astype(np.float32)
    Zt = torch.from_numpy(Z)
    got = sketch.power_refine(lambda x: Zt @ x, lambda y: Zt.T @ y,
                              torch.from_numpy(q0), 2)
    Zj = jnp.asarray(Z)
    want = np.asarray(ref_sketch.power_refine(
        lambda x: Zj @ x, lambda y: Zj.T @ y, jnp.asarray(q0), 2))
    np.testing.assert_allclose(got.numpy() @ got.numpy().T, want @ want.T,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,power_iters", [("gauss", 0), ("gauss", 2),
                                              ("srht", 1)])
def test_range_finder_matches_reference(small_tensor, kind, power_iters):
    t = small_tensor
    init = ref_random_factors(t.shape, (4, 4, 4), jax.random.PRNGKey(2))
    coords = jnp.asarray(t.coords, jnp.int32)
    values = jnp.asarray(t.values, jnp.float32)
    U_ref, sv_ref = ref_sketch.range_finder(
        coords, values, coords[:, 1], init, 1, t.shape[1], 4,
        jax.random.PRNGKey(9), kind=kind, oversample=4,
        power_iters=power_iters)
    tc, tv = convert.device_coords(_port(t), torch.device("cpu"))
    U, sv = sketch.range_finder(
        tc, tv, tc[:, 1], convert.factors(init, "cpu"), 1, t.shape[1], 4,
        Key(jax_draws(9)), kind=kind, oversample=4, power_iters=power_iters)
    U_ref, sv_ref = np.asarray(U_ref), np.asarray(sv_ref)
    assert U.shape == (t.shape[1], 4) and sv.shape == (4,)
    np.testing.assert_allclose(U.numpy() @ U.numpy().T, U_ref @ U_ref.T,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(sv.numpy(), sv_ref, rtol=1e-4, atol=0)


# ------------------------------------------------------- whole paths
@pytest.mark.parametrize("warm", ["sketch", "auto"])
@pytest.mark.parametrize("fixture", sorted(CORE))
def test_hooi_warm_start_matches_reference(request, fixture, warm):
    t = request.getfixturevalue(fixture)
    core = CORE[fixture]
    ref_dec, ref_fits = ref_hooi(t, core, n_invocations=3, seed=0,
                                 warm_start=warm)
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(0))
    dec, fits = hooi(_port(t), core, n_invocations=3, seed=0,
                     init=[np.asarray(f) for f in init], draw=jax_draws(0),
                     warm_start=warm, use_fused_oracle=warm == "auto",
                     device="cpu")
    assert_fits_match(fits, ref_fits)
    assert_core_energy_matches(t, dec.core, ref_dec.core)
    assert_subspaces_match(dec.factors, ref_dec.factors)
    if fixture == "lowrank_tensor":
        assert fits[-1] > 0.99


@pytest.mark.parametrize("P,path,warm", [(4, "baseline", "sketch"),
                                         (4, "liteopt", "sketch"),
                                         (4, "liteopt", "auto")])
def test_dist_warm_start_matches_reference(small_tensor, P, path, warm):
    t, core = small_tensor, CORE["small_tensor"]
    ref_dec, ref_st = ref_dist_hooi(t, core, P, scheme="lite",
                                    n_invocations=3, path=path, seed=0,
                                    use_kernel=False, warm_start=warm)
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(0))
    dec, st = dist_hooi(_port(t), core, P, scheme="lite", n_invocations=3,
                        path=path, seed=0, device="cpu", draw=jax_draws(0),
                        init=[np.asarray(f) for f in init], warm_start=warm,
                        use_fused_oracle=P == 4 and path == "liteopt")
    assert st.comm_backends == ref_st.comm_backends
    assert st.warm_start == ref_st.warm_start
    assert set(st.warm_start.values()) == {"sketch"}
    assert st.z_passes == ref_st.z_passes
    assert st.lanczos_block == ref_st.lanczos_block
    assert st.objective == ref_st.objective == "tucker"
    assert_fits_match(st.fits, ref_st.fits)
    assert_subspaces_match(dec.factors, ref_dec.factors)
    assert_core_energy_matches(t, dec.core, ref_dec.core)


def test_sketch_factor_map_matches_reference_scatter_max(skewed_tensor):
    """``comm_maps``'s ``f_src``: the original row id of every local row
    holding elements, as the reference's scatter-max over the coords finds
    it in its step; rows without elements read nothing (-1)."""
    from repro_torch.core import plan as port_plan
    from repro_torch.engine.comm import comm_maps

    pl = port_plan.plan(_port(skewed_tensor), "lite", 4,
                        core_dims=(4, 4, 4), use_cache=False)
    for mp in pl.parts:
        f_src = comm_maps(mp)["f_src"]
        for p in range(mp.P):
            want = np.zeros(mp.R_pad, np.int64)
            np.maximum.at(want, mp.local_rows[p], mp.coords[p, :, mp.mode])
            held = np.bincount(mp.local_rows[p, :mp.e_per_rank[p]],
                               minlength=mp.R_pad) > 0
            np.testing.assert_array_equal(f_src[p][held], want[held])
            assert np.all(f_src[p][~held] == -1)


def test_warm_start_none_is_the_default_trajectory(small_tensor,
                                                   monkeypatch):
    """``warm_start="none"`` and the default are one path, bitwise, on both
    entry points; sketch and auto reruns are bitwise too."""
    monkeypatch.delenv("REPRO_WARM_START", raising=False)
    t = _port(small_tensor)
    kw = dict(n_invocations=2, seed=0, device="cpu")
    d0, f0 = hooi(t, (3, 3, 3), **kw)
    d1, f1 = hooi(t, (3, 3, 3), warm_start="none", **kw)
    assert f0 == f1
    assert all(torch.equal(a, b) for a, b in zip(d0.factors, d1.factors))
    _, s0 = dist_hooi(t, (3, 3, 3), 4, **kw)
    _, s1 = dist_hooi(t, (3, 3, 3), 4, warm_start="none", **kw)
    assert s0.fits == s1.fits
    assert s0.warm_start == {n: "none" for n in range(3)}
    _, a = hooi(t, (3, 3, 3), warm_start="sketch", **kw)
    _, b = hooi(t, (3, 3, 3), warm_start="sketch", **kw)
    assert a == b
    monkeypatch.setenv("REPRO_WARM_START", "sketch")
    _, c = hooi(t, (3, 3, 3), **kw)
    assert c == a


def test_p1_sketch_trajectory_matches_single_process(lowrank_tensor):
    """P = 1 runs the local backend: the sketch seed through the factor map
    and the stacked products walks the same space as ``hooi``'s."""
    t = _port(lowrank_tensor)
    for warm in ("sketch", "auto"):
        _, fits = hooi(t, (2, 2, 2), n_invocations=3, seed=0, device="cpu",
                       warm_start=warm)
        _, st = dist_hooi(t, (2, 2, 2), 1, n_invocations=3, seed=0,
                          device="cpu", warm_start=warm)
        np.testing.assert_allclose(st.fits, fits, rtol=0, atol=1e-6)
        assert fits[-1] > 0.99
    k, nr, nc = 2, t.shape[0], 4
    full = oracle.count_z_passes(ref_lanczos_niter(k, nr, nc, 1))
    assert st.z_passes[0] < full
