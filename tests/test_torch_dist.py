"""The distributed main path: the port's ``dist_hooi`` against the reference.

The reference runs its P ranks on P simulated host devices (``conftest.py``
sets 8) and is held at ``use_kernel=False``: its Pallas kernel path does not
run on this JAX (ROADMAP Queue C). The port stacks the ranks on one device
(the CPU here). Both get the same plan (bit-identical, see
``test_torch_plan.py``), the reference's initial factors and, through the
port's draw seam, the reference's ``jax.random`` draws.

Bars, as ``test_torch_hooi.py`` sets them out: fits within 1e-4 (as the
captured energy share within 1e-6 relative where the fit is within 1e-3 of
1), ``F Fᵀ`` within 1e-3, final cores' energy within 2e-6 relative. Twins of
``test_engine.py::test_p1_trajectory_identical_to_single_process``, of
``test_roofline.py``'s fused-exactness and block-convergence cases and of
``test_kernel_step.py``'s padding-heavy partitions, plus the comm spaces'
gather maps against the reference's scatter semantics.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.coo import SparseTensor as RefSparseTensor
from repro.core.hooi import random_factors as ref_random_factors
from repro.distributed.dist_hooi import dist_hooi as ref_dist_hooi
from repro_torch import convert
from repro_torch.core import plan as port_plan
from repro_torch.core.hooi import hooi
from repro_torch.distributed.dist_hooi import HooiExecutor, dist_hooi
from repro_torch.engine.comm import comm_maps, make_comm_space
from test_torch_hooi import (assert_core_energy_matches, assert_fits_match,
                             assert_subspaces_match, jax_draws)

CORE = {"lowrank_tensor": (2, 2, 2), "skewed_tensor": (4, 4, 4),
        "small_tensor": (3, 3, 3)}
VARIANTS = {"vector": {},
            "block4_fused": dict(lanczos_block=4, fused_zbuild=True),
            # the port's batched oracle_pair over the stacked ranks (its
            # plain version on the CPU); the reference keeps its plain
            # products, which compute the same function
            "block4_fused_oracle": dict(lanczos_block=4, fused_zbuild=True,
                                        use_fused_oracle=True)}


def _port(t):
    return convert.sparse_tensor(t.coords, t.values, t.shape)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("path", ["liteopt", "baseline"])
def test_p1_trajectory_matches_single_process(lowrank_tensor, path, variant):
    """P = 1 runs the local backend over the identity partition: the same
    stages, key schedule and Krylov walk as ``hooi``."""
    t = _port(lowrank_tensor)
    kw = VARIANTS[variant]
    _, fits = hooi(t, (2, 2, 2), n_invocations=3, seed=0, device="cpu",
                   **kw)
    _, st = dist_hooi(t, (2, 2, 2), 1, scheme="lite", n_invocations=3,
                      path=path, seed=0, device="cpu", **kw)
    assert set(st.comm_backends.values()) == {"local"}
    np.testing.assert_allclose(st.fits, fits, rtol=0, atol=1e-6)
    assert fits[-1] > 0.99


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("path,backend", [("baseline", "psum"),
                                          ("liteopt", "boundary")])
@pytest.mark.parametrize("fixture", ["lowrank_tensor", "skewed_tensor"])
def test_p4_matches_reference(request, fixture, path, backend, variant):
    t = request.getfixturevalue(fixture)
    core = CORE[fixture]
    kw = VARIANTS[variant]
    ref_kw = {k: v for k, v in kw.items() if k != "use_fused_oracle"}
    ref_dec, ref_st = ref_dist_hooi(t, core, 4, scheme="lite",
                                    n_invocations=3, path=path, seed=0,
                                    use_kernel=False, **ref_kw)
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(0))
    dec, st = dist_hooi(_port(t), core, 4, scheme="lite", n_invocations=3,
                        path=path, seed=0, device="cpu", draw=jax_draws(0),
                        init=[np.asarray(f) for f in init], **kw)
    assert set(st.comm_backends.values()) == {backend}
    assert st.comm_backends == ref_st.comm_backends
    assert st.lanczos_block == ref_st.lanczos_block
    assert st.z_passes == ref_st.z_passes
    assert st.r_pad == ref_st.r_pad and st.e_pad == ref_st.e_pad
    assert_fits_match(st.fits, ref_st.fits)
    assert_subspaces_match(dec.factors, ref_dec.factors)
    assert_core_energy_matches(t, dec.core, ref_dec.core)


def _uneven_tensor():
    """``test_kernel_step.py``'s uneven fixture: nnz not divisible by P, so
    every rank's list ends in padding elements and R_pad/E_pad are
    ragged."""
    r = np.random.default_rng(11)
    shape = (13, 7, 9)
    coords = np.stack([r.integers(0, L, 153) for L in shape], axis=1)
    return RefSparseTensor(coords, r.standard_normal(153), shape).dedup()


@pytest.mark.parametrize("path", ["baseline", "liteopt"])
@pytest.mark.parametrize("scheme,core,tensor", [
    ("lite", (2, 3, 2), "uneven"),
    ("coarse", (2, 3, 2), "uneven"),
    ("lite", (1, 1, 1), "nearly_empty"),  # nnz < P: ranks of pure padding
])
def test_padding_heavy_partitions_match_reference(scheme, core, tensor,
                                                  path):
    """Twins of ``test_kernel_step.py``'s padding cases, held against the
    reference's ``use_kernel=False`` runs (its bars: fits within 1e-3 on
    the uneven tensor, 1e-5 with nearly empty ranks)."""
    if tensor == "uneven":
        t, atol = _uneven_tensor(), 1e-3
    else:
        t = RefSparseTensor(np.array([[0, 0, 0], [4, 3, 2]]),
                            np.array([2.0, -3.0]), (5, 4, 3))
        atol = 1e-5
    _, ref_st = ref_dist_hooi(t, core, 4, scheme=scheme, n_invocations=2,
                              path=path, seed=3, use_kernel=False)
    pl = port_plan.plan(_port(t), scheme, 4, core_dims=core, path=path)
    assert any((mp.e_per_rank < mp.E_pad).any() for mp in pl.parts)
    init = ref_random_factors(t.shape, core, jax.random.PRNGKey(3))
    _, st = dist_hooi(_port(t), core, 4, scheme=pl, n_invocations=2,
                      path=path, seed=3, device="cpu", draw=jax_draws(3),
                      init=[np.asarray(f) for f in init])
    assert np.isfinite(st.fits).all()
    np.testing.assert_allclose(st.fits, ref_st.fits, rtol=0, atol=atol)


@pytest.mark.parametrize("P,path,backend", [(1, "liteopt", "local"),
                                            (4, "baseline", "psum"),
                                            (4, "liteopt", "boundary")])
def test_fused_zbuild_exact_all_backends(lowrank_tensor, P, path, backend):
    """The fused Z-build only changes where the first panel product comes
    from: on the CPU the trajectories are exactly equal, and the fused run
    counts one pass over Z less per mode."""
    t = _port(lowrank_tensor)
    kw = dict(scheme="lite", n_invocations=2, seed=0, path=path,
              lanczos_block=4, device="cpu")
    _, sa = dist_hooi(t, (2, 2, 2), P, fused_zbuild=False, **kw)
    _, sb = dist_hooi(t, (2, 2, 2), P, fused_zbuild=True, **kw)
    assert set(sa.comm_backends.values()) == {backend}
    assert sa.fits == sb.fits
    assert not sa.fused_zbuild and sb.fused_zbuild
    for n in sa.z_passes:
        assert sb.z_passes[n] == sa.z_passes[n] - 1


@pytest.mark.parametrize("s", [4, 8])
def test_block_convergence_on_boundary(lowrank_tensor, s):
    _, st = dist_hooi(_port(lowrank_tensor), (2, 2, 2), 4, scheme="lite",
                      n_invocations=2, seed=0, path="liteopt",
                      lanczos_block=s, device="cpu")
    assert st.fits[-1] > 0.999
    # panels are clamped per mode: never wider than min(2k, L_n, K_hat)
    assert all(1 <= b <= 4 for b in st.lanczos_block.values())


def _reference_spaces(mp, local, u_rep, u_shard):
    """The reference's comm-space placements in numpy, with its drop/fill
    sentinels: psum wrap, boundary wrap, and each's per-rank gather."""
    P, Lp, S_pad = mp.P, mp.Lp, mp.S_pad
    L_sent = P * Lp
    psum = np.zeros(L_sent)
    shard = np.zeros((P, Lp))
    bvec = np.zeros(S_pad)
    for p in range(P):
        for r in range(mp.R_pad):
            g = mp.row_gid[p, r]
            if g < L_sent:
                psum[g] += local[p, r]
            if mp.row_owned[p, r]:
                shard[p, g - p * Lp] += local[p, r]
            if mp.bnd_slot[p, r] < S_pad:
                bvec[mp.bnd_slot[p, r]] += local[p, r]
    for p in range(P):
        for j in range(mp.B_pad):
            slot, off = mp.own_bnd_slot[p, j], mp.own_bnd_off[p, j]
            if slot < S_pad and off < Lp:
                shard[p, off] += bvec[slot]
    flat = u_shard.reshape(-1)
    gather = lambda u: np.where(mp.row_gid < L_sent,  # noqa: E731
                                u[np.minimum(mp.row_gid, L_sent - 1)], 0.0)
    return psum, shard, gather(u_rep), gather(flat)


@pytest.mark.parametrize("scheme", ["lite", "coarse"])
@pytest.mark.parametrize("fixture", ["skewed_tensor", "small_tensor"])
def test_comm_spaces_match_reference_semantics(request, fixture, scheme):
    """The gather maps reproduce the reference's scatter-with-drop and
    gather-with-fill placements exactly (on values that are sums of at
    most a few terms, in f64): padding rows read 0 and add 0."""
    t = _port(request.getfixturevalue(fixture))
    pl = port_plan.plan(t, scheme, 4, core_dims=CORE[fixture],
                        use_cache=False)
    rng = np.random.default_rng(0)
    for mp in pl.parts:
        maps = {k: torch.from_numpy(v) for k, v in comm_maps(mp).items()}
        local = rng.standard_normal((mp.P, mp.R_pad))
        local[mp.row_gid >= mp.P * mp.Lp] = 0.0  # padding rows hold no Z
        u_rep = rng.standard_normal(mp.P * mp.Lp)
        u_shard = rng.standard_normal((mp.P, mp.Lp))
        psum, shard, y_rep, y_shard = _reference_spaces(mp, local, u_rep,
                                                        u_shard)
        ms = dict(P=mp.P, Lp=mp.Lp)
        loc = torch.from_numpy(local.reshape(-1))
        zmv = lambda x: x  # noqa: E731 — the "product" is the local vector
        got = {}
        zrmv = lambda y: got.setdefault("y", y) * 0  # noqa: E731
        sp = make_comm_space("psum", ms, maps, zmv, zrmv)
        np.testing.assert_allclose(sp.matvec(loc).numpy(), psum, atol=1e-12)
        sp.rmatvec(torch.from_numpy(u_rep))
        np.testing.assert_array_equal(got.pop("y").numpy(), y_rep)
        sb = make_comm_space("boundary", ms, maps, zmv, zrmv)
        np.testing.assert_allclose(sb.matvec(loc).numpy(), shard,
                                   atol=1e-12)
        sb.rmatvec(torch.from_numpy(u_shard))
        np.testing.assert_array_equal(got.pop("y").numpy(), y_shard)
        assert sb.axis == mp.P and sp.axis is None


@pytest.mark.parametrize("P,path", [(1, "liteopt"), (4, "baseline"),
                                    (4, "liteopt")])
def test_dist_bf16_within_bound_all_backends(lowrank_tensor, P, path):
    """Twin of ``test_roofline.py``'s: on the stacked ranks of every comm
    backend the bf16 Z-build keeps the fit within 1e-2 of f32, and the
    stats report the precision that ran."""
    t = _port(lowrank_tensor)
    kw = dict(scheme="lite", n_invocations=2, seed=0, path=path,
              device="cpu")
    _, sf = dist_hooi(t, (2, 2, 2), P, **kw)
    _, sb = dist_hooi(t, (2, 2, 2), P, precision="bf16", **kw)
    assert sb.precision == "bf16" and sf.precision == "f32"
    assert set(sb.comm_backends.values()) == \
        {{"liteopt": "boundary", "baseline": "psum"}[path]
         if P > 1 else "local"}
    assert sb.fits[-1] > 0.99
    assert max(abs(a - b) for a, b in zip(sf.fits, sb.fits)) < 1e-2


def test_dist_rerun_is_bitwise_and_reports(skewed_tensor):
    t = _port(skewed_tensor)
    kw = dict(n_invocations=2, seed=3, path="auto", lanczos_block=4,
              fused_zbuild=True, use_fused_oracle=True, device="cpu")
    dec1, st1 = dist_hooi(t, (4, 4, 4), 4, **kw)
    dec2, st2 = dist_hooi(t, (4, 4, 4), 4, **kw)
    assert st1.fits == st2.fits
    for a, b in zip(dec1.factors, dec2.factors):
        assert torch.equal(a, b)
    assert st2.plan_cache_hit and not st1.plan_cache_hit
    assert st1.fused_oracle and st1.fused_zbuild and st1.scheme == "lite"
    assert set(st1.comm_backends.values()) <= {"psum", "boundary"}
    assert len(st1.sweep_s) == 2 and set(st1.mode_spectra) == {0, 1, 2}
    for n, F in enumerate(dec1.factors):
        assert tuple(F.shape) == (t.shape[n], 4)
        np.testing.assert_allclose((F.T @ F).numpy(), np.eye(4), atol=1e-4)


def test_executor_checks(monkeypatch, small_tensor):
    t = _port(small_tensor)
    pl = port_plan.plan(t, "lite", 4, core_dims=(3, 3, 3), path="liteopt")
    ex = HooiExecutor(4, "cpu")
    with pytest.raises(ValueError, match="path"):
        ex.run(t, (3, 3, 3), pl, path="baseline")
    with pytest.raises(ValueError, match="core_dims"):
        ex.run(t, (2, 2, 2), pl)
    with pytest.raises(ValueError, match="P=4"):
        HooiExecutor(2, "cpu").run(t, (3, 3, 3), pl)
    with pytest.raises(ValueError, match="unknown path"):
        ex.run(t, (3, 3, 3), "lite", path="nowhere")
    with pytest.raises(ValueError, match="executor has P=4"):
        dist_hooi(t, (3, 3, 3), 2, executor=ex)
    with pytest.raises(ValueError, match="objective"):
        ex.run(t, (3, 3, 3), pl, objective="nn")
    # precision="auto" resolves under the default cost model (no bf16 rate)
    _, st = ex.run(t, (3, 3, 3), pl, n_invocations=1, precision="auto")
    assert st.precision == "f32"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist_hooi(t, (3, 3, 3), 4)
