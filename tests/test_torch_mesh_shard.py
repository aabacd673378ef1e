"""The boundary backend's u-space sharded over a mesh's device groups.

Over ``["cpu"] * G`` meshes the ``boundary`` backend keeps each group's
ranks' rows of the Lanczos u-space on that group (``GroupTensor`` shards),
takes every inner product's per-rank partials there and adds them at home
in rank order, as the reference's ``shard_map`` step keeps each device's
shard and ``psum``s its inner products. Held here: the shards' layout, the
group tensor's operations and the mesh space against the stacked ones
(bitwise), the bytes between groups by kind against their formulas
(``distributed.mesh``: exactly), the size of every crossing, and psum's
bytes, which the sharding leaves as they were. The runs against the
stacked port and the reference are ``test_torch_mesh.py``'s.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import lanczos
from repro_torch.core.coo import SparseTensor
from repro_torch.core.plan import plan as build_plan
from repro_torch.core.sketch import DEFAULT_POWER_ITERS
from repro_torch.distributed.dist_hooi import HooiExecutor, make_ranks_mesh
from repro_torch.distributed.mesh import GroupTensor, u_space_bytes
from repro_torch.engine import comm, oracle
from repro_torch.random import make_key

P = 4
SHAPE, CORE = (40, 30, 25), (3, 3, 3)
KNOBS = {
    "block": dict(lanczos_block=8, fused_zbuild=True, use_fused_oracle=True),
    "vector": {},
    "sketch": dict(lanczos_block=8, warm_start="sketch"),
    "panel4": dict(lanczos_block=4),
}


def _tensor(seed: int = 0, nnz: int = 2000) -> SparseTensor:
    r = np.random.default_rng(seed)
    coords = np.stack([r.integers(0, L, nnz) for L in SHAPE], axis=1)
    return SparseTensor(coords, r.standard_normal(nnz).astype(np.float32),
                        SHAPE).dedup()


def _mesh(G: int):
    return make_ranks_mesh(P, devices=["cpu"] * G)


def _run(G: int, knob: str, path: str = "liteopt", pl=None, **kw):
    t = _tensor()
    pl = pl if pl is not None else build_plan(t, "lite", P, core_dims=CORE,
                                              path=path)
    ex = HooiExecutor(P, mesh=_mesh(G))
    dec, st = ex.run(t, CORE, pl, n_invocations=2, path=path, seed=1,
                     **KNOBS[knob], **kw)
    return t, pl, ex, dec, st


def _specs(ex, pl, knob: str, path: str = "liteopt") -> list:
    """The per-mode static step parameters ``run`` resolves for ``knob``:
    ``niter`` (block iterations under the block driver) and the panel."""
    kw = KNOBS[knob]
    return ex._mode_specs(pl, CORE, path, oracle.ModeSpec(
        block_size=kw.get("lanczos_block", 1),
        fused_zbuild=kw.get("fused_zbuild", False),
        warm_start=kw.get("warm_start", "none")))


def _split(x: torch.Tensor, mesh) -> GroupTensor:
    """A stacked (P, ...) value as a group tensor (its own copies)."""
    return GroupTensor(mesh, [x[r.start:r.stop].clone()
                              for r in map(mesh.ranks_of, range(mesh.G))])


# ------------------------------------------------------- the group tensor
@pytest.mark.parametrize("G", [2, 4])
def test_group_tensor_ops_are_the_stacked_ops(G):
    """Every operation the drivers apply, on a group tensor, is the
    stacked tensor's, bit for bit; a home tensor an op reads crosses to
    each non-home group once."""
    mesh, r = _mesh(G), np.random.default_rng(1)
    a, b = (torch.from_numpy(r.standard_normal((P, 7, 5)).astype(np.float32))
            for _ in range(2))
    c = torch.tensor(0.75)
    m = torch.from_numpy(r.standard_normal((5, 3)).astype(np.float32))
    ga, gb = _split(a, mesh), _split(b, mesh)
    cases = {
        "a - c*b": (ga - c * gb, a - c * b),
        "a / c": (ga / (c + 1e-30), a / (c + 1e-30)),
        "where": (torch.where(c > 1, ga, gb), torch.where(c > 1, a, b)),
        "stack": (torch.stack([ga[..., 0], gb[..., 1]], dim=-1),
                  torch.stack([a[..., 0], b[..., 1]], dim=-1)),
        "cat": (torch.cat([ga, gb[..., 2, None]], dim=-1),
                torch.cat([a, b[..., 2, None]], dim=-1)),
        "a @ m": (ga @ m, a @ m),
    }
    for name, (got, want) in cases.items():
        assert isinstance(got, GroupTensor) and len(got.parts) == G, name
        assert tuple(got.shape) == tuple(want.shape), name
        assert torch.equal(got.home(), want), name
    ga[..., 1:3] = gb[..., 0:2]
    a[..., 1:3] = b[..., 0:2]
    assert torch.equal(ga.home(), a)
    before = mesh.moved_by_kind["u"]
    ga - c * gb  # noqa: B018 — one scalar out to each non-home group
    assert mesh.moved_by_kind["u"] - before == (G - 1) * 4
    with pytest.raises(ValueError, match="trailing"):
        torch.stack([ga, gb], dim=0)
    with pytest.raises(IndexError, match="trailing"):
        ga[0]  # noqa: B018


@pytest.mark.parametrize("G", [1, 2, 4])
def test_mesh_space_partials_are_the_stacked_partials(G):
    """``dot``, ``proj``, ``normal`` and ``zeros`` of the mesh space against
    the stacked space at a sweep's shapes (rows of a few thousand, a
    24-wide basis, 8-wide panels), where a batched product over fewer ranks
    may block its sums otherwise: each group's frame keeps the stacked
    bits."""
    mesh, r = _mesh(G), np.random.default_rng(2)
    Lp, T, s = 3023, 24, 8
    stacked, sharded = lanczos._Space(P), lanczos._space(mesh)
    basis = torch.from_numpy(r.standard_normal((P, Lp, T)).astype(np.float32))
    pan = torch.from_numpy(r.standard_normal((P, Lp, s)).astype(np.float32))
    gbasis = sharded.zeros(Lp, (T,))
    gbasis[..., :] = _split(basis, mesh)
    gpan = _split(pan, mesh)
    vec, gvec = pan[..., 3], gpan[..., 3]
    assert torch.equal(sharded.dot(gvec, gpan[..., 5]),
                       stacked.dot(vec, pan[..., 5]))
    assert torch.equal(sharded.proj(gbasis, gpan).home(),
                       stacked.proj(basis, pan))
    assert torch.equal(sharded.proj(gbasis, gvec).home(),
                       stacked.proj(basis, vec))
    key = make_key(3)
    draws = sharded.normal(key, 11, 4)
    assert torch.equal(draws.home(), stacked.normal(key, 11, 4, "cpu"))
    assert draws.frames is not None and len(draws.parts) == G
    assert all(p.shape[0] == P // G for p in draws.parts)


# ------------------------------------------------------- the comm space
@pytest.mark.parametrize("G", [2, 4])
def test_mesh_boundary_space_is_the_stacked_space(G):
    """The mesh's boundary space on the groups' Z against the stacked
    space on the same products (the groups' answers gathered, as psum
    gathers them): ``Z @ x`` shards, ``Zᵀ @ y`` and the sketch seed, bit
    for bit, vector and panel."""
    t, mesh = _tensor(), _mesh(G)
    pl = build_plan(t, "lite", P, core_dims=CORE)
    mp = max(pl.parts, key=lambda m: m.S_pad)
    maps = {k: torch.from_numpy(v) for k, v in comm.comm_maps(mp).items()}
    gmaps = [{k: torch.from_numpy(v) for k, v in gm.items()}
             for gm in comm.group_maps(comm.comm_maps(mp), P, mp.R_pad,
                                       mp.Lp, G)]
    assert comm.crossing_slots(gmaps) > 0  # boundary rows cross groups
    r = np.random.default_rng(4)
    K = 9
    Z = torch.from_numpy(r.standard_normal((P * mp.R_pad, K))
                         .astype(np.float32))
    ms = dict(P=P, Lp=mp.Lp, R_pad=mp.R_pad)
    per = mp.R_pad * P // G
    Zs = [Z[g * per:(g + 1) * per] for g in range(G)]
    want = comm.make_comm_space("boundary", ms, maps,
                                *oracle.mesh_products(Zs, mesh))
    got = comm.make_mesh_boundary_space(
        ms, gmaps, mesh, oracle.group_products(Zs, mesh))
    assert got.axis is mesh and got.dim_u == want.dim_u == mp.Lp
    for cols in ((), (3,)):
        x = torch.from_numpy(r.standard_normal((K,) + cols)
                             .astype(np.float32))
        u = got.matvec(x)
        assert isinstance(u, GroupTensor) and len(u.parts) == G
        assert torch.equal(u.home(), want.matvec(x))
        y = torch.from_numpy(r.standard_normal((P, mp.Lp) + cols)
                             .astype(np.float32))
        assert torch.equal(got.rmatvec(_split(y, mesh)), want.rmatvec(y))
    F = torch.from_numpy(r.standard_normal((mp.L, 2)).astype(np.float32))
    assert torch.equal(got.seed(F), want.seed(F))


# ------------------------------------------------------------- the runs
@pytest.mark.parametrize("knob", ["block", "vector"])
@pytest.mark.parametrize("G", [2, 4])
def test_boundary_u_space_lives_in_group_tensors(monkeypatch, G, knob):
    """A boundary run's Lanczos basis is a group tensor of G parts of P/G
    ranks each on its group's device, and the step hands back the groups'
    factor shards; the v-space and B stay at home."""
    seen = []
    driver = "gk_block_bidiag" if knob == "block" else "gk_bidiag"
    real = getattr(oracle, driver)

    def spy(*a, **k):
        U, B = real(*a, **k)
        seen.append((U, B))
        return U, B

    monkeypatch.setattr(oracle, driver, spy)
    t, pl, ex, dec, st = _run(G, knob)
    mesh = ex.mesh
    assert len(seen) == 2 * t.ndim
    for (U, B), mp in zip(seen, list(pl.parts) * 2):
        assert isinstance(U, GroupTensor) and len(U.parts) == G
        for g, part in enumerate(U.parts):
            assert part.shape[:2] == (P // G, mp.Lp)
            assert part.device == mesh.devices[g]
        assert isinstance(B, torch.Tensor) and B.device == mesh.home
    assert st.group_bytes == st.group_bytes_u + st.group_bytes_factors
    assert all(np.isfinite(st.fits)) and all(f.shape[0] == L for f, L in
                                             zip(dec.factors, SHAPE))


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("G", [2, 4])
def test_u_bytes_equal_the_formula(G, knob):
    """The ``"u"`` bytes a boundary run moves between groups are the
    formula of ``distributed.mesh`` (``u_space_bytes``, through
    ``HooiExecutor.modeled_u_bytes``) exactly, every sweep; the factor
    bytes are each non-home group's factors and the non-home shards."""
    t, pl, ex, dec, st = _run(G, knob)
    sweeps = len(st.fits)
    kw = {k: v for k, v in KNOBS[knob].items() if k != "use_fused_oracle"}
    modeled = ex.modeled_u_bytes(pl, CORE, **kw)
    assert sorted(modeled) == list(range(t.ndim))
    assert st.group_bytes_u == sweeps * sum(modeled.values())
    eff = [min(k, L) for k, L in zip(CORE, SHAPE)]
    factors = 0
    for n, mp in enumerate(pl.parts):
        factors += sum(L * k for j, (L, k) in enumerate(zip(SHAPE, eff))
                       if j != n)
        factors += P // G * mp.Lp * eff[n]
        if knob == "sketch":  # the seed's factor columns
            factors += SHAPE[n] * min(st.lanczos_block[n], eff[n])
    assert st.group_bytes_factors == sweeps * 4 * (G - 1) * factors


def test_u_bytes_have_no_row_pad_term():
    """The same tensor under default and geometric pads: R_pad and S_pad
    differ, the ``"u"`` bytes do not (they follow the slots that cross
    groups, the iteration counts and K_hat)."""
    t = _tensor()
    got = {}
    for geo in (False, True):
        pl = build_plan(t, "lite", P, core_dims=CORE, pad_geometric=geo)
        got[geo] = (_run(2, "block", pl=pl)[4].group_bytes_u,
                    [mp.R_pad for mp in pl.parts])
    assert got[False][1] != got[True][1]
    assert got[False][0] == got[True][0]
    assert u_space_bytes(P, 1, 0, 9, 3, 6) == 0  # one group moves nothing


@pytest.mark.parametrize("knob", ["block", "vector"])
@pytest.mark.parametrize("G", [2, 4])
def test_no_u_crossing_is_larger_than_its_bound(G, knob):
    """No single ``"u"`` crossing holds more than ``max(S_pad, K_hat,
    T)·max(s, k)·P/G`` elements (``T`` the basis width): what crosses is
    slots, v-space vectors, per-rank partials and small matrices, never a
    group's rows."""
    sizes = []
    t = _tensor()
    pl = build_plan(t, "lite", P, core_dims=CORE)
    ex = HooiExecutor(P, mesh=_mesh(G))
    count = ex.mesh._count

    def spy(x, crossed, kind):
        if crossed and kind == "u":
            sizes.append((x.numel(), x.numel() * x.element_size()))
        return count(x, crossed, kind)

    ex.mesh._count = spy
    _, st = ex.run(t, CORE, pl, n_invocations=1, seed=1, **KNOBS[knob])
    eff = [min(k, L) for k, L in zip(CORE, SHAPE)]
    bound = 0
    for n, (mp, sp) in enumerate(zip(pl.parts, _specs(ex, pl, knob))):
        khat = int(np.prod([e for j, e in enumerate(eff) if j != n]))
        s, T = sp.block_size, sp.niter * sp.block_size
        bound = max(bound, max(mp.S_pad, khat, T) * max(s, eff[n]) * P // G)
    assert sizes and max(n for n, _ in sizes) <= bound
    assert sum(b for _, b in sizes) == st.group_bytes_u


@pytest.mark.parametrize("knob", ["block", "vector", "sketch"])
@pytest.mark.parametrize("G", [2, 4])
def test_psum_bytes_are_unchanged(G, knob):
    """psum keeps its replicated u-space at home: per product x (or each
    group's rows of y) out and each group's answer home, the factors out,
    the fused first panel out and its product home, the sketch's gathered
    rows out and partials home; no factor shard comes home."""
    t, pl, ex, dec, st = _run(G, knob, path="baseline")
    q = P // G
    eff = [min(k, L) for k, L in zip(CORE, SHAPE)]
    words = 0
    for n, (mp, sp) in enumerate(zip(pl.parts, _specs(ex, pl, knob,
                                                        "baseline"))):
        khat = int(np.prod([e for j, e in enumerate(eff) if j != n]))
        s, ws = sp.block_size, sp.warm_start == "sketch"
        words += sum(L * k for j, (L, k) in enumerate(zip(SHAPE, eff))
                     if j != n)
        # the fused first panel out and its product home: one Z @ x's
        products = sp.niter + (DEFAULT_POWER_ITERS if ws else 0)
        words += products * s * (khat + q * mp.R_pad)  # Z @ x
        words += products * s * q * (mp.R_pad + khat)  # Zᵀ @ y
        if ws:
            w = min(s, eff[n])
            words += w * q * (mp.R_pad + khat)
    assert st.group_bytes == len(st.fits) * 4 * (G - 1) * words
    assert st.group_bytes_factors == len(st.fits) * 4 * (G - 1) * sum(
        sum(L * k for j, (L, k) in enumerate(zip(SHAPE, eff)) if j != n)
        for n in range(len(SHAPE)))
