"""The port's kernel wrappers on the CPU against the reference's kernels.

On the CPU each port wrapper runs its plain PyTorch version (the CUDA
kernels are held against those same plain versions on the card, in
``chip_smoke.py`` and ``tests/test_torch_cuda.py``). The same numpy inputs
go to both packages. Twins of the ``tests/test_kernels.py`` cases; f32
tolerance rtol = atol = 2e-4 as in ``tests/test_hooi.py``, and the bf16
contract bit for bit.

The reference's ``oracle_pair`` runs as its own tests run it, in interpret
mode. Its Pallas ``kron_segsum`` does not run in interpret mode under the
installed JAX (``jax.experimental.pallas.load`` no longer exists, so the
reference's own ``test_kron_segsum_*`` fail there too); the ``kron_segsum``
twins therefore hold the port against the reference's plain
``repro.kernels.ref.kron_segsum_ref``, the function that kernel is tested
against. The same holds for the fused ``kron_segsum_oracle``: its twins use
``repro.kernels.ref.kron_segsum_oracle_ref``, within 1e-5 of the largest
output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import ttm
from repro.core.hooi import random_factors
from repro.kernels import ops as ref_ops
from repro.kernels import ref as jax_ref
from repro.kernels.oracle_fused import oracle_pair as pallas_oracle_pair
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kron_segsum import kron_segsum, kron_segsum_oracle
from repro_torch.kernels.oracle_fused import oracle_pair

TOL = dict(rtol=2e-4, atol=2e-4)


def _mk(seed, E, Ka, Kb, R, dense=True):
    """numpy inputs exactly as tests/test_kernels.py makes them."""
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.integers(0, R, size=E))
    if dense:
        _, rows = np.unique(rows, return_inverse=True)
        rows = np.sort(rows)
        R = max(int(rows.max()) + 1 if E else 1, 1)
    a = rng.standard_normal((E, Ka)).astype(np.float32)
    b = rng.standard_normal((E, Kb)).astype(np.float32)
    return rows.astype(np.int32), a, b, R


def _both_kron(rows, a, b, R, precision="f32"):
    got = kron_segsum(torch.from_numpy(rows), torch.from_numpy(a),
                      torch.from_numpy(b), R, precision=precision)
    want = jax_ref.kron_segsum_ref(jnp.asarray(rows), jnp.asarray(a),
                                   jnp.asarray(b), R, precision=precision)
    return got.numpy(), np.asarray(want)


# -------------------------------------------------------------- kron_segsum
@pytest.mark.parametrize(
    "E,Ka,Kb,R",
    [
        (1, 1, 1, 1),          # degenerate
        (7, 3, 5, 4),          # tiny, unaligned everything
        (256, 8, 16, 40),      # one exact element block
        (300, 4, 130, 50),     # Kb > 128
        (1000, 10, 10, 300),   # paper-like: K=10 3-D (K_hat=100)
        (515, 2, 257, 1),      # all elements in one row
        (64, 5, 7, 64),        # one element per row
    ],
)
def test_kron_segsum_matches_ref(E, Ka, Kb, R):
    got, want = _both_kron(*_mk(0, E, Ka, Kb, R))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 1000),
    E=st.integers(1, 400),
    Ka=st.integers(1, 12),
    Kb=st.integers(1, 40),
    R=st.integers(1, 200),
)
def test_kron_segsum_property(seed, E, Ka, Kb, R):
    got, want = _both_kron(*_mk(seed, E, Ka, Kb, R))
    np.testing.assert_allclose(got, want, **TOL)


def test_kron_segsum_empty_input():
    z = kron_segsum(torch.zeros((0,), dtype=torch.int32),
                    torch.zeros((0, 3)), torch.zeros((0, 5)), 4)
    assert tuple(z.shape) == (4, 15)
    np.testing.assert_array_equal(z.numpy(), np.zeros((4, 15)))


def test_kron_segsum_empty_matches_ref():
    rows, a, b, _ = _mk(0, 0, 2, 7, 6)
    got, want = _both_kron(rows, a, b, 6)
    np.testing.assert_array_equal(got, want)


def test_kron_segsum_skewed_rows():
    """Heavy-hub row distribution (one giant slice) — the paper's regime."""
    rng = np.random.default_rng(3)
    E, R = 2000, 64
    rows = np.where(rng.random(E) < 0.6, 7, rng.integers(0, R, E))
    rows = np.sort(rows).astype(np.int32)
    a = rng.standard_normal((E, 4)).astype(np.float32)
    b = rng.standard_normal((E, 25)).astype(np.float32)
    got, want = _both_kron(rows, a, b, R)
    np.testing.assert_allclose(got, want, **TOL)


def test_kron_segsum_bf16_contract():
    """bf16: operands and products rounded as the reference's kernel and
    reference round them, accumulation in f32."""
    rows, a, b, R = _mk(15, 200, 6, 9, 30)
    got, want = _both_kron(rows, a, b, R, precision="bf16")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    f32 = ref.kron_segsum_ref(torch.from_numpy(rows), torch.from_numpy(a),
                              torch.from_numpy(b), R).numpy()
    assert np.abs(got - f32).max() <= 2e-2 * np.abs(f32).max()


def test_kron_segsum_wrapper_checks():
    rows, a, b, R = _mk(1, 20, 3, 4, 10)
    r, ta, tb = (torch.from_numpy(x) for x in (rows, a, b))
    with pytest.raises(TypeError):
        kron_segsum(r.long(), ta, tb, R)
    with pytest.raises(TypeError):
        kron_segsum(r, ta.double(), tb, R)
    with pytest.raises(ValueError):
        kron_segsum(r[:-1], ta, tb, R)
    with pytest.raises(ValueError):
        kron_segsum(r, ta, tb, R, precision="fp8")
    before = kron_segsum.launches
    kron_segsum(r, ta, tb, R)
    assert kron_segsum.launches == before  # the plain version is no launch


# ------------------------------------------------------------- oracle_pair
def _both_oracle(Z, x, y):
    got = oracle_pair(torch.from_numpy(Z), torch.from_numpy(x),
                      torch.from_numpy(y))
    want = pallas_oracle_pair(jnp.asarray(Z), jnp.asarray(x),
                              jnp.asarray(y), interpret=True)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize(
    "R,K", [(1, 1), (5, 3), (128, 128), (300, 100), (1000, 400), (40, 513)]
)
def test_oracle_pair_matches_ref(R, K):
    rng = np.random.default_rng(5)
    Z = rng.standard_normal((R, K)).astype(np.float32)
    x = rng.standard_normal(K).astype(np.float32)
    y = rng.standard_normal(R).astype(np.float32)
    (gx, gy), (wx, wy) = _both_oracle(Z, x, y)
    np.testing.assert_allclose(gx, wx, **TOL)
    np.testing.assert_allclose(gy, wy, **TOL)


@pytest.mark.parametrize(
    "R,K,s",
    [
        (5, 3, 4),       # K_hat not a multiple of 128; panel wider than K
        (300, 513, 8),   # multiple K blocks with a ragged tail
        (40, 128, 16),   # exact single K block
        (128, 100, 1),   # single-row-block Z, width-1 panel
        (1, 1, 4),       # degenerate Z, panel wider than both dims
    ],
)
def test_oracle_pair_panel_edge_geometry(R, K, s):
    rng = np.random.default_rng(11)
    Z = rng.standard_normal((R, K)).astype(np.float32)
    X = rng.standard_normal((K, s)).astype(np.float32)
    Y = rng.standard_normal((R, s)).astype(np.float32)
    (gx, gy), (wx, wy) = _both_oracle(Z, X, Y)
    assert gx.shape == (R, s) and gy.shape == (K, s)
    np.testing.assert_allclose(gx, wx, **TOL)
    np.testing.assert_allclose(gy, wy, **TOL)


def test_oracle_pair_vector_panel_consistent():
    """A width-1 panel reproduces the vector call column for column."""
    rng = np.random.default_rng(12)
    Z = torch.from_numpy(rng.standard_normal((60, 37)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(37).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(60).astype(np.float32))
    vx, vy = oracle_pair(Z, x, y)
    px, py = oracle_pair(Z, x[:, None], y[:, None])
    np.testing.assert_array_equal(vx.numpy(), px[:, 0].numpy())
    np.testing.assert_array_equal(vy.numpy(), py[:, 0].numpy())
    (gx, gy), (wx, wy) = _both_oracle(Z.numpy(), x.numpy(), y.numpy())
    np.testing.assert_allclose(gx, wx, **TOL)
    np.testing.assert_allclose(gy, wy, **TOL)


@pytest.mark.parametrize("s", [None, 1, 5], ids=["vector", "s1", "s5"])
def test_oracle_pair_one_half_matches_zero_companion(s):
    """Leaving one operand out (None) gives the product the reference gives
    with a zero companion, and None for the other half."""
    rng = np.random.default_rng(13)
    R, K = 70, 45
    tail = () if s is None else (s,)
    Z = rng.standard_normal((R, K)).astype(np.float32)
    x = rng.standard_normal((K,) + tail).astype(np.float32)
    y = rng.standard_normal((R,) + tail).astype(np.float32)
    tZ = torch.from_numpy(Z)
    gx, none_y = oracle_pair(tZ, torch.from_numpy(x), None)
    none_x, gy = oracle_pair(tZ, None, torch.from_numpy(y))
    assert none_x is None and none_y is None
    wx = pallas_oracle_pair(jnp.asarray(Z), jnp.asarray(x),
                            jnp.zeros_like(jnp.asarray(y)), interpret=True)[0]
    wy = pallas_oracle_pair(jnp.asarray(Z), jnp.zeros_like(jnp.asarray(x)),
                            jnp.asarray(y), interpret=True)[1]
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), **TOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)


def test_oracle_pair_wrapper_checks():
    Z = torch.zeros((6, 4))
    with pytest.raises(ValueError):
        oracle_pair(Z, torch.zeros(5), torch.zeros(6))
    with pytest.raises(ValueError):
        oracle_pair(Z, torch.zeros(4), torch.zeros((6, 1)))
    with pytest.raises(TypeError):
        oracle_pair(Z.double(), torch.zeros(4), torch.zeros(6))
    with pytest.raises(ValueError):
        oracle_pair(Z, None, None)
    with pytest.raises(ValueError):
        oracle_pair(Z, None, torch.zeros(4))


# ------------------------------------------------- wrapper = core.ttm oracle
def _factors(shape, core, seed):
    facs = random_factors(shape, core, jax.random.PRNGKey(seed))
    return facs, [torch.from_numpy(np.array(f)) for f in facs]


@pytest.mark.parametrize("N,mode", [(3, 0), (3, 2), (4, 1), (4, 3)])
def test_ops_penultimate_matches_core(N, mode):
    rng = np.random.default_rng(7)
    shape = tuple(int(L) for L in rng.integers(5, 12, N))
    nnz = 150
    coords = np.stack([rng.integers(0, L, nnz) for L in shape],
                      1).astype(np.int32)
    values = rng.standard_normal(nnz).astype(np.float32)
    jf, tf = _factors(shape, tuple([3] * N), 0)
    want = ttm.penultimate(jnp.asarray(coords), jnp.asarray(values), jf,
                           mode, shape[mode])
    got = ops.penultimate(torch.from_numpy(coords), torch.from_numpy(values),
                          tf, mode, shape[mode])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("N,mode", [(3, 0), (3, 2), (4, 1)])
def test_ops_penultimate_sorted_matches_core(N, mode):
    """The sorted path (rows pre-sorted and dense) against the reference's
    plain local penultimate, without any sort."""
    rng = np.random.default_rng(9)
    shape = tuple(int(L) for L in rng.integers(5, 12, N))
    nnz = 150
    coords = np.stack([rng.integers(0, L, nnz) for L in shape], 1)
    coords = coords[np.argsort(coords[:, mode], kind="stable")]
    coords = coords.astype(np.int32)
    uniq, local = np.unique(coords[:, mode], return_inverse=True)
    local = local.astype(np.int32)
    R = len(uniq)
    values = rng.standard_normal(nnz).astype(np.float32)
    jf, tf = _factors(shape, tuple([3] * N), 0)
    want = ttm.penultimate_local(jnp.asarray(coords), jnp.asarray(values),
                                 jnp.asarray(local), jf, mode, R)
    got = ops.penultimate_sorted(torch.from_numpy(coords),
                                 torch.from_numpy(values),
                                 torch.from_numpy(local), tf, mode, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_kron_dims_matches_split_ab():
    rng = np.random.default_rng(4)
    shape = (9, 8, 7, 6)
    core = (2, 3, 4, 5)
    coords = torch.from_numpy(np.stack(
        [rng.integers(0, L, 40) for L in shape], 1).astype(np.int32))
    values = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    _, tf = _factors(shape, core, 2)
    for mode in range(4):
        a, b = ops._split_ab(coords, values, tf, mode)
        assert (a.shape[1], b.shape[1]) == ops.split_kron_dims(core, mode)
        assert (a.shape[1], b.shape[1]) == ref_ops.split_kron_dims(core, mode)


# ------------------------------------------------------- kron_segsum_oracle
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("E,Ka,Kb,R", [
    (7, 3, 5, 4),
    (300, 4, 130, 50),     # Kb > 128
    (1000, 10, 10, 300),   # paper-like: K=10 3-D (K_hat=100)
    (515, 2, 257, 1),      # all elements in one row
    (400, 100, 10, 60),    # K_hat = 1000 (4-mode, K = 10)
])
def test_kron_segsum_oracle_matches_ref(E, Ka, Kb, R, s, precision):
    rows, a, b, R = _mk(3, E, Ka, Kb, R)
    X = np.random.default_rng(s).standard_normal((Ka * Kb, s)).astype(
        np.float32)
    got = kron_segsum_oracle(torch.from_numpy(rows), torch.from_numpy(a),
                             torch.from_numpy(b), R, torch.from_numpy(X),
                             precision=precision)
    want = jax_ref.kron_segsum_oracle_ref(
        jnp.asarray(rows), jnp.asarray(a), jnp.asarray(b), R, jnp.asarray(X),
        precision=precision)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30))


def test_kron_segsum_oracle_z_is_kron_segsum():
    """The plain fused version returns kron_segsum's Z and, exactly, its
    product with the panel."""
    rows, a, b, R = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                     for x in _mk(5, 500, 6, 7, 80))
    X = torch.randn((42, 3), generator=torch.Generator().manual_seed(0))
    z, zx = kron_segsum_oracle(rows, a, b, R, X)
    assert torch.equal(z, kron_segsum(rows, a, b, R))
    assert torch.equal(zx, z @ X)


def test_kron_segsum_oracle_wrapper_checks():
    rows, a, b, R = (torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                     for x in _mk(1, 20, 3, 4, 10))
    X = torch.ones((12, 2))
    with pytest.raises(ValueError):
        kron_segsum_oracle(rows, a, b, R, torch.ones((11, 2)))
    with pytest.raises(ValueError):
        kron_segsum_oracle(rows, a, b, R, torch.ones(12))
    with pytest.raises(ValueError):
        kron_segsum_oracle(rows, a, b, R, torch.ones((12, 0)))
    with pytest.raises(TypeError):
        kron_segsum_oracle(rows, a, b, R, X.double())
    with pytest.raises(TypeError):
        kron_segsum_oracle(rows.long(), a, b, R, X)
    with pytest.raises(ValueError):
        kron_segsum_oracle(rows, a, b, R, X, precision="fp8")
    before = kron_segsum_oracle.launches
    z, zx = kron_segsum_oracle(rows[:0], a[:0], b[:0], R, X)
    assert torch.equal(z, torch.zeros((R, 12)))
    assert torch.equal(zx, torch.zeros((R, 2)))
    kron_segsum_oracle(rows, a, b, R, X)
    assert kron_segsum_oracle.launches == before  # the plain version


@pytest.mark.parametrize("N,mode", [(3, 0), (3, 2), (4, 1)])
def test_penultimate_oracle_matches_reference(N, mode):
    """Fused ``(Z, Z @ X)`` through ``ops`` against the reference's
    ``penultimate_sorted_oracle`` on its plain path, for sorted rows and,
    through a sort, for rows in any order."""
    rng = np.random.default_rng(11)
    shape = tuple(int(L) for L in rng.integers(5, 12, N))
    nnz = 150
    coords = np.stack([rng.integers(0, L, nnz) for L in shape], 1)
    values = rng.standard_normal(nnz).astype(np.float32)
    jf, tf = _factors(shape, tuple([3] * N), 0)
    X = rng.standard_normal((3 ** (N - 1), 4)).astype(np.float32)
    order = np.argsort(coords[:, mode], kind="stable")
    cs = coords[order].astype(np.int32)
    want = ref_ops.penultimate_sorted_oracle(
        jnp.asarray(cs), jnp.asarray(values[order]), jnp.asarray(cs[:, mode]),
        jf, mode, shape[mode], jnp.asarray(X), use_kernel=False)
    got = ops.penultimate_sorted_oracle(
        torch.from_numpy(cs), torch.from_numpy(values[order]),
        torch.from_numpy(cs[:, mode]), tf, mode, shape[mode],
        torch.from_numpy(X))
    got_any = ops.penultimate_local_oracle(
        torch.from_numpy(coords.astype(np.int32)), torch.from_numpy(values),
        torch.from_numpy(coords[:, mode].astype(np.int32)), tf, mode,
        shape[mode], torch.from_numpy(X))
    for g, ga, w in zip(got, got_any, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert torch.equal(g, ga)


# ------------------------------------------- kron_segsum, gather form
def _gather_case(seed, shape, core, mode, pad=0):
    """Elements sorted by the mode's rows, numpy, with ``pad`` padding
    elements (value 0, coordinates 0, the last row) at the end, as the
    distributed partitions pad each rank."""
    rng = np.random.default_rng(seed)
    nnz = 300
    coords = np.stack([rng.integers(0, L, nnz) for L in shape], 1)
    coords = coords[np.argsort(coords[:, mode], kind="stable")]
    values = rng.standard_normal(nnz)
    if pad:
        coords = np.concatenate([coords, np.zeros((pad, len(shape)),
                                                  coords.dtype)])
        values = np.concatenate([values, np.zeros(pad)])
    rows = coords[:, mode].copy()
    if pad:
        rows[-pad:] = rows[nnz - 1]
    jf, tf = _factors(shape, core, seed)
    return (coords.astype(np.int32), values.astype(np.float32),
            rows.astype(np.int32), jf, tf)


def _gather_port(coords, values, rows, tf, mode, R, precision):
    """The port's gather form as ``ops`` calls it: every factor gathered at
    N = 3 and N = 4 (two leading factors), the leading levels folded into
    ``a`` at N >= 5."""
    from repro_torch.kernels.kron_segsum import (kron_segsum_gather,
                                                 kron_segsum_gather2)

    *lead, last = [j for j in range(len(tf)) if j != mode]
    tc, tv, tr = (torch.from_numpy(x) for x in (coords, values, rows))
    if len(lead) == 1:
        return kron_segsum_gather(tr, tc, tv, tf[lead[0]], tf[last], lead[0],
                                  last, R, precision=precision)
    if len(lead) == 2:
        j1, j2 = lead
        return kron_segsum_gather2(tr, tc, tv, tf[j1], tf[j2], tf[last], j1,
                                   j2, last, R, precision=precision)
    a = ops._lead_a(tc, tv, tf, lead)
    return kron_segsum_gather(tr, tc, None, a, tf[last], None, last, R,
                              precision=precision)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("N,mode", [(3, 0), (3, 1), (3, 2),
                                    (4, 0), (4, 1), (4, 2), (4, 3),
                                    (5, 0), (5, 1), (5, 2), (5, 3), (5, 4)])
def test_kron_segsum_gather_matches_reference_split(N, mode, precision):
    """The gather form's plain version against the reference's
    ``_split_ab`` and ``kron_segsum_ref``, every mode of 3-, 4- and 5-mode
    tensors (two leading factors gathered at N = 4, the fold at N = 5),
    f32 and the bf16 contract, within 1e-5 of the largest output."""
    shape = (9, 8, 7, 6, 5)[:N]
    core = (3, 4, 2, 5, 2)[:N]
    coords, values, rows, jf, tf = _gather_case(21 + mode, shape, core, mode)
    R = shape[mode]
    got = _gather_port(coords, values, rows, tf, mode, R, precision).numpy()
    a, b = ref_ops._split_ab(jnp.asarray(coords), jnp.asarray(values), jf,
                             mode)
    want = np.asarray(jax_ref.kron_segsum_ref(jnp.asarray(rows), a, b, R,
                                              precision=precision))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("N", [3, 4, 5])
def test_kron_segsum_gather_padding_adds_nothing(N):
    """Padding elements (value 0, coordinates 0) gather row 0 of each
    factor and add nothing: Z equals the unpadded reference's."""
    shape = (9, 8, 7, 6, 5)[:N]
    core = (3, 3, 3, 3, 3)[:N]
    mode = 1
    coords, values, rows, jf, tf = _gather_case(5, shape, core, mode, pad=37)
    R = shape[mode]
    got = _gather_port(coords, values, rows, tf, mode, R, "f32").numpy()
    real = slice(0, len(values) - 37)
    a, b = ref_ops._split_ab(jnp.asarray(coords[real]),
                             jnp.asarray(values[real]), jf, mode)
    want = np.asarray(jax_ref.kron_segsum_ref(jnp.asarray(rows[real]), a, b,
                                              R))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_kron_segsum_gather_equals_row_form_on_cpu():
    """On the CPU the gather form gives the row form's bits on the host's
    ``_split_ab`` operands (as the kernel does on the card), with and
    without a panel."""
    from repro_torch.kernels.kron_segsum import kron_segsum_gather

    coords, values, rows, _, tf = _gather_case(8, (9, 8, 7), (3, 4, 2), 2)
    tc, tv, tr = (torch.from_numpy(x) for x in (coords, values, rows))
    X = torch.randn((12, 3), generator=torch.Generator().manual_seed(1))
    a, b = ops._split_ab(tc, tv, tf, 2)
    z = kron_segsum_gather(tr, tc, tv, tf[0], tf[1], 0, 1, 7)
    zo, zx = kron_segsum_gather(tr, tc, tv, tf[0], tf[1], 0, 1, 7, X=X)
    assert torch.equal(z, kron_segsum(tr, a, b, 7))
    wz, wzx = kron_segsum_oracle(tr, a, b, 7, X)
    assert torch.equal(zo, wz) and torch.equal(zx, wzx)


def test_kron_segsum_gather_wrapper_checks():
    from repro_torch.kernels.kron_segsum import kron_segsum_gather

    coords, values, rows, _, tf = _gather_case(9, (9, 8, 7), (3, 4, 2), 0)
    tc, tv, tr = (torch.from_numpy(x) for x in (coords, values, rows))
    with pytest.raises(ValueError):  # column outside the coordinates
        kron_segsum_gather(tr, tc, tv, tf[1], tf[2], 1, 3, 9)
    with pytest.raises(ValueError):  # a gathered lead needs values
        kron_segsum_gather(tr, tc, None, tf[1], tf[2], 1, 2, 9)
    with pytest.raises(ValueError):  # element counts
        kron_segsum_gather(tr[:-1], tc, tv, tf[1], tf[2], 1, 2, 9)
    with pytest.raises(TypeError):
        kron_segsum_gather(tr, tc.long(), tv, tf[1], tf[2], 1, 2, 9)
    with pytest.raises(TypeError):
        kron_segsum_gather(tr, tc, tv.double(), tf[1], tf[2], 1, 2, 9)
    with pytest.raises(ValueError):
        kron_segsum_gather(tr, tc, tv, tf[1], tf[2], 1, 2, 9,
                           precision="fp8")
    with pytest.raises(ValueError):  # panel of the wrong height
        kron_segsum_gather(tr, tc, tv, tf[1], tf[2], 1, 2, 9,
                           X=torch.ones((7, 2)))
    before = kron_segsum.launches, kron_segsum_oracle.launches
    kron_segsum_gather(tr, tc, tv, tf[1], tf[2], 1, 2, 9)
    kron_segsum_gather(tr, tc, tv, tf[1], tf[2], 1, 2, 9,
                       X=torch.ones((8, 2)))
    assert (kron_segsum.launches, kron_segsum_oracle.launches) == before


# ------------------------------------------ oracle_pair, stacked ranks
@pytest.mark.parametrize("P,R,K,s", [(4, 30, 100, 8), (4, 30, 100, None),
                                     (3, 17, 37, 5), (1, 50, 12, None),
                                     (2, 1, 1, 1)])
def test_oracle_pair_stacked_matches_reference_per_rank(P, R, K, s):
    """The batched plain version against P calls of the reference's
    ``oracle_pair`` (interpret mode), one per rank, within 1e-5 of the
    largest output; Z @ x is over all stacked rows."""
    rng = np.random.default_rng(P * 100 + R + K)
    tail = () if s is None else (s,)
    Z = rng.standard_normal((P * R, K)).astype(np.float32)
    x = rng.standard_normal((K,) + tail).astype(np.float32)
    y = rng.standard_normal((P, R) + tail).astype(np.float32)
    gx, gy = oracle_pair(torch.from_numpy(Z), torch.from_numpy(x),
                         torch.from_numpy(y), P)
    assert tuple(gx.shape) == (P * R,) + tail
    assert tuple(gy.shape) == (P, K) + tail
    wxs, wys = [], []
    for p in range(P):
        wx, wy = pallas_oracle_pair(jnp.asarray(Z[p * R:(p + 1) * R]),
                                    jnp.asarray(x), jnp.asarray(y[p]),
                                    interpret=True)
        wxs.append(np.asarray(wx))
        wys.append(np.asarray(wy))
    wx, wy = np.concatenate(wxs), np.stack(wys)
    np.testing.assert_allclose(gx.numpy(), wx, rtol=0,
                               atol=1e-5 * np.abs(wx).max())
    np.testing.assert_allclose(gy.numpy(), wy, rtol=0,
                               atol=1e-5 * np.abs(wy).max())
    # the stacked call is P single calls, rank by rank, bit for bit
    tZ = torch.from_numpy(Z)
    for p in range(P):
        one = oracle_pair(tZ[p * R:(p + 1) * R], None,
                          torch.from_numpy(y[p]))[1]
        assert torch.equal(gy[p], one)


def test_oracle_pair_stacked_checks():
    Z = torch.zeros((12, 4))
    with pytest.raises(ValueError):  # 12 rows do not split into 5 ranks
        oracle_pair(Z, None, torch.zeros((5, 2)), 5)
    with pytest.raises(ValueError):  # y without its rank dimension
        oracle_pair(Z, None, torch.zeros(12), 4)
    with pytest.raises(ValueError):  # y of the wrong rank count
        oracle_pair(Z, None, torch.zeros((3, 3, 2)), 4)
    with pytest.raises(ValueError):  # vector x with a panel y
        oracle_pair(Z, torch.zeros(4), torch.zeros((4, 3, 2)), 4)
    before = oracle_pair.launches
    xo, yo = oracle_pair(Z, torch.zeros(4), torch.zeros((4, 3)), 4)
    assert tuple(xo.shape) == (12,) and tuple(yo.shape) == (4, 4)
    assert oracle_pair.launches == before  # the plain version
