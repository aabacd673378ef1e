"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU with ``nvcc`` (the kernels are built
from ``src/repro_torch/kernels/csrc``); a CUDA kernel has no CPU mode, so
on a machine without a card they skip. Run them on the card with::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum in another order than the plain versions
(chunked sequential sums and fixed-order partials against ``index_add_``'s
atomics and cuBLAS's reductions), so results agree to f32 rounding relative
to the largest output, 2e-4 of it; reruns of a kernel are bitwise equal.
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.core import hooi, ttm
from repro_torch.core import plan as port_plan
from repro_torch.distributed.dist_hooi import (HooiExecutor, dist_hooi,
                                               make_ranks_mesh)
from repro_torch.data.tensors import synth_tensor
from repro_torch.kernels import ops, ref
from repro_torch.kernels.kron_segsum import (kron_segsum, kron_segsum_gather2,
                                             kron_segsum_oracle)
from repro_torch.distributed import executor as exmod
from repro_torch.engine.oracle import ModeSpec
from repro_torch.engine.steps import make_mode_step_fn
from repro_torch.kernels import oracle_fused
from repro_torch.kernels.oracle_fused import oracle_pair
from repro_torch.random import make_key

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel_err(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def _sorted_inputs(seed, E, Ka, Kb, R, hub=0.0, device="cuda"):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rows = torch.randint(0, R, (E,), generator=g)
    if hub:
        rows[torch.rand(E, generator=g) < hub] = R // 3
    rows = torch.sort(rows).values.to(torch.int32)
    a = torch.randn((E, Ka), generator=g)
    b = torch.randn((E, Kb), generator=g)
    return rows.to(device), a.to(device), b.to(device), R


@pytest.mark.parametrize("E,Ka,Kb,R,hub", [
    (1, 1, 1, 1, 0.0),
    (7, 3, 5, 4, 0.0),
    (5000, 10, 10, 300, 0.0),
    (3000, 2, 257, 1, 0.0),        # one row across three chunks
    (20000, 4, 25, 64, 0.6),       # hub row spanning many chunks
    (4000, 100, 10, 500, 0.0),     # K_hat = 1000 (4-mode, K = 10)
    # K_hat = 1000 with enron's mode-0 hub: 8 elements a tile, the hub
    # row's partials added in series by the fix-up
    (200_000, 100, 10, 6066, 0.09),
    (2048, 3, 3, 4096, 0.0),       # exact chunk multiple, sparse rows
])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_kron_segsum_kernel_matches_plain(cuda, E, Ka, Kb, R, hub, precision):
    rows, a, b, R = _sorted_inputs(0, E, Ka, Kb, R, hub)
    before = kron_segsum.launches
    got = kron_segsum(rows, a, b, R, precision=precision)
    again = kron_segsum(rows, a, b, R, precision=precision)
    torch.cuda.synchronize()
    assert kron_segsum.launches == before + 2
    want = ref.kron_segsum_ref(rows, a, b, R, precision)
    assert _rel_err(got, want) <= 2e-4
    assert torch.equal(got, again)


def test_kron_segsum_kernel_empty_and_checks(cuda):
    rows, a, b, R = _sorted_inputs(1, 100, 3, 4, 20)
    before = kron_segsum.launches
    z = kron_segsum(rows[:0], a[:0], b[:0], R)
    assert kron_segsum.launches == before
    assert torch.equal(z, torch.zeros((R, 12), device=cuda))
    with pytest.raises(ValueError):
        kron_segsum(rows, a.t().contiguous().t(), b, R)  # not contiguous
    with pytest.raises(ValueError):
        kron_segsum(rows.cpu(), a, b, R)  # mixed devices
    # ids outside [0, num_rows) add nothing, as in the reference's
    # segment_sum, and no write leaves Z
    R_cut = int(rows[-1])
    keep = rows < R_cut
    got = kron_segsum(rows, a, b, R_cut)
    want = ref.kron_segsum_ref(rows[keep], a[keep], b[keep], R_cut)
    assert _rel_err(got, want) <= 2e-4


@pytest.mark.parametrize("R,K,s", [(1, 1, 1), (300, 100, 1), (28818, 100, 1),
                                   (28818, 100, 8), (40, 1000, 3),
                                   (1000, 513, 16),
                                   # the sketch panel: one pass of 8 columns
                                   # and a tail of 2
                                   (28818, 100, 10), (12092, 100, 10),
                                   # K = 1000 (four modes at K = 10): 22
                                   # rows a block staged for Z^T y
                                   (24427, 1000, 1), (24427, 1000, 8)])
def test_oracle_pair_kernel_matches_plain(cuda, R, K, s):
    g = torch.Generator(device="cpu").manual_seed(R + K + s)
    Z = torch.randn((R, K), generator=g).to(cuda)
    shape_x, shape_y = ((K,), (R,)) if s == 1 else ((K, s), (R, s))
    x = torch.randn(shape_x, generator=g).to(cuda)
    y = torch.randn(shape_y, generator=g).to(cuda)
    before = oracle_pair.launches
    gx, gy = oracle_pair(Z, x, y)
    ax, ay = oracle_pair(Z, x, y)
    torch.cuda.synchronize()
    assert oracle_pair.launches == before + 2
    wx, wy = ref.oracle_pair_ref(Z, x, y)
    assert gx.shape == wx.shape and gy.shape == wy.shape
    assert _rel_err(gx, wx) <= 2e-4 and _rel_err(gy, wy) <= 2e-4
    assert torch.equal(gx, ax) and torch.equal(gy, ay)
    # one half at a time, as the Lanczos loop calls it
    hx, none_y = oracle_pair(Z, x, None)
    none_x, hy = oracle_pair(Z, None, y)
    torch.cuda.synchronize()
    assert none_x is None and none_y is None
    assert oracle_pair.launches == before + 4
    assert torch.equal(hx, gx) and torch.equal(hy, gy)


def test_hooi_on_card_matches_cpu(cuda):
    """The whole slice on the card (both kernels) against the port's plain
    CPU path, same seed and draws."""
    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    kz, ko = kron_segsum.launches, oracle_pair.launches
    dec_g, fits_g = hooi.hooi(t, (5, 5, 5), n_invocations=3, seed=2,
                              use_fused_oracle=True)
    assert kron_segsum.launches > kz and oracle_pair.launches > ko
    dec_c, fits_c = hooi.hooi(t, (5, 5, 5), n_invocations=3, seed=2,
                              use_fused_oracle=True, device="cpu")
    np.testing.assert_allclose(fits_g, fits_c, rtol=0, atol=1e-4)
    for F, Fc in zip(dec_g.factors, dec_c.factors):
        F = F.cpu().numpy()
        Fc = Fc.numpy()
        np.testing.assert_allclose(F @ F.T, Fc @ Fc.T, atol=1e-3)


def test_second_hooi_call_reuses_the_card_copy(cuda, monkeypatch):
    """A second ``hooi`` on one 1.07M-element tensor copies nothing from
    the host: ``device_coords`` hands it the pair the first call left on
    the card, and both calls (and one on a fresh instance) agree bitwise."""
    from repro_torch import tracing

    t = synth_tensor((1200, 900, 2800), 1_500_000, seed=8)
    assert t.nnz >= 1_000_000
    seen = []
    real = convert.device_coords

    def device_coords(tt, device):
        seen.append(real(tt, device))
        return seen[-1]

    monkeypatch.setattr(convert, "device_coords", device_coords)
    kw = dict(n_invocations=2, seed=4, use_fused_oracle=True)
    first = hooi.hooi(t, (8, 8, 8), **kw)
    tracing.clear()
    with tracing.recording():
        second = hooi.hooi(t, (8, 8, 8), **kw)
    counters = tracing.summary()["hooi.upload"]["counters"]
    tracing.clear()
    fresh = hooi.hooi(convert.sparse_tensor(t.coords, t.values, t.shape),
                      (8, 8, 8), **kw)
    assert seen[1][0] is seen[0][0] and seen[1][1] is seen[0][1]
    assert seen[2][0] is not seen[0][0]
    assert seen[0][0].is_cuda and seen[0][1].is_cuda
    assert counters == {"hooi.upload_bytes": 0, "hooi.upload_reused": 1}
    for dec, fits in (second, fresh):
        assert fits == first[1]
        assert torch.equal(dec.core, first[0].core)
        for F, F0 in zip(dec.factors, first[0].factors):
            assert torch.equal(F, F0)


def test_core_on_card_matches_plain(cuda):
    t = synth_tensor((40, 30, 20, 10), 5_000, alphas=1.0, seed=4)
    coords, values = convert.device_coords(t, cuda)
    factors = hooi.random_factors(t.shape, (3, 4, 2, 5), make_key(1))
    got = ttm.core_from_factors(coords, values, factors)
    want = ttm.core_from_factors(coords.cpu(), values.cpu(),
                                 [f.cpu() for f in factors])
    assert _rel_err(got.cpu(), want) <= 2e-4
    Z = ops.penultimate(coords, values, factors, 2, t.shape[2])
    Zp = ttm.penultimate(coords, values, factors, 2, t.shape[2])
    assert _rel_err(Z, Zp) <= 2e-4


@pytest.mark.parametrize("E,Ka,Kb,R,hub,s", [
    (1, 1, 1, 1, 0.0, 1),
    (7, 3, 5, 4, 0.0, 4),
    (5000, 10, 10, 300, 0.0, 8),
    (3000, 2, 257, 1, 0.0, 8),     # one row across three chunks
    (20000, 4, 25, 64, 0.6, 8),    # hub row spanning many chunks
    (4000, 100, 10, 500, 0.0, 8),  # K_hat = 1000 (4-mode, K = 10)
    (2048, 3, 3, 4096, 0.0, 64),   # a wide panel, sparse rows
    (5000, 10, 10, 300, 0.0, 14),  # range_finder's k + oversample
    (20000, 4, 25, 64, 0.6, 14),
])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_kron_segsum_oracle_kernel_matches_plain(cuda, E, Ka, Kb, R, hub, s,
                                                 precision):
    rows, a, b, R = _sorted_inputs(0, E, Ka, Kb, R, hub)
    g = torch.Generator(device="cpu").manual_seed(E + s)
    X = torch.randn((Ka * Kb, s), generator=g).to(cuda)
    before = kron_segsum_oracle.launches
    got = kron_segsum_oracle(rows, a, b, R, X, precision=precision)
    again = kron_segsum_oracle(rows, a, b, R, X, precision=precision)
    torch.cuda.synchronize()
    assert kron_segsum_oracle.launches == before + 2
    want = ref.kron_segsum_oracle_ref(rows, a, b, R, X, precision)
    for g_, w, a_ in zip(got, want, again):
        assert _rel_err(g_, w) <= 2e-4
        assert torch.equal(g_, a_)
    # the same chunk walk: Z is kron_segsum's bit for bit
    assert torch.equal(got[0], kron_segsum(rows, a, b, R,
                                           precision=precision))


def test_kron_segsum_oracle_kernel_empty_and_checks(cuda):
    rows, a, b, R = _sorted_inputs(1, 100, 3, 4, 20)
    X = torch.ones((12, 2), device=cuda)
    before = kron_segsum_oracle.launches
    z, zx = kron_segsum_oracle(rows[:0], a[:0], b[:0], R, X)
    assert kron_segsum_oracle.launches == before
    assert torch.equal(z, torch.zeros((R, 12), device=cuda))
    assert torch.equal(zx, torch.zeros((R, 2), device=cuda))
    with pytest.raises(ValueError):
        kron_segsum_oracle(rows, a, b, R, X.t().contiguous().t())
    with pytest.raises(TypeError):
        kron_segsum_oracle(rows, a, b, R, X.cpu())
    with pytest.raises(ValueError):
        kron_segsum_oracle(rows, a, b, R, torch.ones((12, 0), device=cuda))


@pytest.mark.parametrize("path", ["liteopt", "baseline"])
def test_dist_hooi_on_card_matches_cpu(cuda, path):
    """The distributed path on the card (all three kernels) against the
    port's plain CPU path: same plan, seed and draws."""
    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    kw = dict(path=path, n_invocations=3, seed=2, lanczos_block=4,
              fused_zbuild=True, use_fused_oracle=True)
    counts = (kron_segsum.launches, kron_segsum_oracle.launches,
              oracle_pair.launches)
    dec_g, st_g = dist_hooi(t, (5, 5, 5), 4, **kw)
    assert kron_segsum.launches > counts[0]
    # 3 modes x 3 sweeps: a step's first call captures it, after an eager
    # warm-up that launches the kernel once; later calls replay the
    # recorded launch, which the wrapper does not count
    assert st_g.step_captures + st_g.graph_replays == 9
    assert kron_segsum_oracle.launches == counts[1] + st_g.step_captures
    assert oracle_pair.launches >= counts[2] + st_g.step_captures
    dec_c, st_c = dist_hooi(t, (5, 5, 5), 4, device="cpu", **kw)
    np.testing.assert_allclose(st_g.fits, st_c.fits, rtol=0, atol=1e-4)
    for F, Fc in zip(dec_g.factors, dec_c.factors):
        F, Fc = F.cpu().numpy(), Fc.numpy()
        np.testing.assert_allclose(F @ F.T, Fc @ Fc.T, atol=1e-3)
    # a rerun on the card is bitwise equal: no float atomics anywhere
    _, st_again = dist_hooi(t, (5, 5, 5), 4, **kw)
    assert st_again.fits == st_g.fits


def _gather_inputs(seed, shape, core, mode, device, pad=0, hub=0.0,
                   nnz=20_000):
    """``nnz`` elements sorted by the mode's rows on the card, with ``pad``
    padding elements (value 0, coordinates 0, the last row) at the end;
    ``hub`` puts that share of the elements in one slice of the mode."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    coords = torch.stack([torch.randint(0, L, (nnz,), generator=g)
                          for L in shape], 1)
    if hub:
        coords[torch.rand(nnz, generator=g) < hub, mode] = shape[mode] // 3
    coords = coords[torch.argsort(coords[:, mode], stable=True)]
    values = torch.randn(nnz, generator=g)
    rows = coords[:, mode].clone()
    if pad:
        coords = torch.cat([coords, torch.zeros((pad, len(shape)),
                                                dtype=coords.dtype)])
        values = torch.cat([values, torch.zeros(pad)])
        rows = torch.cat([rows, rows[-1:].expand(pad)])
    factors = hooi.random_factors(shape, core, make_key(seed), device)
    return (coords.to(torch.int32).to(device), values.to(device),
            rows.to(torch.int32).to(device), factors)


@pytest.mark.parametrize("case", [
    dict(shape=(300, 200, 100), mode=0),
    dict(shape=(300, 200, 100), mode=1),
    dict(shape=(300, 200, 100), mode=2),
    dict(shape=(300, 200, 100), mode=0, hub=0.5),   # hub row over chunks
    dict(shape=(300, 200, 100), mode=2, pad=3000),  # padded partition
    dict(shape=(60, 50, 40, 30), mode=1),           # K_hat = 1000
    dict(shape=(60, 50, 40, 30), mode=0),
    dict(shape=(60, 50, 40, 30), mode=2),
    dict(shape=(60, 50, 40, 30), mode=3),
    dict(shape=(60, 50, 40, 30), mode=0, hub=0.5, nnz=60_000),
    dict(shape=(60, 50, 40, 30), mode=2, pad=3000),
], ids=["m0", "m1", "m2", "hub", "padded", "4mode", "4mode_m0", "4mode_m2",
        "4mode_m3", "4mode_hub", "4mode_padded"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_kron_segsum_gather_bitwise_row_form(cuda, case, precision):
    """The gather form's Z (and ZX) is the row form's on the host's
    ``_split_ab`` operands bit for bit, and within 2e-4 of the plain
    version; reruns bitwise equal. At four modes the two-lead walk runs
    (both leading factors gathered, no fold) and still gives the fold's
    bits."""
    shape, mode = case["shape"], case["mode"]
    core = (10,) * len(shape)
    coords, values, rows, f = _gather_inputs(
        7, shape, core, mode, cuda, pad=case.get("pad", 0),
        hub=case.get("hub", 0.0), nnz=case.get("nnz", 20_000))
    R = shape[mode]
    Khat = 10 ** (len(shape) - 1)
    X = torch.randn((Khat, 8), generator=torch.Generator().manual_seed(3)
                    ).to(cuda)
    counts = (kron_segsum.launches, kron_segsum_oracle.launches,
              kron_segsum_gather2.launches)
    z = ops.penultimate_sorted(coords, values, rows, f, mode, R,
                               precision=precision)
    z2 = ops.penultimate_sorted(coords, values, rows, f, mode, R,
                                precision=precision)
    zo, zx = ops.penultimate_sorted_oracle(coords, values, rows, f, mode, R,
                                           X, precision=precision)
    torch.cuda.synchronize()
    assert (kron_segsum.launches, kron_segsum_oracle.launches,
            kron_segsum_gather2.launches) == (
        counts[0] + 2, counts[1] + 1,
        counts[2] + (3 if len(shape) == 4 else 0))
    a, b = ops._split_ab(coords, values, f, mode)
    want_z = kron_segsum(rows, a, b, R, precision=precision)
    want_zo, want_zx = kron_segsum_oracle(rows, a, b, R, X,
                                          precision=precision)
    assert torch.equal(z, want_z) and torch.equal(z, z2)
    assert torch.equal(zo, z) and torch.equal(zo, want_zo)
    assert torch.equal(zx, want_zx)
    assert _rel_err(z, ref.kron_segsum_ref(rows, a, b, R, precision)) <= 2e-4


@pytest.mark.parametrize("core", [(3, 4, 2, 5), (2, 3, 5, 3), (5, 5, 7, 6),
                                  (4, 3, 2, 9), (3, 5, 2, 20),
                                  (20, 10, 3, 10)],
                         ids=["narrow_last", "odd_widths", "last_6_7",
                              "odd_last_9", "wide_last_two_groups",
                              "two_pair_tiles"])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_two_lead_walk_widths_bitwise_fold(cuda, core, precision):
    """The two-lead walk at widths other than K = 10 (narrow last factors
    that leave block columns unused, odd widths that stage by single
    floats, a last factor wider than one block, more than one pair tile):
    Z and (Z, ZX) bitwise the fold form's, every mode."""
    shape = (60, 50, 40, 30)
    for mode in range(4):
        coords, values, rows, f = _gather_inputs(11 + mode, shape, core, mode,
                                                 cuda, pad=500)
        R = shape[mode]
        a, b = ops._split_ab(coords, values, f, mode)
        X = torch.randn((a.shape[1] * b.shape[1], 5),
                        generator=torch.Generator().manual_seed(mode)).to(cuda)
        before = kron_segsum_gather2.launches
        z = ops.penultimate_sorted(coords, values, rows, f, mode, R,
                                   precision=precision)
        zo, zx = ops.penultimate_sorted_oracle(coords, values, rows, f, mode,
                                               R, X, precision=precision)
        torch.cuda.synchronize()
        assert kron_segsum_gather2.launches == before + 2
        assert torch.equal(z, kron_segsum(rows, a, b, R, precision=precision))
        want_zo, want_zx = kron_segsum_oracle(rows, a, b, R, X,
                                              precision=precision)
        assert torch.equal(zo, want_zo) and torch.equal(zx, want_zx)


@pytest.mark.parametrize("N", [3, 4, 5])
def test_row_order_bitwise_indexing(cuda, N):
    """The unsorted build's reorder on the card (whole rows at N = 3,
    column by column from N = 4, without the mode's column) gives
    indexing's bits."""
    g = torch.Generator().manual_seed(N)
    E = 300_001
    coords = torch.randint(0, 1 << 30, (E, N), generator=g,
                           dtype=torch.int32).to(cuda)
    values = torch.randn(E, generator=g).to(cuda)
    local_rows = torch.randint(0, 1000, (E,), generator=g).to(cuda)
    order = torch.argsort(local_rows, stable=True)
    for mode in range(N):
        c, v, rows = ops._row_order(coords, values, local_rows, mode)
        kept = [j for j in range(N) if N < 4 or j != mode]
        assert torch.equal(c, coords[order][:, kept])
        assert torch.equal(v, values[order])
        assert torch.equal(rows, local_rows[order]) and c.is_contiguous()


@pytest.mark.parametrize("P,R,K,s", [(4, 7206, 100, 8), (4, 3024, 100, 1),
                                     (3, 500, 37, 5), (2, 40, 1000, 16),
                                     (1, 28818, 100, 1),
                                     # the sketch panel on stacked ranks
                                     (4, 7206, 100, 10), (4, 3024, 100, 10),
                                     # four modes: K = 1000, fused_block8
                                     (4, 6107, 1000, 8)])
def test_oracle_pair_stacked_bitwise_single_calls(cuda, P, R, K, s):
    """A stacked call gives each rank the bits of a single call on that
    rank's rows, within 2e-4 of the plain version; reruns bitwise."""
    g = torch.Generator(device="cpu").manual_seed(P + R + K + s)
    tail = () if s == 1 else (s,)
    Z = torch.randn((P * R, K), generator=g).to(cuda)
    y = torch.randn((P, R) + tail, generator=g).to(cuda)
    x = torch.randn((K,) + tail, generator=g).to(cuda)
    before = oracle_pair.launches
    got = oracle_pair(Z, None, y, P)[1]
    again = oracle_pair(Z, None, y, P)[1]
    gx = oracle_pair(Z, x, None)[0]
    torch.cuda.synchronize()
    assert oracle_pair.launches == before + 3
    assert tuple(got.shape) == (P, K) + tail
    assert torch.equal(got, again)
    want = ref.oracle_pair_ref(Z, None, y, P)[1]
    assert _rel_err(got, want) <= 2e-4
    assert _rel_err(gx, Z @ x) <= 2e-4
    for p in range(P):
        Zp = Z[p * R:(p + 1) * R]
        assert torch.equal(got[p], oracle_pair(Zp, None, y[p])[1])
        assert torch.equal(gx[p * R:(p + 1) * R], oracle_pair(Zp, x, None)[0])


def test_range_finder_gather_form_at_sketch_width(cuda):
    """``range_finder``'s ``(Z, Z·Ω)`` at s = k + oversample = 14 through
    the gather form of ``kron_segsum_oracle`` on the card: Z bitwise the
    row form's, ZΩ within 2e-4 of the plain version, and the range finder's
    subspace the CPU path's."""
    from repro_torch.core import sketch

    coords, values, rows, f = _gather_inputs(9, (300, 200, 100), (10,) * 3,
                                             0, cuda)
    X = sketch.test_matrix(make_key(2), 100, 14, "gauss", cuda)
    before = kron_segsum_oracle.launches
    zo, zx = ops.penultimate_sorted_oracle(coords, values, rows, f, 0, 300,
                                           X)
    zo2, zx2 = ops.penultimate_sorted_oracle(coords, values, rows, f, 0, 300,
                                             X)
    torch.cuda.synchronize()
    assert kron_segsum_oracle.launches == before + 2
    assert torch.equal(zo, zo2) and torch.equal(zx, zx2)
    a, b = ops._split_ab(coords, values, f, 0)
    want_zo, want_zx = kron_segsum_oracle(rows, a, b, 300, X)
    assert torch.equal(zo, want_zo) and torch.equal(zx, want_zx)
    assert _rel_err(zx, ref.kron_segsum_oracle_ref(rows, a, b, 300, X)[1]) \
        <= 2e-4
    U, sv = sketch.range_finder(coords, values, rows, f, 0, 300, 10,
                                make_key(5), power_iters=1)
    Uc, svc = sketch.range_finder(coords.cpu(), values.cpu(), rows.cpu(),
                                  [F.cpu() for F in f], 0, 300, 10,
                                  make_key(5), power_iters=1)
    U, Uc = U.cpu().numpy(), Uc.numpy()
    np.testing.assert_allclose(U @ U.T, Uc @ Uc.T, atol=1e-4)
    np.testing.assert_allclose(sv.cpu().numpy(), svc.numpy(), rtol=1e-4)


@pytest.mark.parametrize("warm,objective", [("sketch", "tucker"),
                                            ("auto", "completion"),
                                            ("none", "nn")])
def test_warm_starts_and_objectives_on_card_match_cpu(cuda, warm, objective):
    """The sketch warm start and the objectives on the card (every kernel
    at the sketch's widths) against the port's plain CPU path, single
    process and P = 4 stacked ranks on both backends."""
    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    kw = dict(n_invocations=2, seed=2, use_fused_oracle=True,
              warm_start=warm, objective=objective)
    before = oracle_pair.launches
    out_g, out_c = {}, {}
    dec_g, fits_g = hooi.hooi(t, (5, 5, 5), metrics_out=out_g, **kw)
    assert oracle_pair.launches > before
    dec_c, fits_c = hooi.hooi(t, (5, 5, 5), metrics_out=out_c, device="cpu",
                              **kw)
    np.testing.assert_allclose(fits_g, fits_c, rtol=0, atol=1e-4)
    for key in out_c:
        np.testing.assert_allclose(out_g[key], out_c[key], rtol=0, atol=1e-5)
    if objective == "nn":
        assert all(float(F.min()) >= 0.0 for F in dec_g.factors)
    for path in ("liteopt", "baseline"):
        _, st_g = dist_hooi(t, (5, 5, 5), 4, path=path, **kw)
        _, st_c = dist_hooi(t, (5, 5, 5), 4, path=path, device="cpu", **kw)
        assert st_g.warm_start == st_c.warm_start
        np.testing.assert_allclose(st_g.fits, st_c.fits, rtol=0, atol=1e-4)


def _captured_case(warm_start, path):
    """Per mode: the step's arrays, the uncached step made with
    ``make_mode_step_fn`` and a call of the executor's cached step."""
    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    pl = port_plan.plan(t, "lite", 4, core_dims=(5, 5, 5), path=path)
    ex = HooiExecutor(4)
    specs = ex._mode_specs(pl, (5, 5, 5), path, ModeSpec(
        block_size=4, fused_zbuild=True, warm_start=warm_start,
        use_fused=True))
    up = ex._get_upload(pl, t, exmod._tally())
    steps = []
    for mp, sp in zip(pl.parts, specs):
        skey, step = ex._get_step(mp, sp)

        def cached(arrs, factors, key, skey=skey, step=step):
            return ex._call_step(skey, step, up, arrs, factors, key,
                                 exmod._tally())

        steps.append((up.arrs[mp.mode],
                       make_mode_step_fn(exmod.step_spec(mp, sp)), cached))
    factors = hooi.random_factors(t.shape, (5, 5, 5), make_key(1), "cuda")
    return ex, steps, factors


@pytest.mark.parametrize("warm_start,path", [("none", "baseline"),
                                             ("none", "liteopt"),
                                             ("sketch", "liteopt")],
                         ids=["psum", "boundary", "sketch"])
def test_captured_step_bitwise_eager(cuda, warm_start, path):
    """A mode step captured into CUDA graphs gives the eager step's bits,
    at its capture and at every replay, with each call's own draws and
    factors copied in."""
    ex, steps, factors = _captured_case(warm_start, path)
    for n, (arrs, eager, cached) in enumerate(steps):
        key = make_key(2).fold_in(1000 + n)
        want = eager(arrs, factors, key)
        for _ in range(2):  # the capture, then a replay
            got = cached(arrs, factors, key)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        other = make_key(3).fold_in(1000 + n)
        moved = [F.flip(0).contiguous() for F in factors]
        want = eager(arrs, moved, other)
        got = cached(arrs, moved, other)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ex.stats()["step_captures"] == 3
    assert ex.stats()["step_compilations"] == 3


def test_host_call_results_keep_their_strides_under_capture(cuda):
    """A host call's results keep their strides in a captured step, as an
    eager host call's keep LAPACK's column-major factors: a product that
    reads one makes the eager step's library call, so the captured step
    gives the eager step's bits (ROADMAP Queue C item 6)."""
    from repro_torch.core import lanczos
    from repro_torch.graphs import CaptureHome, StepGraph, host_call

    g = torch.Generator().manual_seed(0)
    B = torch.diag(torch.rand(24, generator=g) + 1) + torch.diag(
        torch.rand(23, generator=g), 1)
    arrs = {"B": B.to(cuda), "U": torch.randn((4, 3024, 24), generator=g)
            .to(cuda)}
    factors = [torch.ones((2, 2), device=cuda)]

    def step(arrs, factors, key):
        P, S = host_call(lanczos._host_svd, arrs["B"] * factors[0][0, 0])
        return P, arrs["U"] @ P[:, :10]

    want = step(arrs, factors, None)
    home = CaptureHome(torch.device("cuda", torch.cuda.current_device()))
    graph, got = StepGraph.capture(home, step, arrs, factors, make_key(0))
    assert got[0].stride() == want[0].stride()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    again = graph(arrs, factors, make_key(1))
    assert all(torch.equal(a, b) for a, b in zip(again, want))


@pytest.mark.parametrize("path", ["baseline", "liteopt"])
def test_captured_step_bitwise_eager_at_3m(cuda, path):
    """ROADMAP Queue C item 6's plan (a 3M-element tensor, P = 4, core
    (10, 10, 10), ``fused_block8``): every captured mode step gives the
    eager step's bits."""
    core = (10, 10, 10)
    t = synth_tensor((1200, 900, 2800), 3_000_000)
    pl = port_plan.plan(t, "lite", 4, core_dims=core, path=path)
    ex = HooiExecutor(4)
    specs = ex._mode_specs(pl, core, path, ModeSpec(
        block_size=8, fused_zbuild=True, use_fused=True))
    up = ex._get_upload(pl, t, exmod._tally())
    factors = hooi.random_factors(t.shape, core, make_key(21), "cuda")
    for mp, sp in zip(pl.parts, specs):
        skey, step = ex._get_step(mp, sp)
        eager = make_mode_step_fn(exmod.step_spec(mp, sp))
        key = make_key(22).fold_in(1000 + mp.mode)
        want = eager(up.arrs[mp.mode], factors, key)
        for _ in range(2):  # the capture, then a replay
            got = ex._call_step(skey, step, up, up.arrs[mp.mode], factors,
                                key, exmod._tally())
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def _stacked_call(P, device):
    """An ``oracle_pair`` call over P stacked ranks at nell-2's mode-2
    rows (K = 100, s = 8): its scratch grows with P."""
    Z = torch.randn((P * 7206, 100), device=device)
    y = torch.randn((P, 7206, 8), device=device)
    return oracle_pair(Z, None, y, P)[1]


def test_oracle_pair_scratch_growth_keeps_replays(cuda):
    """Growing ``oracle_pair``'s scratch after a capture (a wider call on
    the capturing stream) must not free the buffer the captured step
    writes: memory taken after the growth stays untouched by the step's
    replays, which stay bitwise what they were. The step holds the old
    buffer, which goes with it. The scratch is per stream: the captures
    run on the executor's side stream."""
    import gc
    import weakref

    ex, steps, factors = _captured_case("none", "liteopt")
    side = ex._home.stream
    where = (torch.cuda.current_device(), side.cuda_stream)
    with torch.cuda.stream(side):
        _stacked_call(16, cuda)  # a scratch no earlier call needed
    torch.cuda.synchronize()
    held = [(t.data_ptr(), t.numel(), t.dtype)
            for t in oracle_fused._SCRATCH[where]]
    arrs, eager, cached = steps[2]
    key = make_key(2).fold_in(1002)
    first = cached(arrs, factors, key)  # captured over that scratch
    assert [t.data_ptr() for t in oracle_fused._SCRATCH[where]] == \
        [p for p, _, _ in held]
    with torch.cuda.stream(side):
        _stacked_call(32, cuda)  # replaces it
    torch.cuda.synchronize()
    assert [t.data_ptr() for t in oracle_fused._SCRATCH[where]] != \
        [p for p, _, _ in held]
    kept = [k for up in ex._uploads.values() for g in up.graphs.values()
            for k in g.kept]
    old = [k for k in kept if [t.data_ptr() for t in k] ==
           [p for p, _, _ in held]]
    assert old
    # had the old scratch been freed, these would take its blocks
    fills = [torch.full((n,), 7, dtype=dtype, device=cuda)
             for _, n, dtype in held]
    again = cached(arrs, factors, key)
    torch.cuda.synchronize()
    assert all(bool((f == 7).all()) for f in fills)
    assert all(torch.equal(a, b) for a, b in zip(again, first))
    assert all(torch.equal(a, b) for a, b in
               zip(again, eager(arrs, factors, key)))
    gone = weakref.ref(old[0][0])
    del ex, steps, cached, kept, old
    gc.collect()
    assert gone() is None  # freed with the steps that held it


def test_failed_capture_raises(cuda):
    """A step that reads the device inside a segment cannot be captured:
    the capture raises (no eager fallback), its counts are taken back, and
    the card captures the next step normally."""
    from repro_torch.graphs import CaptureHome, StepGraph

    home = CaptureHome(torch.device("cuda", torch.cuda.current_device()))
    arrs = {"x": torch.arange(8.0, device=cuda)}
    factors = [torch.ones((4, 2), device=cuda)]

    def reads_the_device(arrs, factors, key):
        y = arrs["x"] * factors[0].sum()
        return y * float(y.sum())  # a host read inside the segment

    def plain(arrs, factors, key):
        return arrs["x"] * factors[0].sum()

    counts = oracle_pair.launches
    with pytest.raises(RuntimeError):
        StepGraph.capture(home, reads_the_device, arrs, factors, make_key(0))
    assert oracle_pair.launches == counts
    graph, out = StepGraph.capture(home, plain, arrs, factors, make_key(0))
    assert torch.equal(out, plain(arrs, factors, None))
    assert torch.equal(graph(arrs, [2 * factors[0]], make_key(1)),
                       plain(arrs, [2 * factors[0]], None))


def test_stage_upload_from_a_thread_while_sweeping(cuda):
    """``stage_upload`` of one plan in a producer thread while the caller
    sweeps another: the staged plan then runs with no upload and gives
    the bits of a run on a fresh executor."""
    import threading

    ta = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    tb = synth_tensor((50, 40, 30), 15_000, alphas=(1.0, 1.0, 1.0), seed=4)
    core = (5, 5, 5)
    pa = port_plan.plan(ta, "lite", 4, core_dims=core)
    pb = port_plan.plan(tb, "lite", 4, core_dims=core)
    ex = HooiExecutor(4)
    ex.run(ta, core, pa, n_invocations=1)
    staged = {}
    worker = threading.Thread(
        target=lambda: staged.update(ex.stage_upload(pb, tb)))
    worker.start()
    ex.run(ta, core, pa, n_invocations=3, seed=1)
    worker.join()
    assert staged == {"uploads": 32, "already_resident": False}
    _, st = ex.run(tb, core, pb, n_invocations=2, seed=2)
    assert st.uploads == 0 and st.upload_cache_hit
    _, fresh = HooiExecutor(4).run(tb, core, pb, n_invocations=2, seed=2)
    assert st.fits == fresh.fits


def test_concurrent_sweeps_share_the_capture_pool(cuda):
    """Two threads sweep two plans on one executor, each on a stream of its
    own, capturing and then replaying: the steps share one memory pool, so
    their replays must not overlap on the card. Each thread's runs give
    the bits of the same runs made alone."""
    import threading

    core = (5, 5, 5)
    kw = dict(n_invocations=3, lanczos_block=4, fused_zbuild=True,
              use_fused_oracle=True)
    cases = {}
    for name, shape, nnz, seed in (("a", (60, 50, 40), 20_000, 3),
                                   ("b", (50, 40, 30), 15_000, 4)):
        t = synth_tensor(shape, nnz, alphas=(1.1, 1.0, 0.9), seed=seed)
        cases[name] = (t, port_plan.plan(t, "lite", 4, core_dims=core))

    def sweeps(ex, name):
        t, pl = cases[name]
        return [ex.run(t, core, pl, seed=s, **kw) for s in (1, 2, 3)]

    alone = {name: sweeps(HooiExecutor(4), name) for name in cases}
    ex = HooiExecutor(4)
    got, errors = {}, []

    def worker(name):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                got[name] = sweeps(ex, name)
                torch.cuda.current_stream().synchronize()
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(n,)) for n in cases]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert ex.stats()["step_captures"] == 6
    assert ex.stats()["graph_replays"] == 2 * 3 * 3 * 3 - 6
    for name in cases:
        for (dec, st), (dec0, st0) in zip(got[name], alone[name]):
            assert st.fits == st0.fits
            assert all(torch.equal(a, b)
                       for a, b in zip(dec.factors, dec0.factors))


def test_run_stochastic_on_card(cuda):
    """The rung on the card: a rerun captures, compiles and uploads
    nothing and gives the same bits; fits within 1e-4 of the CPU's."""
    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    core = (5, 5, 5)
    covered = t.nnz - t.nnz // 100
    init = hooi.random_factors(t.shape, core, make_key(4), "cpu")
    kw = dict(init_factors=init, covered_nnz=covered, sample_fraction=0.25,
              sample_seed=7, replay_nnz=256, n_invocations=2, seed=1)
    ex = HooiExecutor(4)
    pl = port_plan.plan(t, "lite", 4, core_dims=core)
    dec, st = ex.run_stochastic(t, core, pl, **kw)
    assert st.step_captures == 3 and st.uploads == 4
    again_dec, again = ex.run_stochastic(t, core, pl, **kw)
    assert (again.step_compilations, again.step_captures,
            again.uploads) == (0, 0, 0)
    assert again.fits == st.fits
    assert all(torch.equal(a, b) for a, b in
               zip(again_dec.factors, dec.factors))
    _, cpu = HooiExecutor(4, "cpu").run_stochastic(t, core, pl, **kw)
    np.testing.assert_allclose(st.fits, cpu.fits, rtol=0, atol=1e-4)



def _scheduler_ladder(ex, t, core):
    """plan -> reuse -> stochastic-refine -> repartition -> reuse ->
    reselect through a ``StreamScheduler`` on ``ex``, at chip_smoke's
    knobs; returns the results."""
    from repro_torch.engine.scheduler import StreamScheduler
    from repro_torch.streaming import StreamingTensor

    stream = StreamingTensor.from_tensor(t, name="ladder")
    r = np.random.default_rng(1)
    new = synth_tensor(t.shape, t.nnz // 100, alphas=(1.1, 1.0, 0.9),
                       seed=5)
    updates = t.coords[r.integers(0, t.nnz, t.nnz // 100)]
    hub = np.tile(t.coords[0], (int(0.18 * t.nnz), 1))
    appends = [None, None, (new.coords, new.values),
               (updates, r.standard_normal(len(updates))), None,
               (hub, r.standard_normal(len(hub)))]
    out = []
    with StreamScheduler(ex, core, n_invocations=2, scheme="lite",
                         path="auto", sample_fraction=0.25, sample_seed=7,
                         replay_nnz=256, correction_every=2,
                         use_fused_oracle=True) as sched:
        for seed, batch in enumerate(appends):
            if batch is not None:
                stream.append(*batch)
            out.append(sched.submit(stream, seed=seed).result())
    return out


def test_scheduler_ladder_on_card(cuda, monkeypatch):
    """The refresh ladder on the card: the CPU's decisions and drifts at
    every rung, and the CPU's fits within 1e-4 at the plan rung (the later
    rungs start from the factors the rung before carried, which the card
    and the CPU round differently, so they are held to the card's own
    reruns instead); the plan rung bitwise a direct run on its plan and
    seed; each reuse captures, compiles and uploads nothing; every capture
    made by the scheduler's consumer thread (on the legacy default stream)
    runs on the executor's own stream; a second ladder from the same state
    gives the same bits, its refine included."""
    import threading

    from repro_torch.graphs import StepGraph
    from repro_torch.streaming import StreamingTensor

    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    core = (5, 5, 5)
    captures = []
    original = StepGraph.capture.__func__

    def spy(cls, home, fn, arrs, factors, key, **kw):
        seen = []

        def step(a, f, k):
            seen.append(torch.cuda.current_stream(home.device))
            return fn(a, f, k)

        out = original(cls, home, step, arrs, factors, key, **kw)
        captures.append((threading.current_thread().name,
                         torch.cuda.current_stream(home.device), home.stream,
                         seen))
        return out

    monkeypatch.setattr(StepGraph, "capture", classmethod(spy))
    ex = HooiExecutor(4)
    got = _scheduler_ladder(ex, t, core)
    assert [r.decision for r in got] == [
        "plan", "reuse", "stochastic-refine", "repartition", "reuse",
        "reselect"]
    assert captures
    for thread, caller, own, seen in captures:
        assert thread.startswith("sched-run")
        assert caller == torch.cuda.default_stream(cuda)
        assert seen and all(s == own for s in seen)
    for r in (got[1], got[4]):
        assert (r.stats.step_compilations, r.stats.step_captures,
                r.stats.uploads, r.stats.graph_replays) == (0, 0, 0, 6)
    assert got[3].stats.step_compilations == 0  # geometric pads survived
    snap = StreamingTensor.from_tensor(t, name="ladder").snapshot()
    _, direct = ex.run(snap, core, got[0].plan, n_invocations=2,
                       path="auto", seed=0, use_fused_oracle=True)
    assert direct.uploads == 0 and direct.fits == got[0].fits
    cpu = _scheduler_ladder(HooiExecutor(4, "cpu"), t, core)
    for g, c in zip(got, cpu, strict=True):
        assert g.decision == c.decision and g.drift == c.drift
    np.testing.assert_allclose(got[0].fits, cpu[0].fits, rtol=0, atol=1e-4)
    again = _scheduler_ladder(ex, t, core)
    for a, g in zip(again, got, strict=True):
        assert a.decision == g.decision and a.fits == g.fits
        assert all(torch.equal(x, y) for x, y in
                   zip(a.decomposition.factors, g.decomposition.factors))


def test_producer_staging_during_a_capture(cuda, monkeypatch):
    """A producer thread stages a second stream's plan through pinned
    memory while the consumer is inside a capture (forced: each waits for
    the other). The capture survives and does not record the staging: the
    staged plan then runs with no upload and gives the bits of a fresh
    executor's run, and the captured stream's reuse replays the bits of
    its first run."""
    import threading

    from repro_torch.engine.scheduler import StreamScheduler
    from repro_torch.graphs import StepGraph
    from repro_torch.streaming import StreamingTensor

    ta = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    tb = synth_tensor((50, 40, 30), 15_000, alphas=(1.0, 1.0, 1.0), seed=4)
    core = (5, 5, 5)
    sa = StreamingTensor.from_tensor(ta, name="a")
    sb = StreamingTensor.from_tensor(tb, name="b")
    capturing, staged = threading.Event(), threading.Event()
    original = StepGraph.capture.__func__

    def capture(cls, home, fn, arrs, factors, key, **kw):
        def step(a, f, k):
            if torch.cuda.is_current_stream_capturing() \
                    and not capturing.is_set():
                capturing.set()
                assert staged.wait(60), "the producer never staged"
            return fn(a, f, k)

        return original(cls, home, step, arrs, factors, key, **kw)

    ex = HooiExecutor(4)
    stage = ex.stage_upload

    def stage_upload(pl, t):
        if t.fingerprint() == sb.fingerprint() and not staged.is_set():
            assert capturing.wait(60), "the consumer never captured"
            try:
                return stage(pl, t)
            finally:
                staged.set()
        return stage(pl, t)

    monkeypatch.setattr(StepGraph, "capture", classmethod(capture))
    monkeypatch.setattr(ex, "stage_upload", stage_upload)
    with StreamScheduler(ex, core, n_invocations=2, scheme="lite",
                         workers=2) as sched:
        fa = sched.submit(sa, seed=0)
        fb = sched.submit(sb, seed=1)
        ra, rb = fa.result(), fb.result()
        again = sched.submit(sa, seed=0).result()
    assert capturing.is_set() and staged.is_set()
    assert rb.stats.uploads == 0 and rb.stats.upload_cache_hit
    _, fresh = HooiExecutor(4).run(sb.snapshot(), core, rb.plan,
                                   n_invocations=2, seed=1)
    assert rb.fits == fresh.fits
    assert again.decision == "reuse" and again.fits == ra.fits


def test_pool_on_card(cuda, monkeypatch):
    """``ExecutorPool`` and ``StreamRouter`` on the card at a small size:
    one lane per CUDA device, each executor on its own ``cuda:i``; a plan
    carried as save bytes, loaded and adopted by lane 0 gives a ``reuse``
    with 0 uploads (its steps captured on the fresh executor), a resubmit
    0/0/0 with the same bits; behind a held run the batch share is
    refused while an interactive submit is admitted; the backlog returns
    to 0; inside every lane run the current device is the lane's; no lane
    thread is left after ``close()``."""
    import io
    import threading

    import _chaos
    from repro_torch.core.plan import PartitionPlan
    from repro_torch.engine import ExecutorPool, PoolSaturated, StreamRouter
    from repro_torch.streaming import StreamingTensor

    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    core = (5, 5, 5)
    stream = StreamingTensor.from_tensor(t, name="s")
    snap = stream.snapshot()
    pl = port_plan.plan(snap, "lite", 4, core_dims=core, path="auto",
                        pad_geometric=True, use_cache=False)
    buf = io.BytesIO()
    pl.save(buf)
    count = torch.cuda.device_count()
    seen = []
    with ExecutorPool(count, 4, core, scheme="lite", path="auto",
                      pad_geometric=True, n_invocations=2,
                      use_fused_oracle=True) as pool:
        assert [lane.executor.device for lane in pool.lanes] == [
            torch.device("cuda", i) for i in range(count)]
        for lane in pool.lanes:
            def call_step(*a, _real=lane.executor._call_step,
                          _i=lane.index):
                seen.append((_i, torch.cuda.current_device()))
                return _real(*a)
            monkeypatch.setattr(lane.executor, "_call_step", call_step)
        router = StreamRouter(pool, max_pending=4)
        loaded = PartitionPlan.load(io.BytesIO(buf.getvalue()), snap)
        assert pool.lane(0).scheduler.adopt(stream, loaded)
        first = router.submit(stream, seed=0,
                              priority="interactive").result()
        assert (first.decision, first.stats.lane, first.stats.uploads) == \
            ("reuse", 0, 0)
        assert first.plan is loaded and first.stats.step_captures == 3
        again = router.submit(stream, seed=0,
                              priority="interactive").result()
        assert (again.decision, again.stats.lane,
                again.stats.step_compilations, again.stats.step_captures,
                again.stats.uploads) == ("reuse", 0, 0, 0, 0)
        assert again.fits == first.fits

        held = synth_tensor((40, 30, 20), 3_000, seed=9)
        small = [synth_tensor((40, 30, 20), 3_000, seed=10 + s)
                 for s in range(3)]
        gate = threading.Event()
        fault = _chaos.FaultPlan().at(held.fingerprint(), "run",
                                      _chaos.hold(gate))
        with contextlib.ExitStack() as stack:
            for lane in pool.lanes:
                stack.enter_context(_chaos.inject(lane.executor, fault))
            try:
                router.submit(held, priority="interactive")
                router.submit(small[0], priority="batch")
                with pytest.raises(PoolSaturated) as exc:
                    router.submit(small[1], priority="batch")
                assert (exc.value.pending, exc.value.limit) == (2, 2)
                router.submit(small[2], priority="interactive",
                              deadline_s=120.0)
                assert router.pending() == 3
            finally:
                gate.set()
            res = router.drain()
        assert [r.decision for r in res] == ["reuse", "reuse", "plan",
                                             "plan", "plan"]
        deadline = time.monotonic() + 30
        while router.pending() and time.monotonic() < deadline:
            time.sleep(0.01)
        st = router.stats()
        assert st.rejected_by_priority == {"batch": 1}
        assert (st.submitted, st.completed, st.failed) == (5, 5, 0)
        assert st.backlog_s == pytest.approx((0.0,) * count, abs=1e-12)
        if count == 1:
            with pytest.raises(ValueError):
                router.reroute(stream)
        router.close()
    assert seen and all(i == dev for i, dev in seen)
    assert not [th for th in threading.enumerate()
                if th.name.startswith(("sched-prepare", "sched-run"))]


def _load_queued_kernels(dev, n: int) -> None:
    """Launch once, at the tests' size, the kernels the upload tests queue:
    a kernel's first launch loads its module, which may wait for the
    device and so run the queued work before the upload it is to race."""
    torch.cuda._sleep(1)
    torch.empty(n, dtype=torch.int64, device=dev).fill_(7)
    x = torch.ones(n, device=dev)
    x.sum() + x.sum()
    torch.cuda.synchronize()


def test_upload_waits_for_work_queued_on_its_block(cuda):
    """Work still queued on the current stream over a block just freed
    there (as a sweep on the consumer thread leaves it while a producer
    stages the next plan) must not land on the uploaded values: an
    upload's device array is a block of its uploader's stream's cache."""
    n = 1 << 20
    # the uploader first: allocating its pinned staging buffers may wait
    # for the device, which would run the queued write before the put
    up = exmod._Uploader(cuda)
    want = np.arange(n, dtype=np.int64)
    _load_queued_kernels(cuda, n)
    old = torch.empty(n, dtype=torch.int64, device=cuda)
    torch.cuda._sleep(200_000_000)  # queue the write well behind the put
    old.fill_(7)
    del old  # the block is free while the fill still waits to run
    got = up.put(want)
    up.finish()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_upload_freed_under_queued_reads_is_not_reused(cuda):
    """An upload's arrays are blocks of its uploader's stream; a read still
    queued on the reading stream when the upload is freed (a sweep in
    flight while its plan's arrays go) sees their values, not the next
    upload's, since the reader marked them (``_read_here``)."""
    n = 1 << 20
    up = exmod._Uploader(cuda)
    ones = np.ones(n, dtype=np.float32)
    held = exmod._StochUpload(arrs={}, coords=up.put(ones),
                              values=up.put(ones), n_arrays=2)
    up.finish()
    assert exmod._read_here(held) is held
    _load_queued_kernels(cuda, n)
    torch.cuda._sleep(200_000_000)  # queue the reads well behind the puts
    total = held.coords.sum() + held.values.sum()
    del held  # the blocks are free while the reads still wait to run
    for _ in range(2):
        up.put(np.zeros(n, dtype=np.float32))
    up.finish()
    torch.cuda.synchronize()
    assert total.item() == 2 * n


def test_upload_does_not_wait_for_the_current_stream(cuda):
    """A producer staging a plan while a sweep is queued on the current
    stream holds neither its copies nor the host behind that sweep."""
    up = exmod._Uploader(cuda)  # its pinned buffers first (may wait)
    want = np.arange(1 << 20, dtype=np.int64)
    _load_queued_kernels(cuda, want.size)
    torch.cuda._sleep(2_000_000_000)  # about a second of queued work
    got = up.put(want)
    up.finish()
    assert not torch.cuda.current_stream(cuda).query()
    np.testing.assert_array_equal(got.cpu().numpy(), want)


# ------------------------------------------------------- the rank mesh
@pytest.fixture
def two_gpus(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: a mesh over distinct cards")
    return [torch.device("cuda", i) for i in range(2)]


def _geometric_case():
    """A small tensor and its ``pad_geometric`` plan at P = 4: every
    group's first element lies at a multiple of the chunk kernel's CHUNK in
    the stacked arrays, so the groups' Z are the stacked Z's bits."""
    from repro_torch.kernels.kron_segsum import CHUNK

    t = synth_tensor((300, 200, 250), 200_000, alphas=(1.1, 1.0, 0.9),
                     seed=5)
    pl = port_plan.plan(t, "lite", 4, core_dims=(5, 5, 5), path="auto",
                        pad_geometric=True)
    assert all(mp.E_pad % CHUNK == 0 for mp in pl.parts)
    return t, pl


MESH_KNOBS = {"fused_block8": dict(lanczos_block=8, fused_zbuild=True),
              "vector": {},
              # its last segment opens on the groups' draws (the Lanczos
              # restarts), before any crossing orders a group behind home
              "sketch": dict(lanczos_block=8, warm_start="sketch")}


@pytest.mark.parametrize("knob", sorted(MESH_KNOBS))
@pytest.mark.parametrize("path", ["baseline", "liteopt"])
def test_mesh_on_one_card_bitwise_stacked(cuda, path, knob):
    """``[cuda:0] * G`` meshes (each group on its own stream) give the
    stacked executor's factors, core and fits bitwise, reruns too, with
    the group path's launches: one Z-build and one ``oracle_pair`` a
    group a product, each on its group's stream and current device. Both
    run eagerly, their captures off (a captured step may round apart from
    the same step run eagerly; the captured mesh is
    ``test_mesh_captured_bitwise``'s)."""
    from repro_torch.kernels import ops as kops

    t, pl = _geometric_case()
    kw = dict(n_invocations=2, path=path, seed=4, use_fused_oracle=True,
              **MESH_KNOBS[knob])
    stacked = HooiExecutor(4)
    stacked._home = None  # its captures off
    want_dec, want = stacked.run(t, (5, 5, 5), pl, **kw)
    seen = []

    def spy(real):
        def call(*a, **k):
            t0 = a[0]
            seen.append((torch.cuda.current_device(), t0.device.index,
                         torch.cuda.current_stream().cuda_stream))
            return real(*a, **k)
        return call

    for G in (2, 4):
        mesh = make_ranks_mesh(4, devices=[cuda] * G)
        ex = HooiExecutor(4, mesh=mesh)
        ex._home = None  # its captures off
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kops, "kron_segsum_gather",
                       spy(kops.kron_segsum_gather))
            mp.setattr(kops, "_oracle_pair_kernel",
                       spy(kops._oracle_pair_kernel))
            seen.clear()
            dec, st = ex.run(t, (5, 5, 5), pl, **kw)
        again_dec, again = ex.run(t, (5, 5, 5), pl, **kw)
        torch.cuda.synchronize()
        assert (st.groups, st.step_captures, again.step_compilations,
                again.uploads) == (G, 0, 0, 0)
        assert st.fits == want.fits == again.fits
        for a, b, c in zip(dec.factors, want_dec.factors,
                           again_dec.factors):
            assert torch.equal(a, b) and torch.equal(a, c)
        assert torch.equal(dec.core, want_dec.core)
        streams = {s.cuda_stream for s in mesh.streams}
        home = torch.cuda.current_stream().cuda_stream
        assert all(cur == dev for cur, dev, _ in seen)
        # every launch on a group's stream, and each group launched, but
        # the core's build over the full COO at home
        assert {s for _, _, s in seen} == streams | {home}
        assert st.group_bytes > 0


def _mesh_launch_spy(seen: list):
    """Patches for the two launch sites of ``kernels.ops``: each call
    records whether the current stream is capturing and its handle."""
    from repro_torch.kernels import ops as kops

    def spy(real):
        def call(*a, **k):
            seen.append((torch.cuda.is_current_stream_capturing(),
                         torch.cuda.current_stream().cuda_stream))
            return real(*a, **k)
        return call

    return [(kops, "kron_segsum_gather", spy(kops.kron_segsum_gather)),
            (kops, "_oracle_pair_kernel", spy(kops._oracle_pair_kernel))]


def _equal_runs(a, b) -> bool:
    (dec, st), (wdec, wst) = a, b
    return st.fits == wst.fits and torch.equal(dec.core, wdec.core) and all(
        torch.equal(x, y) for x, y in zip(dec.factors, wdec.factors))


@pytest.mark.parametrize("G", [2, 4])
@pytest.mark.parametrize("knob", sorted(MESH_KNOBS))
@pytest.mark.parametrize("path", ["baseline", "liteopt"])
def test_mesh_captured_bitwise(cuda, path, knob, G):
    """A ``[cuda:0] * G`` mesh's steps captured as CUDA graphs: the first
    run captures, with every recorded launch on its group's stream (each
    group's) and the bits of the stacked captured run and of the same mesh
    run eagerly, and the eager run's bytes between groups, by kind; a
    rerun captures, compiles and uploads nothing and replays, bitwise; a
    replay with another seed (new factors and draws) is that seed's eager
    run, not the first run's; its first sweep is a cold calibration
    sample labelled with the groups."""
    t, pl = _geometric_case()
    kw = dict(n_invocations=2, path=path, seed=4, use_fused_oracle=True,
              **MESH_KNOBS[knob])
    want = HooiExecutor(4).run(t, (5, 5, 5), pl, **kw)
    eager_ex = HooiExecutor(4, mesh=make_ranks_mesh(4, devices=[cuda] * G))
    eager_ex._home = None  # its captures off
    eager = eager_ex.run(t, (5, 5, 5), pl, **kw)
    other = eager_ex.run(t, (5, 5, 5), pl, **dict(kw, seed=5))

    mesh = make_ranks_mesh(4, devices=[cuda] * G)
    ex = HooiExecutor(4, mesh=mesh)
    seen: list = []
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, fn in _mesh_launch_spy(seen):
            mp.setattr(mod, name, fn)
        got = ex.run(t, (5, 5, 5), pl, **kw)
    st = got[1]
    assert st.groups == G and st.step_captures == 3
    assert _equal_runs(got, want) and _equal_runs(got, eager)
    assert (st.group_bytes_u, st.group_bytes_factors) == \
        (eager[1].group_bytes_u, eager[1].group_bytes_factors)
    captured = {s for capturing, s in seen if capturing}
    assert captured == {s.cuda_stream for s in mesh.streams}
    samples = ex.calibration_samples()
    assert samples[0]["warm"] is False and samples[-1]["warm"] is True
    assert all(s["groups"] == G for s in samples)
    segments = {len(g.segments) for g in ex._uploads[pl].graphs.values()}
    assert segments == {4 if knob == "sketch" else 2}

    again = ex.run(t, (5, 5, 5), pl, **kw)
    ast = again[1]
    assert (ast.step_compilations, ast.step_captures, ast.uploads) == \
        (0, 0, 0)
    assert ast.graph_replays == 6 and _equal_runs(again, got)
    assert ast.group_bytes == st.group_bytes
    moved = ex.run(t, (5, 5, 5), pl, **dict(kw, seed=5))
    assert moved[1].step_captures == 0 and moved[1].graph_replays == 6
    assert _equal_runs(moved, other) and not _equal_runs(moved, got)
    assert moved[1].group_bytes == other[1].group_bytes


def test_failed_mesh_capture_raises(cuda):
    """A mesh capture whose group streams are not joined back before a
    segment ends (a mutant of the join at a cut) raises from ``run``; the
    step is not run eagerly instead (the warm-up and the capture are its
    only calls), nothing counts as captured, and the mesh's streams and a
    fresh capture on the same mesh work afterwards."""
    from repro_torch.distributed.mesh import RankMesh

    t, pl = _geometric_case()
    kw = dict(n_invocations=1, path="liteopt", seed=4, lanczos_block=8,
              fused_zbuild=True, use_fused_oracle=True)
    mesh = make_ranks_mesh(4, devices=[cuda] * 2)
    ex = HooiExecutor(4, mesh=mesh)
    calls = []
    real_get = ex._get_step

    def get_step(*a, **k):
        skey, step = real_get(*a, **k)

        def counted(*args):
            calls.append(skey)
            return step(*args)
        return skey, counted

    real_join = RankMesh.join

    def join(self, stream):
        if not torch.cuda.is_current_stream_capturing():
            real_join(self, stream)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ex, "_get_step", get_step)
        mp.setattr(RankMesh, "join", join)
        with pytest.raises(RuntimeError):
            ex.run(t, (5, 5, 5), pl, **kw)
    assert len(calls) == 2  # the warm-up and the capture, no eager call
    assert ex.stats()["step_captures"] == 0
    for g in range(mesh.G):
        with mesh.group(g):
            torch.ones(8, device=cuda).sum()
    torch.cuda.synchronize()
    fresh = HooiExecutor(4, mesh=mesh)
    _, st = fresh.run(t, (5, 5, 5), pl, **kw)
    assert st.step_captures == 3


def test_run_stochastic_on_mesh_captures(cuda):
    """The stochastic rung of a mesh executor runs at home, with no groups,
    and is captured as the stacked executor's is: 3 captures, a rerun
    0/0/0, the stacked executor's bits; ``profile_phases`` on the mesh
    captures its Z-build and mode steps too."""
    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    core = (5, 5, 5)
    covered = t.nnz - t.nnz // 100
    init = hooi.random_factors(t.shape, core, make_key(4), "cpu")
    kw = dict(init_factors=init, covered_nnz=covered, sample_fraction=0.25,
              sample_seed=7, replay_nnz=256, n_invocations=2, seed=1)
    pl = port_plan.plan(t, "lite", 4, core_dims=core)
    want_dec, want = HooiExecutor(4).run_stochastic(t, core, pl, **kw)
    ex = HooiExecutor(4, mesh=make_ranks_mesh(4, devices=[cuda] * 2))
    dec, st = ex.run_stochastic(t, core, pl, **kw)
    assert st.step_captures == 3 and st.fits == want.fits
    assert all(torch.equal(a, b) for a, b in zip(dec.factors,
                                                 want_dec.factors))
    _, again = ex.run_stochastic(t, core, pl, **kw)
    assert (again.step_compilations, again.step_captures,
            again.uploads) == (0, 0, 0) and again.graph_replays > 0
    before = ex.stats()["step_captures"]
    ex.profile_phases(t, core, pl, repeats=1, lanczos_block=8,
                      fused_zbuild=True, use_fused_oracle=True)
    assert ex.stats()["step_captures"] - before == 6


@pytest.mark.parametrize("G", [2, 4])
def test_mesh_boundary_u_space_on_group_streams(cuda, G):
    """Over ``[cuda:0] * G`` a boundary run keeps its u-space on the
    groups: every ``GroupTensor`` part on its group's device and made on
    its group's stream, and the ``"u"`` bytes the formula's."""
    from repro_torch.distributed.mesh import GroupTensor

    t, pl = _geometric_case()
    core = (5, 5, 5)
    knobs = dict(lanczos_block=8, fused_zbuild=True)
    mesh = make_ranks_mesh(4, devices=[cuda] * G)
    ex = HooiExecutor(4, mesh=mesh)
    seen = []
    real = GroupTensor.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        seen.append((tuple(p.device for p in self.parts), self.made_on))

    kw = dict(n_invocations=2, seed=4, use_fused_oracle=True, **knobs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(GroupTensor, "__init__", init)
        _, st = ex.run(t, core, pl, path="liteopt", **kw)
    torch.cuda.synchronize()
    streams = tuple(s.cuda_stream for s in mesh.streams)
    assert seen and all(devs == mesh.devices and made == streams
                        for devs, made in seen)
    modeled = ex.modeled_u_bytes(pl, core, path="liteopt", **knobs)
    assert st.group_bytes_u == len(st.fits) * sum(modeled.values())
    assert st.group_bytes == st.group_bytes_u + st.group_bytes_factors


def _load_mesh_kernels(dev, n: int) -> None:
    """The kernels the mesh-ordering tests queue, launched once first (a
    first launch may wait for the device)."""
    torch.cuda._sleep(1)
    x = torch.ones(n, device=dev)
    x.sum()
    torch.zeros(n, device=dev)
    torch.full((n,), 3.0, device=dev).fill_(1.0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("hazard", ["read_before_write", "block_reused"])
@pytest.mark.parametrize("direction", ["to_home", "to_group"])
def test_mesh_crossing_is_ordered(cuda, direction, hazard):
    """What one group writes and another reads crosses through ``to_home``
    or ``to_group``: the reader waits for the writer's stream (else it
    reads before the write lands) and the block is marked read on the
    reader's stream (else the writer's stream hands it out again while the
    read is still queued). The side that must wait is held busy."""
    n = 1 << 20
    mesh = make_ranks_mesh(2, devices=[cuda] * 2)
    _load_mesh_kernels(cuda, n)
    writer, reader = (1, None) if direction == "to_home" else (None, 1)

    def on(side):  # group 1 or home (the current stream)
        return mesh.group(side) if side is not None \
            else contextlib.nullcontext()

    if hazard == "read_before_write":
        with on(writer):
            x = torch.full((n,), 3.0, device=cuda)
            torch.cuda._sleep(200_000_000)  # the write of the 1s waits
            x.fill_(1.0)
        got = mesh.to_home(x, 1) if direction == "to_home" \
            else mesh.to_group(x, 1)
        with on(reader):
            total = got.sum()
    else:
        with on(writer):
            x = torch.ones(n, device=cuda)
        with on(reader):
            torch.cuda._sleep(200_000_000)  # the read waits
        got = mesh.to_home(x, 1) if direction == "to_home" \
            else mesh.to_group(x, 1)
        with on(reader):
            total = got.sum()
        del x, got  # free while the read still waits to run
        with on(writer):
            torch.zeros(n, device=cuda)  # would take the freed block
    torch.cuda.synchronize()
    assert total.item() == n


def test_mesh_over_two_cards(two_gpus):
    """A mesh over distinct cards: each group's arrays on its card, its
    launches there, the run bitwise the stacked one on cuda:0."""
    t, pl = _geometric_case()
    kw = dict(n_invocations=2, path="liteopt", seed=4, lanczos_block=8,
              fused_zbuild=True, use_fused_oracle=True)
    stacked = HooiExecutor(4, two_gpus[0])
    stacked._home = None  # eager, as the mesh's steps
    want_dec, want = stacked.run(t, (5, 5, 5), pl, **kw)
    ex = HooiExecutor(4, mesh=make_ranks_mesh(4, devices=two_gpus))
    dec, st = ex.run(t, (5, 5, 5), pl, **kw)
    up = ex._uploads[pl]
    for m in up.arrs:
        for g, ga in enumerate(m["groups"]):
            assert all(a.device == two_gpus[g] for a in ga.values())
    assert st.fits == want.fits
    assert all(torch.equal(a, b) for a, b in zip(dec.factors,
                                                 want_dec.factors))
    _, again = ex.run(t, (5, 5, 5), pl, **kw)
    assert again.fits == st.fits and again.uploads == 0


def test_hooi_on_another_card_from_a_thread(two_gpus):
    """Single-process ``hooi(device="cuda:1")`` from a thread whose
    current device is ``cuda:0`` launches every kernel on cuda:1 with
    cuda:1 current, and gives the fits of the same run on cuda:0."""
    import concurrent.futures

    from repro_torch.kernels import ops as kops

    t = synth_tensor((60, 50, 40), 20_000, seed=3)
    want = hooi.hooi(t, (5, 5, 5), n_invocations=2, device=two_gpus[0],
                     use_fused_oracle=True)[1]
    seen = []

    def spy(real):
        def call(*a, **k):
            seen.append((torch.cuda.current_device(), a[0].device.index))
            return real(*a, **k)
        return call

    def run():
        torch.cuda.set_device(0)
        return hooi.hooi(t, (5, 5, 5), n_invocations=2, device="cuda:1",
                         use_fused_oracle=True)[1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kops, "kron_segsum_gather", spy(kops.kron_segsum_gather))
        mp.setattr(kops, "_oracle_pair_kernel",
                   spy(kops._oracle_pair_kernel))
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            got = pool.submit(run).result(timeout=300)
    assert seen and all(s == (1, 1) for s in seen)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------- four modes and the schemes
def _run_pair(t, core, pl, **kw):
    """The same run captured (a fresh executor) and eagerly (its captures
    off): ((dec, stats) captured, (dec, stats) eager)."""
    captured = HooiExecutor(4)
    eager = HooiExecutor(4)
    eager._home = None
    got = captured.run(t, core, pl, **kw)
    want = eager.run(t, core, pl, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("path", ["baseline", "liteopt"])
def test_four_mode_dist_captured_bitwise_eager_and_cpu(cuda, path):
    """The paper suite's enron-s mirror (four modes, a hub on mode 0) at
    core 10^4, K̂ = 1000, ``fused_block8``: the captured run is its eager
    run bit for bit, and its fits lie within 1e-4 of the CPU path's."""
    from repro_torch.data.tensors import paper_suite

    t = paper_suite(0.25)["enron-s"]
    core = (10, 10, 10, 10)
    kw = dict(n_invocations=2, path=path, seed=3, lanczos_block=8,
              fused_zbuild=True, use_fused_oracle=True)
    pl = port_plan.plan(t, "lite", 4, core_dims=core, path="auto")
    got, want = _run_pair(t, core, pl, **kw)
    assert got[1].step_captures == 4 and want[1].step_captures == 0
    assert _equal_runs(got, want)
    _, cpu = dist_hooi(t, core, 4, scheme=pl, device="cpu", **kw)
    np.testing.assert_allclose(got[1].fits, cpu.fits, rtol=0, atol=1e-4)


@pytest.mark.parametrize("path", ["baseline", "liteopt"])
@pytest.mark.parametrize("scheme", ["medium", "hypergraph"])
def test_uni_policy_plan_captured_bitwise_eager(cuda, scheme, path):
    """MediumG and HyperG plans (one copy of the elements, each mode's rows
    shared by several ranks: their own ``Lp``, boundary maps and padding)
    through captured steps give the eager run's bits."""
    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    pl = port_plan.plan(t, scheme, 4, core_dims=(5, 5, 5), path="auto")
    assert pl.scheme.uni
    got, want = _run_pair(t, (5, 5, 5), pl, n_invocations=2, path=path,
                          seed=2, lanczos_block=8, fused_zbuild=True,
                          use_fused_oracle=True)
    assert got[1].step_captures == 3
    assert _equal_runs(got, want)


def test_capture_after_every_graph_of_the_home_died(cuda):
    """A plan dropped with its captured steps leaves its executor's pool
    without a live graph; a later plan's capture takes a fresh pool (a
    pool whose uses have dropped to none cannot be captured into: PyTorch's
    host allocator asserts), and its runs replay bitwise."""
    import gc

    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    ex = HooiExecutor(4)
    kw = dict(n_invocations=2, path="liteopt", seed=2, lanczos_block=8,
              fused_zbuild=True, use_fused_oracle=True)
    pl = port_plan.plan(t, "lite", 4, core_dims=(5, 5, 5), path="auto",
                        use_cache=False)
    assert ex.run(t, (5, 5, 5), pl, **kw)[1].step_captures == 3
    first = ex._home.pool
    del pl
    gc.collect()
    assert not ex._home.graphs
    pl = port_plan.plan(t, "coarse", 4, core_dims=(5, 5, 5), path="auto",
                        use_cache=False)
    got = ex.run(t, (5, 5, 5), pl, **kw)
    again = ex.run(t, (5, 5, 5), pl, **kw)
    assert got[1].step_captures == 3 and again[1].graph_replays == 6
    assert ex._home.pool != first and len(ex._home.graphs) >= 3
    assert _equal_runs(got, again)


def _plan_fixture(name):
    """The host layer's fixtures of ``tests/test_torch_plan.py``, drawn by
    the port: (tensor, core dims, P)."""
    from repro_torch.core.coo import SparseTensor

    if name == "hub4":
        return synth_tensor((20, 25, 60, 12), 3_000,
                            alphas=(1.4, 1.4, 1.1, 0.8), hub_fraction=0.09,
                            hub_modes=(0,), seed=5), (2, 2, 2, 2), 4
    if name == "hypersparse":
        return synth_tensor((40, 30, 200_000), 800, alphas=(1.0, 1.0, 1.4),
                            seed=11), (3, 3, 3), 4
    if name == "p7":
        return synth_tensor((3, 200, 30), 700, alphas=(2.0, 0.5, 0.5),
                            hub_fraction=0.3, hub_modes=(0,),
                            seed=14), (3, 3, 3), 7
    shape = (70_001, 70_003, 65_537, 65_539)  # past a 64-bit linear index
    r = np.random.default_rng(63)
    coords = np.stack([r.choice(r.integers(0, L, 40), 600) for L in shape],
                      axis=1)
    coords = np.unique(coords, axis=0)
    return (SparseTensor(coords, r.standard_normal(len(coords)), shape),
            (2, 2, 2, 2), 4)


def _assert_same_arrays(got, want):
    import dataclasses

    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif isinstance(b, tuple) and b and dataclasses.is_dataclass(b[0]):
            for x, y in zip(a, b, strict=True):
                _assert_same_arrays(x, y)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("scheme", ["lite", "coarse", "medium"])
@pytest.mark.parametrize("name", ["hub4", "hypersparse", "p7", "past_2_63"])
def test_plan_on_card_bitwise_the_cpu_plan(cuda, name, scheme):
    """The plan built on the card is the plan built on the CPU, array for
    array; it leaves nothing allocated on the card; it uploads the
    coordinates and values once, beside the O(L) tables (Lite's slice
    table, int32, and its stage-2 cut, P int64, in a mode that has one;
    CoarseG's owner map and each mode's relabelling, int64) and MediumG's
    host-built policy."""
    from repro_torch import tracing

    t, core, P = _plan_fixture(name)
    want = port_plan.plan(t, scheme, P, core_dims=core, use_cache=False,
                          device="cpu")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    tracing.clear()
    try:
        with tracing.recording():
            got = port_plan.plan(t, scheme, P, core_dims=core,
                                 use_cache=False, device=cuda)
        counters = [e["counters"] for e in tracing.summary().values()]
    finally:
        tracing.clear()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before
    for a, b in zip(got.scheme.policies, want.scheme.policies, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for mp, mp_want in zip(got.parts, want.parts, strict=True):
        _assert_same_arrays(mp, mp_want)
    _assert_same_arrays(got.metrics, want.metrics)
    assert got.cost == want.cost
    up = sum(c.get("plan.upload_bytes", 0) for c in counters)
    down = sum(c.get("plan.download_bytes", 0) for c in counters)
    tables = {"lite": 12, "coarse": 16, "medium": 8}[scheme] * sum(t.shape)
    host_policy = 4 * t.nnz if scheme == "medium" else 0
    extra = up - (t.coords.nbytes + t.values.nbytes + tables + host_policy)
    if scheme == "lite":
        assert extra % (8 * P) == 0 and 0 <= extra <= 8 * P * t.ndim, extra
    else:
        assert extra == 0
    parts_bytes = sum(mp.coords[p, :k].nbytes + 2 * 4 * k
                      for mp in got.parts
                      for p, k in enumerate(mp.e_per_rank))
    assert down > parts_bytes
