"""What the port's main path calls, on the CPU.

The Z-build reads each element's coordinates and gathers the factor rows
in the kernel (its gather form), so for 3- and 4-mode tensors the host never
forms the (E, Ka) and (E, Kb) operands of ``kernels.ops._split_ab`` nor the
fold of the leading factors (``ops._lead_a``); and the distributed step's
``Zᵀ y`` over the stacked ranks is one batched ``oracle_pair`` call per
product. On the card these are the same calls, so ``chip_smoke.py``'s launch
counts show the same thing there.
"""

import math

import pytest
import torch

from repro_torch import tracing
from repro_torch.core.hooi import hooi
from repro_torch.data.tensors import synth_tensor
from repro_torch.distributed.dist_hooi import dist_hooi
from repro_torch.engine import oracle as engine_oracle
from repro_torch.engine import steps
from repro_torch.kernels import kron_segsum as kron_module
from repro_torch.kernels import ops, ref

CORE = (3, 3, 3)
CORE4 = (3, 2, 3, 2)


@pytest.fixture(scope="module")
def tensor():
    return synth_tensor((30, 25, 20), 2_000, alphas=(1.1, 1.0, 0.9), seed=4)


@pytest.fixture(scope="module")
def tensor4():
    return synth_tensor((14, 12, 10, 9), 1_500, alphas=(1.1, 1.0, 0.9, 0.8),
                        seed=5)


def _forbid_split(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("_split_ab on the main path")

    monkeypatch.setattr(ops, "_split_ab", refuse)
    monkeypatch.setattr(ops, "_lead_a", refuse)
    calls = []

    def counting(gather):
        def counted(*args, **kwargs):
            calls.append(kwargs.get("X") is not None)
            return gather(*args, **kwargs)
        return counted

    for name in ("kron_segsum_gather", "kron_segsum_gather2"):
        monkeypatch.setattr(ops, name, counting(getattr(kron_module, name)))
    return calls


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_fused_oracle=True),
    dict(lanczos_block=4, fused_zbuild=True, use_fused_oracle=True),
], ids=["vector", "fused_oracle", "block4_fused"])
def test_single_process_gathers_without_split(monkeypatch, tensor, kw):
    calls = _forbid_split(monkeypatch)
    _, fits = hooi(tensor, CORE, n_invocations=2, seed=0, device="cpu", **kw)
    assert len(fits) == 2
    fused = kw.get("fused_zbuild", False)
    # three mode steps per sweep (fused ones with a panel), then the core
    assert calls == 2 * ([fused] * 3 + [False])


@pytest.mark.parametrize("path", ["liteopt", "baseline"])
@pytest.mark.parametrize("fused_zbuild", [False, True])
def test_distributed_gathers_without_split(monkeypatch, tensor, path,
                                           fused_zbuild):
    calls = _forbid_split(monkeypatch)
    _, st = dist_hooi(tensor, CORE, 4, path=path, n_invocations=2, seed=0,
                      lanczos_block=4, fused_zbuild=fused_zbuild,
                      use_fused_oracle=True, device="cpu")
    assert len(st.fits) == 2
    assert calls == 2 * ([fused_zbuild] * 3 + [False])


@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_fused_oracle=True),
    dict(lanczos_block=4, fused_zbuild=True, use_fused_oracle=True),
], ids=["vector", "fused_oracle", "block4_fused"])
def test_single_process_four_modes_gathers_without_fold(monkeypatch, tensor4,
                                                         kw):
    """At four modes every Z-build gathers both leading factors' rows (the
    two-lead form): ``_lead_a`` and ``_split_ab`` never run."""
    calls = _forbid_split(monkeypatch)
    _, fits = hooi(tensor4, CORE4, n_invocations=2, seed=0, device="cpu",
                   **kw)
    assert len(fits) == 2
    fused = kw.get("fused_zbuild", False)
    assert calls == 2 * ([fused] * 4 + [False])


@pytest.mark.parametrize("path", ["liteopt", "baseline"])
@pytest.mark.parametrize("fused_zbuild", [False, True])
def test_distributed_four_modes_gathers_without_fold(monkeypatch, tensor4,
                                                     path, fused_zbuild):
    calls = _forbid_split(monkeypatch)
    _, st = dist_hooi(tensor4, CORE4, 4, path=path, n_invocations=2, seed=0,
                      lanczos_block=4, fused_zbuild=fused_zbuild,
                      use_fused_oracle=True, device="cpu")
    assert len(st.fits) == 2
    assert calls == 2 * ([fused_zbuild] * 4 + [False])


@pytest.mark.parametrize("shape", [(14, 12, 10, 9), (8, 7, 6, 5, 4)],
                         ids=["N4", "N5"])
def test_fold_bytes_counter(shape):
    """``zbuild.fold_bytes`` counts the (E, Ka) f32 fold wherever a Z-build
    still forms one: none at four modes, E * Ka * 4 bytes a build at five
    (Ka the product of the three leading widths of each build)."""
    t = synth_tensor(shape, 600, seed=6)
    core = (2, 3, 2, 3, 2)[:len(shape)]
    tracing.clear()
    with tracing.recording():
        hooi(t, core, n_invocations=1, seed=0, device="cpu")
        summ = tracing.summary()
    tracing.clear()
    got = summ.get("zbuild", {}).get("counters", {}).get("zbuild.fold_bytes",
                                                          0)
    want = 0
    if len(shape) >= 5:
        # one sweep: a build per mode, then the core's build of mode 0
        for mode in list(range(len(shape))) + [0]:
            *lead, _ = [j for j in range(len(shape)) if j != mode]
            want += t.nnz * math.prod(core[j] for j in lead) * 4
    assert summ["zbuild"]["count"] == len(shape) + 1
    assert got == want


def _four_mode_case(mode, seed=3):
    g = torch.Generator().manual_seed(seed + mode)
    shape, core = (9, 8, 7, 6), (3, 4, 2, 5)
    E = 700
    coords = torch.stack([torch.randint(0, L, (E,), generator=g)
                          for L in shape], 1)
    coords = coords[torch.argsort(coords[:, mode], stable=True)]
    coords = coords.to(torch.int32)
    values = torch.randn(E, generator=g)
    values[::50] = 0.0  # padding-like elements add nothing
    factors = [torch.randn(L, k, generator=g) for L, k in zip(shape, core)]
    return coords, values, coords[:, mode].contiguous(), factors, shape[mode]


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_gather_ref_two_leads_bitwise_fold(mode, precision):
    """The plain two-lead form (``a`` formed from both leading factors as
    ``_lead_a`` forms it) equals the fold form bit for bit, Z and
    (Z, Z @ X), through ``ref`` and through ``kron_segsum_gather2``."""
    coords, values, rows, f, R = _four_mode_case(mode)
    l1, l2, last = [j for j in range(4) if j != mode]
    a, b = ops._split_ab(coords, values, f, mode)
    want = ref.kron_segsum_ref(rows, a, b, R, precision)
    got = ref.kron_segsum_gather2_ref(rows, coords, values, f[l1], f[l2],
                                      f[last], l1, l2, last, R, precision)
    assert torch.equal(got, want)
    X = torch.randn((a.shape[1] * b.shape[1], 3),
                    generator=torch.Generator().manual_seed(mode))
    zo, zx = kron_module.kron_segsum_gather2(
        rows, coords, values, f[l1], f[l2], f[last], l1, l2, last, R, X=X,
        precision=precision)
    wz, wzx = kron_module.kron_segsum_oracle(rows, a, b, R, X,
                                             precision=precision)
    assert torch.equal(zo, wz) and torch.equal(zx, wzx)
    assert torch.equal(ops.penultimate_sorted(coords, values, rows, f, mode,
                                              R, precision=precision), want)


def test_gather_two_leads_wrapper_checks():
    coords, values, rows, f, R = _four_mode_case(0)
    gather2 = kron_module.kron_segsum_gather2
    with pytest.raises(ValueError):  # a column outside the coordinates
        gather2(rows, coords, values, f[1], f[2], f[3], 1, 4, 3, R)
    with pytest.raises(ValueError):  # element counts
        gather2(rows, coords, values[:-1], f[1], f[2], f[3], 1, 2, 3, R)
    with pytest.raises(ValueError):  # a factor that is not 2-D
        gather2(rows, coords, values, f[1], f[2][0], f[3], 1, 2, 3, R)
    with pytest.raises(TypeError):
        gather2(rows, coords, values, f[1], f[2].double(), f[3], 1, 2, 3, R)
    with pytest.raises(TypeError):
        gather2(rows, coords.long(), values, f[1], f[2], f[3], 1, 2, 3, R)
    with pytest.raises(ValueError):
        gather2(rows, coords, values, f[1], f[2], f[3], 1, 2, 3, R,
                precision="fp8")
    with pytest.raises(ValueError):  # panel of the wrong height
        gather2(rows, coords, values, f[1], f[2], f[3], 1, 2, 3, R,
                X=torch.ones((7, 2)))
    before = (kron_module.kron_segsum_gather2.launches,
              kron_module.kron_segsum.launches)
    gather2(rows, coords, values, f[1], f[2], f[3], 1, 2, 3, R)
    assert (kron_module.kron_segsum_gather2.launches,
            kron_module.kron_segsum.launches) == before  # the CPU launches
    # nothing


@pytest.mark.parametrize("shape,core", [
    ((30, 25, 20), CORE), ((14, 12, 10, 9), CORE4),
    ((8, 7, 6, 5, 4), (2, 3, 2, 3, 2))], ids=["N3", "N4", "N5"])
def test_unsorted_build_takes_elements_in_row_order(shape, core):
    """A Z-build over unsorted rows sorts them stably and takes the
    coordinates (whole rows at N = 3, column by column from N = 4, without
    the mode's own column) and values in that order: the same Z bits, and
    the same (Z, Z @ X), as sorting by hand."""
    t = synth_tensor(shape, 900, seed=7)
    coords = torch.as_tensor(t.coords, dtype=torch.int32)
    values = torch.as_tensor(t.values, dtype=torch.float32)
    f = [torch.randn(L, k, generator=torch.Generator().manual_seed(L))
         for L, k in zip(shape, core)]
    for mode in range(len(shape)):
        order = torch.argsort(coords[:, mode], stable=True)
        c, v, rows = ops._row_order(coords, values, coords[:, mode], mode)
        kept = [j for j in range(len(shape)) if len(shape) < 4 or j != mode]
        assert torch.equal(c, coords[order][:, kept])
        assert torch.equal(v, values[order])
        assert torch.equal(rows, coords[order, mode]) and c.is_contiguous()
        z = ops.penultimate(coords, values, f, mode, shape[mode])
        want = ops.penultimate_sorted(coords[order], values[order],
                                      coords[order, mode], f, mode,
                                      shape[mode])
        assert torch.equal(z, want)
        X = torch.randn((z.shape[1], 2),
                        generator=torch.Generator().manual_seed(mode))
        zo, zx = ops.penultimate_local_oracle(coords, values,
                                              coords[:, mode], f, mode,
                                              shape[mode], X)
        assert torch.equal(zo, want) and torch.equal(zx, want @ X)


@pytest.mark.parametrize("path", ["liteopt", "baseline"])
def test_stacked_products_one_call_per_product(monkeypatch, tensor, path):
    """Every ``zrmv`` of the distributed step is one ``oracle_pair`` call
    over all P ranks, and every ``zmv`` one call over the stacked rows."""
    P = 4
    seen = []
    pair = ops.oracle_pair

    def counted_pair(Z, x, y, P_=None):
        seen.append(("zmv" if y is None else "zrmv", P_,
                     None if y is None else tuple(y.shape)))
        return pair(Z, x, y, P_)

    products = []
    stacked = engine_oracle.stacked_products

    def counted_stacked(Z, P_, *, fused=False):
        zmv, zrmv = stacked(Z, P_, fused=fused)

        def zmv_c(x):
            products.append("zmv")
            return zmv(x)

        def zrmv_c(y):
            products.append("zrmv")
            return zrmv(y)

        return zmv_c, zrmv_c

    monkeypatch.setattr(ops, "oracle_pair", counted_pair)
    monkeypatch.setattr(steps, "stacked_products", counted_stacked)
    dist_hooi(tensor, CORE, P, path=path, n_invocations=2, seed=0,
              lanczos_block=4, fused_zbuild=True, use_fused_oracle=True,
              device="cpu")
    assert products.count("zrmv") > 0
    assert [k for k, _, _ in seen] == products
    for kind, got_P, y_shape in seen:
        if kind == "zrmv":
            assert got_P == P and y_shape[0] == P
        else:
            assert got_P is None
