"""The plain reference against the port's CPU path on a tiny tensor."""

import numpy as np
import pytest
import torch

from _tiny import ROOT  # noqa: F401

from tuckerbench.inputs import Draws, init_factors, start_panel
from tuckerbench.reference import partition, tucker as ref


@pytest.fixture(scope="module")
def tensor():
    from repro_torch.core.coo import SparseTensor
    from tuckerbench import gen

    shape = (60, 50, 80, 30)
    c, v = gen.draw_tensor(shape, 20_000, (1.4, 1.4, 1.1, 0.8), 0.09, (0,),
                           seed=7, device="cpu")
    return SparseTensor(c, v, shape)


@pytest.mark.parametrize("mode", [0, 2, 3])
def test_penultimate_is_the_ports(tensor, mode):
    from repro_torch.core.ttm import penultimate

    core = (10, 10, 10, 10)
    facs = init_factors(tensor.shape, core, 11, torch.device("cpu"))
    coords = torch.from_numpy(tensor.coords)
    values = torch.from_numpy(tensor.values)
    want = penultimate(coords.int(), values.float(), facs, mode,
                       tensor.shape[mode])
    got = ref.penultimate(coords, values, facs, mode, tensor.shape[mode])
    scale = float(got.abs().max())
    assert float((got - want.double()).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("block", [1, 8])
def test_krylov_left_is_the_ports_lanczos(tensor, block):
    """The program's Lanczos from the same start lands on the reference's
    Ritz vectors to f32 rounding."""
    from repro_torch.core.lanczos import (gk_block_bidiag, lanczos_niter,
                                          svd_from_bidiag)
    from repro_torch.core.lanczos import gk_bidiag
    from repro_torch.random import make_key
    from repro_torch.core.ttm import penultimate

    core = (10, 10, 10, 10)
    facs = init_factors(tensor.shape, core, 12, torch.device("cpu"))
    coords = torch.from_numpy(tensor.coords)
    values = torch.from_numpy(tensor.values)
    Z = penultimate(coords.int(), values.float(), facs, 2, tensor.shape[2])
    L, K = Z.shape
    key = make_key(0, Draws(99)).fold_in(1000 + 2)  # sweep 0, mode 2
    if block == 1:
        niter = lanczos_niter(10, L, K)
        U, B = gk_bidiag(lambda x: Z @ x, lambda u: Z.T @ u, L, K, niter,
                         key, device="cpu")
    else:
        niter = lanczos_niter(10, L, K, block)
        U, B = gk_block_bidiag(lambda x: Z @ x, lambda u: Z.T @ u, L, K,
                               niter, block, key, device="cpu")
    left, _ = svd_from_bidiag(U, B, 10, key)
    X = start_panel(99, 0, 4, 2, K, block)
    Uref, S = ref.krylov_left(Z.double(), X, niter)
    got = ref.step_numbers(left, Uref, S)
    assert got["deficit"] < 1e-9 and got["angle"] < 1e-4
    # a factor from another start is far off
    other = ref.step_numbers(torch.linalg.qr(torch.randn(L, 10)).Q, Uref, S)
    assert other["deficit"] > 1e-2


def test_core_and_fit_are_the_ports(tensor):
    from repro_torch.core.hooi import Decomposition, fit_score
    from repro_torch.core.ttm import core_from_factors

    core = (10, 10, 10, 10)
    facs = init_factors(tensor.shape, core, 13, torch.device("cpu"))
    coords = torch.from_numpy(tensor.coords)
    values = torch.from_numpy(tensor.values)
    want = core_from_factors(coords.int(), values.float(), facs)
    Z = ref.penultimate(coords, values, facs, 3, tensor.shape[3])
    got = ref.core_of(facs[3], Z, core)
    assert float((got - want.double()).norm() / got.norm()) < 1e-5
    fit = fit_score(tensor, Decomposition(core=want, factors=facs))
    assert ref.fit_of(float((values ** 2).sum()), got) == pytest.approx(
        fit, abs=1e-7)


def test_partition_check_finds_every_fault(tensor):
    from repro_torch.core.plan import plan

    pl = plan(tensor, "lite", 4, core_dims=(10,) * 4, use_cache=False)
    coords = torch.from_numpy(tensor.coords)
    key = partition.key(coords, tensor.shape)
    vals = torch.from_numpy(tensor.values)
    ranks = [(mp.coords[p], mp.values[p], mp.e_per_rank[p])
             for mp in pl.parts for p in range(mp.P)]
    per_mode = [ranks[i:i + 4] for i in range(0, len(ranks), 4)]
    for r in per_mode:
        assert partition.mismatches(r, key, vals, tensor.shape, "cpu") == 0
    r = list(per_mode[1])
    c, v, n = r[2]
    r[2] = (c, v, n - 1)  # an element left out
    assert partition.mismatches(r, key, vals, tensor.shape, "cpu") > 0
    v2 = np.array(v)
    v2[0] += 1.0  # a value altered
    r[2] = (c, v2, n)
    assert partition.mismatches(r, key, vals, tensor.shape, "cpu") == 1


def test_below_2_63_the_key_is_the_linear_index(tensor):
    (key,) = partition.key(torch.from_numpy(tensor.coords), tensor.shape)
    want = np.ravel_multi_index(tuple(tensor.coords.T), tensor.shape)
    assert np.array_equal(key.numpy(), want)


NELL1 = (2902330, 2143368, 25495389)


def _wrapped(c, shape):
    """The one-word linear index in int64, wrapping past 2**63."""
    k = torch.tensor(c[0], dtype=torch.int64)
    for m in range(1, len(shape)):
        k = k * shape[m] + c[m]
    return int(k)


def test_coordinates_a_wrapped_index_confuses_are_told_apart():
    """Two nell-1 coordinates whose linear indices differ by exactly 2**64
    share a wrapped one-word key; the check holds one for the other as a
    mismatch."""
    q, r = divmod(2 ** 64, NELL1[2])
    a, b = (q // NELL1[1], q % NELL1[1], r), (0, 0, 0)
    lin = lambda c: (c[0] * NELL1[1] + c[1]) * NELL1[2] + c[2]  # noqa: E731
    assert lin(a) - lin(b) == 2 ** 64 and all(x < L for x, L in zip(a, NELL1))
    assert _wrapped(a, NELL1) == _wrapped(b, NELL1)
    want = torch.tensor([b, (1, 2, 3), (9, 9, 9)], dtype=torch.int64)
    got = torch.tensor([a, (1, 2, 3), (9, 9, 9)], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    key = partition.key(want, NELL1)
    assert len(key) == 2
    assert partition.mismatches([(want, vals, 3)], key, vals, NELL1,
                                "cpu") == 0
    assert partition.mismatches([(got, vals, 3)], key, vals, NELL1,
                                "cpu") > 0


@pytest.fixture(scope="module")
def nell1_plan():
    """A Lite P = 4 plan of 20,000 elements at nell-1's shape."""
    from repro_torch.core.coo import SparseTensor
    from repro_torch.core.plan import plan
    from tuckerbench import gen

    c, v = gen.draw_tensor(NELL1, 20_000, (1.2, 1.2, 1.4), seed=8,
                           device="cpu")
    t = SparseTensor(c, v, NELL1)
    pl = plan(t, "lite", 4, core_dims=(10, 10, 10), use_cache=False)
    coords = torch.from_numpy(c)
    return pl, partition.key(coords, NELL1), torch.from_numpy(v)


def _ranks(mp):
    return [(mp.coords[p], mp.values[p], mp.e_per_rank[p])
            for p in range(mp.P)]


def test_a_plan_past_2_63_reads_no_mismatch(nell1_plan):
    pl, key, vals = nell1_plan
    assert len(key) == 2
    for mp in pl.parts:
        assert partition.mismatches(_ranks(mp), key, vals, NELL1, "cpu") == 0


@pytest.mark.parametrize("fault", ["moved", "doubled"])
def test_a_fault_in_a_plan_past_2_63_reads_a_mismatch(nell1_plan, fault):
    """One element's last-mode coordinate moved by one, or one element
    held twice (in the place of another)."""
    pl, key, vals = nell1_plan
    mp = pl.parts[2]
    r = _ranks(mp)
    c, v, n = r[1]
    c, v = np.array(c), np.array(v)
    if fault == "moved":
        c[3, 2] += 1 if c[3, 2] + 1 < NELL1[2] else -1
    else:
        c[4], v[4] = c[3], v[3]
    r[1] = (c, v, n)
    assert partition.mismatches(r, key, vals, NELL1, "cpu") > 0
