"""The check decides: a tiny run of each cell on the CPU is correct, its
lower-precision control is not, and neither is a run whose timed path is
broken underneath, once for each fault the cells can have.

Each run goes through the harness as the benchmark runs it (set-up, warm-up,
window, check against the plain reference with the cell's own limits); only
the look for a card is skipped.
"""

import pytest
import torch

from _tiny import run_tiny

CELLS = ["nell2.lite.p4", "nell2.hooi", "enron.hooi", "enron.lite.p4"]
DIST = ["nell2.lite.p4", "enron.lite.p4"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(cell):
    res = run_tiny(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_is_not(cell):
    res = run_tiny(cell, control="bf16")
    assert not res["correct"], res["checks"]
    failed = {k for k, c in res["checks"].items() if c["value"] > c["limit"]}
    # the program's bf16 Z-builds fail the step, the reference's bf16 core
    # fails the core and the fit, where the cell compares it
    want = {"step_deficit", "core_rel", "fit_gap"} & res["checks"].keys()
    assert {"step_deficit", "core_rel"} <= want <= failed, res["checks"]


def _step_unchanged(monkeypatch, cell):
    """Each mode step returns its input factor (through the objective, as
    a real step's result goes)."""
    if cell in DIST:
        from repro_torch.distributed import executor

        real = executor.HooiExecutor._call_step

        def call_step(self, skey, step, home, arrs, factors, key, tally):
            F, sv = real(self, skey, step, home, arrs, factors, key, tally)
            n = skey[3]
            flat = torch.zeros((F.shape[0] * F.shape[1], F.shape[2]),
                               dtype=F.dtype, device=F.device)
            flat[home.row_perms[n]] = factors[n]
            return flat.reshape(F.shape), sv

        monkeypatch.setattr(executor.HooiExecutor, "_call_step", call_step)
    else:
        from repro_torch.engine import steps

        real = steps.local_mode_step

        def local_mode_step(coords, values, factors, mode, *a, **kw):
            obj = kw.pop("objective", None)
            real(coords, values, factors, mode, *a, **kw)
            F = factors[mode]
            return F if obj is None else obj.refine_factor(F, None)

        monkeypatch.setattr(steps, "local_mode_step", local_mode_step)


def _half_batch(monkeypatch, cell):
    """Half of the elements left out, the rest counted twice (the mean
    over what is left)."""
    if cell in DIST:
        from repro_torch.core import plan as plan_mod

        real = plan_mod.plan

        def plan(*a, **kw):
            pl = real(*a, **kw)
            for mp in pl.parts:
                mp.values[:, 1::2] = 0.0
                mp.values[:, 0::2] *= 2.0
            return pl

        monkeypatch.setattr(plan_mod, "plan", plan)
    else:
        from repro_torch import convert

        real = convert.device_coords

        def device_coords(t, device):
            c, v = real(t, device)
            v = v.clone()
            v[1::2] = 0.0
            v[0::2] *= 2.0
            return c, v

        monkeypatch.setattr(convert, "device_coords", device_coords)


def _no_exchange(monkeypatch, cell):
    """The boundary rows that other ranks computed are never added in."""
    from repro_torch.engine import comm

    monkeypatch.setattr(comm, "add_slots", lambda *a, **kw: None)


def _core_altered(monkeypatch, cell):
    """The answer altered where it is produced: the core."""
    from repro_torch.core import ttm

    real = ttm.core_from_factors

    def core_from_factors(coords, values, factors):
        G = real(coords, values, factors).clone()
        G.view(-1)[0] += 1e-3 * float(G.abs().max())
        return G

    monkeypatch.setattr(ttm, "core_from_factors", core_from_factors)


FAULTS = [(c, f) for c in CELLS for f in
          (_step_unchanged, _half_batch, _core_altered)] + \
    [(c, _no_exchange) for c in DIST]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=lambda x: x if isinstance(x, str)
                         else x.__name__.strip("_"))
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    res = run_tiny(cell)
    assert not res["correct"], res["checks"]


@pytest.fixture(autouse=True)
def _fresh_plans():
    """A fault planted in a plan must not outlive its test in the cache."""
    from repro_torch.core.plan import plan_cache_clear

    plan_cache_clear()
    yield
    plan_cache_clear()
