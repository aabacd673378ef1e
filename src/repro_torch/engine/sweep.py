"""The HOOI sweep loop.

The port of ``src/repro/engine/sweep.py``. Key derivation is the shared
contract: the step for invocation ``it`` and mode ``n`` draws from
``sweep_key(key, it, N, n)``, the path ``(1000 + it*N + n,)`` below the
root — the same chain as the reference, which is what lets the parity tests
inject the reference's draws.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch

from repro_torch import tracing
from repro_torch.random import Key

__all__ = ["sweep_key", "run_hooi_sweeps"]


def sweep_key(key: Key, it: int, nmodes: int, mode: int) -> Key:
    """Per-(invocation, mode) key — one convention for every backend."""
    return key.fold_in(1000 + it * nmodes + mode)


def run_hooi_sweeps(
    coords: torch.Tensor,
    values: torch.Tensor,
    t,
    factors: list,
    key: Key,
    n_invocations: int,
    mode_step: Callable[[int, Sequence[torch.Tensor], Key], torch.Tensor],
    on_sweep: Callable[[int, float, float], None] | None = None,
    objective=None,
    metrics_out: dict | None = None,
):
    """Run ``n_invocations`` HOOI sweeps, returning (Decomposition, fits).

    ``mode_step(n, factors, key) -> new factor``, in original row order.
    ``on_sweep(it, seconds, fit)`` observes each sweep's wall time up to the
    device finishing its mode steps (the core and fit come after). The core
    is (re)finalized from the final factors, so ``n_invocations=0`` still
    yields a valid decomposition of the bootstrap factors. With tracing on
    (``repro_torch.tracing``) the spans ``sweep``, ``sweep.steps`` (the
    interval ``on_sweep`` gets), ``sweep.core`` (the core and
    ``finalize_core``) and ``sweep.fit`` time each sweep.

    ``objective`` (an ``engine.objective.Objective``) owns the per-sweep
    accounting: ``finalize_core``, ``fit`` and ``sweep_metrics``; ``None``
    runs the historical inline ``fit_score``, which ``TuckerObjective``
    reproduces bitwise. ``metrics_out`` collects the objective's extra
    per-sweep stats (completion's ``holdout_rmse``).
    """
    from repro_torch.core.hooi import Decomposition, fit_score
    from repro_torch.core.ttm import core_from_factors

    N = t.ndim
    fits: list[float] = []
    core = None
    for it in range(n_invocations):
        with tracing.span("sweep"):
            with tracing.span("sweep.steps"):
                t0 = time.perf_counter()
                for n in range(N):
                    factors[n] = mode_step(n, factors,
                                           sweep_key(key, it, N, n))
                if coords.is_cuda:
                    torch.cuda.synchronize(coords.device)
                sweep_s = time.perf_counter() - t0
            with tracing.span("sweep.core"):
                core = core_from_factors(coords, values, factors)
                if objective is not None:
                    core = objective.finalize_core(core, factors)
            with tracing.span("sweep.fit"):
                if objective is None:
                    fit = fit_score(t, Decomposition(core=core,
                                                     factors=factors))
                else:
                    fit = objective.fit(t, core, factors)
            if objective is not None and metrics_out is not None:
                objective.sweep_metrics(metrics_out, t, core, factors)
            fits.append(fit)
            if on_sweep is not None:
                on_sweep(it, sweep_s, fit)
    if core is None:  # n_invocations == 0: finalize the initial factors
        core = core_from_factors(coords, values, factors)
        if objective is not None:
            core = objective.finalize_core(core, factors)
    return Decomposition(core=core, factors=factors), fits
