"""The harness's seam to the program under test (``repro_torch``).

``Recorder`` is the program's own Tucker objective with two additions: it
keeps a reference to each factor that a mode step returns (the full-row
factor in original row order, which the objective's ``refine_factor`` is
handed and returns unchanged), so that the reference can follow the
decomposition step by step from what the timed path produced; and it opens
a profiler span around each call into the objective's finalize (the core
and the fit, which holds the host's ||T||² pass), so that a trace names the
time spent there. Keeping a reference costs no copy and no
synchronisation; a span costs microseconds, and records only under a
profiler.
"""

from __future__ import annotations

import dataclasses
import gc

import torch
from torch.profiler import record_function

from repro_torch.engine.objective import TuckerObjective

__all__ = ["Recorder", "release"]


@dataclasses.dataclass(frozen=True)
class Recorder(TuckerObjective):
    steps: list = dataclasses.field(default_factory=list, compare=False,
                                    hash=False)

    def refine_factor(self, F: torch.Tensor, S: torch.Tensor
                      ) -> torch.Tensor:
        self.steps.append(F)
        return F

    def finalize_core(self, core, factors):
        with record_function("objective.finalize_core"):
            return super().finalize_core(core, factors)

    def fit(self, t, core, factors) -> float:
        with record_function("objective.fit"):
            return super().fit(t, core, factors)


def release() -> None:
    """Drop the program's cached plans (and with them the uploads and
    captured steps keyed on them) and return their device memory."""
    from repro_torch.core.plan import plan_cache_clear

    plan_cache_clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
