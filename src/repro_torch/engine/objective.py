"""Sweep objectives: the tucker objective, the one this port carries.

The port of the parts of ``src/repro/engine/objective.py`` that the plan and
the executor consult. ``resolve_objective`` keeps the reference's resolution
rule (None honors ``REPRO_OBJECTIVE``, a name, or an instance), but only the
standard tucker objective exists here: completion and nonnegative Tucker
raise ``NotImplementedError`` naming ROADMAP Queue A item 9.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

from repro_torch import envknobs

__all__ = ["TuckerObjective", "TUCKER", "resolve_objective"]


@dataclasses.dataclass(frozen=True)
class TuckerObjective:
    """The paper's standard objective: every seam is the identity."""

    name: ClassVar[str] = "tucker"

    def cache_token(self) -> tuple:
        """Static discriminator for plan cache keys."""
        return (self.name,)

    def prepare_tensor(self, t):
        """The view of ``t`` the sweeps run on: ``t`` itself."""
        return t

    def extra_svd_flops(self, metrics, core_dims, model) -> float:
        """Objective-specific flops added to the plan's SVD phase: none."""
        return 0.0


TUCKER = TuckerObjective()


def resolve_objective(objective=None) -> TuckerObjective:
    """None honors ``REPRO_OBJECTIVE`` (default tucker); ``"tucker"`` and a
    ``TuckerObjective`` pass; the reference's other objectives refuse."""
    if objective is None:
        objective = envknobs.objective() or "tucker"
    if isinstance(objective, TuckerObjective) or objective == "tucker":
        return TUCKER
    if objective in envknobs.OBJECTIVES:
        raise NotImplementedError(
            f"objective={objective!r}: objectives other than tucker are "
            "ROADMAP Queue A item 9")
    raise ValueError(f"unknown objective {objective!r} "
                     f"(expected one of {envknobs.OBJECTIVES})")
