"""The cost model behind the plan's analytic costs.

The port's own copy of the reference's ``core/calibrate.py``: ``CostModel``
and the process-wide current model, which ``repro_torch.core.plan`` scores
candidate schemes with and ``engine.comm`` compares backends with. The
least-squares fit from measured sweeps (``fit_cost_model``) and the
executor's calibration samples are ROADMAP Queue A item 10.
"""

from __future__ import annotations

import dataclasses
import threading

__all__ = [
    "CostModel",
    "DEFAULT_COST_MODEL",
    "current_cost_model",
    "current_cost_model_state",
    "set_cost_model",
    "cost_model_version",
]


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-rank effective rates behind ``PlanCost``.

    ``source`` records provenance ("default" or "fitted:<n samples>") so
    reported selections can say which model produced them.

    The optional per-phase rates split the single ``flop_rate`` into the two
    phases of a HOOI mode step — the TTM Z build (streaming scatter/matmul;
    on TPU the Pallas ``kron_segsum`` kernel) and the Lanczos/SVD oracle
    (dense matvecs). They default to ``flop_rate``, so a model fitted
    without per-phase samples behaves exactly as before; a per-phase fit
    (``fit_cost_model`` on samples carrying ``ttm_flops``/``svd_flops``)
    lets the ``auto`` selector trade E_max against R_max under the rates the
    kernels actually achieve.
    """

    flop_rate: float = 5.0e10  # flop/s per rank (combined, both phases)
    net_bandwidth: float = 1.0e10  # bytes/s per link
    ttm_flop_rate: float | None = None  # TTM (Z-build) phase; None -> flop_rate
    svd_flop_rate: float | None = None  # Lanczos/SVD phase; None -> flop_rate
    # TTM rate measured under bf16 contributions (samples labelled
    # precision="bf16"); drives the "auto" precision policy — None = unknown
    ttm_flop_rate_bf16: float | None = None
    # per-comm-backend effective bandwidths (the engine's psum vs boundary
    # collectives stress the interconnect differently); None -> net_bandwidth
    psum_bandwidth: float | None = None
    boundary_bandwidth: float | None = None
    # FLOPs per factor entry per ADMM iteration (NN objective's eager refine:
    # scaled X/W/Y updates are a handful of elementwise ops per entry); folded
    # into the svd phase by the plan cost — see Objective.extra_svd_flops
    admm_flops_per_entry: float = 6.0
    # stochastic-refine rung: modeled seconds for a sampled pass are
    # (sampled_nnz / total_nnz) * sampled_pass_overhead * full_sweep_seconds.
    # The overhead multiplier absorbs everything a minibatch pays that a
    # full sweep amortizes — single-device execution (no P-way split), the
    # O(nnz) fit/core accounting on the full snapshot, pow2 shape padding.
    # See core/plan.py::stochastic_refine_seconds.
    sampled_pass_overhead: float = 2.0
    source: str = "default"

    def __post_init__(self):
        if self.flop_rate <= 0 or self.net_bandwidth <= 0:
            raise ValueError(
                f"rates must be positive: flop_rate={self.flop_rate}, "
                f"net_bandwidth={self.net_bandwidth}"
            )
        for name in ("ttm_flop_rate", "svd_flop_rate", "ttm_flop_rate_bf16",
                     "psum_bandwidth", "boundary_bandwidth"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        if self.sampled_pass_overhead <= 0:
            raise ValueError(
                f"sampled_pass_overhead must be positive, got "
                f"{self.sampled_pass_overhead}")

    def phase_rates(self) -> tuple[float, float]:
        """(ttm_rate, svd_rate), falling back to the combined rate."""
        return (self.ttm_flop_rate or self.flop_rate,
                self.svd_flop_rate or self.flop_rate)

    def bandwidth_for(self, backend: str | None = None) -> float:
        """Effective bytes/s for a comm backend, falling back to the
        combined ``net_bandwidth`` (``local`` moves no collective bytes but
        is charged the base rate for its residual fm traffic)."""
        if backend == "psum" and self.psum_bandwidth is not None:
            return self.psum_bandwidth
        if backend == "boundary" and self.boundary_bandwidth is not None:
            return self.boundary_bandwidth
        return self.net_bandwidth

    def flops_seconds(self, flops: float) -> float:
        return float(flops) / self.flop_rate

    def phase_seconds(self, ttm_flops: float, svd_flops: float
                      ) -> tuple[float, float]:
        rt, rs = self.phase_rates()
        return float(ttm_flops) / rt, float(svd_flops) / rs

    def comm_seconds(self, nbytes: float, backend: str | None = None) -> float:
        return float(nbytes) / self.bandwidth_for(backend)

    def predict_seconds(self, flops: float, nbytes: float) -> float:
        return self.flops_seconds(flops) + self.comm_seconds(nbytes)


DEFAULT_COST_MODEL = CostModel()

_LOCK = threading.Lock()
_CURRENT = DEFAULT_COST_MODEL
_VERSION = 0  # bumped on set_cost_model; part of the plan cache key


def current_cost_model() -> CostModel:
    """The process-wide model ``repro.core.plan`` scores candidates with."""
    with _LOCK:
        return _CURRENT


def current_cost_model_state() -> tuple[CostModel, int]:
    """(model, version) read atomically — callers that key caches on the
    version must score with the model read in the same snapshot."""
    with _LOCK:
        return _CURRENT, _VERSION


def set_cost_model(model: CostModel | None) -> CostModel:
    """Install ``model`` (None restores the default); returns the new model.

    Bumps the model version, which is part of the plan cache key — cached
    plans scored under the old rates are not silently reused.
    """
    global _CURRENT, _VERSION
    if model is not None and not isinstance(model, CostModel):
        raise TypeError(f"expected CostModel, got {type(model).__name__}")
    with _LOCK:
        _CURRENT = DEFAULT_COST_MODEL if model is None else model
        _VERSION += 1
        return _CURRENT


def cost_model_version() -> int:
    with _LOCK:
        return _VERSION
