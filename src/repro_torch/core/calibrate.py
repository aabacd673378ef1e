"""The cost model behind the plan's analytic costs, and its fit.

The port's own copy of the reference's ``core/calibrate.py``: ``CostModel``
and the process-wide current model, which ``repro_torch.core.plan`` scores
candidate schemes with and ``engine.comm`` compares backends with, and the
least-squares fit of its rates from measured sweeps: ``HooiExecutor``
records one sample per sweep (``calibration_samples()``, plus the pure-TTM
probe of ``profile_phases``), ``fit_cost_model`` turns them into a
``CostModel`` and ``set_cost_model`` installs it (the plan cache keys on the
model version). The fitter is numpy and the same as the reference's, so the
same samples give the same model.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Sequence

import numpy as np

__all__ = [
    "CostModel",
    "DEFAULT_COST_MODEL",
    "current_cost_model",
    "current_cost_model_state",
    "set_cost_model",
    "cost_model_version",
    "fit_cost_model",
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


# ------------------------------------------------------------------ fitting
def _fit_bf16_ttm_rate(use: Sequence[Mapping], cm: CostModel) -> CostModel:
    """Attach the bf16 TTM rate when bf16-labelled pure-TTM samples exist.

    ``HooiExecutor.profile_phases(precision="bf16")`` appends phase="ttm"
    probes (``svd_flops=0, comm_bytes=0``) labelled with the precision that
    ran; the bf16 rate is the robust one-parameter estimate
    ``sum(flops) / sum(seconds)`` over those, attached only when physical.
    The ``"auto"`` precision policy (``engine.zbuild.resolve_precision``)
    compares it against the fitted f32 TTM rate.
    """
    flop_sum = sec_sum = 0.0
    for s in use:
        if s.get("precision") != "bf16" or s.get("phase") != "ttm":
            continue
        f = float(s.get("ttm_flops", 0.0))
        sec = float(s.get("seconds", 0.0))
        if f > 0 and sec > 0:
            flop_sum += f
            sec_sum += sec
    if flop_sum <= 0 or sec_sum <= 0:
        return cm
    rate = flop_sum / sec_sum
    if not np.isfinite(rate) or rate <= 0:
        return cm
    return dataclasses.replace(cm, ttm_flop_rate_bf16=rate,
                               source=cm.source + "+bf16")


def _fit_backend_bandwidths(use: Sequence[Mapping],
                            cm: CostModel) -> CostModel:
    """Attach per-backend effective bandwidths when samples are labelled.

    Executor samples carry the comm backend they ran (``"psum"`` /
    ``"boundary"``; per-mode mixes are labelled ``"mixed"`` and skipped).
    For each backend with positive comm residual after the fitted compute
    phases, the effective bandwidth is total bytes / total residual seconds
    — a deliberately robust one-parameter estimate, only attached when it
    is physical (positive, finite)."""
    updates: dict[str, float] = {}
    for backend, field in (("psum", "psum_bandwidth"),
                           ("boundary", "boundary_bandwidth")):
        byte_sum = resid_sum = 0.0
        for s in use:
            if s.get("comm_backend") != backend:
                continue
            b = float(s.get("comm_bytes", 0.0))
            if b <= 0:
                continue
            tt, sv = cm.phase_seconds(
                float(s.get("ttm_flops", s["critical_path_flops"])),
                float(s.get("svd_flops", 0.0)))
            resid = float(s["seconds"]) - (tt + sv)
            if resid > 0:
                byte_sum += b
                resid_sum += resid
        if byte_sum > 0 and resid_sum > 0:
            bw = byte_sum / resid_sum
            if np.isfinite(bw):
                updates[field] = bw
    if not updates:
        return cm
    return dataclasses.replace(cm, source=cm.source + "+backends", **updates)


def _fit_phases(use: Sequence[Mapping], base: CostModel) -> CostModel | None:
    """Per-phase fit: seconds ~= ttm/r_ttm + svd/r_svd + bytes/bw.

    Needs the (ttm_flops, svd_flops) columns to be independent — e.g. the
    executor's ``profile_phases`` pure-TTM probe next to full sweeps, or
    sweeps over plans with different E_max/R_max ratios. Returns None when
    the phase columns are degenerate or the fit is unphysical, so the caller
    falls back to the single-rate fit.
    """
    A2 = np.array([[float(s["ttm_flops"]), float(s["svd_flops"])]
                   for s in use])
    y = np.array([float(s["seconds"]) for s in use])
    scale2 = np.maximum(A2.max(axis=0), 1e-30)
    if (A2.max(axis=0) <= 0).any() \
            or np.linalg.matrix_rank(A2 / scale2) < 2:
        return None
    bts = np.array([float(s.get("comm_bytes", 0.0)) for s in use])
    # comm column: joint-fit only when it adds rank; otherwise pin to base
    A3 = np.column_stack([A2, bts])
    scale3 = np.maximum(A3.max(axis=0), 1e-30)
    if bts.max() > 0 and np.linalg.matrix_rank(A3 / scale3) == 3:
        x, *_ = np.linalg.lstsq(A3 / scale3, y, rcond=None)
        x = x / scale3
        if (x > 0).all():
            return CostModel(
                flop_rate=2.0 / (x[0] + x[1]),
                net_bandwidth=1.0 / x[2],
                ttm_flop_rate=1.0 / x[0],
                svd_flop_rate=1.0 / x[1],
                source=f"fitted-phases:{len(use)}",
            )
    resid = y - bts / base.net_bandwidth
    if (resid <= 0).any():  # comm effectively free (shared-memory mesh)
        resid = y
    x, *_ = np.linalg.lstsq(A2 / scale2, resid, rcond=None)
    x = x / scale2
    if (x <= 0).any():
        return None
    return CostModel(
        flop_rate=2.0 / (x[0] + x[1]),
        net_bandwidth=base.net_bandwidth,
        ttm_flop_rate=1.0 / x[0],
        svd_flop_rate=1.0 / x[1],
        source=f"fitted-phases:{len(use)}",
    )


def fit_cost_model(
    samples: Sequence[Mapping],
    base: CostModel | None = None,
    warm_only: bool = True,
) -> CostModel:
    """Least-squares fit of (flop_rate, net_bandwidth) from measured sweeps.

    Each sample is a mapping with ``critical_path_flops``, ``comm_bytes`` and
    measured ``seconds`` for one HOOI sweep (``HooiExecutor`` records exactly
    these). We solve ``seconds ~= flops * x0 + bytes * x1`` for nonnegative
    ``x0 = 1/flop_rate``, ``x1 = 1/net_bandwidth``.

    When every sample additionally carries per-phase ``ttm_flops`` /
    ``svd_flops`` columns (the executor records them; its
    ``profile_phases`` probe contributes a pure-TTM sample that makes the
    design full-rank), the TTM and Lanczos/SVD rates are fitted separately
    and returned as ``ttm_flop_rate`` / ``svd_flop_rate`` — ``auto``
    selection then re-scores candidates under kernel-speed rates. A
    degenerate or unphysical per-phase design falls back to the single-rate
    fit below.

    Samples labelled with different ``groups`` (a mesh's device groups;
    unlabelled is 1) are refused: they measure different machines.

    ``warm_only`` drops samples flagged ``warm=False`` (sweeps that paid jit
    compilation — those times measure XLA, not the machine's rates). When the
    design matrix is degenerate (one plan measured, or comm negligible on a
    shared-memory mesh), the comm term is pinned to ``base`` and only the
    flop rate is fitted — that is the dominant term for the paper's
    computation-bound workloads anyway.
    """
    base = base or DEFAULT_COST_MODEL
    groups = {s.get("groups", 1) for s in samples}
    if len(groups) > 1:
        # ranks stacked on one device and ranks spread over a mesh's groups
        # run at different rates: fit each executor's samples on their own
        raise ValueError(f"samples from meshes of {sorted(groups)} device "
                         "groups: fit each group count on its own")
    all_use = [s for s in samples if not warm_only or s.get("warm", True)]
    if not all_use:
        raise ValueError("no usable samples (all cold or empty)")
    # bf16-labelled samples feed only the dedicated bf16 TTM rate — mixing
    # them into the main design would bias the f32 phase rates
    use = [s for s in all_use if s.get("precision", "f32") != "bf16"] \
        or all_use
    if all("ttm_flops" in s and "svd_flops" in s for s in use):
        phased = _fit_phases(use, base)
        if phased is not None:
            return _fit_bf16_ttm_rate(
                all_use, _fit_backend_bandwidths(use, phased))
    A = np.array(
        [[float(s["critical_path_flops"]), float(s["comm_bytes"])] for s in use]
    )
    y = np.array([float(s["seconds"]) for s in use])
    if (y <= 0).any() or (A[:, 0] <= 0).any():
        raise ValueError("samples need positive seconds and flops")

    def _flops_only() -> CostModel:
        # pin comm at base rate, fit the flop term on the residual; if the
        # pinned comm model over-predicts any sample (comm is effectively
        # free, e.g. a shared-memory mesh), attribute the whole measured
        # time to flops rather than inverting a clamped-to-zero residual
        # into an absurdly fast machine
        resid = y - A[:, 1] / base.net_bandwidth
        if (resid <= 0).any():
            resid = y
        x0 = float(resid @ A[:, 0]) / float(A[:, 0] @ A[:, 0])
        return CostModel(
            flop_rate=1.0 / max(x0, 1e-18),
            net_bandwidth=base.net_bandwidth,
            source=f"fitted:{len(use)}",
        )

    # column scaling for conditioning; rank check decides 1- vs 2-term fit
    scale = A.max(axis=0)
    if scale[1] <= 0 or np.linalg.matrix_rank(A / np.maximum(scale, 1e-30)) < 2:
        return _fit_bf16_ttm_rate(
            all_use, _fit_backend_bandwidths(use, _flops_only()))
    x, *_ = np.linalg.lstsq(A / scale, y, rcond=None)
    x = x / scale
    if x[0] <= 0 or x[1] <= 0:  # unphysical joint fit -> robust 1-term fit
        return _fit_bf16_ttm_rate(
            all_use, _fit_backend_bandwidths(use, _flops_only()))
    return _fit_bf16_ttm_rate(all_use, _fit_backend_bandwidths(use, CostModel(
        flop_rate=1.0 / x[0],
        net_bandwidth=1.0 / x[1],
        source=f"fitted:{len(use)}",
    )))
