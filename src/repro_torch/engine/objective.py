"""Objectives: *what* the sweep loop optimizes.

The port of ``src/repro/engine/objective.py``. The paper's HOOI is one
objective — minimize the Frobenius residual of an orthonormal-factor Tucker
model — over the Z-build → oracle → comm pipeline. Masked and constrained
sparse Tucker variants share that core; what changes is the data the sweeps
see, what happens to a factor after the oracle solve, and how each sweep is
scored. Those seams are the ``Objective`` contract:

* ``prepare_tensor(t)`` — the host-side *view* of the input the sweeps run
  on. ``CompletionObjective`` drops its held-out entries here; views are
  stamped and returned unchanged on re-entry, and memoized per source.
* ``refine_factor(F, S)`` — post-processing of one mode's oracle solve, on
  the full-row factor in *original* row order (after the comm backend's
  finalize and the executor's row-perm restore). Identity for Tucker and
  completion; ADMM splitting onto the nonnegative orthant for
  ``NNTuckerObjective`` (elementwise torch on the factor's device).
* ``finalize_core``, ``fit`` and ``sweep_metrics`` — the reported core, the
  per-sweep fit and extra trajectory stats (held-out RMSE for completion).
  ``TuckerObjective.fit`` is the historical ``fit_score`` call, so the
  default trajectories stay bitwise what they were.

``predict_at_coords`` — model values at given coordinates, which the
completion RMSE and the NN fit need — runs on the factors' device in f64,
chunked, in the reference's contraction order (the reference runs it in
numpy on the host; at nell-2 size that is 61M × 1,000 multiply-adds per NN
fit). The small f64 algebra on the core (the NN least-squares core and the
model norm) stays in numpy on the host, as in the reference.

``cache_token()`` discriminates plan cache entries and plan files.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Sequence

import numpy as np
import torch

from repro_torch import envknobs, tracing

__all__ = ["Objective", "TuckerObjective", "CompletionObjective",
           "NNTuckerObjective", "TUCKER", "resolve_objective",
           "predict_at_coords", "admm_nonneg_factor", "holdout_mask"]


# --------------------------------------------------------------- helpers

def holdout_mask(nnz: int, fraction: float, seed: int) -> np.ndarray:
    """Deterministic per-index holdout selection, stable under appends.

    Entry ``i`` is held out iff the keyed hash ``sample_unit(i, seed)`` at
    ``HOLDOUT_DOMAIN`` (0) falls below ``fraction`` — the reference's
    stream, bit for bit.
    """
    from repro_torch.core.stochastic import HOLDOUT_DOMAIN, sample_unit

    if fraction <= 0.0 or nnz == 0:
        return np.zeros(nnz, dtype=bool)
    if fraction >= 1.0:
        return np.ones(nnz, dtype=bool)
    unit = sample_unit(np.arange(nnz, dtype=np.uint64), seed, HOLDOUT_DOMAIN)
    return unit < float(fraction)


def _f64(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.from_numpy(np.asarray(x, dtype=np.float64)).to(device)


def predict_at_coords(core, factors: Sequence, coords,
                      chunk: int | None = None) -> torch.Tensor:
    """Model values ``M[i_1..i_N] = core ×_n F_n`` at ``coords`` (nnz, N),
    as a float64 tensor on the factors' device.

    Chunked over entries (``chunk``: 65,536 on the CPU, as the reference,
    2^20 on the card): per chunk, the mode-0 factor rows contract the core
    once, then each remaining mode contracts its gathered rows elementwise
    over the batch — the reference's order, O(nnz · Π K_n), no
    densification. ``coords`` may be a numpy array (moved a chunk at a time)
    or a tensor.
    """
    dev = factors[0].device if isinstance(factors[0], torch.Tensor) \
        else torch.device("cpu")
    if chunk is None:
        chunk = 65536 if dev.type == "cpu" else 1 << 20
    core64 = _f64(core, dev)
    fs = [_f64(f, dev) for f in factors]
    nnz = int(coords.shape[0])
    out = torch.empty(nnz, dtype=torch.float64, device=dev)
    for s in range(0, nnz, chunk):
        c = coords[s:s + chunk]
        c = (c if isinstance(c, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(c))).to(dev).long()
        acc = torch.tensordot(fs[0][c[:, 0]], core64, dims=([1], [0]))
        for n in range(1, len(fs)):
            acc = torch.einsum("bk...,bk->b...", acc, fs[n][c[:, n]])
        out[s:s + c.shape[0]] = acc.reshape(-1)
    return out


def admm_nonneg_factor(F: torch.Tensor, S: torch.Tensor, iters: int = 8,
                       rho: float = 1.0, ridge: float = 0.0,
                       residual_balance: bool = False,
                       balance_mu: float = 10.0,
                       balance_tau: float = 2.0) -> torch.Tensor:
    """Project one mode's oracle solve onto the nonnegative orthant by ADMM.

    ``M = F·diag(S)`` is the energy-weighted unconstrained solution; scaled
    ADMM on ``min_X ½‖X−M‖² + ridge/2·‖X‖² + I₊(X)`` with the split
    ``X = W``::

        X ← (M + ρ(W − Y)) / (1 + ridge + ρ)      (x-update)
        W ← max(X + Y, 0)                          (projection)
        Y ← Y + X − W                              (dual ascent)

    elementwise closed form, since the quadratic term comes from an
    orthonormal basis. Returns ``W`` (exactly nonnegative) with columns
    normalized (dead columns keep scale through the eps clamp).
    ``residual_balance=True`` is Boyd §3.4.1's adaptive ρ: ρ is scaled by
    ``balance_tau`` when one of the primal residual ``‖X − W‖`` and the dual
    residual ``ρ‖W − W_prev‖`` exceeds ``balance_mu``× the other, and the
    scaled dual ``Y`` is rescaled to keep the dual variable. ρ is then a
    device scalar, so no step waits for the device.
    """
    M = F * S[None, :]
    W = torch.clamp(M, min=0.0)
    Y = torch.zeros_like(M)
    if not residual_balance:
        denom = 1.0 + float(ridge) + float(rho)
        for _ in range(max(int(iters), 1)):
            X = (M + rho * (W - Y)) / denom
            W = torch.clamp(X + Y, min=0.0)
            Y = Y + X - W
    else:
        mu = float(balance_mu)
        tau = float(balance_tau)
        rho_t = torch.tensor(float(rho), dtype=M.dtype, device=M.device)
        for _ in range(max(int(iters), 1)):
            denom = 1.0 + float(ridge) + rho_t
            X = (M + rho_t * (W - Y)) / denom
            W_new = torch.clamp(X + Y, min=0.0)
            Y = Y + X - W_new
            r_p = torch.linalg.norm(X - W_new)
            r_d = rho_t * torch.linalg.norm(W_new - W)
            new_rho = torch.where(
                r_p > mu * r_d, rho_t * tau,
                torch.where(r_d > mu * r_p, rho_t / tau, rho_t))
            Y = Y * (rho_t / new_rho)
            rho_t = new_rho
            W = W_new
    norms = torch.sqrt(torch.sum(W * W, dim=0))
    return W / torch.clamp(norms, min=1e-6)[None, :]


# ------------------------------------------------------------ objectives

@dataclasses.dataclass(frozen=True)
class Objective:
    """Base contract; the defaults are the standard Tucker behaviors."""

    name: ClassVar[str] = "tucker"

    def cache_token(self) -> tuple:
        """Static discriminator for plan cache keys and plan files."""
        return (self.name,)

    def prepare_tensor(self, t):
        """The view of ``t`` the sweeps run on (idempotent)."""
        return t

    def refine_factor(self, F: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
        """Post-process one mode's oracle solve (full rows, original order)."""
        return F

    def finalize_core(self, core, factors):
        """The core the decomposition reports for these factors (the sweep
        loop hands in the projection core ``T ×_n F_nᵀ``)."""
        return core

    def fit(self, t, core, factors) -> float:
        """Per-sweep fit scalar; the default is the historical fit_score."""
        from repro_torch.core.hooi import Decomposition, fit_score

        return fit_score(t, Decomposition(core=core, factors=list(factors)))

    def sweep_metrics(self, out: dict, t, core, factors) -> None:
        """Append per-sweep extra stats (e.g. held-out RMSE) into ``out``."""

    def extra_svd_flops(self, metrics, core_dims, model) -> float:
        """Objective-specific flops added to the plan's SVD phase."""
        return 0.0


@dataclasses.dataclass(frozen=True)
class TuckerObjective(Objective):
    """The paper's standard objective: every seam is the identity or the
    historical call, so trajectories are bitwise the default's."""

    name: ClassVar[str] = "tucker"


TUCKER = TuckerObjective()


@dataclasses.dataclass(frozen=True)
class CompletionObjective(Objective):
    """Masked fit: residuals over the training entries only.

    ``prepare_tensor`` drops the held-out fraction of entries from the COO
    view, so partitioning, the Z-build, the oracle and the fit see only the
    training entries. The held-out coordinates and values ride along on the
    view; ``sweep_metrics`` scores the model there as held-out RMSE per
    sweep. ``holdout_fraction=0`` is the tensor itself, i.e. Tucker.
    """

    name: ClassVar[str] = "completion"

    holdout_fraction: float = 0.2
    holdout_seed: int = 0

    def cache_token(self) -> tuple:
        return (self.name, float(self.holdout_fraction),
                int(self.holdout_seed))

    def prepare_tensor(self, t):
        from repro_torch.core.coo import SparseTensor

        if getattr(t, "_objective_view", None) == self.cache_token():
            return t
        if self.holdout_fraction <= 0.0 or t.nnz == 0:
            return t
        # memoized per source object: repeated calls on one tensor return
        # the same view, keeping its fingerprint memo and plan-cache identity
        memo = getattr(t, "_objective_view_memo", None)
        if memo is not None and memo[0] == self.cache_token():
            return memo[1]
        held = holdout_mask(t.nnz, self.holdout_fraction, self.holdout_seed)
        view = SparseTensor(coords=t.coords[~held], values=t.values[~held],
                            shape=t.shape)
        object.__setattr__(view, "_objective_view", self.cache_token())
        object.__setattr__(view, "_holdout_coords", t.coords[held])
        object.__setattr__(view, "_holdout_values", t.values[held])
        sv = getattr(t, "_stream_version", None)
        if sv is not None:
            object.__setattr__(view, "_stream_version", sv)
        object.__setattr__(t, "_objective_view_memo",
                           (self.cache_token(), view))
        return view

    def sweep_metrics(self, out: dict, t, core, factors) -> None:
        hc = getattr(t, "_holdout_coords", None)
        if hc is None or len(hc) == 0:
            return
        pred = predict_at_coords(core, factors, hc)
        hv = _f64(getattr(t, "_holdout_values"), pred.device)
        rmse = float(torch.sqrt(torch.mean((pred - hv) ** 2)))
        out.setdefault("holdout_rmse", []).append(rmse)


@dataclasses.dataclass(frozen=True)
class NNTuckerObjective(Objective):
    """Nonnegative / ridge-regularized Tucker via ADMM splitting.

    Each mode's oracle solve goes through ``admm_nonneg_factor``: the
    factors the sweep carries are exactly nonnegative with unit columns.
    They are no longer orthonormal, so the fit comes from the residual
    expansion ``‖T − M‖² = ‖T‖² − 2⟨T, M⟩ + ‖M‖²``, with ``⟨T, M⟩`` taken at
    the stored coordinates (``predict_at_coords``, on the device) and
    ``‖M‖²`` through the factor Gram matrices folded into the core.
    """

    name: ClassVar[str] = "nn"

    admm_iters: int = 8
    rho: float = 1.0
    ridge: float = 0.0
    residual_balance: bool = False
    balance_mu: float = 10.0
    balance_tau: float = 2.0

    def cache_token(self) -> tuple:
        tok = (self.name, int(self.admm_iters), float(self.rho),
               float(self.ridge))
        if self.residual_balance:
            # appended only when on, so the fixed-rho token stays as it was
            tok += ("rb", float(self.balance_mu), float(self.balance_tau))
        return tok

    def refine_factor(self, F: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
        return admm_nonneg_factor(F, S, iters=self.admm_iters, rho=self.rho,
                                  ridge=self.ridge,
                                  residual_balance=self.residual_balance,
                                  balance_mu=self.balance_mu,
                                  balance_tau=self.balance_tau)

    def finalize_core(self, core, factors):
        # the least-squares core for non-orthonormal factors: the separable
        # normal equations G ×_n (F_nᵀF_n) = G_proj, one K×K solve per mode
        # (in f64 numpy on the host, as the reference)
        g64 = core.detach().cpu().double().numpy()
        for n, f in enumerate(factors):
            fn = f.detach().cpu().double().numpy()
            gram = fn.T @ fn + 1e-10 * np.eye(fn.shape[1])
            mat = np.moveaxis(g64, n, 0).reshape(g64.shape[n], -1)
            g64 = np.moveaxis(
                np.linalg.solve(gram, mat).reshape(
                    (g64.shape[n],) + tuple(np.delete(g64.shape, n))),
                0, n)
        return torch.from_numpy(g64).to(device=core.device, dtype=core.dtype)

    def fit(self, t, core, factors) -> float:
        with tracing.span("sweep.norm2"):
            true_norm2 = getattr(t, "_true_norm2", None)
            t2 = float(true_norm2) if true_norm2 is not None else float(
                np.sum(np.asarray(t.values, dtype=np.float64) ** 2))
        pred = predict_at_coords(core, factors, t.coords)
        tm = float(torch.dot(_f64(t.values, pred.device), pred))
        core64 = core.detach().cpu().double().numpy()
        acc = core64
        for n, f in enumerate(factors):
            g = f.detach().cpu().double().numpy()
            acc = np.moveaxis(
                np.tensordot(g.T @ g, acc, axes=[[1], [n]]), 0, n)
        m2 = float(np.sum(acc * core64))
        err2 = max(t2 - 2.0 * tm + m2, 0.0)
        return 1.0 - float(np.sqrt(err2) / (np.sqrt(t2) + 1e-30))

    def extra_svd_flops(self, metrics, core_dims, model) -> float:
        # elementwise ops per (row, column) factor entry per ADMM iteration
        # (CostModel.admm_flops_per_entry), replicated on every rank
        total = 0.0
        for n, pm in enumerate(metrics.per_mode):
            total += float(pm.L) * float(core_dims[n])
        return float(self.admm_iters) \
            * float(getattr(model, "admm_flops_per_entry", 6.0)) * total


_BY_NAME = {
    "tucker": TuckerObjective,
    "completion": CompletionObjective,
    "nn": NNTuckerObjective,
}


def resolve_objective(objective=None) -> Objective:
    """The one resolution rule for every entry point: ``None`` honors
    ``REPRO_OBJECTIVE`` (default tucker), a name gives a default-parameter
    instance, an ``Objective`` passes through."""
    if objective is None:
        objective = envknobs.objective() or "tucker"
    if isinstance(objective, str):
        try:
            return _BY_NAME[objective]()
        except KeyError:
            raise ValueError(
                f"unknown objective {objective!r} "
                f"(expected one of {tuple(_BY_NAME)})") from None
    if isinstance(objective, Objective):
        return objective
    raise TypeError(f"objective must be None, a name, or an Objective, "
                    f"got {type(objective).__name__}")
