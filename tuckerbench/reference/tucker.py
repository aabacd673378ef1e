"""The plain reference of sparse Tucker's HOOI steps, in float64.

Plain PyTorch: it imports neither the program nor JAX. It works from the
benchmark's tensor (coordinates and values as drawn) and from the factors it
is asked to judge, and re-derives everything else:

* ``penultimate`` — Z_(n) = T x_{j != n} F_j, unfolded along mode n, with the
  other modes' Kronecker rows in increasing mode order (the last fastest),
  built over the elements sorted by their mode-n row, in blocks, with each
  row's sum taken as a difference of one float64 prefix sum per block;
* ``krylov_left`` — the HOOI mode update as the program's Lanczos computes
  it in exact arithmetic: the block Krylov space of ZᵀZ from the step's
  start panel, Z applied to it, and that product's leading left singular
  vectors (the Ritz vectors of the Golub–Kahan bidiagonalization);
* ``step_numbers`` — how far a factor the program returned lies from them;
* ``core_of`` and ``fit_of`` — the core T x_n F_nᵀ and the fit
  1 - ||T - G x F|| / ||T|| of orthonormal factors.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["penultimate", "krylov_left", "step_numbers", "core_of",
           "fit_of", "BLOCK_VALUES"]

F64 = torch.float64
# Kronecker values per block of the Z-build: 2^27 float64s (1 GiB), so a
# block of the four-mode tensor (K̂ = 1000) holds 134,217 elements
BLOCK_VALUES = 1 << 27


def _kron_rows(coords: torch.Tensor, values: torch.Tensor, factors,
               mode: int, precision: str) -> torch.Tensor:
    """val * kron(F_j[c_j] for j != mode), one row per element.

    ``precision="bf16"`` is the lower-precision control: the scaled leading
    rows and the last factor's rows rounded to bfloat16, each product
    rounded to bfloat16."""
    other = [j for j in range(coords.shape[1]) if j != mode]
    *lead, last = other
    a = values[:, None].to(F64)
    for j in lead:
        rows = factors[j].index_select(0, coords[:, j])
        a = (a[:, :, None] * rows[:, None, :]).reshape(a.shape[0], -1)
    b = factors[last].index_select(0, coords[:, last])
    if precision == "bf16":
        a = a.to(torch.bfloat16)
        b = b.to(torch.bfloat16)
        return (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1).to(F64)
    return (a[:, :, None] * b[:, None, :]).reshape(a.shape[0], -1)


def penultimate(coords: torch.Tensor, values: torch.Tensor,
                factors: Sequence[torch.Tensor], mode: int, rows: int,
                order: torch.Tensor | None = None,
                precision: str = "f64") -> torch.Tensor:
    """Z_(mode) in float64 (``rows`` x K̂). ``order`` sorts the elements by
    their mode-``mode`` coordinate (computed when not given)."""
    facs = [f.to(F64) for f in factors]
    K = math.prod(int(f.shape[1]) for j, f in enumerate(facs) if j != mode)
    Z = torch.zeros((rows, K), dtype=F64, device=coords.device)
    if order is None:
        order = torch.argsort(coords[:, mode])
    step = max(1, BLOCK_VALUES // max(K, 1))
    for lo in range(0, order.numel(), step):
        idx = order[lo:lo + step]
        c = coords.index_select(0, idx)
        r = c[:, mode]
        # the prefix sum runs along the last dimension, over the elements
        # (a scan along the first would walk each column alone)
        contrib = _kron_rows(c, values.index_select(0, idx), facs, mode,
                             precision).T.contiguous()
        starts = torch.ones(r.numel(), dtype=torch.bool, device=r.device)
        starts[1:] = r[1:] != r[:-1]
        head = torch.nonzero(starts).squeeze(1)
        ends = torch.cat([head[1:], head.new_tensor([r.numel()])]) - 1
        csum = torch.cumsum(contrib, 1)
        del contrib
        seg = csum[:, ends]
        seg[:, 1:] -= csum[:, ends[:-1]]
        del csum
        Z.index_add_(0, r[head], seg.T)  # distinct rows within a block
    return Z


def _orth(X: torch.Tensor, basis: torch.Tensor | None) -> torch.Tensor:
    for _ in range(2):
        if basis is not None:
            X = X - basis @ (basis.T @ X)
        X, _ = torch.linalg.qr(X)
    return X


def krylov_left(Z: torch.Tensor, start: torch.Tensor, blocks: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(left singular vectors, singular values) of Z Q, Q an orthonormal
    basis of the block Krylov space span{X, (ZᵀZ) X, ..., (ZᵀZ)^(m-1) X}
    of ``blocks`` = m blocks from the start panel X = ``start``."""
    G = Z.T @ Z
    Q = _orth(start.to(F64), None)
    basis = Q
    for _ in range(blocks - 1):
        Q = _orth(G @ Q, basis)
        basis = torch.cat([basis, Q], dim=1)
    W = Z @ basis
    U, S, _ = torch.linalg.svd(W, full_matrices=False)
    return U, S


def step_numbers(F: torch.Tensor, U: torch.Tensor, S: torch.Tensor
                 ) -> dict:
    """How far the program's factor ``F`` (its column space, orthonormalized
    in float64) lies from the reference's step (``krylov_left``'s U, S):

    * ``deficit`` — the share of the leading k singular values' energy of
      Z Q that F misses: 1 - ||Fᵀ Z Q||² / sum_{i<=k} S_i². Second order
      in F's error, and weighted by the gaps of the spectrum, so a pair of
      nearly equal singular values at the k-th place does not swing it;
    * ``angle`` — the sine of the largest angle between F and the leading
      k left singular vectors (first order, but it swings with that gap).
    """
    k = int(F.shape[1])
    Fq, _ = torch.linalg.qr(F.to(F64))
    Uk = U[:, :k]
    top = float(torch.sum(S[:k] ** 2))
    proj = U.T @ Fq  # coordinates of F in the range of Z Q
    got = float(torch.sum((proj * S[:, None]) ** 2))
    resid = Fq - Uk @ (Uk.T @ Fq)
    return {
        "deficit": 1.0 - got / top if top > 0 else 0.0,
        "angle": float(torch.linalg.matrix_norm(resid, ord=2)),
    }


def core_of(F_last: torch.Tensor, Z_last: torch.Tensor, core_dims
            ) -> torch.Tensor:
    """The core G = T x_n F_nᵀ from the last mode's Z (built from the
    other factors) and that mode's factor: G_(N-1) = F_{N-1}ᵀ Z_(N-1),
    folded back to (K_0, ..., K_{N-1})."""
    N = len(core_dims)
    G = F_last.to(F64).T @ Z_last
    G = G.reshape((int(core_dims[-1]),) + tuple(int(k)
                                                  for k in core_dims[:-1]))
    return G.permute(*range(1, N), 0).contiguous()


def fit_of(norm2: float, core: torch.Tensor) -> float:
    """1 - sqrt(||T||² - ||G||²) / ||T||: the fit of orthonormal factors
    with the projection core."""
    g2 = float(torch.sum(core.to(F64) ** 2))
    return 1.0 - math.sqrt(max(norm2 - g2, 0.0)) / (math.sqrt(norm2) + 1e-300)
