"""TTM-chain via the per-element Kronecker reformulation (paper §3 + App. A).

The port of ``src/repro/core/ttm.py``, with the same conventions:

* ``unfold(T, n)`` = ``T.movedim(n, 0).reshape(L_n, -1)`` — columns are
  C-order flattenings of the remaining modes in increasing mode order
  (largest remaining mode varies fastest).
* The matching per-element contribution is
  ``contr_n(e) = val(e) * kron(F_{j1}[l_{j1}], ..., F_{jr}[l_{jr}])`` with
  ``j1 < ... < jr`` the modes != n (second kron operand fastest).

``kron_contributions``/``penultimate``/``penultimate_local`` are the plain
formulations (they materialise (nnz, K̂)). ``core_from_factors`` is not: it
builds the core from the Z-build of mode 0, which runs the kernel on the
card, so the (nnz, ∏K) intermediate of the reference never exists.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import tracing

__all__ = [
    "unfold",
    "fold",
    "dense_ttm",
    "dense_ttm_chain",
    "kron_contributions",
    "penultimate",
    "penultimate_local",
    "core_from_factors",
]


def unfold(T: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-n unfolding, L_n x prod(other)."""
    return T.movedim(mode, 0).reshape(T.shape[mode], -1)


def fold(M: torch.Tensor, mode: int, shape: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`unfold`."""
    shape = list(shape)
    rest = [shape[j] for j in range(len(shape)) if j != mode]
    T = M.reshape([shape[mode]] + rest)
    return T.movedim(0, mode)


def dense_ttm(T: torch.Tensor, mode: int, A: torch.Tensor) -> torch.Tensor:
    """T x_mode A  (A: K x L_mode). Dense oracle."""
    moved = T.movedim(mode, -1)
    out = torch.tensordot(moved, A.T, dims=([-1], [0]))
    return out.movedim(-1, mode)


def dense_ttm_chain(T: torch.Tensor,
                    mats: dict[int, torch.Tensor]) -> torch.Tensor:
    """Apply T x_j mats[j] for every j in mats (commutative, paper §2.1)."""
    out = T
    for j in sorted(mats):
        out = dense_ttm(out, j, mats[j])
    return out


def kron_contributions(
    coords: torch.Tensor,  # (nnz, N) int
    values: torch.Tensor,  # (nnz,)
    factors: Sequence[torch.Tensor],  # F_j: (L_j, K_j)
    mode: int,
) -> torch.Tensor:
    """contr_n(e) for every element: (nnz, K_hat_n), built by successive
    outer products in increasing mode order (C-order convention)."""
    nnz = values.shape[0]
    cur = values[:, None]
    for j in range(len(factors)):
        if j == mode:
            continue
        rows = factors[j].index_select(0, coords[:, j])
        cur = (cur[:, :, None] * rows[:, None, :]).reshape(
            nnz, cur.shape[1] * rows.shape[1])
    return cur


def penultimate(
    coords: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_rows: int,
) -> torch.Tensor:
    """Global penultimate matrix Z_(n): (L_n, K_hat_n), eq. (1) of the paper."""
    return penultimate_local(coords, values, coords[:, mode], factors, mode,
                             num_rows)


def penultimate_local(
    coords: torch.Tensor,
    values: torch.Tensor,
    local_rows: torch.Tensor,  # (nnz,) row ids in [0, num_local_rows)
    factors: Sequence[torch.Tensor],
    mode: int,
    num_local_rows: int,
) -> torch.Tensor:
    """Local copy Z^p with rows given by ``local_rows`` (paper §3)."""
    contribs = kron_contributions(coords, values, factors, mode)
    out = torch.zeros((num_local_rows, contribs.shape[1]),
                      dtype=contribs.dtype, device=contribs.device)
    return out.index_add_(0, local_rows.long(), contribs)


def core_from_factors(
    coords: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
) -> torch.Tensor:
    """Core G = T x_1 F_1^T x_2 ... x_N F_N^T  (paper Fig 2 last step).

    The mode-0 unfolding of G is F_0ᵀ Z_(0), with Z_(0) the penultimate
    matrix of mode 0; reshaping its C-order columns gives (K_1, ..., K_N).
    Z_(0) comes from the same Z-build as the mode steps (the CUDA kernel on
    the card, f32), so the work is one pass over the elements and the
    (nnz, ∏K) intermediate is never formed.
    """
    from repro_torch.kernels import ops

    with tracing.span("zbuild", device=coords.is_cuda):
        Z0 = ops.penultimate(coords, values, factors, 0,
                             int(factors[0].shape[0]))
    G0 = factors[0].T @ Z0
    return G0.reshape(tuple(int(f.shape[1]) for f in factors))
