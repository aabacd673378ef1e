"""Matrix-free Lanczos (Golub–Kahan) bidiagonalization for the SVD step.

The port of the vector driver of ``src/repro/core/lanczos.py``. The method
only asks for the two products ``Z @ x`` and ``y @ Z`` (paper §3 'SVD
Component'); callers supply them as closures. Per the paper (§7.1, after
SLEPc), ``2*K`` bidiagonalization iterations serve K requested singular
vectors, with full two-pass reorthogonalization to keep float32 stable.

The reference's ``fori_loop`` is a Python loop here, and every data-dependent
choice (lucky-breakdown restarts) is a ``torch.where`` on device scalars, so
the loop never waits for the device. The random draws (start vector, restart
directions, completion columns) come from ``key`` along the reference's
``fold_in`` chain (``repro_torch.random``). Only the replicated u-space
(``axis=None``) is in this slice; the sharded one comes with the
distributed path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.random import Key, make_key

__all__ = ["LanczosResult", "lanczos_bidiag", "svd_via_lanczos",
           "gk_bidiag", "svd_from_bidiag", "lanczos_niter",
           "effective_block_size"]

_EPS = 1e-30


class LanczosResult(NamedTuple):
    left_vectors: torch.Tensor  # (nrows, k) leading left singular vectors
    singular_values: torch.Tensor  # (k,)
    n_queries: int  # oracle queries consumed (Q_n in the paper)


def _replicated_only(axis) -> None:
    if axis is not None:
        raise NotImplementedError(
            "a sharded u-space (axis=...) belongs to the distributed main "
            "path, ROADMAP Queue A item 6")


def lanczos_niter(k: int, nrows: int, ncols: int, block_size: int = 1) -> int:
    """The paper/SLEPc iteration count, clamped to the operator's rank cap
    (in block iterations when ``block_size > 1``)."""
    base = int(min(2 * k, nrows, ncols))
    if block_size <= 1:
        return base
    s = min(int(block_size), max(base, 1))
    return -(-base // s)


def effective_block_size(k: int, nrows: int, ncols: int,
                         block_size: int) -> int:
    """Clamp a requested panel width to the operator's vector-iteration
    budget."""
    base = lanczos_niter(k, nrows, ncols)
    return max(1, min(int(block_size), base))


def _reorth(u: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    # CGS2 ("twice is enough"); zero columns of the preallocated basis
    # contribute nothing, so the full fixed-shape product is safe
    for _ in range(2):
        u = u - basis @ (basis.T @ u)
    return u


def gk_bidiag(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    dim_u: int,
    ncols: int,
    niter: int,
    key: Key,
    axis: str | None = None,
    *,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The GK bidiagonalization body. Returns ``(U, B)`` with ``B`` upper
    bidiagonal: ``Z V = U B``. ``device`` is where the oracle's vectors
    live (default: the card)."""
    _replicated_only(axis)
    dev = resolve_device(device)
    f32 = torch.float32
    V = torch.zeros((ncols, niter), dtype=f32, device=dev)
    U = torch.zeros((dim_u, niter), dtype=f32, device=dev)
    alphas = torch.zeros((niter,), dtype=f32, device=dev)
    betas = torch.zeros((niter,), dtype=f32, device=dev)

    r_u = key.fold_in(17).normal((dim_u, niter), dev)  # breakdown restarts
    r_v = key.fold_in(29).normal((ncols, niter), dev)
    v = key.fold_in(3).normal((ncols,), dev)
    v = v / (torch.linalg.norm(v) + _EPS)

    u_prev = torch.zeros((dim_u,), dtype=f32, device=dev)
    beta_prev = torch.zeros((), dtype=f32, device=dev)
    scale = torch.full((), _EPS, dtype=f32, device=dev)
    for i in range(niter):
        V[:, i] = v
        u = matvec(v) - beta_prev * u_prev
        u = _reorth(u, U)
        alpha = torch.sqrt(torch.sum(u * u))
        scale = torch.maximum(scale, alpha)
        # Lucky breakdown: restart with a fresh direction, record alpha = 0
        # so the restart never mixes into the computed singular vectors.
        ok = alpha > 1e-6 * scale
        u_new = _reorth(r_u[:, i], U)
        u_new = u_new / (torch.sqrt(torch.sum(u_new * u_new)) + _EPS)
        u = torch.where(ok, u / (alpha + _EPS), u_new)
        alpha = torch.where(ok, alpha, 0.0)
        U[:, i] = u
        alphas[i] = alpha

        w = rmatvec(u) - alpha * v
        w = _reorth(w, V)
        beta = torch.linalg.norm(w)
        scale = torch.maximum(scale, beta)
        ok_b = beta > 1e-6 * scale
        v_new = _reorth(r_v[:, i], V)
        v_new = v_new / (torch.linalg.norm(v_new) + _EPS)
        v = torch.where(ok_b, w / (beta + _EPS), v_new)
        beta = torch.where(ok_b, beta, 0.0)
        betas[i] = beta
        u_prev, beta_prev = u, beta

    # Z V = U B with B *upper* bidiagonal: alphas on the diagonal, betas on
    # the superdiagonal (Z v_{i+1} = beta_i u_i + alpha_{i+1} u_{i+1}).
    B = torch.diag(alphas) + torch.diag(betas[:-1], 1)
    return U, B


def _complete_columns(left: torch.Tensor, m: int, key: Key,
                      axis: str | None) -> torch.Tensor:
    """Append ``m`` orthonormal columns to ``left`` (rank-deficient edge),
    column by column with CGS2."""
    _replicated_only(axis)
    extra = key.fold_in(1).normal((left.shape[0], m), left.device)
    basis = left
    for j in range(m):
        c = extra[:, j]
        for _ in range(2):
            c = c - basis @ (basis.T @ c)
        c = c / (torch.sqrt(torch.sum(c * c)) + _EPS)
        basis = torch.cat([basis, c[:, None]], dim=1)
    return basis


def svd_from_bidiag(
    U: torch.Tensor,
    B: torch.Tensor,
    k: int,
    key: Key,
    axis: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Left singular vectors from the GK output: SVD of the small bidiagonal
    matrix, projected through U, completed to ``k`` orthonormal columns when
    the iteration count could not reach ``k`` (rank-deficient operators).

    The (niter, niter) SVD runs on the host (LAPACK) whatever ``U``'s
    device: singular vectors are defined up to sign, and a sign flip here
    flips columns of the next mode's Z and so changes its Krylov space. One
    routine keeps card and CPU runs on the same trajectory, and the matrix
    is at most a few dozen wide.
    """
    _replicated_only(axis)
    P, S, _ = torch.linalg.svd(B.cpu(), full_matrices=False)
    P, S = P.to(U.device), S.to(U.device)
    niter = int(B.shape[0])
    kk = min(k, niter)
    left = U @ P[:, :kk]
    if kk < k:
        left = _complete_columns(left, k - kk, key, axis)
        S = torch.cat([S[:kk], torch.zeros((k - kk,), dtype=S.dtype,
                                           device=S.device)])
    return left, S[:k]


def lanczos_bidiag(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    rmatvec: Callable[[torch.Tensor], torch.Tensor],
    nrows: int,
    ncols: int,
    k: int,
    niter: int | None = None,
    key: Key | None = None,
    *,
    device: str | torch.device | None = None,
) -> LanczosResult:
    """Leading-k left singular vectors of the oracle matrix Z.

    matvec : x (ncols,) -> Z @ x (nrows,)
    rmatvec: u (nrows,) -> Z.T @ u (ncols,)
    """
    if key is None:
        key = make_key(0)
    if niter is None:
        niter = lanczos_niter(k, nrows, ncols)
    else:
        niter = int(min(niter, nrows, ncols))
        niter = max(niter, min(k, nrows, ncols))
    U, B = gk_bidiag(matvec, rmatvec, nrows, ncols, niter, key, axis=None,
                     device=device)
    left, S = svd_from_bidiag(U, B, k, key, axis=None)
    return LanczosResult(left, S, n_queries=2 * niter)


def svd_via_lanczos(Z: torch.Tensor, k: int, key: Key | None = None,
                    niter: int | None = None) -> LanczosResult:
    """Convenience wrapper: explicit (single-rank) Z, on Z's device."""
    return lanczos_bidiag(
        lambda x: Z @ x,
        lambda u: Z.T @ u,
        Z.shape[0],
        Z.shape[1],
        k,
        niter=niter,
        key=key,
        device=Z.device,
    )
