"""Randomized range-finder sketches for the oracle SVD + adaptive rank.

The port of ``src/repro/core/sketch.py``. The paper's SVD component spends
``2*K`` full GK iterations per mode per sweep (§7.1). A Halko-style
randomized range finder recovers the leading subspace of Z in one or two
passes: sample ``Y = Z @ Ω`` for a random test matrix Ω, orthonormalize,
optionally power-iterate. This module supplies

* the test matrices (``test_matrix``: Gaussian and SRHT) and a standalone
  ``range_finder`` that computes ``(Z, Z·Ω)`` in one element pass through
  ``engine.zbuild.build_local_z_oracle`` (the ``kron_segsum_oracle`` kernel
  on the card);
* the *factor-seeded* start panel of the engine's warm start
  (``warm_start="sketch"``): ``qr(Zᵀ F_n[:, :s])``, one step of subspace
  iteration from the previous factors, so Lanczos only refines;
* ``sketch_niter`` — the reduced refinement budget, ``min(k, …)`` Krylov
  directions instead of full GK's ``min(2k, …)``;
* ``adapt_rank`` — the tail-spectrum rank policy (numpy, the reference's).

The random draws go through the port's seam (``repro_torch.random``) along
the reference's paths: the SRHT's ``split`` children (sign, selection) and
the start panel's ``fold_in(key, 41)``. The small QR and SVD factorizations
run on the host (LAPACK), as the port's other small factorizations do, so
card and CPU runs share signs.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.graphs import host_call
from repro_torch.random import Key

__all__ = ["DEFAULT_POWER_ITERS", "SKETCH_KINDS", "test_matrix",
           "sketch_niter", "sketch_block_size", "seeded_start_panel",
           "power_refine", "range_finder", "adapt_rank"]

# one power iteration on top of the factor seed: the seed is already a
# subspace-iteration step at sweep > 0, so a single extra pass suffices to
# sharpen the sweep-0 (purely random) case without inflating pass counts
DEFAULT_POWER_ITERS = 1

SKETCH_KINDS = ("gauss", "srht")


def _host_qr(a: torch.Tensor) -> torch.Tensor:
    """Reduced Q of ``a``, factored on the host and returned row-major on
    ``a``'s device (the layout the oracle kernels read)."""
    return host_call(_qr_rowmajor, a)


def _qr_rowmajor(a: torch.Tensor) -> torch.Tensor:
    q, _ = torch.linalg.qr(a)
    return q.contiguous()


def _fwht(x: torch.Tensor) -> torch.Tensor:
    """Fast Walsh–Hadamard transform along axis 0 (length a power of two)."""
    m = x.shape[0]
    h = 1
    while h < m:
        x = x.reshape(m // (2 * h), 2, h, -1)
        x = torch.cat([x[:, 0] + x[:, 1], x[:, 0] - x[:, 1]], dim=1)
        x = x.reshape(m, -1)
        h *= 2
    return x


def test_matrix(key: Key, n: int, s: int, kind: str = "gauss",
                device: str | torch.device = "cpu") -> torch.Tensor:
    """Random test matrix Ω (n, s) for sketching: ``Y = Z @ Ω``.

    ``gauss`` is the dense Gaussian sketch (the draw of ``key``). ``srht``
    is the subsampled randomized Hadamard transform: ``key.split()`` gives
    the sign and the selection children; ``s`` columns of the next power of
    two are chosen without replacement, mixed by a Walsh–Hadamard transform,
    truncated to ``n`` rows and given random signs. Every consumer
    orthonormalizes, so no ``sqrt(n/s)`` scale is applied.
    """
    if kind not in SKETCH_KINDS:
        raise ValueError(f"unknown sketch kind {kind!r} "
                         f"(expected one of {SKETCH_KINDS})")
    if kind == "gauss":
        return key.normal((n, s), device)
    m = 1 << max(int(n) - 1, 1).bit_length()
    k_sign, k_sel = key.split()
    cols = k_sel.choice(m, s, device)
    onehot = torch.zeros((m, s), dtype=torch.float32, device=device)
    onehot[cols, torch.arange(s, device=device)] = 1.0
    H_s = _fwht(onehot)[:n]
    signs = torch.where(k_sign.bernoulli(0.5, (n, 1), device), 1.0, -1.0)
    return signs.to(torch.float32) * H_s


def sketch_niter(k: int, nrows: int, ncols: int, block_size: int = 1) -> int:
    """Refinement budget for a sketch-warm-started block GK driver:
    ``min(k, nrows, ncols)`` Krylov directions (half of full GK's), counted
    in block iterations exactly like ``lanczos_niter``."""
    base = max(int(min(k, nrows, ncols)), 1)
    if block_size <= 1:
        return base
    s = min(int(block_size), base)
    return -(-base // s)


def sketch_block_size(k: int, nrows: int, ncols: int,
                      block_size: int = 1) -> int:
    """Panel width for a sketch-warm-started block driver: at least ``k``
    (the factor seed must span the mode's whole previous subspace), clamped
    by the operator's vector budget like ``effective_block_size``."""
    from repro_torch.core.lanczos import effective_block_size

    return effective_block_size(k, nrows, ncols,
                                max(int(block_size), int(k)))


def seeded_start_panel(seed: torch.Tensor, key: Key, ncols: int,
                       block_size: int) -> torch.Tensor:
    """Orthonormal (ncols, s) start panel from a factor-seeded sketch.

    ``seed`` is the v-space sketch ``Zᵀ F[:, :w]`` (summed over the ranks
    already). A panel wider than the seed (``s > w``) is filled with normals
    drawn at ``key.fold_in(41)``.
    """
    s = int(block_size)
    w = int(seed.shape[1])
    key41 = key.fold_in(41)

    def panel(host: torch.Tensor) -> torch.Tensor:
        if w < s:
            extra = key41.normal((ncols, s - w), "cpu")
            host = torch.cat([host, extra.to(host.dtype)], dim=1)
        return _qr_rowmajor(host[:, :s])

    return host_call(panel, seed)


def power_refine(matvec: Callable, rmatvec: Callable, panel: torch.Tensor,
                 iters: int) -> torch.Tensor:
    """Subspace (power) iteration on a v-space panel through the oracle:
    one matvec and one rmatvec pass over Z per iteration, then a QR."""
    q = panel
    for _ in range(int(iters)):
        q = _host_qr(rmatvec(matvec(q)))
    return q


def range_finder(
    coords: torch.Tensor,
    values: torch.Tensor,
    local_rows: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_rows: int,
    k: int,
    key: Key,
    *,
    kind: str = "gauss",
    oversample: int = 4,
    power_iters: int = 0,
    sorted_rows: bool = False,
    precision: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Randomized range finder for one mode's penultimate matrix.

    Draws Ω (K_hat, k + oversample), computes ``(Z, Z @ Ω)`` in one fused
    element pass (``build_local_z_oracle``), orthonormalizes, optionally
    power-iterates, and resolves the small projected SVD (on the host).
    Returns ``(U_k, sv_est)``: the leading left subspace and the sketch's
    spectrum estimate. The reference's ``use_kernel`` is absent: the device
    decides the Z-build.
    """
    from repro_torch.engine.zbuild import build_local_z_oracle

    khat = 1
    for i, f in enumerate(factors):
        if i != mode:
            khat *= int(f.shape[1])
    s = max(1, min(int(k) + int(oversample), int(num_rows), khat))
    omega = test_matrix(key, khat, s, kind, values.device)
    Z, Y = build_local_z_oracle(
        coords, values, local_rows, factors, mode, num_rows, omega,
        sorted_rows=sorted_rows, precision=precision)
    Q = _host_qr(Y)
    for _ in range(int(power_iters)):
        Q = _host_qr(Z @ (Z.T @ Q))
    B = Q.T @ Z
    Ub, sv, _ = torch.linalg.svd(B.cpu(), full_matrices=False)
    kk = min(int(k), s)
    return Q @ Ub[:, :kk].to(Q.device), sv[:kk].to(Q.device)


def adapt_rank(
    spectrum,
    k: int,
    *,
    grow_thresh: float = 0.15,
    shrink_thresh: float = 0.02,
    grow_step: int = 2,
    k_min: int = 2,
    k_max: int | None = None,
) -> int:
    """Tail-spectrum rank policy: the next ``R_n`` for one mode.

    ``spectrum`` is the mode's (estimated) leading singular values. Ratios
    are relative to ``σ_1``: an energetic retained tail (``σ_k/σ_1 >
    grow_thresh``) grows the rank by ``grow_step``; collapsed trailing
    values (``σ_j/σ_1 < shrink_thresh``) shrink it to the number of
    energetic columns; otherwise ``k`` stays. The result is clamped to
    ``[k_min, k_max]`` and, for fixed ``k``, is monotone non-decreasing in
    every ratio ``σ_j/σ_1``.
    """
    k = int(k)
    s = np.asarray(spectrum, dtype=float).ravel()[:k]
    hi = k if k_max is None else int(k_max)
    lo = min(int(k_min), hi)
    if s.size == 0 or not np.isfinite(s[0]) or s[0] <= 0.0:
        return min(max(k, lo), hi)
    rel = s / s[0]
    if rel[-1] > grow_thresh:
        k_new = k + int(grow_step)
    else:
        k_new = int(np.sum(rel >= shrink_thresh))
    return min(max(k_new, lo), hi)
