"""The yardstick of the kernels: the H100's published peaks, the operations
and bytes of each operation a sweep runs, and the sweep's structure.

Counts are of the operation's own work, whatever implements it: each input
byte read once and each output byte written once, over the tensor's real
elements and rows (padding slots count nothing, so padding shows as a lower
share). The least time of an operation is the larger of its operations over
the float32 peak and its bytes over the memory bandwidth.

The counts were first written in ``chip_smoke.py`` (``gather_bound_ms``,
``fused_gather_bound_ms``, ``oracle_half_bound_ms``); these are corrected
copies: an element's row id is one of its coordinates and is not read
twice, and the fold of the leading factors at four modes counts as the
operation's own products.
"""

from __future__ import annotations

import math
from typing import Sequence

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS", "least_ms", "zbuild_counts",
           "oracle_counts", "lanczos_shape", "sweep_zbuilds",
           "sweep_oracle_calls"]

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores


def least_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """(least time in ms, the bound that sets it: "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), \
        "bytes" if t_bytes >= t_ops else "operations"


def zbuild_counts(E: int, N: int, Ka: int, Kb: int, rows: int,
                  factor_floats: int, s: int = 0, rows_with_elements: int = 0
                  ) -> tuple[float, float]:
    """One Z-build over ``E`` elements of an ``N``-mode tensor: (flops, bytes).

    Reads each element's ``N`` coordinates and its value once (4 bytes
    each) and the other modes' factors once (``factor_floats``), writes Z
    (``rows`` x ``Ka*Kb`` floats) once. Per element ``Ka*Kb`` multiply-adds
    of the Kronecker row into Z and ``Ka`` products forming the scaled
    leading part (the value times the leading factors' rows; at N >= 4 the
    fold of those factors). The fused form (``s`` > 0) also reads the panel
    X (``Ka*Kb`` x ``s``) once, writes Z @ X (``rows`` x ``s``) once, and
    multiplies each row that holds elements by X.
    """
    K = Ka * Kb
    nbytes = 4 * (E * (N + 1) + factor_floats + rows * K)
    flops = 2 * E * K + E * Ka
    if s:
        nbytes += 4 * (K * s + rows * s)
        flops += 2 * rows_with_elements * K * s
    return float(flops), float(nbytes)


def oracle_counts(R: int, K: int, s: int) -> tuple[float, float]:
    """One Lanczos product, Z @ X or Zᵀ @ Y, with Z ``R`` x ``K`` and a
    panel of ``s`` columns: Z read once, the panel in and the result out
    once: (flops, bytes)."""
    return float(2 * R * K * s), float(4 * (R * K + K * s + R * s))


def _lanczos_niter(k: int, nrows: int, ncols: int, block: int = 1) -> int:
    base = int(min(2 * k, nrows, ncols))
    if block <= 1:
        return base
    s = min(int(block), max(base, 1))
    return -(-base // s)


def lanczos_shape(k: int, nrows: int, ncols: int, block: int,
                  fused_zbuild: bool) -> tuple[int, int, bool]:
    """One mode step's Lanczos: (panel width s, iterations, block driver).

    The paper's iteration count (``2k``, SLEPc's default) clamped by the
    operator's rank, in block iterations of the clamped panel width when
    the block driver runs (a panel wider than 1, or the fused Z-build)."""
    s = max(1, min(int(block), _lanczos_niter(k, nrows, ncols)))
    blockish = fused_zbuild or s > 1
    return s, _lanczos_niter(k, nrows, ncols, s if blockish else 1), blockish


def _khat(core_dims: Sequence[int], mode: int) -> tuple[int, int, int]:
    other = [int(k) for j, k in enumerate(core_dims) if j != mode]
    Kb = other[-1]
    Ka = math.prod(other[:-1])
    return Ka, Kb, Ka * Kb


def sweep_zbuilds(shape, core_dims, nnz: int, block: int,
                  fused_zbuild: bool, z_rows: Sequence[int],
                  rows_with_elements: Sequence[int]) -> list[dict]:
    """The Z-builds of one sweep and its core: per mode step one build
    (fused with the first panel product under ``fused_zbuild``), then the
    core's build of mode 0 over all the elements. ``z_rows[n]`` are the
    rows a mode's build writes (the stacked ranks' real local rows, or
    ``L_n`` in one process)."""
    N = len(shape)
    out = []
    for n in range(N):
        Ka, Kb, K = _khat(core_dims, n)
        s, _, _ = lanczos_shape(int(core_dims[n]), int(shape[n]), K, block,
                                fused_zbuild)
        factor_floats = sum(int(L) * int(k) for j, (L, k)
                            in enumerate(zip(shape, core_dims)) if j != n)
        out.append(dict(kind=f"mode{n}", E=nnz, N=N, Ka=Ka, Kb=Kb,
                        rows=int(z_rows[n]), factor_floats=factor_floats,
                        s=s if fused_zbuild else 0,
                        rows_with_elements=int(rows_with_elements[n])))
    Ka, Kb, _ = _khat(core_dims, 0)
    out.append(dict(kind="core", E=nnz, N=N, Ka=Ka, Kb=Kb,
                    rows=int(shape[0]),
                    factor_floats=sum(int(L) * int(k) for L, k
                                      in zip(shape[1:], core_dims[1:])),
                    s=0, rows_with_elements=0))
    return out


def sweep_oracle_calls(shape, core_dims, block: int, fused_zbuild: bool,
                       z_rows: Sequence[int]) -> list[dict]:
    """The Lanczos products of one sweep, per mode: how many, at which
    panel width, over a Z of ``z_rows[n]`` x K̂ (the fused Z-build computes
    the first Z @ X itself)."""
    out = []
    for n in range(len(shape)):
        _, _, K = _khat(core_dims, n)
        s, niter, blockish = lanczos_shape(int(core_dims[n]), int(shape[n]),
                                           K, block, fused_zbuild)
        calls = 2 * niter - (1 if blockish and fused_zbuild else 0)
        out.append(dict(mode=n, calls=calls, R=int(z_rows[n]), K=K, s=s))
    return out
