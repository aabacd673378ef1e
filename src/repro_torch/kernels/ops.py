"""Dispatch around the port's kernels, as ``src/repro/kernels/ops.py`` is.

Public entry points used by the rest of the port:

  * ``penultimate(coords, values, factors, mode, num_rows)`` — kernel-backed
    counterpart of ``repro_torch.core.ttm.penultimate``;
  * ``penultimate_local`` / ``penultimate_sorted`` — the same for arbitrary
    and for pre-sorted row ids;
  * ``penultimate_local_oracle`` / ``penultimate_sorted_oracle`` — the fused
    build with the first oracle panel product, ``(Z, Z @ X)``;
  * ``oracle_pair(Z, x, y)`` — the fused Lanczos oracle.

The wrappers prepare the kernel's layout (fold the leading Kronecker levels
into ``a``, sort elements by row) and hand it to the kernel wrappers, which
choose by device: the plain version for CPU tensors, the CUDA kernel for
CUDA tensors. The reference's VMEM admission gate and its quiet fallback
to the plain path are gone: the CUDA kernel takes every shape on the path.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .kron_segsum import kron_segsum, kron_segsum_oracle
from .oracle_fused import oracle_pair as _oracle_pair_kernel

__all__ = ["penultimate", "penultimate_local", "penultimate_sorted",
           "penultimate_local_oracle", "penultimate_sorted_oracle",
           "oracle_pair", "split_kron_dims"]


def split_kron_dims(core_dims: Sequence[int], mode: int) -> tuple[int, int]:
    """(Ka, Kb) that ``_split_ab`` will produce for these factor widths:
    b takes the last non-mode factor's width, a the product of the rest."""
    other = [j for j in range(len(core_dims)) if j != mode]
    *lead, last = other
    Ka = 1
    for j in lead:
        Ka *= int(core_dims[j])
    return Ka, int(core_dims[last])


def _split_ab(
    coords: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold modes j != mode into (a, b): a = val * kron(leading rows),
    b = rows of the last non-mode factor (the widest kron level stays in the
    kernel's hot loop)."""
    other = [j for j in range(len(factors)) if j != mode]
    *lead, last = other
    nnz = values.shape[0]
    a = values[:, None]
    for j in lead:
        rows = factors[j].index_select(0, coords[:, j])
        # explicit width (not -1): must also reshape for nnz == 0
        a = (a[:, :, None] * rows[:, None, :]).reshape(
            nnz, a.shape[1] * rows.shape[1])
    b = factors[last].index_select(0, coords[:, last])
    return a.contiguous(), b.contiguous()


def penultimate_sorted(
    coords: torch.Tensor,
    values: torch.Tensor,
    local_rows: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_local_rows: int,
    *,
    precision: str = "f32",
) -> torch.Tensor:
    """Z for elements already sorted by ``local_rows`` (ascending)."""
    a, b = _split_ab(coords, values, factors, mode)
    return kron_segsum(local_rows.to(torch.int32).contiguous(),
                       a.to(torch.float32), b.to(torch.float32),
                       num_local_rows, precision=precision)


def penultimate_local(
    coords: torch.Tensor,
    values: torch.Tensor,
    local_rows: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_local_rows: int,
    *,
    precision: str = "f32",
) -> torch.Tensor:
    """Z for row ids in any order: a stable sort on the tensors' device puts
    them in the kernel's order (stable, so reruns are bitwise equal)."""
    order = torch.argsort(local_rows, stable=True)
    return penultimate_sorted(
        coords[order], values[order], local_rows[order], factors, mode,
        num_local_rows, precision=precision)


def penultimate_sorted_oracle(
    coords: torch.Tensor,
    values: torch.Tensor,
    local_rows: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_local_rows: int,
    X: torch.Tensor,  # (K_hat, s) first oracle panel
    *,
    precision: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(Z, Z @ X)`` for elements already sorted by ``local_rows``:
    one ``kron_segsum_oracle`` launch on the card."""
    a, b = _split_ab(coords, values, factors, mode)
    return kron_segsum_oracle(local_rows.to(torch.int32).contiguous(),
                              a.to(torch.float32), b.to(torch.float32),
                              num_local_rows, X.contiguous(),
                              precision=precision)


def penultimate_local_oracle(
    coords: torch.Tensor,
    values: torch.Tensor,
    local_rows: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_local_rows: int,
    X: torch.Tensor,
    *,
    precision: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """``penultimate_sorted_oracle`` for row ids in any order (stable sort
    on the tensors' device first, as ``penultimate_local``)."""
    order = torch.argsort(local_rows, stable=True)
    return penultimate_sorted_oracle(
        coords[order], values[order], local_rows[order], factors, mode,
        num_local_rows, X, precision=precision)


def penultimate(
    coords: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_rows: int,
    *,
    precision: str = "f32",
) -> torch.Tensor:
    """Global Z_(n) (single-rank): rows are the raw mode-n coordinates."""
    return penultimate_local(coords, values, coords[:, mode], factors, mode,
                             num_rows, precision=precision)


def oracle_pair(
    Z: torch.Tensor, x: torch.Tensor | None, y: torch.Tensor | None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(Z @ x, Zᵀ @ y): the kernel for CUDA tensors, the plain version for
    CPU tensors. A None operand gives a None product."""
    return _oracle_pair_kernel(Z, x, y)
