"""Dispatch around the port's kernels, as ``src/repro/kernels/ops.py`` is.

Public entry points used by the rest of the port:

  * ``penultimate(coords, values, factors, mode, num_rows)`` — kernel-backed
    counterpart of ``repro_torch.core.ttm.penultimate``;
  * ``penultimate_local`` / ``penultimate_sorted`` — the same for arbitrary
    and for pre-sorted row ids;
  * ``penultimate_local_oracle`` / ``penultimate_sorted_oracle`` — the fused
    build with the first oracle panel product, ``(Z, Z @ X)``;
  * ``oracle_pair(Z, x, y, P)`` — the fused Lanczos oracle, over P stacked
    ranks.

The wrappers prepare the kernel's layout (sort elements by row; for N >= 5
fold the leading Kronecker levels into ``a``) and hand it to the gather
form of the Z-build kernels, which reads each element's coordinates and
gathers the factor rows itself (at N = 4 both leading factors' rows, so no
(E, Ka) array is formed). The kernel wrappers choose by device: the
plain version for CPU tensors, the CUDA kernel for CUDA tensors. The
reference's VMEM admission gate and its quiet fallback to the plain path
are gone: the CUDA kernel takes every shape on the path.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import tracing

from .kron_segsum import kron_segsum_gather, kron_segsum_gather2
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


def _lead_a(
    coords: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    lead: Sequence[int],
    cols: Sequence[int] | None = None,
) -> torch.Tensor:
    """a = val * kron(rows of the leading factors), (nnz, Ka); ``cols``
    gives the column of ``coords`` that holds each leading mode (default:
    column j for mode j)."""
    nnz = values.shape[0]
    a = values[:, None]
    for j, col in zip(lead, lead if cols is None else cols):
        rows = factors[j].index_select(0, coords[:, col])
        # explicit width (not -1): must also reshape for nnz == 0
        a = (a[:, :, None] * rows[:, None, :]).reshape(
            nnz, a.shape[1] * rows.shape[1])
    return a.contiguous()


def _split_ab(
    coords: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold modes j != mode into (a, b): a = val * kron(leading rows),
    b = rows of the last non-mode factor (the widest kron level stays in the
    kernel's hot loop). The row form's operands; the main path gathers them
    in the kernel instead (``_gathered``)."""
    *lead, last = [j for j in range(len(factors)) if j != mode]
    b = factors[last].index_select(0, coords[:, last])
    return _lead_a(coords, values, factors, lead), b.contiguous()


def _gathered(coords, values, local_rows, factors, mode, num_rows, X,
              precision):
    """The gather form of the Z-build: with one or two leading factors
    (N = 3, 4) the kernel gathers every factor's rows itself; with more, the
    leading levels are folded into ``a`` here (counted as
    ``zbuild.fold_bytes``) and only the last factor is gathered. ``coords``
    has a column per mode, or one per mode but ``mode`` (``_row_order``'s
    layout from N = 4), since the rows stand for the mode's own."""
    other = [j for j in range(len(factors)) if j != mode]
    *lead, last = other
    col = dict(zip(other, other if coords.shape[1] == len(factors)
                   else range(len(other))))
    rows = local_rows.to(torch.int32).contiguous()
    coords = coords.to(torch.int32).contiguous()
    values = values.to(torch.float32).contiguous()

    def f32(j):
        return factors[j].to(torch.float32).contiguous()

    if len(lead) == 1:
        (j,) = lead
        return kron_segsum_gather(rows, coords, values, f32(j), f32(last),
                                  col[j], col[last], num_rows, X=X,
                                  precision=precision)
    if len(lead) == 2:
        j1, j2 = lead
        return kron_segsum_gather2(rows, coords, values, f32(j1), f32(j2),
                                   f32(last), col[j1], col[j2], col[last],
                                   num_rows, X=X, precision=precision)
    a = _lead_a(coords, values, factors, lead,
                [col[j] for j in lead]).to(torch.float32)
    tracing.count("zbuild.fold_bytes", a.numel() * a.element_size())
    return kron_segsum_gather(rows, coords, None, a, f32(last), None,
                              col[last], num_rows, X=X, precision=precision)


def _row_order(coords, values, local_rows, mode):
    """The elements sorted by row on their device: a stable sort (so reruns
    are bitwise equal) gives the sorted rows and the order. Rows of four or
    more coordinates are taken column by column into one array: PyTorch's
    indexing of whole (E, 4) int32 rows took 34.5 ms at 54.2M elements on an
    H100, by column 12.4 ms (three-coordinate rows, whole: 5.8 ms at
    76.9M). Column by column, ``mode``'s own column is left out (the kernels
    read the rows in its place): one gather fewer, and E int32 less held
    while Z is built."""
    rows, order = torch.sort(local_rows, stable=True)
    N = coords.shape[1]
    if N < 4:
        return coords[order], values[order], rows
    c = coords.new_empty((coords.shape[0], N - 1))
    for i, j in enumerate(j for j in range(N) if j != mode):
        c[:, i] = coords[:, j][order]
    return c, values[order], rows


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
    return _gathered(coords, values, local_rows, factors, mode,
                     num_local_rows, None, precision)


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
    c, v, rows = _row_order(coords, values, local_rows, mode)
    return penultimate_sorted(c, v, rows, factors, mode, num_local_rows,
                              precision=precision)


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
    return _gathered(coords, values, local_rows, factors, mode,
                     num_local_rows, X.contiguous(), precision)


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
    c, v, rows = _row_order(coords, values, local_rows, mode)
    return penultimate_sorted_oracle(c, v, rows, factors, mode,
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
    P: int | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(Z @ x, Zᵀ @ y), with ``P`` stacked ranks each rank's Z_pᵀ y_p: the
    kernel for CUDA tensors, the plain version for CPU tensors. A None
    operand gives a None product."""
    return _oracle_pair_kernel(Z, x, y, P)
