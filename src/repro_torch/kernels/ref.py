"""Plain PyTorch versions of the port's CUDA kernels.

Each wrapper (``kron_segsum.py``, ``oracle_fused.py``) takes these for a
tensor that lies on the CPU; ``chip_smoke.py`` holds each kernel against
them on the card. They follow the reference's ``src/repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch

__all__ = ["kron_segsum_ref", "kron_segsum_oracle_ref", "kron_segsum_gather_ref",
           "oracle_pair_ref"]


def kron_segsum_ref(
    rows: torch.Tensor,  # (E,) int — row ids in [0, num_rows)
    a: torch.Tensor,  # (E, Ka) float — element values folded in
    b: torch.Tensor,  # (E, Kb) float
    num_rows: int,
    precision: str = "f32",
) -> torch.Tensor:
    """Z[r] = sum_{e: rows[e]=r} kron(a[e], b[e]) — the TTM hot loop.

    Returns (num_rows, Ka*Kb) float32. C-order kron: b varies fastest.
    ``precision="bf16"`` is the kernel's mixed-precision contract: operands
    rounded to bf16, each product rounded to bf16, f32 accumulation.
    """
    E, Ka = a.shape
    Kb = b.shape[1]
    if precision == "bf16":
        a = a.to(torch.bfloat16)
        b = b.to(torch.bfloat16)
    contribs = (a[:, :, None] * b[:, None, :]).reshape(E, Ka * Kb)
    contribs = contribs.to(torch.float32)
    out = torch.zeros((num_rows, Ka * Kb), dtype=torch.float32,
                      device=contribs.device)
    return out.index_add_(0, rows.long(), contribs)


def kron_segsum_gather_ref(
    rows: torch.Tensor,
    coords: torch.Tensor,
    values: torch.Tensor | None,
    lead: torch.Tensor,
    last: torch.Tensor,
    lead_col: int | None,
    last_col: int,
    num_rows: int,
    precision: str = "f32",
) -> torch.Tensor:
    """``kron_segsum`` with the factor rows gathered per element:
    ``a = values * lead[coords[:, lead_col]]`` (one f32 multiply per
    entry), or ``lead`` itself when ``lead_col`` is None, and
    ``b = last[coords[:, last_col]]``."""
    if lead_col is None:
        a = lead
    else:
        a = values[:, None] * lead.index_select(0, coords[:, lead_col].long())
    b = last.index_select(0, coords[:, last_col].long())
    return kron_segsum_ref(rows, a, b, num_rows, precision)


def kron_segsum_gather2_ref(
    rows: torch.Tensor,
    coords: torch.Tensor,
    values: torch.Tensor,
    F1: torch.Tensor,
    F2: torch.Tensor,
    last: torch.Tensor,
    c1: int,
    c2: int,
    last_col: int,
    num_rows: int,
    precision: str = "f32",
) -> torch.Tensor:
    """``kron_segsum_gather_ref`` with two leading factors:
    ``a = kron(values * F1[coords[:, c1]], F2[coords[:, c2]])``, formed in
    that order (as ``ops._lead_a`` forms it)."""
    a1 = values[:, None] * F1.index_select(0, coords[:, c1].long())
    a2 = F2.index_select(0, coords[:, c2].long())
    a = (a1[:, :, None] * a2[:, None, :]).reshape(
        a1.shape[0], a1.shape[1] * a2.shape[1])
    return kron_segsum_gather_ref(rows, coords, None, a, last, None, last_col,
                                  num_rows, precision)


def kron_segsum_oracle_ref(
    rows: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    num_rows: int,
    X: torch.Tensor,  # (Ka*Kb, s)
    precision: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused build + first oracle product: ``(Z, Z @ X)``."""
    Z = kron_segsum_ref(rows, a, b, num_rows, precision)
    return Z, Z @ X


def oracle_pair_ref(
    Z: torch.Tensor,  # (P*R, Khat)
    x: torch.Tensor | None,  # (Khat,) or (Khat, s) panel
    y: torch.Tensor | None,  # (R[, s]), or with P: (P, R[, s])
    P: int | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The Lanczos oracle pair: (Z @ x, Zᵀ @ y); a None operand gives a
    None product. With ``P`` stacked ranks, the second product is each
    rank's ``Z_pᵀ y_p``, ``(P, Khat[, s])``, taken rank by rank exactly as
    a single call on that rank's rows takes it."""
    xo = None if x is None else Z @ x
    if y is None:
        return xo, None
    if P is None:
        return xo, Z.T @ y
    Zs = Z.view(int(P), -1, Z.shape[1])
    return xo, torch.stack([Zp.T @ yp for Zp, yp in zip(Zs, y)])
