"""Plain PyTorch versions of the port's CUDA kernels.

Each wrapper (``kron_segsum.py``, ``oracle_fused.py``) takes these for a
tensor that lies on the CPU; ``chip_smoke.py`` holds each kernel against
them on the card. They follow the reference's ``src/repro/kernels/ref.py``.
"""

from __future__ import annotations

import torch

__all__ = ["kron_segsum_ref", "kron_segsum_oracle_ref", "oracle_pair_ref"]


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
    Z: torch.Tensor,  # (R, Khat)
    x: torch.Tensor | None,  # (Khat,) or (Khat, s) panel
    y: torch.Tensor | None,  # (R,) or (R, s) panel
) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The Lanczos oracle pair: (Z @ x, Z.T @ y); a None operand gives a
    None product."""
    return (None if x is None else Z @ x), (None if y is None else Z.T @ y)
