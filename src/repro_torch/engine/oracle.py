"""Oracle stage: how a mode step answers the Lanczos products for its Z.

The port of ``src/repro/engine/oracle.py``'s vector path. The SVD component
only consumes Z through ``Z @ x`` and ``Zᵀ @ y`` (paper §3):

* ``fused=False`` — plain ``torch.matmul`` products, as the reference leaves
  them to XLA.
* ``fused=True`` — the ``oracle_pair`` kernel. GK's two products of one
  iteration depend on each other (u = f(Z v) before Zᵀ u), so each call
  asks for one product and leaves the other operand out (None). The
  reference passes a zero companion instead and discards its product; the
  results are the same, and either way it is one pass of Z per product.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.lanczos import gk_bidiag, svd_from_bidiag
from repro_torch.kernels import ops as kernel_ops
from repro_torch.random import Key

__all__ = ["z_products", "solve_oracle"]


def z_products(Z: torch.Tensor, *,
               fused: bool = False) -> tuple[Callable, Callable]:
    """(matvec, rmatvec) for an explicit Z. Both accept width-``s`` panels
    as well as vectors."""
    if not fused:
        # the vector rmatvec keeps the reference's ``y @ Z`` contraction
        return ((lambda x: Z @ x),
                (lambda y: y @ Z if y.dim() == 1 else Z.T @ y))

    def matvec(x):
        return kernel_ops.oracle_pair(Z, x.contiguous(), None)[0]

    def rmatvec(y):
        return kernel_ops.oracle_pair(Z, None, y.contiguous())[1]

    return matvec, rmatvec


def solve_oracle(
    matvec: Callable,
    rmatvec: Callable,
    dim_u: int,
    ncols: int,
    k: int,
    niter: int,
    key: Key,
    axis: str | None = None,
    *,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Leading-k left singular vectors of the oracle: one GK sweep plus the
    small-SVD projection."""
    U, B = gk_bidiag(matvec, rmatvec, dim_u, ncols, niter, key, axis=axis,
                     device=device)
    return svd_from_bidiag(U, B, k, key, axis=axis)
