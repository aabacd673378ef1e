"""Mode steps composed from the engine stages.

The port of ``src/repro/engine/steps.py::local_mode_step``, vector branch:
a HOOI mode step is the **Z-build** (``engine.zbuild``) followed by the
**oracle** (``engine.oracle``: the Z products and the one Lanczos body),
with the identity partition. This is what ``repro_torch.core.hooi`` runs.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch

from repro_torch.core.lanczos import lanczos_niter
from repro_torch.random import Key

from .oracle import solve_oracle, z_products
from .zbuild import build_local_z

__all__ = ["local_mode_step"]


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def local_mode_step(
    coords: torch.Tensor,
    values: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_rows: int,
    key: Key,
    *,
    k: int | None = None,
    niter: int | None = None,
    use_fused_oracle: bool = False,
    precision: str = "f32",
    timings: dict | None = None,
) -> torch.Tensor:
    """One single-process mode step; returns the refined factor (num_rows, k).

    ``timings`` (optional) accumulates blocking per-phase wall times under
    ``"ttm"``/``"svd"``. ``niter`` is clamped as the reference's
    ``lanczos_bidiag`` clamps it.
    """
    k = int(factors[mode].shape[1]) if k is None else int(k)
    Khat = 1
    for j, f in enumerate(factors):
        if j != mode:
            Khat *= int(f.shape[1])
    t0 = time.perf_counter()
    Z = build_local_z(coords, values, coords[:, mode], factors, mode,
                      num_rows, sorted_rows=False, precision=precision)
    if timings is not None:
        _sync(Z)
    t1 = time.perf_counter()
    matvec, rmatvec = z_products(Z, fused=use_fused_oracle)
    if niter is None:
        niter = lanczos_niter(k, num_rows, Khat)
    else:
        niter = max(int(min(niter, num_rows, Khat)),
                    min(k, num_rows, Khat))
    left, _S = solve_oracle(matvec, rmatvec, num_rows, Khat, k, niter, key,
                            device=Z.device)
    if timings is not None:
        _sync(left)
        t2 = time.perf_counter()
        timings["ttm"] = timings.get("ttm", 0.0) + (t1 - t0)
        timings["svd"] = timings.get("svd", 0.0) + (t2 - t1)
    return left
