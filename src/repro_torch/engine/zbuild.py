"""Z-build stage: the §4.3 TTM hot spot, one implementation for every path.

The port of ``src/repro/engine/zbuild.py``. Each HOOI mode step first
materializes the (local) penultimate matrix
``Z = segment_sum(kron_contributions, rows)``. There is one route, through
``kernels.ops``: the CUDA ``kron_segsum`` kernel for tensors on the card,
its plain version for tensors on the CPU. The device decides, not a flag.
``build_local_z_oracle`` is the fused stage: the ``kron_segsum_oracle``
kernel returns ``(Z, Z @ X)`` for the first block-Lanczos panel X.
``build_group_z`` runs either on each device group of a
``distributed.mesh.RankMesh``: one launch per group over its ranks'
elements, on its device and stream. Each build opens one ``zbuild`` span
(``repro_torch.tracing``), timed on the device where the elements are on
the card (on a mesh, host time only).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import envknobs, tracing
from repro_torch.kernels import ops as kernel_ops

__all__ = ["build_local_z", "build_local_z_oracle", "build_group_z",
           "resolve_precision",
           "resolve_fused_zbuild", "PRECISIONS"]

PRECISIONS = envknobs.PRECISIONS


def resolve_precision(precision: str | None) -> str:
    """Z-build precision for a mode step: ``"f32"`` or ``"bf16"``.

    ``None`` and ``"auto"`` honor ``REPRO_PRECISION``; ``"auto"`` then
    consults the current ``CostModel`` (``core.calibrate``): when
    calibration measured a bf16 TTM rate above 1.05 times the f32 one, it
    picks bf16, as the reference does. Otherwise f32.
    """
    if precision in PRECISIONS:
        return precision
    if precision not in (None, "auto"):
        raise ValueError(f"unknown precision {precision!r} "
                         f"(expected one of {PRECISIONS + ('auto', None)})")
    env = envknobs.precision()
    if env is not None:
        return env
    if precision == "auto":
        from repro_torch.core.calibrate import current_cost_model

        model = current_cost_model()
        bf16 = model.ttm_flop_rate_bf16
        f32 = model.ttm_flop_rate or model.flop_rate
        if bf16 and bf16 > 1.05 * f32:
            return "bf16"
    return "f32"


def resolve_fused_zbuild(fused_zbuild: bool | None) -> bool:
    """Fused Z-build→first-oracle decision: ``None`` honors
    ``REPRO_FUSED_ZBUILD=1``, else off."""
    if fused_zbuild is None:
        return envknobs.fused_zbuild()
    return bool(fused_zbuild)


def build_local_z(
    coords: torch.Tensor,
    values: torch.Tensor,
    local_rows: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_rows: int,
    *,
    sorted_rows: bool = True,
    precision: str = "f32",
) -> torch.Tensor:
    """The (local) penultimate matrix Z — (num_rows, K_hat).

    ``sorted_rows=True`` asserts that the elements are already sorted by
    ``local_rows`` (the partition contract of the distributed path), which
    skips the sort; the single-process path passes ``sorted_rows=False``
    since raw COO order is arbitrary. ``precision="bf16"`` is the kernel's
    contract: operands and products rounded to bf16, f32 accumulation.
    """
    with tracing.span("zbuild", device=coords.is_cuda):
        return _local_z(coords, values, local_rows, factors, mode, num_rows,
                        sorted_rows, precision)


def _local_z(coords, values, local_rows, factors, mode, num_rows,
             sorted_rows, precision):
    fn = (kernel_ops.penultimate_sorted if sorted_rows
          else kernel_ops.penultimate_local)
    return fn(coords, values, local_rows, factors, mode, num_rows,
              precision=precision)


def build_local_z_oracle(
    coords: torch.Tensor,
    values: torch.Tensor,
    local_rows: torch.Tensor,
    factors: Sequence[torch.Tensor],
    mode: int,
    num_rows: int,
    X: torch.Tensor,  # (K_hat, s) first oracle panel
    *,
    sorted_rows: bool = True,
    precision: str = "f32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused stage: ``(Z, Z @ X)`` in one pass over the elements.

    ``sorted_rows=False`` sorts first and then runs the same fused kernel
    (the reference builds Z and multiplies separately there; the result is
    the same up to f32 rounding).
    """
    with tracing.span("zbuild", device=coords.is_cuda):
        return _local_z_oracle(coords, values, local_rows, factors, mode,
                               num_rows, X, sorted_rows, precision)


def _local_z_oracle(coords, values, local_rows, factors, mode, num_rows, X,
                    sorted_rows, precision):
    fn = (kernel_ops.penultimate_sorted_oracle if sorted_rows
          else kernel_ops.penultimate_local_oracle)
    return fn(coords, values, local_rows, factors, mode, num_rows, X,
              precision=precision)


def build_group_z(
    mesh,
    groups: Sequence[dict],
    factors: Sequence[torch.Tensor],
    mode: int,
    num_rows: int,
    X: torch.Tensor | None = None,
    *,
    precision: str = "f32",
    gather: bool = True,
) -> tuple[list[torch.Tensor], torch.Tensor | list | None]:
    """Each device group's Z over its ranks' elements, and with a first
    panel X the panel product.

    ``groups[g]`` holds group g's sorted ``coords``, ``values`` and
    ``rows`` (local rows offset by ``p*R_pad`` within the group);
    ``num_rows`` is a group's ``P/G*R_pad``. ``factors`` and X lie at home:
    each group gets the factors its build reads (every one but the mode's,
    which the build does not read and stays None) and X. Returns the
    groups' Z, each on its device, and ``Z @ X`` (None without X):
    concatenated at home in the stacked layout, or with ``gather=False``
    left on the groups as a list (the boundary space places it there).
    """
    with tracing.span("zbuild"):  # host time only: groups have own streams
        Zs, ZXs = [], []
        for g, arrs in enumerate(groups):
            facs = [None if j == mode else mesh.to_group(f, g, "factors")
                    for j, f in enumerate(factors)]
            Xg = None if X is None else mesh.to_group(X, g)
            with mesh.group(g):
                if Xg is None:
                    Zs.append(_local_z(arrs["coords"], arrs["values"],
                                       arrs["rows"], facs, mode, num_rows,
                                       True, precision))
                else:
                    Z, ZX = _local_z_oracle(
                        arrs["coords"], arrs["values"], arrs["rows"], facs,
                        mode, num_rows, Xg, True, precision)
                    Zs.append(Z)
                    ZXs.append(ZX)
    if X is None:
        return Zs, None
    if not gather:
        return Zs, ZXs
    return Zs, torch.cat([mesh.to_home(zx, g) for g, zx in enumerate(ZXs)])
