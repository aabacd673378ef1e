"""Distributed HOOI: the ``dist_hooi`` entry point over ``HooiExecutor``.

The port of ``src/repro/distributed/dist_hooi.py``. The P ranks are stacked
along a leading dimension on one device (default: the card), or spread over
the device groups of ``mesh=make_ranks_mesh(P, devices)``; see
``repro_torch.distributed.executor`` and ``repro_torch.distributed.mesh``.
Calls run on the process-wide ``shared_executor(P, device, mesh=)``, so a
repeated call on a cached plan compiles and uploads nothing. The
reference's ``use_kernel`` argument is absent: the device decides the
Z-build (kernels on the card, plain PyTorch on the CPU).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.core.coo import SparseTensor
from repro_torch.core.distribution import Scheme
from repro_torch.core.hooi import Decomposition
from repro_torch.core.plan import PartitionPlan
from repro_torch.random import Draw

from .executor import (DistHooiStats, HooiExecutor,  # noqa: F401
                       comm_model, shared_executor)
from .mesh import RankMesh, make_ranks_mesh

__all__ = ["dist_hooi", "make_ranks_mesh", "comm_model", "DistHooiStats",
           "HooiExecutor", "shared_executor"]


def dist_hooi(
    t: SparseTensor,
    core_dims: Sequence[int],
    P_ranks: int,
    scheme: str | Scheme | PartitionPlan = "lite",
    n_invocations: int = 3,
    path: str = "liteopt",
    seed: int = 0,
    plan_seed: int = 0,
    executor: HooiExecutor | None = None,
    use_fused_oracle: bool | None = None,
    precision: str | None = None,
    lanczos_block: int | None = None,
    fused_zbuild: bool | None = None,
    warm_start: str | None = None,
    pad_geometric: bool = False,
    objective=None,
    *,
    device: str | torch.device | None = None,
    mesh: RankMesh | None = None,
    draw: Draw | None = None,
    init: Sequence | None = None,
    on_sweep: Callable[[int, float, float], None] | None = None,
) -> tuple[Decomposition, DistHooiStats]:
    """Distributed HOOI: partition with ``scheme`` over ``P_ranks`` ranks.

    ``scheme`` is a scheme name (including ``"auto"``), a prebuilt
    ``Scheme`` or a ``PartitionPlan``; names and schemes go through the
    content-keyed plan cache, with ``plan_seed`` threaded to randomized
    schemes. ``path`` selects the comm backend family (``"baseline"`` ->
    psum, ``"liteopt"`` -> boundary, ``"auto"`` -> per mode; P=1 always
    runs ``local``, the same engine instantiation as ``hooi``). The other
    knobs are ``HooiExecutor.run``'s (``pad_geometric`` quantizes the
    partition pads to powers of two, part of the plan-cache key, as the
    scheduler's streaming plans are built). ``executor`` overrides
    ``shared_executor(P_ranks, device, mesh=mesh)``: ``mesh``
    (``make_ranks_mesh``) spreads the ranks over its device groups, and
    excludes ``device`` (its first device is the run's). ``init`` passes
    initial factors (coerced to ``core_dims``), ``draw`` the random-draw
    seam, ``on_sweep(it, seconds, fit)`` observes every sweep.
    """
    ex = executor if executor is not None \
        else shared_executor(P_ranks, device, mesh=mesh)
    if ex.P != P_ranks:
        raise ValueError(f"executor has P={ex.P}, asked for {P_ranks}")
    return ex.run(t, core_dims, scheme, n_invocations=n_invocations,
                  path=path, seed=seed, plan_seed=plan_seed,
                  use_fused_oracle=use_fused_oracle, precision=precision,
                  lanczos_block=lanczos_block, fused_zbuild=fused_zbuild,
                  warm_start=warm_start, init_factors=init,
                  pad_geometric=pad_geometric, objective=objective,
                  draw=draw, on_sweep=on_sweep)
