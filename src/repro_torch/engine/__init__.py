"""The layered HOOI engine: Z-build -> oracle -> comm backend.

The port of ``src/repro/engine/__init__.py``. One mode step is three
stages:

* **Z-build** (``engine.zbuild``): the penultimate matrix, through the
  CUDA ``kron_segsum`` kernel on the card or its plain version on the CPU.
* **oracle** (``engine.oracle``): the Z products (plain or the fused
  ``oracle_pair`` kernel) feeding the one Lanczos body
  (``repro_torch.core.lanczos``).
* **comm backend** (``engine.comm``): ``local`` (P=1), ``psum``
  (replicated row space, the paper's baseline) or ``boundary`` (sharded
  rows + O(P) boundary exchange), over P ranks stacked on one device or
  over a mesh of device groups (``repro_torch.distributed.mesh``), whose
  groups build and multiply their Z (``build_group_z``,
  ``group_products``): psum gathers their answers at the mesh's home
  (``mesh_products``), boundary keeps its shards on the groups
  (``make_mesh_boundary_space``).

``engine.steps`` composes the stages into mode steps; ``engine.sweep`` is
the sweep loop both ``repro_torch.core.hooi.hooi`` and
``repro_torch.distributed.executor.HooiExecutor`` drive;
``engine.objective`` says what that loop optimizes (standard Tucker,
masked completion, nonnegative ADMM Tucker); ``engine.scheduler``
pipelines many tensors (or stream versions) through one executor;
``engine.pool`` + ``engine.router`` serve many concurrent streams over
several executors, one device or mesh each, with priority admission and
warm-start reroutes.

Not exported, unlike the reference: ``resolve_kernel`` and
``kernel_forced_by_env`` (the device picks the kernel), ``AXIS`` (the name
of the reference's mesh axis; the port's mesh is a list of device groups
with no named axis) and
``ARRAY_FIELDS`` (the reference's per-shard upload layout; the port's is
``repro_torch.distributed.executor.upload_mode``).
"""

from .comm import (
    COMM_BACKENDS,
    OracleSpace,
    make_comm_space,
    make_mesh_boundary_space,
    resolve_backend,
)
from .objective import (
    CompletionObjective,
    NNTuckerObjective,
    Objective,
    TuckerObjective,
    resolve_objective,
)
from .oracle import (
    ModeSpec,
    choose_warm_start,
    count_z_passes,
    group_products,
    mesh_products,
    mode_spec,
    resolve_block_size,
    resolve_knobs,
    resolve_warm_start,
    solve_oracle,
    solve_oracle_block,
    z_products,
)
from .pool import ExecutorPool, PoolLane, PoolStats, device_slices
from .router import PoolSaturated, StreamRouter
from .scheduler import ScheduledResult, StreamScheduler
from .steps import (
    local_mode_step,
    make_mode_step_fn,
    make_stochastic_step_fn,
    make_zbuild_step_fn,
)
from .sweep import run_hooi_sweeps, sweep_key
from .zbuild import (
    build_group_z,
    build_local_z,
    build_local_z_oracle,
    resolve_fused_zbuild,
    resolve_precision,
)

__all__ = [
    "COMM_BACKENDS",
    "OracleSpace",
    "make_comm_space",
    "make_mesh_boundary_space",
    "resolve_backend",
    "Objective",
    "TuckerObjective",
    "CompletionObjective",
    "NNTuckerObjective",
    "resolve_objective",
    "solve_oracle",
    "solve_oracle_block",
    "count_z_passes",
    "resolve_block_size",
    "resolve_warm_start",
    "choose_warm_start",
    "ModeSpec",
    "resolve_knobs",
    "mode_spec",
    "z_products",
    "group_products",
    "mesh_products",
    "ExecutorPool",
    "PoolLane",
    "PoolStats",
    "device_slices",
    "PoolSaturated",
    "StreamRouter",
    "ScheduledResult",
    "StreamScheduler",
    "local_mode_step",
    "make_mode_step_fn",
    "make_stochastic_step_fn",
    "make_zbuild_step_fn",
    "run_hooi_sweeps",
    "sweep_key",
    "build_local_z",
    "build_local_z_oracle",
    "build_group_z",
    "resolve_precision",
    "resolve_fused_zbuild",
]
