"""ExecutorPool: a serving tier of executors, one device each.

The port of ``src/repro/engine/pool.py``. ``StreamScheduler`` pipelines many
tensors through one ``HooiExecutor``; the serving regime (many small
independent decomposition streams) needs several executors running at
once, each on its own device, with streams routed across them.

This module is the resource layer of that tier:

* ``device_slices(n, P)`` gives ``n`` lanes one device each. The reference
  cuts ``n`` disjoint ``P``-device slices out of its mesh; here a lane
  stacks its P ranks on one device, so ``n`` lanes need ``n`` distinct
  devices. Executors never share a CUDA device, so their sweeps overlap
  instead of time-slicing one card.

* ``ExecutorPool`` owns ``n`` **lanes**. A lane is one ``HooiExecutor`` on
  its device (its own step and upload caches) plus one ``StreamScheduler``
  (its own producer pool and consumer thread): the per-lane pipeline is
  exactly the single-executor pipeline, so every scheduler contract
  (submission order, refresh ladder, a rerun with 0 compilations, captures
  and uploads) holds per lane unchanged.

* ``PoolStats`` aggregates the per-stream accounting every run already
  lands in ``DistHooiStats`` (queue wait, prepare/sweep seconds, SLO
  hit/miss) across lanes, and carries the router's admission counters when
  read through ``repro_torch.engine.router.StreamRouter.stats()``.

Routing policy (priority classes, modelled cost, admission control,
backpressure, warm-start reroutes) lives above this layer in
``repro_torch.engine.router``; the pool itself is policy-free.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import TYPE_CHECKING, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.engine.scheduler import StreamScheduler

if TYPE_CHECKING:  # runtime import is deferred: executor imports the engine
    from repro_torch.distributed.executor import HooiExecutor

__all__ = ["ExecutorPool", "PoolLane", "PoolStats", "device_slices"]


def _lane_device(d) -> torch.device:
    """``d`` as a device with an explicit index: ``"cuda"`` means the
    current CUDA device, which ``"cuda:0"`` may name too."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_slices(n_executors: int, P_ranks: int, devices=None) -> list:
    """One single-device slice per lane: ``n_executors`` lists of one
    ``torch.device`` each (the reference's return shape).

    ``devices=None`` means every CUDA device, ``cuda:0`` to
    ``cuda:{count-1}``; the first ``n_executors`` are used. Raises
    ``ValueError`` when there are fewer devices than lanes (no lane falls
    back to the CPU) and when two lanes would share a CUDA device: a pool
    whose executors silently shared a card would report overlap that the
    hardware never delivers. ``"cuda"`` is read as the current CUDA device
    before that check, so ``["cuda", "cuda:0"]`` is a duplicate.

    ``"cpu"`` may repeat in ``devices``: the CPU lanes stand in for the
    reference's simulated host devices, which torch has no counterpart to,
    so ``devices=["cpu"] * n`` gives ``n`` lanes on the plain PyTorch path.
    ``P_ranks`` is checked, not used: each lane stacks its ranks on its
    device.
    """
    n, P = int(n_executors), int(P_ranks)
    if n < 1 or P < 1:
        raise ValueError(f"need n_executors >= 1 and P_ranks >= 1, "
                         f"got {n_executors} x {P_ranks}")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = [_lane_device(d) for d in devices]
    if len(devs) < n:
        raise ValueError(
            f"pool of {n} lanes (P={P} ranks stacked on each lane's device) "
            f"needs {n} devices, have {len(devs)}: shrink the pool, or pass "
            "devices=['cpu'] * n for lanes on the CPU")
    devs = devs[:n]
    cards = [d for d in devs if d.type == "cuda"]
    if len(set(cards)) < len(cards):
        raise ValueError(f"lanes would share a CUDA device: {devs}")
    return [[d] for d in devs]


@dataclasses.dataclass
class PoolLane:
    """One executor + its scheduler pipeline, on its device."""

    index: int
    executor: HooiExecutor
    scheduler: StreamScheduler
    devices: tuple


@dataclasses.dataclass
class PoolStats:
    """Aggregate serving-tier accounting (lanes + router admission).

    Read via ``ExecutorPool.stats()`` (router fields zero) or
    ``StreamRouter.stats()`` (router fields filled in). Per-lane raw dicts
    are kept so dashboards can drill down without re-walking the pool.
    """

    n_lanes: int
    # ---- lane aggregates (summed StreamScheduler totals) ----
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    host_s: float = 0.0
    device_s: float = 0.0
    queue_wait_s: float = 0.0
    slo_hit: int = 0
    slo_miss: int = 0
    decisions: dict = dataclasses.field(default_factory=dict)
    lane_stats: tuple = ()  # per-lane StreamScheduler.stats() dicts
    lane_executors: tuple = ()  # per-lane HooiExecutor.stats() snapshots
    # ---- router-level counters (admission/backpressure/affinity) ----
    rejected: int = 0  # submissions refused admission (PoolSaturated)
    rejected_by_priority: dict = dataclasses.field(default_factory=dict)
    rerouted: int = 0  # warm-start stream transfers between lanes
    backlog_s: tuple = ()  # modelled pending seconds per lane at read time

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class ExecutorPool:
    """``n_executors`` scheduler-fronted executors, one device each.

    Construction kwargs after ``core_dims`` are forwarded to every lane's
    ``StreamScheduler`` (scheme, path, n_invocations, drift_tol,
    pad_geometric, ...), so a pool is configured exactly like a single
    scheduler. ``devices`` is ``device_slices``' (None: every CUDA device).
    Use as a context manager (or call ``close``) to stop every lane's
    worker threads.

    The pool is policy-free: ``lane(i).scheduler.submit`` is the raw
    per-lane entry point. Almost all callers want
    ``repro_torch.engine.router.StreamRouter`` on top: it owns lane choice,
    admission control and backpressure.
    """

    def __init__(
        self,
        n_executors: int,
        P_ranks: int,
        core_dims: Sequence[int],
        *,
        devices=None,
        workers: int = 2,
        **scheduler_kw,
    ):
        from repro_torch.distributed.executor import HooiExecutor

        self.P = int(P_ranks)
        self.core_dims = tuple(int(k) for k in core_dims)
        slices = device_slices(n_executors, P_ranks, devices)
        self.lanes: list[PoolLane] = []
        try:
            for i, sl in enumerate(slices):
                ex = HooiExecutor(self.P, sl[0])
                sched = StreamScheduler(ex, self.core_dims, lane=i,
                                        workers=workers, **scheduler_kw)
                self.lanes.append(PoolLane(index=i, executor=ex,
                                           scheduler=sched,
                                           devices=tuple(sl)))
        except BaseException:
            self.close()  # the lanes already started stop their threads
            raise

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "ExecutorPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Drain and stop every lane's worker threads (idempotent)."""
        for lane in self.lanes:
            lane.scheduler.close()

    # -------------------------------------------------------------- access
    @property
    def n_lanes(self) -> int:
        return len(self.lanes)

    def lane(self, i: int) -> PoolLane:
        return self.lanes[i]

    # ---------------------------------------------------------------- stats
    def stats(self) -> PoolStats:
        """Aggregated lane accounting (router counters zero at this layer)."""
        lane_stats = tuple(l.scheduler.stats() for l in self.lanes)
        lane_execs = tuple(l.executor.stats() for l in self.lanes)
        decisions: collections.Counter = collections.Counter()
        agg = {"submitted": 0, "completed": 0, "failed": 0,
               "host_s": 0.0, "device_s": 0.0, "queue_wait_s": 0.0,
               "slo_hit": 0, "slo_miss": 0}
        for ls in lane_stats:
            for k in agg:
                agg[k] += ls[k]
            decisions.update(ls["decisions"])
        return PoolStats(
            n_lanes=self.n_lanes,
            decisions=dict(decisions),
            lane_stats=lane_stats,
            lane_executors=lane_execs,
            **agg,
        )
