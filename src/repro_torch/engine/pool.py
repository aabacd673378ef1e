"""ExecutorPool: a serving tier of executors, one device or mesh each.

The port of ``src/repro/engine/pool.py``. ``StreamScheduler`` pipelines many
tensors through one ``HooiExecutor``; the serving regime (many small
independent decomposition streams) needs several executors running at
once, each on devices of its own, with streams routed across them.

This module is the resource layer of that tier:

* ``device_slices(n, P)`` gives ``n`` lanes their devices. The reference
  cuts ``n`` disjoint ``P``-device slices out of its devices; here a lane
  is one device, on which it stacks its P ranks, or a list of devices, a
  ``distributed.mesh.RankMesh`` of device groups (a device may repeat
  within one lane's list). No CUDA device serves two lanes, so their
  sweeps overlap instead of time-slicing one card.

* ``ExecutorPool`` owns ``n`` **lanes**. A lane is one ``HooiExecutor`` on
  its device or mesh (its own step and upload caches) plus one
  ``StreamScheduler`` (its own producer pool and consumer thread): the
  per-lane pipeline is exactly the single-executor pipeline, so every
  scheduler contract (submission order, refresh ladder, a rerun with 0
  compilations, captures and uploads) holds per lane unchanged.

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

from repro_torch.device import indexed_device
from repro_torch.engine.scheduler import StreamScheduler

if TYPE_CHECKING:  # runtime import is deferred: executor imports the engine
    from repro_torch.distributed.executor import HooiExecutor

__all__ = ["ExecutorPool", "PoolLane", "PoolStats", "device_slices"]


def device_slices(n_executors: int, P_ranks: int, devices=None) -> list:
    """The devices of each lane: ``n_executors`` lists of ``torch.device``
    (the reference's return shape).

    ``devices=None`` means every CUDA device, ``cuda:0`` to
    ``cuda:{count-1}``, one per lane; the first ``n_executors`` are used
    (lanes of P cards, as the reference's, would need n*P of them). An
    entry of ``devices`` is one device, on which the lane stacks its P
    ranks, or a list of G devices (G dividing ``P_ranks``), the lane's
    mesh of device groups; a device may repeat within one lane's list.
    Raises
    ``ValueError`` when there are fewer entries than lanes (no lane falls
    back to the CPU) and when two lanes would share a CUDA device: a pool
    whose executors silently shared a card would report overlap that the
    hardware never delivers. ``"cuda"`` is read as the current CUDA device
    before that check, so ``["cuda", "cuda:0"]`` is a duplicate.

    ``"cpu"`` may serve several lanes: the CPU lanes stand in for the
    reference's simulated host devices, which torch has no counterpart to,
    so ``devices=["cpu"] * n`` gives ``n`` lanes on the plain PyTorch path
    (and ``[["cpu"] * G] * n`` n lanes of G groups each).
    """
    n, P = int(n_executors), int(P_ranks)
    if n < 1 or P < 1:
        raise ValueError(f"need n_executors >= 1 and P_ranks >= 1, "
                         f"got {n_executors} x {P_ranks}")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        lanes = [[torch.device("cuda", i)] for i in range(count)]
    else:
        lanes = [[indexed_device(d) for d in entry]
                 if isinstance(entry, (list, tuple))
                 else [indexed_device(entry)] for entry in devices]
    if len(lanes) < n:
        raise ValueError(
            f"pool of {n} lanes (P={P} ranks on each lane's device or "
            f"mesh) needs {n} devices, have {len(lanes)}: shrink the pool, "
            "or pass devices=['cpu'] * n for lanes on the CPU")
    lanes = lanes[:n]
    for lane in lanes:
        if not lane or P % len(lane):
            raise ValueError(f"a lane of {len(lane)} device groups does "
                             f"not split P={P} ranks evenly: {lane}")
    cards = [d for lane in lanes for d in dict.fromkeys(lane)
             if d.type == "cuda"]
    if len(set(cards)) < len(cards):
        raise ValueError(f"lanes would share a CUDA device: {lanes}")
    return lanes


@dataclasses.dataclass
class PoolLane:
    """One executor + its scheduler pipeline, on its device or mesh."""

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
    """``n_executors`` scheduler-fronted executors, one device or mesh each.

    Construction kwargs after ``core_dims`` are forwarded to every lane's
    ``StreamScheduler`` (scheme, path, n_invocations, drift_tol,
    pad_geometric, ...), so a pool is configured exactly like a single
    scheduler. ``devices`` is ``device_slices``' (None: every CUDA device);
    a lane of several devices runs ``HooiExecutor(P, mesh=...)`` over them.
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
        from repro_torch.distributed.mesh import RankMesh

        self.P = int(P_ranks)
        self.core_dims = tuple(int(k) for k in core_dims)
        slices = device_slices(n_executors, P_ranks, devices)
        self.lanes: list[PoolLane] = []
        try:
            for i, sl in enumerate(slices):
                ex = HooiExecutor(self.P, mesh=RankMesh(self.P, sl)) \
                    if len(sl) > 1 else HooiExecutor(self.P, sl[0])
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
