"""StreamRouter: priority + cost routing over an ExecutorPool, with
admission control and backpressure.

The port of ``src/repro/engine/router.py``, with the same policy. The
paper's thesis is that distribution decisions are cheap enough to make at
serve time; the router applies that one level up: *placement across
executors* is also decided per submission, from the same modelled cost the
``auto`` selector uses (``PlanCost``):

* **lane choice**: each lane carries a modelled backlog (seconds of
  admitted-but-unfinished work). A new source goes to the least-loaded
  lane; a known source's cost estimate is, in order of preference, its
  last *measured* prepare+sweep seconds, the modelled
  ``PlanCost.total_s x n_invocations`` of its adopted plan, then a flat
  default. Streams are **sticky**: a ``StreamingTensor`` keeps its lane so
  the refresh ladder (reuse / repartition) and the lane executor's caches
  stay warm.

* **admission control**: a bounded queue over the whole pool
  (``max_pending``), scaled per priority class: ``interactive`` may fill
  the whole queue, ``normal`` most of it, ``batch`` half (defaults;
  ``admission_shares``). When a class's share is full, ``submit`` raises
  ``PoolSaturated`` *immediately*: backpressure is surfaced to the caller,
  never absorbed into an unbounded internal queue. Priority governs
  admission and lane choice; within a lane, execution order stays
  submission order (the scheduler contract).

* **warm-start reroutes**: when a sticky stream's home lane is backlogged
  past ``reroute_threshold_s`` (or ``reroute()`` is called), the home
  lane's adopted plan is serialized with ``PartitionPlan.save()`` and
  ``load()``-ed against the stream's current snapshot on the target lane
  (the same bytes would cross processes). On success the target adopts it,
  which stages its uploads: the next submit replays as ``reuse`` /
  ``repartition`` instead of a full re-selection, with 0 uploads, and,
  because ``pad_geometric`` quantizes padded shapes, with 0 compilations
  wherever the target executor has already built steps of those shapes.
  On the card the target still captures its steps once: a CUDA graph is
  bound to the arrays it was captured over. A stale plan (the stream grew
  since serialization) is refused by the fingerprint check and the stream
  simply re-plans cold on the new lane.

Per-stream accounting (queue wait, prepare/sweep seconds, SLO deadline
hit/miss, lane) lands on each run's ``DistHooiStats``; ``stats()``
aggregates the pool view into ``PoolStats``.
"""

from __future__ import annotations

import dataclasses
import io
import threading
import weakref
from concurrent.futures import CancelledError, Future, wait as futures_wait

from repro_torch.core.coo import SparseTensor
from repro_torch.core.plan import PartitionPlan
from repro_torch.engine.pool import ExecutorPool, PoolStats
from repro_torch.random import Draw
from repro_torch.streaming import StreamingTensor

__all__ = ["StreamRouter", "PoolSaturated", "ADMISSION_SHARES",
           "DEFAULT_COST_S"]

# priority class -> fraction of max_pending that class may fill. Interactive
# traffic can always use headroom that batch admission left free, so a
# saturated batch tier never starves the latency-sensitive one.
ADMISSION_SHARES = {"interactive": 1.0, "normal": 0.85, "batch": 0.5}

# modelled-cost fallback for a source the router has never seen and that has
# no adopted plan yet (seconds per invocation; deliberately generic: the
# first completion replaces it with a measurement)
DEFAULT_COST_S = 0.05


class PoolSaturated(RuntimeError):
    """Admission refused: the pool's bounded queue is full for this class.

    Backpressure is the caller's signal to shed, delay, or retry at a
    higher priority; the router never buffers beyond ``max_pending``.
    """

    def __init__(self, priority: str, pending: int, limit: int):
        super().__init__(
            f"pool saturated for priority={priority!r}: {pending} pending "
            f">= class limit {limit}: retry later or raise the priority")
        self.priority = priority
        self.pending = pending
        self.limit = limit


class StreamRouter:
    """Routes ``submit()`` calls across an ``ExecutorPool``'s lanes.

    Thread-safe: many client threads may submit concurrently; completion
    bookkeeping runs on the lanes' worker threads. ``drain()`` returns
    results in global submission order (across lanes). ``close()`` closes
    the router *and* the pool's lanes.
    """

    def __init__(
        self,
        pool: ExecutorPool,
        *,
        max_pending: int = 64,
        admission_shares: dict | None = None,
        reroute_threshold_s: float | None = None,
        default_cost_s: float = DEFAULT_COST_S,
    ):
        self.pool = pool
        self.max_pending = int(max_pending)
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.shares = dict(ADMISSION_SHARES if admission_shares is None
                           else admission_shares)
        # None disables load-triggered reroutes (explicit reroute() always
        # works); small thresholds make hot lanes shed sticky streams
        self.reroute_threshold_s = reroute_threshold_s
        self.default_cost_s = float(default_cost_s)

        self._lock = threading.Lock()
        self._closed = False
        self._futures: list[Future] = []  # submission order, since last drain
        self._backlog = [0.0] * pool.n_lanes  # modelled pending seconds
        self._inflight = 0
        self._rr = 0  # round-robin tiebreak for equal backlogs
        # sticky lane per stream; weak so a dead stream frees its slot
        self._affinity: "weakref.WeakKeyDictionary[StreamingTensor, int]" \
            = weakref.WeakKeyDictionary()
        # last measured prepare+sweep seconds per source (cost estimator);
        # a SparseTensor is a frozen dataclass over arrays, so it cannot
        # be a key and falls back to the model
        self._measured: "weakref.WeakKeyDictionary[object, float]" \
            = weakref.WeakKeyDictionary()
        self._submitted = 0
        self._rejected: dict[str, int] = {}
        self._rerouted = 0

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "StreamRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop admitting, then drain and stop every pool lane."""
        with self._lock:
            self._closed = True
        self.pool.close()

    # --------------------------------------------------------------- submit
    def submit(
        self,
        source: SparseTensor | StreamingTensor,
        *,
        name: str | None = None,
        seed: int = 0,
        priority: str = "normal",
        deadline_s: float | None = None,
        n_invocations: int | None = None,
        objective=None,
        draw: Draw | None = None,
    ) -> Future:
        """Admit, route, and queue one decomposition of ``source``.

        Raises ``PoolSaturated`` (backpressure) when ``priority``'s share
        of the bounded queue is full, and ``RuntimeError`` after
        ``close()``. On admission, returns the lane scheduler's future
        (resolves to a ``ScheduledResult``; SLO fields stamped when
        ``deadline_s`` is given). ``objective`` and ``draw`` (the run's
        random-draw seam, ``repro_torch.random``) are forwarded to the lane
        scheduler.
        """
        if priority not in self.shares:
            raise ValueError(f"unknown priority {priority!r}; known: "
                             f"{sorted(self.shares)}")
        with self._lock:
            if self._closed:
                raise RuntimeError("router is closed")
            limit = max(1, int(round(self.shares[priority]
                                     * self.max_pending)))
            if self._inflight >= limit:
                self._rejected[priority] = \
                    self._rejected.get(priority, 0) + 1
                raise PoolSaturated(priority, self._inflight, limit)
            est = self._estimate_cost(source, n_invocations)
            lane_i = self._choose_lane(source)
            lane = self.pool.lanes[lane_i]
            # submit under the router lock: _futures order must equal the
            # global submission order the lanes see (the lane scheduler
            # takes its own lock; it never calls back into the router, so
            # the router -> scheduler lock order cannot invert)
            fut = lane.scheduler.submit(
                source, name=name, seed=seed, deadline_s=deadline_s,
                n_invocations=n_invocations, objective=objective, draw=draw)
            self._inflight += 1
            self._backlog[lane_i] += est
            self._submitted += 1
            self._futures.append(fut)
        # outside the lock: done callbacks may fire inline if the job
        # already resolved, and they re-take the router lock
        fut.add_done_callback(
            lambda f, li=lane_i, e=est, src=source:
            self._on_done(li, e, src, f))
        return fut

    def drain(self, *, return_exceptions: bool = False) -> list:
        """Wait for everything admitted since the last drain; results in
        global submission order (semantics mirror ``StreamScheduler.drain``:
        all futures are awaited before any failure re-raises)."""
        with self._lock:
            futs = list(self._futures)
            self._futures.clear()
        futures_wait(futs)
        if return_exceptions:
            out = []
            for f in futs:
                if f.cancelled():
                    out.append(CancelledError())
                else:
                    e = f.exception()
                    out.append(e if e is not None else f.result())
            return out
        return [f.result() for f in futs]

    # -------------------------------------------------------------- routing
    def _estimate_cost(self, source, n_invocations) -> float:
        """Modelled seconds this submission will occupy its lane (lock
        held). Measured history beats the plan model beats the flat
        default: the ``auto`` selector's calibration story applied to
        placement."""
        try:
            measured = self._measured.get(source)
        except TypeError:  # not weakly referenceable or not hashable
            measured = None
        if measured is not None:
            return measured
        n = n_invocations
        if n is None:
            n = self.pool.lanes[0].scheduler.n_invocations
        if isinstance(source, StreamingTensor):
            home = self._affinity.get(source)
            if home is not None:
                pl = self.pool.lanes[home].scheduler.adopted_plan(source)
                if pl is not None:
                    return max(float(pl.cost.total_s) * n, 1e-6)
        return self.default_cost_s * n

    def _least_loaded(self, exclude: int | None = None) -> int:
        cands = [i for i in range(self.pool.n_lanes) if i != exclude]
        best = min(cands, key=lambda i: (self._backlog[i],
                                         (i - self._rr)
                                         % self.pool.n_lanes))
        self._rr = (best + 1) % self.pool.n_lanes
        return best

    def _choose_lane(self, source) -> int:
        """Sticky for streams (with threshold-triggered warm-start
        reroutes), least modelled backlog otherwise. Lock held."""
        if isinstance(source, StreamingTensor):
            home = self._affinity.get(source)
            if home is None:
                home = self._least_loaded()
                self._affinity[source] = home
                return home
            if self.reroute_threshold_s is not None \
                    and self.pool.n_lanes > 1:
                best = self._least_loaded(exclude=home)
                if (self._backlog[home] - self._backlog[best]
                        > self.reroute_threshold_s):
                    return self._reroute_locked(source, home, best)
            return home
        return self._least_loaded()

    def _reroute_locked(self, src: StreamingTensor, home: int,
                        target: int) -> int:
        """Move a stream's affinity, carrying its plan via save()/load()."""
        pl = self.pool.lanes[home].scheduler.adopted_plan(src)
        if pl is not None and pl.fingerprint is not None:
            buf = io.BytesIO()
            try:
                # validate under the TARGET lane's objective: its view is
                # what future submits there will fingerprint against; an
                # objective mismatch is refused like a stale plan and the
                # stream simply re-plans cold on the new lane
                tsched = self.pool.lanes[target].scheduler
                pl.save(buf)
                warm = PartitionPlan.load(io.BytesIO(buf.getvalue()),
                                          src.snapshot(),
                                          objective=tsched.objective)
            except ValueError:
                warm = None  # stream grew since adoption: stale plan
            if warm is not None:
                tsched.adopt(src, warm)
        self._affinity[src] = target
        self._rerouted += 1
        return target

    def reroute(self, src: StreamingTensor, lane: int | None = None) -> int:
        """Explicitly move a stream to ``lane`` (default: least-loaded
        other lane; ``ValueError`` on a one-lane pool, which has none),
        warm-starting its plan on the target. Returns the new lane
        index."""
        with self._lock:
            home = self._affinity.get(src)
            if home is None:
                raise ValueError("stream has no lane yet: submit it first")
            target = self._least_loaded(exclude=home) if lane is None \
                else int(lane)
            if not 0 <= target < self.pool.n_lanes:
                raise ValueError(f"lane {target} outside pool of "
                                 f"{self.pool.n_lanes}")
            if target == home:
                return home
            return self._reroute_locked(src, home, target)

    # ------------------------------------------------------------ bookkeeping
    def _on_done(self, lane_i: int, est: float, source, fut: Future) -> None:
        with self._lock:
            self._backlog[lane_i] = max(0.0, self._backlog[lane_i] - est)
            self._inflight -= 1
            if not fut.cancelled() and fut.exception() is None:
                r = fut.result()
                try:
                    self._measured[source] = \
                        max(float(r.prepare_s + r.run_s), 1e-6)
                except TypeError:
                    pass  # not a weak key: keep the model estimate

    # ---------------------------------------------------------------- stats
    def stats(self) -> PoolStats:
        """Pool aggregates + this router's admission/affinity counters."""
        base = self.pool.stats()
        with self._lock:
            return dataclasses.replace(
                base,
                rejected=sum(self._rejected.values()),
                rejected_by_priority=dict(self._rejected),
                rerouted=self._rerouted,
                backlog_s=tuple(self._backlog),
            )

    def pending(self) -> int:
        """Admitted-but-unfinished jobs across the pool (queue occupancy)."""
        with self._lock:
            return self._inflight
