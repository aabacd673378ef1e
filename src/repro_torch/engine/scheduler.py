"""StreamScheduler: overlap host-side planning with device-side sweeps.

The port of ``src/repro/engine/scheduler.py``. When many tensors (or many
versions of a streaming tensor) flow through one executor, the distribution
step can hide behind the sweeps: while the device sweeps tensor *k*, a
producer thread partitions and stages tensor *k+1*. A two-stage pipeline:

::

    submit(t_1) submit(t_2) submit(t_3) ...
        |            |           |
    [producer pool: host work]         [consumer thread: device work]
      snapshot -> refresh decision        run(t_1)
      -> PartitionPlan (auto / extend)    run(t_2)                time
      -> stage_upload (host->device)      run(t_3)                  |
                                                                    v

Stage 1 (producers, ``HooiExecutor.prepare``/``stage_upload``): snapshot,
plan construction or refresh, uploads through pinned memory on the
executor's upload stream; nothing is captured or swept. Stage 2 (one
consumer thread, ``HooiExecutor.run``/``run_stochastic``): the device work,
in submission order, so captures, replays and the calibration samples stay
single-threaded.

Streaming refresh ladder (per submitted batch of a ``StreamingTensor``):

* **reuse** — the stream version is unchanged since the adopted plan:
  same plan object, resident uploads, captured steps -> the run reports 0
  compilations, 0 captures and 0 uploads.
* **stochastic-refine** — sampling is on (``sample_fraction`` /
  ``REPRO_SAMPLE_FRACTION``), the drift is below the (tighter) stochastic
  tolerance and the modeled sampled pass undercuts a full sweep: keep the
  adopted plan untouched and update the carried factors from a
  deterministic minibatch of the appended elements plus a replay reservoir
  (``HooiExecutor.run_stochastic``). A full correction run every
  ``correction_every`` appends bounds the rung's fit error;
  ``DistHooiStats.fit_delta`` observes it.
* **repartition** — the projected §4 load imbalance stays within
  ``drift_tol`` of the imbalance the plan was selected at: keep the scheme,
  extend its policies to the appended elements in O(batch)
  (``core.plan.extend_scheme``) and rebuild the partitions. With geometric
  pads (``pad_geometric=True``, the default here) the padded shapes
  usually survive, so no step compiles; the producer uploads the new
  arrays, and on the card the steps are captured again over them (a graph
  is bound to the arrays it was captured over).
* **reselect** — some mode skewed beyond the tolerance: rerun the
  real-time selector from scratch.

The decision and its drift land on ``DistHooiStats.stream_decision`` /
``stream_drift``. Two differences from the reference: there is no
``use_kernel`` argument (the device decides the kernels), and a ``submit``
may carry a ``draw`` (``repro_torch.random.Draw``), the random-draw seam the
port's other entry points have, which the scheduler passes to ``run`` and
``run_stochastic``.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from concurrent.futures import (
    CancelledError,
    Future,
    InvalidStateError,
    ThreadPoolExecutor,
    wait as futures_wait,
)
from typing import Sequence

import numpy as np

from repro_torch import envknobs
from repro_torch.core.coo import SparseTensor
from repro_torch.core.metrics import MetricsExtender
from repro_torch.core.plan import (
    PartitionPlan,
    extend_scheme,
    refresh_decision,
    rescore_plan,
    slice_owner_maps,
)
from repro_torch.core.sketch import adapt_rank
from repro_torch.engine.objective import resolve_objective
from repro_torch.engine.oracle import resolve_warm_start
from repro_torch.random import Draw
from repro_torch.streaming import StreamingTensor

__all__ = ["StreamScheduler", "ScheduledResult", "DECISIONS",
           "MAX_RETAINED_FUTURES"]

DECISIONS = ("plan", "reuse", "stochastic-refine", "repartition", "reselect")

# resolved futures retained for drain(); beyond this, the oldest resolved
# ones are released so a drain-less serving loop cannot pin every result
# it ever produced
MAX_RETAINED_FUTURES = 4096


@dataclasses.dataclass
class ScheduledResult:
    """What one scheduled decomposition produced, with pipeline provenance."""

    name: str
    seq: int  # submission order
    decomposition: object  # repro_torch.core.hooi.Decomposition
    stats: object  # DistHooiStats (stream_decision/_drift/prepare_s set)
    plan: PartitionPlan
    decision: str  # one of DECISIONS
    drift: dict | None  # refresh_decision output (appends only)
    prepare_s: float  # host stage: snapshot + decision + plan + staging
    run_s: float  # device stage: sweeps (consumer thread)
    stream_version: int | None  # version decomposed (streams only)
    # serving-tier accounting (defaults keep pre-pool callers working):
    # time spent waiting in queues — submit -> sweep start, minus the
    # prepare work itself (which overlaps earlier sweeps by design)
    queue_wait_s: float = 0.0
    # None when no deadline was given; else whether submit -> result
    # latency met it (mirrored on stats.slo_met)
    slo_met: bool | None = None

    @property
    def fits(self):
        return self.stats.fits


@dataclasses.dataclass
class _StreamState:
    """Scheduler-side memory of one StreamingTensor's adopted plan."""

    plan: PartitionPlan
    version: int  # stream version the plan's policies cover
    owner_maps: tuple  # per-mode slice -> rank (adoption-time majority)
    loads: list  # per-mode per-rank element counts at `version`
    # per-mode imbalance at *adoption* (selection) time — the fixed drift
    # baseline. Repartitions must not ratchet it: a stream skewing a
    # little per batch still has to compare against the imbalance the
    # scheme was actually selected at, or it would never reselect.
    baseline: tuple
    # cache token of the objective the plan was built under: a submit with
    # a different objective sees a different training view, so the state
    # is stale for it and the stream replans from scratch
    objective: tuple = ("tucker",)
    # incremental SchemeMetrics state (built lazily at first repartition,
    # on the covered prefix of the view) — keeps the repartition path's
    # metrics in O(batch) instead of an O(nnz) recompute
    extender: MetricsExtender | None = None
    # ---- sketch warm start / adaptive rank ----
    # the stream's *current* per-mode ranks (adaptive rank mutates these;
    # None = the scheduler default)
    core_dims: tuple | None = None
    # last run's factor matrices — the next run's init_factors, so the
    # factor-seeded sketch warm start carries across runs and across the
    # reselect rung (None until a run completes, or when warm_start
    # resolves to "none" — carrying factors would change trajectories)
    factors: object = None
    # [(stream_version, core_dims, modeled_total_s), ...] — the adaptive
    # rank trace, mirrored onto DistHooiStats.rank_trajectory
    rank_trajectory: list = dataclasses.field(default_factory=list)
    # ---- stochastic-refine rung ----
    # leading view elements already *incorporated into the factors* (by a
    # full sweep or a stochastic refine). Deliberately separate from the
    # plan-coverage bookkeeping above: a refine leaves plan/version/loads/
    # extender untouched (its partitions still describe exactly the
    # pre-append prefix, keeping the repartition path's covered-slicing and
    # load projection exact), and tracks incorporation here instead
    refined_nnz: int = 0
    # stream version whose appends are all incorporated — the eligibility
    # gate that makes "stochastic-refine never fires on an unchanged
    # stream version" structural
    refined_version: int = -1
    # consecutive refines since the last full sweep (drives the step-size
    # decay and the correction_every full-sweep cadence)
    stoch_count: int = 0
    # final fit of the last *full* run — the reference fit_delta is
    # measured against
    last_full_fit: float | None = None
    # a refine died mid-run (chaos, OOM, ...): its sampled elements were
    # marked incorporated at prepare time but never reached the factors.
    # The flag forces the next submit down a full (correction) path, which
    # re-anchors everything; any successful run clears it
    stoch_failed: bool = False


@dataclasses.dataclass
class _Job:
    seq: int
    name: str
    source: object  # SparseTensor | StreamingTensor
    seed: int
    n_invocations: int
    future: Future
    objective: object = None  # resolved engine.objective.Objective
    draw: Draw | None = None  # the random-draw seam for run/run_stochastic
    # the per-stream ranks this job plans and runs with (adaptive rank may
    # differ from the scheduler default); None = scheduler core_dims
    core_dims: tuple | None = None
    submit_t: float = 0.0  # perf_counter at submit (queue-wait/SLO clock)
    deadline_s: float | None = None  # submit -> result SLO budget
    # per-stream prepare ordering: wait for the previous submit of the same
    # stream, signal the next (None for plain tensors / first submit)
    wait_event: threading.Event | None = None
    done_event: threading.Event | None = None
    # filled by the producer stage
    tensor: SparseTensor | None = None
    plan: PartitionPlan | None = None
    decision: str = "plan"
    drift: dict | None = None
    prepare_s: float = 0.0
    stream_version: int | None = None
    # stochastic-refine routing: {"covered_nnz", "step_index"} when the
    # consumer should run the sampled pass instead of a full sweep
    stoch: dict | None = None


class StreamScheduler:
    """Asynchronous multi-tensor front end for one ``HooiExecutor``.

    ``submit`` returns a ``concurrent.futures.Future`` resolving to a
    ``ScheduledResult``; device runs happen in submission order. Use as a
    context manager (or call ``close``) to stop the worker threads.

    The executor is owned by the caller but must not be driven from other
    threads while a scheduler is attached — the scheduler's consumer
    thread is the only one that runs it.
    """

    def __init__(
        self,
        executor,
        core_dims: Sequence[int],
        *,
        scheme: str = "auto",
        path: str = "liteopt",
        n_invocations: int = 2,
        drift_tol: float = 0.25,
        workers: int = 2,
        pad_geometric: bool = True,
        plan_seed: int = 0,
        use_fused_oracle: bool | None = None,
        lane: int | None = None,
        objective=None,
        warm_start: str | None = None,
        adaptive_rank: bool = False,
        rank_policy: dict | None = None,
        sample_fraction: float | None = None,
        sample_seed: int = 0,
        replay_nnz: int = 1024,
        correction_every: int = 4,
        stochastic_tol: float | None = None,
        step_size: float = 0.5,
        step_decay: float = 0.5,
    ):
        self.executor = executor
        # pool-lane label stamped on every run's stats (None standalone)
        self.lane = lane
        # default sweep objective for submissions that don't override it
        # (None honors REPRO_OBJECTIVE; resolved once, here)
        self.objective = resolve_objective(objective)
        self.core_dims = tuple(int(k) for k in core_dims)
        self.scheme = scheme
        self.path = path
        self.n_invocations = int(n_invocations)
        self.drift_tol = float(drift_tol)
        self.pad_geometric = bool(pad_geometric)
        self.plan_seed = int(plan_seed)
        self.use_fused_oracle = use_fused_oracle
        # oracle warm start (None honors REPRO_WARM_START). Resolved once:
        # under "none" no factors are carried either, so the scheduler path
        # reproduces its historical trajectories bitwise.
        self.warm_start = warm_start
        self._warm_resolved = resolve_warm_start(warm_start)
        # adaptive per-mode rank: after each stream run, adapt_rank reads
        # the sketch/GK tail spectrum and may grow/shrink the stream's
        # core_dims; the plan is re-scored in place (rescore_plan — same
        # parts tuple, so the executor's upload cache stays hot)
        self.adaptive_rank = bool(adaptive_rank)
        self.rank_policy = dict(rank_policy or {})
        # without an explicit cap a mode could never grow (adapt_rank
        # clamps to k when k_max is None) — default to 2x the initial rank
        self.rank_policy.setdefault(
            "k_max", 2 * max(self.core_dims))
        # stochastic-refine rung: None honors REPRO_SAMPLE_FRACTION; 0 (or
        # an unset knob) disables the rung and the ladder is exactly the
        # historical three rungs
        if sample_fraction is None:
            sample_fraction = envknobs.sample_fraction()
        if sample_fraction is not None and not sample_fraction:
            sample_fraction = None  # explicit 0 = off
        if sample_fraction is not None \
                and not 0.0 < float(sample_fraction) <= 1.0:
            raise ValueError(
                f"sample_fraction must be in (0, 1], got {sample_fraction}")
        self.sample_fraction = None if sample_fraction is None \
            else float(sample_fraction)
        self.sample_seed = int(sample_seed)
        self.replay_nnz = int(replay_nnz)
        # every correction_every-th append runs a full (correction) sweep;
        # 0 = never correct (property tests only — unbounded fit drift)
        self.correction_every = int(correction_every)
        # drift ceiling for sampling; None = refresh_decision's drift_tol/2
        self.stochastic_tol = None if stochastic_tol is None \
            else float(stochastic_tol)
        self.step_size = float(step_size)
        self.step_decay = float(step_decay)

        self._pool = ThreadPoolExecutor(
            max_workers=max(int(workers), 1),
            thread_name_prefix="sched-prepare")
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # adopted-plan state and prepare-order tails, keyed weakly on the
        # stream OBJECT: a dead stream's state is evicted with it (a
        # long-lived scheduler must not accumulate every stream it ever
        # served), and — unlike id() keys — a new stream allocated at a
        # recycled address can never inherit a dead stream's plan
        self._streams: "weakref.WeakKeyDictionary[StreamingTensor, _StreamState]" \
            = weakref.WeakKeyDictionary()
        self._stream_tail: "weakref.WeakKeyDictionary[StreamingTensor, threading.Event]" \
            = weakref.WeakKeyDictionary()
        self._futures: list[Future] = []  # submitted since the last drain()
        self._ready: dict[int, _Job] = {}  # prepared, awaiting the consumer
        self._next_seq = 0  # next submission number
        self._next_run = 0  # next seq the consumer will execute
        self._closed = False
        # busy-window accounting: wall time only accrues while work is in
        # flight, so idle gaps between bursts do not dilute the overlap
        # numbers of a long-lived scheduler
        self._busy_wall = 0.0
        self._burst_start: float | None = None
        self._totals = {
            "submitted": 0, "completed": 0, "failed": 0,
            "host_s": 0.0, "device_s": 0.0,
            # serving-tier aggregates (per-stream values on DistHooiStats)
            "queue_wait_s": 0.0, "slo_hit": 0, "slo_miss": 0,
        }
        self._decisions = collections.Counter()
        self._consumer = threading.Thread(
            target=self._consume, name="sched-run", daemon=True)
        self._consumer.start()

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "StreamScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Drain outstanding work, then stop the worker threads."""
        self._pool.shutdown(wait=True)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._consumer.join()

    # --------------------------------------------------------------- submit
    def submit(
        self,
        source: SparseTensor | StreamingTensor,
        *,
        name: str | None = None,
        seed: int = 0,
        n_invocations: int | None = None,
        deadline_s: float | None = None,
        objective=None,
        draw: Draw | None = None,
    ) -> Future:
        """Queue one decomposition of ``source``'s current state.

        For a ``StreamingTensor`` the state is snapshotted by the producer
        stage — an append racing a submit is picked up by the prepare that
        runs after it (bounded staleness; submits of one stream are
        prepared strictly in submission order).

        ``deadline_s`` is an SLO budget on submit -> result latency: the
        run still completes past it, but ``stats.slo_met`` (and the
        ``slo_hit``/``slo_miss`` totals) record whether it was honored.

        ``objective`` overrides the scheduler's default sweep objective for
        this submission (a name or an ``engine.objective.Objective``). A
        stream's adopted plan is per-objective: switching objectives on the
        same stream replans from scratch on first sight of the new one.

        ``draw`` fills the run's random-draw seam (``repro_torch.random``;
        None draws from a generator seeded by ``seed``).
        """
        if name is None:
            name = getattr(source, "name", None) or "tensor"
        fut: Future = Future()
        with self._lock:
            # _closed check and pool hand-off both under the lock: the
            # wait_event chain relies on the pool receiving same-stream
            # jobs in submission order, and a close() racing this submit
            # must not leave an unresolvable future in _futures
            if self._closed:
                raise RuntimeError("scheduler is closed")
            job = _Job(
                seq=self._next_seq,
                name=str(name),
                source=source,
                seed=int(seed),
                n_invocations=self.n_invocations
                if n_invocations is None else int(n_invocations),
                future=fut,
                objective=self.objective if objective is None
                else resolve_objective(objective),
                draw=draw,
                submit_t=time.perf_counter(),
                deadline_s=None if deadline_s is None else float(deadline_s),
            )
            if isinstance(source, StreamingTensor):
                # chain per-stream prepares: FIFO pool order (enqueue under
                # this lock) guarantees the predecessor was dequeued first,
                # so waiting on it cannot deadlock the worker pool
                job.wait_event = self._stream_tail.get(source)
                job.done_event = threading.Event()
                self._stream_tail[source] = job.done_event
            try:
                self._pool.submit(self._prepare_safely, job)
            except RuntimeError as e:  # pool shut down under us
                if job.done_event is not None:
                    job.done_event.set()  # unblock any chained successor
                raise RuntimeError("scheduler is closed") from e
            self._next_seq += 1
            self._futures.append(fut)
            # bound retention: callers consuming results future-by-future
            # (never draining) must not accumulate one ScheduledResult per
            # submission forever; pending futures are never dropped
            while len(self._futures) > MAX_RETAINED_FUTURES \
                    and self._futures[0].done():
                self._futures.pop(0)
            self._totals["submitted"] += 1
            if self._burst_start is None:
                self._burst_start = time.perf_counter()
        return fut

    def drain(self, *, return_exceptions: bool = False) -> list:
        """Block until everything submitted since the last ``drain``
        finished; results in submission order.

        All jobs are waited on *before* any failure is raised, so one bad
        job never aborts the batch mid-flight. With the default
        ``return_exceptions=False`` the first failure re-raises and the
        batch's other results are discarded with the drained futures —
        when partial results matter, pass ``return_exceptions=True``
        (exceptions appear in-place, like ``asyncio.gather``) or keep the
        ``submit()``-returned futures yourself.

        Consuming: drained futures are released. Retention between drains
        is bounded (``MAX_RETAINED_FUTURES``) — drain at least that often,
        or hold the futures yourself."""
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

    # ------------------------------------------------------- pool interface
    def pending(self) -> int:
        """Jobs submitted but not yet finished (router backlog signal)."""
        with self._lock:
            return (self._totals["submitted"] - self._totals["completed"]
                    - self._totals["failed"])

    def adopted_plan(self, src: StreamingTensor) -> PartitionPlan | None:
        """The plan this scheduler currently holds for ``src`` (or None)."""
        with self._lock:
            state = self._streams.get(src)
            return None if state is None else state.plan

    def adopt(self, src: StreamingTensor, pl: PartitionPlan,
              objective=None) -> bool:
        """Warm-start: adopt an externally built plan for ``src``.

        The router's reroute path hands a ``PartitionPlan.save()``/
        ``load()`` round-tripped plan from another lane here, so the first
        submit on this lane replays the stream's refresh ladder (``reuse``
        / ``repartition``) instead of rerunning the full selector. The
        plan must describe ``src``'s *current* snapshot — on a fingerprint
        mismatch (the stream grew since serialization) or an objective
        mismatch adoption is refused and the caller falls back to a cold
        plan. Uploads are staged immediately so the adopting lane's first
        run finds its device arrays resident.
        """
        obj = self.objective if objective is None \
            else resolve_objective(objective)
        if pl.objective != obj.name:
            return False
        t = obj.prepare_tensor(src.snapshot())
        if pl.fingerprint is None or pl.fingerprint != t.fingerprint():
            return False
        version = getattr(t, "_stream_version", src.version)
        self._adopt(src, pl, t, version, obj)
        self.executor.stage_upload(pl, t)
        return True

    # ------------------------------------------------------ result delivery
    @staticmethod
    def _deliver(fut: Future, *, result=None, exc=None) -> None:
        """Resolve a job's future, tolerating caller-side cancellation.

        ``Future.cancel()`` can win on a still-pending job; ``set_result``
        then raises ``InvalidStateError``, which must not kill the worker
        threads — the job's slot bookkeeping (``_ready``/counters) is what
        keeps the pipeline advancing, not the future itself.
        """
        try:
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)
        except InvalidStateError:
            pass  # cancelled by the caller; the work is simply dropped

    def _note_finished(self, failed: bool) -> None:
        """Completion bookkeeping (under ``_cv``): close the busy window
        when the last in-flight job finishes."""
        self._totals["failed" if failed else "completed"] += 1
        done = self._totals["completed"] + self._totals["failed"]
        if done >= self._totals["submitted"] and self._burst_start is not None:
            self._busy_wall += time.perf_counter() - self._burst_start
            self._burst_start = None

    # -------------------------------------------------------- producer side
    def _prepare_safely(self, job: _Job) -> None:
        try:
            if job.wait_event is not None:
                job.wait_event.wait()
            try:
                t0 = time.perf_counter()
                if isinstance(job.source, StreamingTensor):
                    self._prepare_stream(job, job.source)
                else:
                    # the objective's training view is what gets planned,
                    # uploaded AND swept — prepare_tensor is idempotent on
                    # its own output, so the executor sees the same object
                    job.tensor = job.objective.prepare_tensor(job.source)
                    job.decision = "plan"
                    job.core_dims = self.core_dims
                    job.plan, _ = self.executor.prepare(
                        job.tensor, self.core_dims, self.scheme,
                        path=self.path, plan_seed=self.plan_seed,
                        pad_geometric=self.pad_geometric,
                        objective=job.objective)
                job.prepare_s = time.perf_counter() - t0
            finally:
                if job.done_event is not None:
                    job.done_event.set()
        except BaseException as e:  # noqa: BLE001 — delivered via the future
            job.plan = None  # consumer skips it
            with self._cv:
                self._note_finished(failed=True)
                self._ready[job.seq] = job
                self._cv.notify_all()
            self._deliver(job.future, exc=e)
            return
        with self._cv:
            self._ready[job.seq] = job
            self._cv.notify_all()

    def _prepare_stream(self, job: _Job, src: StreamingTensor) -> None:
        """Stage 1 for a stream: snapshot, refresh ladder, plan, stage."""
        ex = self.executor
        obj = job.objective
        # the refresh ladder runs on the objective's training VIEW of the
        # snapshot: completion's per-element holdout hash is append-stable,
        # so view(k+1) = view(k) + the appended batch's training entries in
        # order — exactly the prefix property extend_scheme relies on
        t = obj.prepare_tensor(src.snapshot())
        version = getattr(t, "_stream_version", src.version)
        job.tensor = t
        job.stream_version = version
        with self._lock:
            state = self._streams.get(src)
            if state is not None and state.objective != obj.cache_token():
                state = None  # other-objective plan: stale view, replan
        # adaptive rank: the stream's current ranks, not the scheduler
        # default — the post-run policy mutates state.core_dims
        dims = self.core_dims if state is None or state.core_dims is None \
            else state.core_dims
        job.core_dims = dims

        if state is None:
            # first sight of this stream (under this objective): full
            # real-time selection
            pl, _ = ex.prepare(t, dims, self.scheme,
                               path=self.path, plan_seed=self.plan_seed,
                               pad_geometric=self.pad_geometric,
                               objective=obj)
            job.decision = "plan"
            self._adopt(src, pl, t, version, obj)
            job.plan = pl
            return

        if state.version == version:
            # nothing appended: the plan (and its resident uploads) stand
            job.decision = "reuse"
            job.plan = state.plan
            ex.stage_upload(state.plan, t)  # idempotent; 0 transfers
            return

        # appended batches: project them onto the adopted owner maps and
        # ask the invalidation predicate (§4 imbalance drift). The batch
        # is sliced out of the *snapshot view* (appends are concatenated in
        # order), not re-read from the stream — an append racing this
        # prepare lands in the next submit's snapshot, never in a policy
        # extension longer than the tensor it extends
        covered = len(state.plan.scheme.policy(0))
        new_coords = t.coords[covered:]
        loads = [
            state.loads[n] + np.bincount(
                np.asarray(state.owner_maps[n])[new_coords[:, n]],
                minlength=state.plan.P)
            for n in range(t.ndim)
        ]
        # fourth-rung eligibility: sampling on, carried factors to refine,
        # genuinely new data since the last refine (never fires on an
        # unchanged stream version), no failed refine awaiting correction,
        # and the correction cadence not yet due. Eligibility only *offers*
        # the rung; refresh_decision still demands low drift and a modeled
        # cost win before picking it.
        nnz = int(t.nnz)
        stoch = None
        if self.sample_fraction is not None:
            with self._lock:
                eligible = (state.factors is not None
                            and not state.stoch_failed
                            and nnz > state.refined_nnz
                            and (self.correction_every <= 0
                                 or state.stoch_count + 1
                                 < self.correction_every))
                refined = state.refined_nnz
            if eligible:
                stoch = {
                    "sampled_nnz": min(self.replay_nnz, refined)
                    + int(self.sample_fraction * (nnz - refined)),
                    "total_nnz": nnz,
                }
                if self.stochastic_tol is not None:
                    stoch["tol"] = self.stochastic_tol
        decision, drift = refresh_decision(state.plan, loads,
                                           tol=self.drift_tol,
                                           baseline=state.baseline,
                                           stochastic=stoch)
        job.drift = drift
        job.decision = decision
        if decision == "stochastic-refine":
            # the adopted plan stands untouched — version/loads/extender
            # still describe exactly the pre-append prefix, so a later
            # repartition's covered-slicing stays exact. Incorporation is
            # tracked at prepare time (the next submit's prepare may run
            # before this refine's sweep — same pipeline discipline as
            # state.version); a failed run flips stoch_failed in _consume
            # and the next submit takes the full correction path.
            job.plan = state.plan
            with self._lock:
                job.stoch = {"covered_nnz": state.refined_nnz,
                             "step_index": state.stoch_count}
                state.refined_nnz = nnz
                state.refined_version = version
                state.stoch_count += 1
            return
        if decision == "repartition":
            # keep the selected scheme; extend its policies to the appended
            # elements (O(batch)) and rebuild the padded partitions. The §4
            # metrics extend incrementally too (O(batch), same numbers as a
            # recompute); the extender state is built once, on the covered
            # prefix of the view, the first time this path runs
            if state.extender is not None and state.extender.nnz != covered:
                # extend() mutates before ex.prepare() can fail (e.g. a
                # killed prepare): the incremental state ran ahead of the
                # still-adopted plan — discard and rebuild on the prefix
                state.extender = None
            if state.extender is None:
                prefix = SparseTensor(coords=t.coords[:covered],
                                      values=t.values[:covered],
                                      shape=t.shape)
                state.extender = MetricsExtender(
                    prefix, state.plan.scheme, dims)
            scheme2 = extend_scheme(state.plan.scheme, state.owner_maps,
                                    new_coords)
            metrics = state.extender.extend(new_coords, scheme2)
            pl, _ = ex.prepare(t, dims, scheme2, path=self.path,
                               pad_geometric=self.pad_geometric,
                               objective=obj, metrics=metrics)
            with self._lock:
                state.plan = pl
                state.version = version
                state.loads = [np.asarray(mp.e_per_rank).copy()
                               for mp in pl.parts]
                # owner maps AND the drift baseline are kept: existing
                # slices' majority owners are what the extension just
                # reinforced, and drift stays measured against the
                # imbalance at *selection* (no ratcheting via repeated
                # repartitions)
                # a full sweep will (re)incorporate every view element —
                # reset the stochastic rung's cadence and coverage
                state.refined_nnz = nnz
                state.refined_version = version
                state.stoch_count = 0
        else:
            pl, _ = ex.prepare(t, dims, self.scheme,
                               path=self.path, plan_seed=self.plan_seed,
                               pad_geometric=self.pad_geometric,
                               objective=obj)
            self._adopt(src, pl, t, version, obj)
        job.plan = pl

    def _adopt(self, src: StreamingTensor, pl: PartitionPlan,
               t: SparseTensor, version: int, obj=None) -> None:
        """Make ``pl`` the stream's reference plan for drift tracking."""
        obj = self.objective if obj is None else obj
        state = _StreamState(
            plan=pl,
            version=version,
            owner_maps=slice_owner_maps(pl, t),
            loads=[np.asarray(mp.e_per_rank).copy() for mp in pl.parts],
            baseline=tuple(max(float(m.ttm_imbalance), 1.0)
                           for m in pl.metrics.per_mode),
            objective=obj.cache_token(),
            core_dims=tuple(pl.core_dims),
            refined_nnz=int(t.nnz),
            refined_version=version,
        )
        with self._lock:
            # carry the warm-start factors and rank trace across the
            # reselect rung: a fresh selection changes the *distribution*,
            # not the decomposition the stream has converged toward
            prev = self._streams.get(src)
            if prev is not None and prev.objective == state.objective:
                state.factors = prev.factors
                state.rank_trajectory = prev.rank_trajectory
                state.last_full_fit = prev.last_full_fit
            self._streams[src] = state

    def _after_stream_run(self, job: _Job, src: StreamingTensor,
                          dims: Sequence[int], dec, stats) -> None:
        """Post-run stream bookkeeping: factor carry + adaptive rank.

        Runs on the consumer thread right after the sweep. Stores the
        decomposition's factors as the stream's next ``init_factors`` (the
        sketch warm start seeds from them), and — with ``adaptive_rank`` —
        feeds the run's tail spectra to ``adapt_rank``: a changed rank
        re-scores the adopted plan in place via ``rescore_plan`` (same
        ``parts`` tuple → the executor's resident uploads survive; only
        genuinely new step signatures compile). The trace lands on
        ``stats.rank_trajectory``.
        """
        with self._lock:
            state = self._streams.get(src)
        if state is None or state.objective != job.objective.cache_token():
            return
        # the stochastic rung *requires* carried factors (it refines them),
        # so sampling keeps them even when the warm start is off
        if self._warm_resolved != "none" or self.sample_fraction is not None:
            state.factors = dec.factors
        with self._lock:
            state.stoch_failed = False  # any successful run re-anchors
            if job.decision == "stochastic-refine":
                if state.last_full_fit is not None and stats.fits:
                    stats.fit_delta = float(stats.fits[-1]) \
                        - float(state.last_full_fit)
            elif stats.fits:
                state.last_full_fit = float(stats.fits[-1])
        if job.decision == "stochastic-refine":
            # no adaptive rank off a minibatch spectrum — and rescore_plan
            # would rightly refuse the grown snapshot anyway
            return
        if not self.adaptive_rank or not stats.mode_spectra:
            return
        new_dims = tuple(
            adapt_rank(stats.mode_spectra[n], int(dims[n]),
                       **self.rank_policy)
            for n in range(len(dims)))
        pl2 = job.plan
        if new_dims != tuple(dims):
            pl2 = rescore_plan(job.plan, job.tensor, new_dims,
                               objective=job.objective)
        with self._lock:
            state.core_dims = new_dims
            if pl2 is not job.plan and state.plan is job.plan:
                # adopt the rescored plan for the refresh ladder; the
                # incremental metrics state was rank-parameterized, rebuild
                # it lazily at the next repartition
                state.plan = pl2
                state.extender = None
            state.rank_trajectory.append({
                "stream_version": job.stream_version,
                "core_dims": tuple(int(k) for k in new_dims),
                "modeled_total_s": float(pl2.cost.total_s),
            })
            stats.rank_trajectory = list(state.rank_trajectory)

    # -------------------------------------------------------- consumer side
    def _consume(self) -> None:
        while True:
            with self._cv:
                while self._next_run not in self._ready and not self._closed:
                    self._cv.wait()
                if self._next_run not in self._ready:
                    return  # closed and drained
                job = self._ready.pop(self._next_run)
                self._next_run += 1
            if job.plan is None:  # producer failed; future already set
                continue
            if job.future.cancelled():  # caller gave up before the sweep
                with self._cv:
                    self._note_finished(failed=True)
                continue
            try:
                dims = job.core_dims or self.core_dims
                src = job.source \
                    if isinstance(job.source, StreamingTensor) else None
                init = None
                if src is not None and (self._warm_resolved != "none"
                                        or self.sample_fraction is not None):
                    with self._lock:
                        state = self._streams.get(src)
                        facs = None if state is None else state.factors
                    # factors only carry onto the same mode sizes (streams
                    # append elements, not rows — but stay defensive)
                    if facs is not None and all(
                            int(f.shape[0]) == s
                            for f, s in zip(facs, job.tensor.shape)):
                        init = facs
                t0 = time.perf_counter()
                if job.stoch is not None:
                    # the rung's budget is ONE pass — O(batch) device work
                    # regardless of the scheduler's full-sweep invocation
                    # count (the periodic correction sweep is what restores
                    # full-accuracy fits)
                    dec, stats = self.executor.run_stochastic(
                        job.tensor, dims, job.plan,
                        init_factors=init,
                        covered_nnz=job.stoch["covered_nnz"],
                        sample_fraction=self.sample_fraction,
                        sample_seed=self.sample_seed,
                        replay_nnz=self.replay_nnz,
                        step_size=self.step_size,
                        step_decay=self.step_decay,
                        step_index=job.stoch["step_index"],
                        n_invocations=1,
                        seed=job.seed, objective=job.objective,
                        draw=job.draw)
                else:
                    dec, stats = self.executor.run(
                        job.tensor, dims, job.plan,
                        n_invocations=job.n_invocations, path=self.path,
                        seed=job.seed,
                        use_fused_oracle=self.use_fused_oracle,
                        objective=job.objective,
                        warm_start=self.warm_start, init_factors=init,
                        draw=job.draw)
                t1 = time.perf_counter()
                run_s = t1 - t0
                if src is not None:
                    self._after_stream_run(job, src, dims, dec, stats)
                stats.stream_decision = job.decision
                stats.stream_drift = job.drift
                stats.prepare_s = job.prepare_s
                # serving-tier accounting: wait = everything between submit
                # and sweep start that was not the prepare work itself; the
                # SLO clock is the caller-visible submit -> result latency
                queue_wait = max(0.0, (t0 - job.submit_t) - job.prepare_s)
                slo_met = None if job.deadline_s is None \
                    else (t1 - job.submit_t) <= job.deadline_s
                stats.queue_wait_s = queue_wait
                stats.run_s = run_s
                stats.slo_deadline_s = job.deadline_s
                stats.slo_met = slo_met
                stats.lane = self.lane
                res = ScheduledResult(
                    name=job.name, seq=job.seq, decomposition=dec,
                    stats=stats, plan=job.plan, decision=job.decision,
                    drift=job.drift, prepare_s=job.prepare_s, run_s=run_s,
                    stream_version=job.stream_version,
                    queue_wait_s=queue_wait, slo_met=slo_met)
                with self._cv:
                    self._note_finished(failed=False)
                    self._totals["host_s"] += job.prepare_s
                    self._totals["device_s"] += run_s
                    self._totals["queue_wait_s"] += queue_wait
                    if slo_met is not None:
                        self._totals["slo_hit" if slo_met else
                                      "slo_miss"] += 1
                    self._decisions[job.decision] += 1
                self._deliver(job.future, result=res)
            except BaseException as e:  # noqa: BLE001
                if job.stoch is not None \
                        and isinstance(job.source, StreamingTensor):
                    # the refine marked its elements incorporated at
                    # prepare time but died before touching the factors:
                    # force the next submit down a full correction path
                    with self._lock:
                        state = self._streams.get(job.source)
                        if state is not None:
                            state.stoch_failed = True
                with self._cv:
                    self._note_finished(failed=True)
                self._deliver(job.future, exc=e)

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        """Pipeline totals: the overlap proof in numbers.

        ``wall_s`` is the accumulated *busy* wall time — each window runs
        from a submit into an idle pipeline until its last in-flight job
        finishes, so idle gaps between bursts do not dilute it. ``host_s``
        and ``device_s`` are the summed stage times. ``overlap_s = host_s
        + device_s - wall_s`` is the wall time the pipeline *hid* — what
        sequential plan-then-sweep execution would have paid on top.
        """
        with self._lock:
            out = dict(self._totals)
            out["decisions"] = dict(self._decisions)
            wall = self._busy_wall
            if self._burst_start is not None:  # burst still in flight
                wall += time.perf_counter() - self._burst_start
            out["wall_s"] = wall
            out["overlap_s"] = max(
                0.0, out["host_s"] + out["device_s"] - wall) if wall else 0.0
            return out
