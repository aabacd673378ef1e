"""PartitionPlan: distribution plans and the real-time ``auto`` selector.

The port's own copy of the reference's ``core/plan.py``, limited to what the
distributed main path uses. Its arrays are host numpy; a build's passes over
the elements run in PyTorch on the plan's device (``core/tally.py``):

  * ``PartitionPlan`` bundles what host-side partitioning produces for one
    (tensor, scheme, P) triple: the ``Scheme``, the padded per-mode
    ``ModePartition`` arrays, the §4 ``SchemeMetrics`` and an analytic
    ``PlanCost``.
  * ``plan(t, scheme, P)`` is the single constructor. Plans are cached
    in-process with LRU eviction, keyed by tensor *content*
    (``SparseTensor.fingerprint()``), so a second run on the same tensor
    skips all host-side partitioning.
  * ``scheme="auto"`` builds the cheap candidates (``lite``, ``coarse``,
    ``medium``), scores each with the cost model and returns the
    predicted-fastest plan.
  * ``save()``/``load()`` (and ``load_plan``) extend the amortization across
    processes: a plan serializes to one ``.npz`` in the reference's format
    (a file either package writes loads in the other) and is validated
    against the tensor's fingerprint and the objective on load.

  * the streaming helpers the scheduler's refresh ladder runs on:
    ``slice_owner_maps`` (slice -> rank under an adopted plan),
    ``extend_scheme`` (policies extended to appended elements in
    O(batch)), ``stochastic_refine_seconds`` and ``refresh_decision``
    (the §4 drift test that picks the rung) and ``rescore_plan`` (new core
    dims on the same partitions).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time
from typing import Sequence

import numpy as np

from repro_torch import tracing

from . import tally
from .calibrate import current_cost_model, current_cost_model_state
from .coo import SparseTensor
from .distribution import Scheme, build_scheme, row_owner_map
from .metrics import ModeMetrics, SchemeMetrics, scheme_metrics

__all__ = [
    "PlanCost",
    "PartitionPlan",
    "plan",
    "load_plan",
    "AUTO_CANDIDATES",
    "plan_cache_stats",
    "plan_cache_clear",
    "last_plan_call_cache_hit",
    "slice_owner_maps",
    "extend_scheme",
    "stochastic_refine_seconds",
    "refresh_decision",
    "rescore_plan",
]

# Candidates for real-time selection: the schemes whose construction is cheap
# enough to run inline before every decomposition (paper Fig 16).
AUTO_CANDIDATES = ("lite", "coarse", "medium")

PLAN_FILE_VERSION = 1

@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Modeled per-invocation wall time of one HOOI sweep under a plan.

    Deterministic function of the §4 metrics and the current ``CostModel`` —
    measured (noisy) build time is kept separately on
    ``PartitionPlan.build_s`` so selection is reproducible.
    """

    flops_s: float  # critical-path TTM+SVD flops / rates (= ttm_s + svd_s)
    comm_s: float  # per-device collective bytes (comm_model + fm volume) / BW
    comm_bytes: float
    path: str  # collective path ("baseline" | "liteopt" | "auto") costed
    # per-phase split under the CostModel's (possibly calibrated) phase
    # rates; defaults keep pre-phase plan files loadable
    ttm_s: float = 0.0  # bottleneck-rank TTM (Z build) seconds
    svd_s: float = 0.0  # bottleneck-rank Lanczos/SVD seconds
    # per-mode comm backend the engine will run ("local"|"psum"|"boundary");
    # defaults keep pre-engine plan files loadable
    mode_backends: tuple = ()
    # modeled comm seconds per whole-plan backend choice — what lets the
    # auto selector score comm backends, not just schemes
    backend_s: dict | None = None

    @property
    def total_s(self) -> float:
        return self.flops_s + self.comm_s


@dataclasses.dataclass(frozen=True, eq=False)
class PartitionPlan:
    """Everything host-side partitioning produces, ready for the runtime.

    ``eq=False``: plans compare by identity — the cache contract is that a
    hit returns the *same object*, so sharing is observable and device-side
    uploads keyed on the plan (``HooiExecutor``) can be reused.
    """

    scheme: Scheme
    parts: tuple  # tuple[ModePartition, ...] (distributed.partition)
    metrics: SchemeMetrics
    cost: PlanCost
    core_dims: tuple[int, ...]
    P: int
    build_s: float  # measured host-side construction wall time
    cache_key: tuple | None = None
    # auto only: modeled total_s per candidate name (selection transparency)
    candidates: dict | None = None
    # content hash of the tensor this plan was built for (save/load guard).
    # For plans built from a StreamingTensor snapshot this is the stream's
    # *chain* fingerprint (incremental hash of the append history) — equally
    # content-identifying, O(batch) to maintain.
    fingerprint: str | None = None
    # stream version the fingerprint corresponds to (None for one-shot
    # tensors); lets persisted plans say *which* state of a stream they
    # describe
    stream_version: int | None = None
    # partitions built with geometric (pow2) pad quantization — part of the
    # compiled-shape contract, so it must survive save/load
    pad_geometric: bool = False
    # sweep objective this plan partitions and scores ("tucker" |
    # "completion" | "nn"): a completion plan describes the objective's
    # *training view* of the tensor, and the cost includes the objective's
    # extra FLOP terms — running it under another objective would be wrong
    # twice, so executors and load() refuse a mismatch
    objective: str = "tucker"
    # host seconds of the build's parts (fingerprint, scheme, partition,
    # metrics, cost), stamped like build_s; None for a loaded plan
    build_parts_s: dict | None = None

    @property
    def name(self) -> str:
        return self.scheme.name

    @property
    def nmodes(self) -> int:
        return self.scheme.nmodes

    def comm(self, mode: int) -> dict:
        """Per-mode analytic comm model (same dict dist_hooi reports)."""
        from repro_torch.distributed.partition import comm_model

        n = mode
        K = self.core_dims
        khat = int(np.prod([K[j] for j in range(len(K)) if j != n]))
        return comm_model(self.parts[n], khat, 2 * int(K[n]))

    # ------------------------------------------------------------ persistence
    def save(self, path) -> None:
        """Serialize to one ``.npz`` for cross-process reuse (``load``).

        Stores the scheme policies, every padded ``ModePartition`` array, the
        §4 metrics, the modeled cost, the objective and the source tensor's
        fingerprint. ``path`` is a filename or a binary file-like object.
        The arrays are stored uncompressed (``np.savez``; the reference
        compresses, and ``load`` reads both): zlib over a large plan's
        arrays costs more than the plan build a warm start saves.
        """
        if self.fingerprint is None:
            raise ValueError(
                "plan has no tensor fingerprint — rebuild it with "
                "repro_torch.core.plan.plan()")
        arrays: dict[str, np.ndarray] = {}
        policies = self.scheme.policies[:1] if self.scheme.uni \
            else self.scheme.policies
        for n, pol in enumerate(policies):
            arrays[f"policy_{n}"] = np.asarray(pol)
        mp_scalars = []
        for n, mp in enumerate(self.parts):
            scalars = {}
            for f in dataclasses.fields(mp):
                v = getattr(mp, f.name)
                if isinstance(v, np.ndarray):
                    arrays[f"mp{n}_{f.name}"] = v
                else:
                    scalars[f.name] = int(v)
            mp_scalars.append(scalars)
        meta = {
            "version": PLAN_FILE_VERSION,
            "fingerprint": self.fingerprint,
            "scheme": {"name": self.scheme.name, "uni": self.scheme.uni,
                       "P": self.scheme.P, "nmodes": self.scheme.nmodes},
            "mp_scalars": mp_scalars,
            "metrics": dataclasses.asdict(self.metrics),
            "cost": dataclasses.asdict(self.cost),
            "core_dims": list(self.core_dims),
            "P": self.P,
            "build_s": self.build_s,
            "candidates": self.candidates,
            "stream_version": self.stream_version,
            "pad_geometric": self.pad_geometric,
            "objective": self.objective,
        }
        np.savez(path, __meta__=np.array(json.dumps(meta)), **arrays)

    @classmethod
    def load(cls, path, t: SparseTensor, objective=None) -> "PartitionPlan":
        """Deserialize a plan and validate it against ``t``.

        Raises ``ValueError`` on an unknown file version, on an objective
        mismatch (``objective``: None honors ``REPRO_OBJECTIVE``, default
        tucker; a name or an ``Objective``) and on a fingerprint mismatch;
        the objective's view of ``t`` is taken before the fingerprint check,
        as when the plan was built.
        """
        from repro_torch.distributed.partition import ModePartition
        from repro_torch.engine.objective import resolve_objective

        obj = resolve_objective(objective)
        t = obj.prepare_tensor(t)
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["__meta__"]))
            if meta.get("version") != PLAN_FILE_VERSION:
                raise ValueError(
                    f"unsupported plan file version {meta.get('version')!r}")
            saved_objective = meta.get("objective", "tucker")
            if saved_objective != obj.name:
                raise ValueError(
                    f"plan file was built for objective="
                    f"{saved_objective!r}, asked to load for {obj.name!r} — "
                    "refusing to apply it across objectives")
            fp = t.fingerprint()
            if meta["fingerprint"] != fp:
                raise ValueError(
                    f"plan was built for tensor {meta['fingerprint'][:12]}…, "
                    f"got {fp[:12]}… — refusing to apply a stale plan")
            sm = meta["scheme"]
            if sm["uni"]:
                pol = z["policy_0"]
                policies = tuple(pol for _ in range(sm["nmodes"]))
            else:
                policies = tuple(z[f"policy_{n}"]
                                 for n in range(sm["nmodes"]))
            scheme = Scheme(name=sm["name"], policies=policies,
                            uni=sm["uni"], P=sm["P"])
            parts = []
            for n, scalars in enumerate(meta["mp_scalars"]):
                kw = dict(scalars)
                for f in dataclasses.fields(ModePartition):
                    if f.name not in kw:
                        kw[f.name] = z[f"mp{n}_{f.name}"]
                parts.append(ModePartition(**kw))
        md = meta["metrics"]
        metrics = SchemeMetrics(
            **{**md, "per_mode": tuple(ModeMetrics(**m)
                                       for m in md["per_mode"]),
               "core_dims": tuple(md["core_dims"])})
        cd = dict(meta["cost"])
        if "mode_backends" in cd:  # JSON turns tuples into lists
            cd["mode_backends"] = tuple(cd["mode_backends"])
        return cls(
            scheme=scheme,
            parts=tuple(parts),
            metrics=metrics,
            cost=PlanCost(**cd),
            core_dims=tuple(meta["core_dims"]),
            P=int(meta["P"]),
            build_s=float(meta["build_s"]),
            cache_key=None,
            candidates=meta["candidates"],
            fingerprint=meta["fingerprint"],
            stream_version=meta.get("stream_version"),
            pad_geometric=bool(meta.get("pad_geometric", False)),
            objective=saved_objective,
        )


def load_plan(path, t: SparseTensor, objective=None) -> PartitionPlan:
    """Module-level alias for ``PartitionPlan.load``."""
    return PartitionPlan.load(path, t, objective=objective)


# ---------------------------------------------------------------- cost model
_PATH_BACKEND = {"baseline": "psum", "liteopt": "boundary"}


def _plan_cost(
    parts: Sequence, metrics: SchemeMetrics, core_dims: Sequence[int],
    path: str, model, objective=None
) -> PlanCost:
    from repro_torch.distributed.partition import comm_model
    from repro_torch.engine.comm import backend_comm_bytes, cheaper_backend

    N = len(core_dims)
    P = int(parts[0].P) if parts else 1
    per_mode = []
    for n in range(N):
        khat = int(np.prod([core_dims[j] for j in range(N) if j != n]))
        per_mode.append(comm_model(parts[n], khat, 2 * int(core_dims[n])))
    # factor-matrix rows move once per mode step regardless of backend (§4.2)
    fm_bytes = metrics.fm_volume * 4.0

    # score every comm backend (per-mode bytes at its — possibly
    # calibrated — per-backend bandwidth), so the auto selector can compare
    # backends, not just schemes
    backend_s = {
        b: sum(model.comm_seconds(backend_comm_bytes(b, c), b)
               for c in per_mode)
        + model.comm_seconds(fm_bytes)
        for b in ("psum", "boundary")
    }
    if P == 1:
        # the engine's collective-free local backend: only fm traffic
        backend_s["local"] = model.comm_seconds(fm_bytes)
        mode_backends = ("local",) * N
    elif path == "auto":
        # per-mode selection from the partition metrics — the one rule the
        # engine's resolve_backend also applies at run time
        mode_backends = tuple(cheaper_backend(c, model) for c in per_mode)
    else:
        mode_backends = (_PATH_BACKEND[path],) * N
    comm_bytes = fm_bytes + sum(
        backend_comm_bytes(b, c) for c, b in zip(per_mode, mode_backends))
    comm_s = model.comm_seconds(fm_bytes) + sum(
        model.comm_seconds(backend_comm_bytes(b, c), b)
        for c, b in zip(per_mode, mode_backends) if b != "local")
    # per-phase scoring: with default (un-calibrated) phase rates this
    # reduces exactly to critical_path_flops / flop_rate. Objectives that
    # do extra per-mode factor work (NN-ADMM refine) fold their FLOPs into
    # the svd phase — same phase of the sweep, same rate.
    extra = 0.0
    if objective is not None:
        extra = float(objective.extra_svd_flops(metrics, core_dims, model))
    ttm_s, svd_s = model.phase_seconds(metrics.ttm_flops_max,
                                       metrics.svd_flops_max + extra)
    return PlanCost(
        flops_s=ttm_s + svd_s,
        comm_s=comm_s,
        comm_bytes=comm_bytes,
        path=path,
        ttm_s=ttm_s,
        svd_s=svd_s,
        mode_backends=mode_backends,
        backend_s=backend_s,
    )


# --------------------------------------------------------------------- cache
_CACHE: dict[tuple, PartitionPlan] = {}  # insertion-ordered; LRU eviction
_CACHE_LOCK = threading.Lock()
_STATS = {"hits": 0, "misses": 0}
CACHE_MAX_ENTRIES = 128  # plans hold padded per-device arrays — bound them


def plan_cache_stats() -> dict:
    with _CACHE_LOCK:
        return dict(_STATS, size=len(_CACHE))


# per-thread record of the last plan() call's cache outcome: the global
# hit/miss counters are shared, so "did MY call hit?" cannot be answered by
# differencing them once concurrent submitters build plans in parallel
# (another thread's miss in the window would misreport this thread's hit)
_TLS = threading.local()


def last_plan_call_cache_hit() -> bool:
    """Whether the calling thread's most recent ``plan()`` was a cache hit.

    Thread-local, so it stays correct under concurrent plan builds — this
    is what ``HooiExecutor.run`` reports as ``plan_cache_hit``.
    """
    return bool(getattr(_TLS, "cache_hit", False))


def plan_cache_clear() -> None:
    with _CACHE_LOCK:
        _CACHE.clear()
        _STATS["hits"] = 0
        _STATS["misses"] = 0


@contextlib.contextmanager
def _part(parts_s: dict, name: str):
    """Time one part of a plan's build into ``parts_s[name]`` (always, as
    ``build_s``), under the span ``plan.<name>`` (``repro_torch.tracing``)."""
    t0 = time.perf_counter()
    with tracing.span(f"plan.{name}"):
        yield
    parts_s[name] = time.perf_counter() - t0


def _freeze_kw(kw: dict) -> tuple:
    return tuple(sorted((k, repr(v)) for k, v in kw.items()))


# --------------------------------------------------------------- constructor
def _build_plan(
    t: SparseTensor,
    scheme: Scheme,
    core_dims: tuple[int, ...],
    path: str,
    build_s: float,
    cache_key: tuple | None,
    model,
    pad_geometric: bool = False,
    objective=None,
    metrics: SchemeMetrics | None = None,
    *,
    parts_s: dict,
    device=None,
) -> PartitionPlan:
    """The plan of ``scheme``; ``parts_s`` holds the seconds of the parts
    already built (fingerprint, scheme) and gets the rest."""
    from repro_torch.distributed.partition import make_mode_partitions

    t0 = time.perf_counter()
    # the scheme's tallies and device copies, where it was built here
    with tally.scope(t, device):
        with _part(parts_s, "partition"):
            parts = make_mode_partitions(t, scheme,
                                         pad_geometric=pad_geometric)
        with _part(parts_s, "metrics"):
            if metrics is None:
                metrics = scheme_metrics(t, scheme, core_dims)
    with _part(parts_s, "cost"):
        cost = _plan_cost(parts, metrics, core_dims, path, model,
                          objective=objective)
    return PartitionPlan(
        scheme=scheme,
        parts=parts,
        metrics=metrics,
        cost=cost,
        core_dims=core_dims,
        P=scheme.P,
        build_s=build_s + (time.perf_counter() - t0),
        cache_key=cache_key,
        fingerprint=t.fingerprint(),
        stream_version=getattr(t, "_stream_version", None),
        pad_geometric=pad_geometric,
        objective=objective.name if objective is not None else "tucker",
        build_parts_s=parts_s,
    )


def plan(
    t: SparseTensor,
    scheme: str | Scheme = "auto",
    P: int | None = None,
    *,
    core_dims: Sequence[int] | None = None,
    path: str = "liteopt",
    seed: int = 0,
    use_cache: bool = True,
    pad_geometric: bool = False,
    objective=None,
    metrics: SchemeMetrics | None = None,
    device=None,
    **scheme_kw,
) -> PartitionPlan:
    """Single constructor for ``PartitionPlan``.

    ``scheme`` may be a scheme name (including ``"auto"``) or a prebuilt
    ``Scheme`` (bypasses the scheme constructor; still builds partitions,
    metrics and cost — cached by the scheme's *content*, so equal-content
    schemes share one plan). For a prebuilt ``Scheme``, ``P`` must be
    omitted or agree with ``scheme.P``; for names it defaults to 8.

    ``core_dims`` defaults to the paper's K=10 per mode; it parameterizes the
    FLOP/comm cost model and the metrics, not the policies themselves.

    ``pad_geometric`` quantizes the padded partition dimensions to powers of
    two (streaming: compiled shapes survive small appends); it participates
    in the cache key since it changes the parts' shapes.

    ``objective`` selects the sweep objective the plan is built *for* (None
    honors ``REPRO_OBJECTIVE``, default tucker; a name or an
    ``engine.objective.Objective``). The objective's ``prepare_tensor`` view
    is applied first — a completion plan partitions the training view, not
    the raw tensor — its parameters join the cache key, its name is stamped
    on the plan (executors refuse a mismatch), and its extra FLOP terms
    enter the cost the auto selector scores.

    ``metrics`` (prebuilt-``Scheme`` path only) supplies precomputed
    ``SchemeMetrics``, skipping the O(nnz·N²) recompute — the streaming
    scheduler maintains them incrementally across appends
    (``core.metrics.MetricsExtender``).

    ``device`` is where the build's passes over the elements run
    (``repro_torch.device.plan_device``: by default the card when there is
    one, else the CPU). The plan is the same, bit for bit, on either, so it
    is not part of the cache key; nothing the build puts on the device
    outlives the call.
    """
    if path not in ("baseline", "liteopt", "auto"):
        raise ValueError(f"unknown path {path!r}")
    from repro_torch.engine.objective import resolve_objective

    obj = resolve_objective(objective)
    t = obj.prepare_tensor(t)
    N = t.ndim
    core = tuple(int(k) for k in (core_dims or (10,) * N))
    if len(core) != N:
        raise ValueError(f"core_dims has {len(core)} entries for {N} modes")
    # the cost model parameterizes PlanCost: a recalibration must not reuse
    # plans scored under the old rates (model and version read in one
    # snapshot, so the cached cost always matches its key's version)
    model, mv = current_cost_model_state()
    parts_s: dict = {}
    with _part(parts_s, "fingerprint"):
        fp = t.fingerprint()

    if isinstance(scheme, Scheme):
        if P is not None and P != scheme.P:
            raise ValueError(f"scheme built for P={scheme.P}, asked for {P}")
        # key on scheme *content*, never id(): a GC'd scheme's id can be
        # reused by CPython, which would hand a different scheme the old
        # plan; equal-content schemes sharing one cached plan is correct
        key = ("prebuilt", scheme.content_key(), fp, core, path,
               mv, pad_geometric, obj.cache_token())
        parts_s["scheme"] = 0.0
        return _cached(key, use_cache,
                       lambda: _build_plan(t, scheme, core, path, 0.0, key,
                                           model, pad_geometric,
                                           objective=obj, metrics=metrics,
                                           parts_s=parts_s, device=device))
    if metrics is not None:
        raise ValueError("prebuilt metrics are only valid with a prebuilt "
                         "Scheme — named schemes rebuild their policies, "
                         "which would invalidate them")
    P = 8 if P is None else int(P)

    name = scheme.lower()
    key = (fp, name, P, core, path, seed, _freeze_kw(scheme_kw),
           mv, pad_geometric, obj.cache_token())

    if name == "auto":
        def make_auto() -> PartitionPlan:
            t0 = time.perf_counter()
            with tally.scope(t, device):  # one upload for the candidates
                cands = {
                    c: plan(t, c, P, core_dims=core, path=path, seed=seed,
                            use_cache=use_cache, pad_geometric=pad_geometric,
                            objective=obj, **scheme_kw)
                    for c in AUTO_CANDIDATES
                }
            best = min(cands, key=lambda c: cands[c].cost.total_s)
            return dataclasses.replace(
                cands[best],
                cache_key=key,
                build_s=time.perf_counter() - t0,
                candidates={c: p.cost.total_s for c, p in cands.items()},
            )

        return _cached(key, use_cache, make_auto)

    def make() -> PartitionPlan:
        # the device copies, slice sizes and pair counts made once for
        # scheme, parts, metrics
        with tally.scope(t, device):
            with _part(parts_s, "scheme"):
                s = build_scheme(t, name, P, seed=seed, **scheme_kw)
            return _build_plan(t, s, core, path, parts_s["scheme"], key,
                               model, pad_geometric, objective=obj,
                               parts_s=parts_s)

    return _cached(key, use_cache, make)


# --------------------------------------------------- streaming invalidation
def slice_owner_maps(pl: PartitionPlan, t: SparseTensor
                     ) -> tuple[np.ndarray, ...]:
    """Per-mode slice -> rank maps implied by the plan's policies on ``t``.

    ``t`` must be the snapshot the plan was partitioned from (policies are
    per-element). The maps cover every slice — empty slices get round-robin
    owners, the same convention ``row_owner_map`` uses for factor rows — so
    an appended element always has a well-defined rank. Computed once when
    a plan is adopted for a stream (O(nnz·N)); after that the scheduler
    tracks per-rank loads in O(batch) per append.
    """
    if pl.fingerprint is not None and pl.fingerprint != t.fingerprint():
        raise ValueError("owner maps need the snapshot the plan was built "
                         f"from (plan {pl.fingerprint[:12]}…, tensor "
                         f"{t.fingerprint()[:12]}…)")
    with tally.scope(t):  # one upload for every mode
        return tuple(row_owner_map(t, pl.scheme.policy(n), n, pl.P)
                     for n in range(pl.nmodes))


def extend_scheme(scheme: Scheme, owner_maps: Sequence[np.ndarray],
                  new_coords: np.ndarray) -> Scheme:
    """Cheap per-mode repartition: extend policies to appended elements.

    Existing element assignments are untouched (their device placement
    stays stable); each appended element joins, per mode, the rank that
    owns its slice under ``owner_maps``. This is O(batch) host work versus
    a full scheme (re)construction — the streaming analogue of the paper's
    "distribution step cheaper than one HOOI iteration" claim. The result
    is multi-policy even if the source was uni-policy (owner maps differ
    per mode).
    """
    new_coords = np.asarray(new_coords)
    policies = tuple(
        np.concatenate([
            scheme.policy(n),
            np.asarray(owner_maps[n])[new_coords[:, n]].astype(np.int32),
        ])
        for n in range(scheme.nmodes)
    )
    return Scheme(name=scheme.name, policies=policies, uni=False, P=scheme.P)


def stochastic_refine_seconds(pl: PartitionPlan, sampled_nnz: int,
                              total_nnz: int, model=None) -> float:
    """Modeled seconds for one stochastic-refine pass under this plan.

    The minibatch step does the same per-element Z-build/oracle work as a
    full sweep over ``sampled_nnz / total_nnz`` of the elements, times the
    model's ``sampled_pass_overhead`` (single-device execution, full-
    snapshot fit accounting, pow2 padding — everything a full sweep
    amortizes). Scaling the plan's own ``cost.total_s`` keeps the
    comparison apples-to-apples: both sides are scored by the same
    calibrated model, so the *ratio* is what decides the rung.
    """
    if model is None:
        model = current_cost_model()
    frac = min(max(float(sampled_nnz) / max(float(total_nnz), 1.0), 0.0), 1.0)
    overhead = float(getattr(model, "sampled_pass_overhead", 2.0))
    return frac * overhead * float(pl.cost.total_s)


def refresh_decision(pl: PartitionPlan, mode_loads: Sequence[np.ndarray],
                     *, tol: float = 0.25,
                     baseline: Sequence[float] | None = None,
                     stochastic: dict | None = None
                     ) -> tuple[str, dict]:
    """Is the plan's scheme still good for the grown element distribution?

    ``mode_loads``: per-mode per-rank element counts after projecting the
    appended coordinates onto the plan's slice owner maps. The drift signal
    is the §4 Metric-1 load imbalance (E_max / E_avg) this plan *would*
    have, compared against the imbalance it was selected at: within
    ``tol`` relative slack the scheme is kept and only the partitions are
    rebuilt (``"repartition"``, via ``extend_scheme``); beyond it the
    appends have skewed some mode enough that the real-time selector should
    rerun (``"reselect"``).

    ``baseline`` overrides the per-mode comparison imbalances. Callers that
    refresh a plan repeatedly (the scheduler) must pin the baseline to the
    *selection-time* values: ``pl`` is replaced on every repartition, so
    re-deriving the baseline from it would ratchet — a stream skewing a
    little per batch would never cross the tolerance. Defaults to ``pl``'s
    own metrics (correct for a one-shot check).

    ``stochastic`` opts the ladder's fourth rung in: a dict with
    ``sampled_nnz`` and ``total_nnz`` (the minibatch the caller *would*
    run), optional ``tol`` (drift ceiling for sampling, default ``tol/2``)
    and ``model`` (CostModel). When the worst drift ratio is within the
    stochastic tolerance **and** the modeled sampled pass is cheaper than
    the plan's full-sweep cost (``stochastic_refine_seconds``), the
    decision is ``"stochastic-refine"`` — keep the adopted plan untouched
    and update factors from the sampled minibatch only. The ladder is
    monotone in drift by construction: stochastic-refine below
    ``1 + stoch_tol``, repartition up to ``1 + tol``, reselect beyond.

    Returns ``(decision, drift)`` where drift maps mode -> {imbalance,
    baseline, ratio} plus ``"worst"`` — surfaced in ``DistHooiStats``.
    When the stochastic rung was evaluated, drift also carries
    ``"stochastic_s"`` / ``"full_sweep_s"`` (the modeled costs).
    """
    drift: dict = {}
    worst = 0.0
    for n, loads in enumerate(mode_loads):
        loads = np.asarray(loads, dtype=np.float64)
        total = float(loads.sum())
        imb = float(loads.max() * len(loads) / total) if total else 1.0
        if baseline is not None:
            base = max(float(baseline[n]), 1.0)
        else:
            base = max(float(pl.metrics.per_mode[n].ttm_imbalance), 1.0)
        ratio = imb / base
        worst = max(worst, ratio)
        drift[n] = {"imbalance": imb, "baseline": base, "ratio": ratio}
    drift["worst"] = worst
    if worst > 1.0 + tol:
        return "reselect", drift
    if stochastic is not None:
        stoch_tol = float(stochastic.get("tol", tol / 2.0))
        stoch_s = stochastic_refine_seconds(
            pl, stochastic["sampled_nnz"], stochastic["total_nnz"],
            stochastic.get("model"))
        drift["stochastic_s"] = stoch_s
        drift["full_sweep_s"] = float(pl.cost.total_s)
        if worst <= 1.0 + stoch_tol and stoch_s < float(pl.cost.total_s):
            return "stochastic-refine", drift
    return "repartition", drift


def rescore_plan(pl: PartitionPlan, t: SparseTensor,
                 core_dims: Sequence[int], *,
                 objective=None) -> PartitionPlan:
    """Re-score a plan for new ``core_dims`` without repartitioning.

    The adaptive-rank policy changes a mode's ``K_n`` mid-stream; the
    partitions (element placement, padded shapes) do not depend on the
    core dims, so the plan's device arrays stay valid — only the §4
    metrics and the modeled cost are rank-parameterized. The returned plan
    is a ``dataclasses.replace`` copy sharing the **same** ``parts`` tuple,
    which is exactly what the executor's upload cache dedupes on
    (``_uploads_by_parts[id(parts)]``): running the rescored plan uploads
    nothing and compiles only the genuinely-new ``niter``/``K_n`` steps.

    ``t`` must be the (objective-prepared) snapshot the plan was built
    from — metrics are recomputed against its element distribution.
    """
    from repro_torch.engine.objective import resolve_objective

    obj = resolve_objective(objective if objective is not None
                            else pl.objective)
    t = obj.prepare_tensor(t)
    if pl.fingerprint is not None and pl.fingerprint != t.fingerprint():
        raise ValueError("rescore needs the snapshot the plan was built "
                         f"from (plan {pl.fingerprint[:12]}…, tensor "
                         f"{t.fingerprint()[:12]}…)")
    core = tuple(int(k) for k in core_dims)
    if len(core) != pl.nmodes:
        raise ValueError(
            f"core_dims has {len(core)} entries for {pl.nmodes} modes")
    model, _ = current_cost_model_state()
    metrics = scheme_metrics(t, pl.scheme, core)
    cost = _plan_cost(pl.parts, metrics, core, pl.cost.path, model,
                      objective=obj)
    return dataclasses.replace(pl, metrics=metrics, cost=cost,
                               core_dims=core, cache_key=None)


def _cached(key: tuple, use_cache: bool, make) -> PartitionPlan:
    if use_cache:
        with _CACHE_LOCK:
            hit = _CACHE.get(key)
            if hit is not None:
                _STATS["hits"] += 1
                # LRU: a hit moves the entry to the back of the eviction order
                _CACHE[key] = _CACHE.pop(key)
                _TLS.cache_hit = True
                return hit
    p = make()
    # set AFTER make(): auto's candidate sub-calls overwrite the flag, the
    # outermost call's outcome must win for last_plan_call_cache_hit()
    _TLS.cache_hit = False
    if use_cache:
        with _CACHE_LOCK:
            _STATS["misses"] += 1
            # a concurrent builder may have won the race: keep its object so
            # the identity contract (same key -> same plan) holds
            existing = _CACHE.get(key)
            if existing is not None:
                return existing
            _CACHE[key] = p
            while len(_CACHE) > CACHE_MAX_ENTRIES:
                _CACHE.pop(next(iter(_CACHE)))
    return p
