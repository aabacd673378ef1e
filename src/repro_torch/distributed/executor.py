"""HooiExecutor: distributed HOOI over P ranks stacked on one device, or
spread over the device groups of a mesh.

The port of ``src/repro/distributed/executor.py``. The reference runs the P
ranks on P devices of a ``ranks`` mesh, through ``shard_map`` steps it
compiles and caches, over device uploads it caches per plan. Here the P
ranks are a leading dimension of every partition array on one device (the
card, or the CPU when asked), and a ``psum`` is a sum over that dimension in
rank order (``engine.comm``). With ``mesh=`` (``distributed.mesh``) the
ranks are spread over G device groups: each group holds its ranks'
elements and builds and multiplies their Z on its device, and under the
``boundary`` backend also its ranks' rows of the Lanczos u-space (the
groups' factor shards come home for the factor); the psum space, the
v-space, the full COO, the core and the fit stay at the mesh's home (its
first device). A mesh whose groups all lie on one card has its steps
captured as the stacked executor's are, each group's launches a branch of
the graph on its own stream (``repro_torch.graphs``); over distinct cards
they run eagerly, since a graph that spans cards cannot be checked on one
card. A G = 1 mesh is the stacked executor. The
executor owns no math of its own: every
mode step is built by ``engine.steps`` (Z-build -> oracle -> comm backend)
and the sweep loop is the shared ``engine.sweep.run_hooi_sweeps``. What it
owns:

* a **step cache**: step functions keyed on the reference's static
  signature (backend, Z-build and oracle variants, mode, pads, P, K_n,
  niter, precision, panel width, fused build, objective, warm start), LRU
  bounded at ``MAX_COMPILED_STEPS``. A *compilation* is counted exactly as
  the reference counts it: the first call of a (step, shapes) signature.
  On the CPU, and over a mesh whose groups lie on distinct cards, the step
  then runs eagerly. Otherwise on the card (a mesh on one card included) a
  call runs the step
  as CUDA graphs (``repro_torch.graphs``): the first call over a plan's
  arrays is a **capture** (an eager warm-up, then the step captured segment
  by segment), later calls replay. A graph is bound to the arrays it was
  captured over, so captures live with the plan's upload; a plan whose pads
  equal another's shares its steps (no compilation) but captures its own.
* an **upload cache**: each plan's device arrays, keyed weakly on the
  plan's identity and deduplicated on its parts (an ``auto`` plan shares
  its winner's arrays); over a mesh, one set of element arrays per group
  and one of its boundary maps (``comm.group_maps``, packed in one array)
  on its device, the rest at home. On the card they go up through
  pinned memory on a stream of their own (one per group), so
  ``stage_upload`` can run in a producer thread while another thread
  sweeps.
* **calibration**: every sweep of ``run`` appends a sample (modeled flops
  and bytes beside the measured seconds; a sweep that paid a compilation
  or a capture is ``warm=False``), and ``profile_phases`` appends a pure
  TTM probe and a full sweep; ``core.calibrate.fit_cost_model`` fits them.
  A mesh of G > 1 groups labels its samples ``groups=G``.
* the **stochastic-refine rung** (``run_stochastic``): carried factors
  updated from a deterministic minibatch of an append (``core.stochastic``)
  through the same step cache.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import convert, tracing
from repro_torch.core.coo import SparseTensor
from repro_torch.core.distribution import Scheme
from repro_torch.core.hooi import Decomposition, random_factors
from repro_torch.core.plan import (PartitionPlan, last_plan_call_cache_hit,
                                   plan as build_plan, plan_cache_stats)
from repro_torch.core.sketch import DEFAULT_POWER_ITERS
from repro_torch.core.stochastic import (blend_factor, next_pow2,
                                         sample_batch, step_eta)
from repro_torch.core.ttm import core_from_factors
from repro_torch.device import (full_precision_matmul, on_own_device,
                                resolve_device)
from repro_torch.distributed.mesh import (MOVE_KINDS, GroupTensor,
                                          RankMesh, make_ranks_mesh,
                                          u_space_bytes)
from repro_torch.engine.comm import (backend_comm_bytes, comm_maps,
                                     crossing_slots, group_maps,
                                     resolve_backend)
from repro_torch.engine.objective import resolve_objective
from repro_torch.engine.oracle import (ModeSpec, count_z_passes, mode_spec,
                                       resolve_knobs)
from repro_torch.engine.steps import (make_mode_step_fn,
                                      make_stochastic_step_fn,
                                      make_zbuild_step_fn)
from repro_torch.engine.sweep import run_hooi_sweeps
from repro_torch.graphs import CaptureHome, StepGraph
from repro_torch.random import Draw, Key, make_key

from .partition import comm_model  # noqa: F401 — re-export

__all__ = ["HooiExecutor", "shared_executor", "DistHooiStats", "comm_model",
           "upload_mode", "make_ranks_mesh", "RankMesh", "RUN_PATHS"]

MAX_CALIBRATION_SAMPLES = 1024
MAX_COMPILED_STEPS = 256  # step functions (and their captures) per executor
MAX_STOCH_UPLOADS = 32  # resident stochastic minibatches per executor
MAX_SHARED_MESH_EXECUTORS = 8  # shared executors kept for given meshes

RUN_PATHS = ("baseline", "liteopt", "auto")

# arrays one mode's upload moves: coordinates, values, the stacked local
# rows, the six comm-space maps of ``comm.comm_maps`` and the row perm
ARRAYS_PER_MODE = 10


@dataclasses.dataclass
class DistHooiStats:
    """What one ``run`` (or ``run_stochastic``) reports; the reference's
    fields that mean the same.

    * ``fits`` — fit after each sweep;
    * ``sweep_s`` — each sweep's wall seconds (its mode steps, up to the
      device finishing; the core and fit come after);
    * ``comm`` — the plan's analytic per-mode comm model;
    * ``r_pad``/``e_pad`` — per mode, padded local rows and elements per rank;
    * ``scheme``/``selection`` — the scheme that ran (``auto`` resolves to a
      candidate) and, for ``auto``, each candidate's modeled seconds;
    * ``partition_build_s`` — host seconds spent in ``plan()`` this call
      (about 0 on a plan-cache hit or a passed-in plan);
    * ``setup_s`` — host seconds from the call's start to its first sweep
      (plan, initial factors, uploads; for a refine the sampling too);
    * ``plan_cache_hit``/``plan_cache`` — this call's cache outcome and the
      cache's counters after it;
    * ``step_compilations``/``step_cache_hits`` — this call's step calls
      whose (step, shapes) signature was new / already seen, counted as the
      reference counts its compilations;
    * ``step_captures`` — CUDA-graph captures this call (0 on the CPU): the
      compilations, plus first calls over a new plan's arrays at shapes
      already seen; ``graph_replays`` — step calls served by replaying a
      captured step (the kernels it recorded run again; the wrappers'
      ``launches`` count none of them);
    * ``uploads`` — arrays this call put on the device: ``ARRAYS_PER_MODE``
      (10) per mode and the tensor's coordinates and values for a plan
      (``10 N + 2``; on the CPU the same arrays, wrapped in place), 4 for a
      stochastic refine (the minibatch's and the snapshot's coordinates and
      values); the reference moves ``9 N + 2`` for a plan; over a mesh
      of G groups ``N (4 G + 7) + 2`` (per mode each group's three
      element arrays and its packed boundary maps, the six maps and the
      row perm at home);
      ``upload_cache_hit`` — they were resident already;
    * ``executor`` — the executor's cumulative ``stats()`` after the call;
    * ``z_kernel`` — per mode, True when the CUDA kernel built Z (the card);
    * ``comm_backends`` — per mode, ``"local"``, ``"psum"`` or
      ``"boundary"``;
    * ``fused_oracle`` — the Lanczos products ran ``oracle_pair``;
    * ``precision`` — the Z-build precision that ran;
    * ``lanczos_block`` — per mode, the effective panel width (1 = vector);
    * ``fused_zbuild`` — the mode steps ran ``kron_segsum_oracle``;
    * ``z_passes`` — per mode, counted passes over Z per sweep
      (``engine.oracle.count_z_passes``, the sketch's seed and power passes
      included);
    * ``objective`` — the objective that ran (``"tucker"``,
      ``"completion"`` or ``"nn"``), and ``objective_metrics`` its extra
      per-sweep stats (completion's ``holdout_rmse``), None when it has none;
    * ``warm_start`` — per mode, the warm start that ran (``"none"`` or
      ``"sketch"``);
    * ``mode_spectra`` — per mode, the last sweep's singular-value
      estimates;
    * ``groups`` — the device groups the ranks ran on (1: stacked on one
      device); ``group_bytes`` — bytes this call moved between groups
      (``RankMesh.moved_bytes``; 0 for one group), and by kind
      ``group_bytes_u`` (the comm space and the Lanczos body: products'
      operands, boundary rows, partials, home scalars) and
      ``group_bytes_factors`` (the factors each group's Z-build reads and
      the factor shards coming home; ``RankMesh.moved_by_kind``);
    * ``sample_fraction``/``sample_nnz``/``replay_nnz``/``step_size`` — the
      stochastic rung only: the fraction sampled, the sampled new elements,
      the replayed prefix elements and the blend step ``eta`` applied.

    Set by ``engine.scheduler.StreamScheduler`` (None or 0 outside it):

    * ``stream_decision``/``stream_drift`` — the refresh ladder's rung
      (``"plan"``, ``"reuse"``, ``"stochastic-refine"``, ``"repartition"``,
      ``"reselect"``) and the §4 drift that picked it
      (``refresh_decision``'s report);
    * ``prepare_s`` — the producer's host seconds (snapshot, decision,
      plan, upload staging), overlapped with earlier sweeps; ``run_s`` —
      the consumer's seconds in ``run``/``run_stochastic``;
      ``queue_wait_s`` — submit to sweep start, less ``prepare_s``;
    * ``fit_delta`` — a refine's final fit less the last full run's;
    * ``rank_trajectory`` — adaptive rank's trace for the stream
      (``{"stream_version", "core_dims", "modeled_total_s"}`` per run);
    * ``slo_deadline_s``/``slo_met`` — the submit's latency budget and
      whether submit to result met it;
    * ``lane`` — the scheduler's lane label.

    Set by ``run`` when tracing was on (``repro_torch.tracing``): ``spans``,
    the call's own ``tracing.summary`` (its ``dist_hooi`` span and every
    span beneath), else None.
    """

    fits: list
    sweep_s: list
    comm: dict
    r_pad: dict
    e_pad: dict
    scheme: str = ""
    selection: dict | None = None
    partition_build_s: float = 0.0
    setup_s: float = 0.0
    plan_cache_hit: bool = False
    plan_cache: dict | None = None
    step_compilations: int = 0
    step_cache_hits: int = 0
    step_captures: int = 0
    graph_replays: int = 0
    uploads: int = 0
    upload_cache_hit: bool = False
    executor: dict | None = None
    z_kernel: dict | None = None
    comm_backends: dict | None = None
    fused_oracle: bool = False
    precision: str = "f32"
    lanczos_block: dict | None = None
    fused_zbuild: bool = False
    z_passes: dict | None = None
    objective: str = "tucker"
    objective_metrics: dict | None = None
    warm_start: dict | None = None
    mode_spectra: dict | None = None
    groups: int = 1
    group_bytes: int = 0
    group_bytes_u: int = 0
    group_bytes_factors: int = 0
    sample_fraction: float | None = None
    sample_nnz: int | None = None
    replay_nnz: int | None = None
    step_size: float | None = None
    stream_decision: str | None = None
    stream_drift: dict | None = None
    prepare_s: float = 0.0
    run_s: float = 0.0
    queue_wait_s: float = 0.0
    fit_delta: float | None = None
    rank_trajectory: list | None = None
    slo_deadline_s: float | None = None
    slo_met: bool | None = None
    lane: int | None = None
    spans: dict | None = None


def _flat(arrs: dict):
    """A step's arrays, a mesh's per-group arrays included."""
    for name, a in arrs.items():
        if name in _PER_GROUP:
            for ga in a:
                yield from ga.values()
        else:
            yield a


_PER_GROUP = ("groups", "space")  # a mesh's per-group arrays, by mode


def _put_packed(maps: dict, put: Callable) -> dict:
    """Host index arrays moved as one int64 array (one upload), returned
    as views of it by name."""
    dev = put(np.concatenate([np.asarray(a, np.int64).reshape(-1)
                              for a in maps.values()]))
    out, lo = {}, 0
    for name, a in maps.items():
        n = int(np.prod(a.shape))
        out[name] = dev[lo:lo + n].view(a.shape)
        lo += n
    return out


@dataclasses.dataclass(eq=False)
class _PlanUpload:
    """One plan's device arrays (the upload cache's payload) and the steps
    captured over them. Over a mesh of several groups, each mode's arrays
    hold ``groups`` and ``space``: per group its ranks' elements and its
    boundary maps on its device."""

    arrs: tuple  # per mode: the step's arrays (``upload_mode``)
    zarrs: tuple  # per mode: coords, values, rows (the Z-build-only step)
    row_perms: tuple  # per mode: (L,) relabelled -> original row ids
    coords: torch.Tensor  # the whole tensor's COO (core and fit)
    values: torch.Tensor
    n_arrays: int
    graphs: dict = dataclasses.field(default_factory=dict)

    def tensors(self) -> list:
        """The arrays at home (every array, without a mesh)."""
        return [*(a for m in self.arrs for k, a in m.items()
                  if k not in _PER_GROUP),
                *self.row_perms, self.coords, self.values]

    def group_tensors(self, g: int) -> list:
        return [a for m in self.arrs for k in _PER_GROUP
                for a in m[k][g].values()]


@dataclasses.dataclass(eq=False)
class _StochUpload:
    """One refine's minibatch and the snapshot it is scored on."""

    arrs: dict  # the minibatch: coords (pow2-padded), values
    coords: torch.Tensor  # the whole snapshot's COO
    values: torch.Tensor
    n_arrays: int
    graphs: dict = dataclasses.field(default_factory=dict)

    def tensors(self) -> list:
        return [*self.arrs.values(), self.coords, self.values]


def _read_here(up, mesh: RankMesh | None = None):
    """Mark an upload's arrays as read on the current stream (a mesh
    group's also on the group's stream, where an eager step reads them; a
    captured one reads them on the current stream), and return it. They are
    blocks of their uploader's stream, whose cache may hand a block out
    again as soon as it is freed; ``record_stream`` makes that wait for the
    work queued on the reader. Off CUDA: nothing."""
    if up.coords.is_cuda:
        stream = torch.cuda.current_stream(up.coords.device)
        for a in up.tensors():
            a.record_stream(stream)
        for g in range(mesh.G if mesh is not None else 0):
            for a in up.group_tensors(g):
                a.record_stream(mesh.streams[g])
                if a.device == stream.device:
                    a.record_stream(stream)
    return up


_STAGE_BYTES = 1 << 24  # one pinned staging buffer (two alternate)


class _Uploader:
    """Host arrays to the executor's device. On the card: through two
    pinned staging buffers, on a stream of its own, waited for by
    ``finish`` (so the arrays are ready for every stream and thread), into
    blocks of that stream's cache (so no work queued on another stream can
    still be using them; the readers mark them, ``_read_here``); on the
    CPU, wrapped in place. ``count`` is the arrays put."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.count = 0
        if dev.type == "cuda":
            self.stream = torch.cuda.Stream(dev)
            self.bufs = [torch.empty(_STAGE_BYTES, dtype=torch.uint8,
                                     pin_memory=True) for _ in range(2)]
            self.events = [None, None]
            self.turn = 0

    def put(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(arr, dtype=dtype))
        self.count += 1
        if self.dev.type != "cuda":
            return src.to(self.dev)
        with torch.cuda.stream(self.stream):
            out = torch.empty(src.shape, dtype=src.dtype, device=self.dev)
        s, d = src.reshape(-1).view(torch.uint8), \
            out.reshape(-1).view(torch.uint8)
        for lo in range(0, s.numel(), _STAGE_BYTES):
            n = min(_STAGE_BYTES, s.numel() - lo)
            buf, ev = self.bufs[self.turn], self.events[self.turn]
            if ev is not None:
                ev.synchronize()  # its last copy has left the buffer
            buf[:n].copy_(s[lo:lo + n])
            with torch.cuda.stream(self.stream):
                d[lo:lo + n].copy_(buf[:n], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(self.stream)
            self.events[self.turn] = ev
            self.turn ^= 1
        return out

    def finish(self) -> None:
        if self.dev.type == "cuda":
            self.stream.synchronize()


def upload_mode(mp, dev: torch.device, put: Callable | None = None,
                ranks: range | None = None) -> dict:
    """One ``ModePartition`` on ``dev``: its elements flattened over the
    ranks, with each rank's local rows offset by ``p*R_pad`` (still sorted,
    one Z-build for all ranks), and the comm spaces' gather maps. ``put``
    moves one host array (default: a plain copy). ``ranks`` (a mesh
    group's range) moves only those ranks' elements, their rows offset
    from the range's first rank, and no maps."""
    if put is None:
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    P, E_pad, N = mp.coords.shape
    if P * mp.R_pad >= 2**31:
        raise ValueError(f"P*R_pad = {P * mp.R_pad} rows exceed int32")
    lo, hi = (0, P) if ranks is None else (ranks.start, ranks.stop)
    n = hi - lo
    rows = (mp.local_rows[lo:hi].astype(np.int32)
            + (np.arange(n, dtype=np.int32) * np.int32(mp.R_pad))[:, None])
    arrs = {"coords": put(mp.coords[lo:hi].reshape(n * E_pad, N)),
            "values": put(mp.values[lo:hi].reshape(-1)),
            "rows": put(rows.reshape(-1))}
    if ranks is None:
        for name, idx in comm_maps(mp).items():
            arrs[name] = put(idx)
    return arrs


def step_spec(mp, spec: ModeSpec) -> dict:
    """The static spec ``make_mode_step_fn`` and ``make_zbuild_step_fn``
    build one mode's step from: the partition's pads and the mode's
    ``ModeSpec``."""
    return dict(mode=mp.mode, R_pad=mp.R_pad, Lp=mp.Lp, P=mp.P, spec=spec)


def _tally() -> dict:
    return {"step_compilations": 0, "step_cache_hits": 0,
            "step_captures": 0, "graph_replays": 0, "uploads": 0,
            "upload_cache_hits": 0}


class HooiExecutor:
    """Runs distributed HOOI sweeps over ``P_ranks`` ranks stacked on one
    device (default: the card), or spread over the device groups of
    ``mesh`` (``make_ranks_mesh``; its home is then ``device``), caching
    the steps and the per-plan uploads across runs.
    ``shared_executor(P, device, mesh=)`` hands out one per process, which
    ``dist_hooi`` runs on."""

    def __init__(self, P_ranks: int, device: str | torch.device | None = None,
                 *, mesh: RankMesh | None = None):
        self.P = int(P_ranks)
        if self.P < 1:
            raise ValueError(f"P_ranks must be >= 1, got {P_ranks}")
        if mesh is not None:
            if device is not None:
                raise ValueError("pass a mesh or a device, not both: the "
                                 "mesh's first device is its home")
            if mesh.P != self.P:
                raise ValueError(f"mesh of P={mesh.P} ranks, executor has "
                                 f"P={self.P}")
            device = mesh.home
        self.mesh = mesh
        # the group path runs only over several groups: a one-group mesh is
        # the stacked executor on its device
        self._spread = mesh if mesh is not None and mesh.G > 1 else None
        self.groups = 1 if self._spread is None else mesh.G
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._steps: dict[tuple, Callable] = {}  # static sig -> step fn
        self._seen_shapes: set[tuple] = set()  # (static sig, arg shapes)
        self._uploads: "weakref.WeakKeyDictionary[PartitionPlan, _PlanUpload]" \
            = weakref.WeakKeyDictionary()
        # an auto plan is a dataclasses.replace copy of its winning
        # candidate sharing its parts tuple: dedupe on the parts' identity
        # (stable while an upload lives: some plan in _uploads holds them)
        self._uploads_by_parts: "weakref.WeakValueDictionary[int, _PlanUpload]" \
            = weakref.WeakValueDictionary()
        # stochastic minibatches, LRU-keyed on everything sample_batch's
        # output is a pure function of
        self._stoch_uploads: "collections.OrderedDict[tuple, _StochUpload]" \
            = collections.OrderedDict()
        self._samples: "collections.deque[dict]" = collections.deque(
            maxlen=MAX_CALIBRATION_SAMPLES)
        self._stats = {"runs": 0, "step_compilations": 0,
                       "step_cache_hits": 0, "step_captures": 0,
                       "graph_replays": 0, "uploads": 0,
                       "upload_cache_hits": 0}
        # steps are captured on one card only: a mesh over distinct cards
        # runs them eagerly (``_invoke``)
        one_card = self._spread is None or all(
            d == self.device for d in self._spread.devices)
        self._home = CaptureHome(self.device) \
            if self.device.type == "cuda" and one_card else None

    # ------------------------------------------------------------ planning
    def _check_plan(self, pl: PartitionPlan, t: SparseTensor,
                    core_dims: Sequence[int], path: str,
                    objective: str = "tucker") -> None:
        """Refuse a prebuilt plan that does not describe this run (``t`` is
        the objective's view): the upload cache is keyed on the plan, so a
        mismatched plan would run the wrong arrays."""
        if pl.P != self.P:
            raise ValueError(
                f"plan built for P={pl.P}, executor has P={self.P}")
        if pl.objective != objective:
            raise ValueError(
                f"plan was built for objective={pl.objective!r}, asked to "
                f"run {objective!r} — its view, metrics and cost describe "
                "a different training tensor; build a matching plan")
        if pl.fingerprint is not None \
                and pl.fingerprint != t.fingerprint():
            raise ValueError(
                f"plan was built for tensor {pl.fingerprint[:12]}…, "
                f"got {t.fingerprint()[:12]}…")
        if tuple(pl.core_dims) != tuple(int(k) for k in core_dims):
            raise ValueError(
                f"plan modeled core_dims={pl.core_dims}, asked to run "
                f"{tuple(core_dims)}")
        if path != "auto" and pl.cost.path not in (path, "auto"):
            raise ValueError(
                f"plan costed for path={pl.cost.path!r}, running {path!r}")

    def _plan(self, t, core_dims, scheme, path, plan_seed, pad_geometric,
              obj, metrics=None) -> tuple[PartitionPlan, bool]:
        if isinstance(scheme, PartitionPlan):
            self._check_plan(scheme, t, core_dims, path, obj.name)
            return scheme, False
        pl = build_plan(t, scheme, self.P, core_dims=tuple(core_dims),
                        path=path, seed=plan_seed,
                        pad_geometric=pad_geometric, objective=obj,
                        metrics=metrics)
        return pl, last_plan_call_cache_hit()

    def _mode_specs(self, pl: PartitionPlan, core_dims: Sequence[int],
                    path: str, knobs: ModeSpec) -> list[ModeSpec]:
        """Per-mode step specs: ``engine.oracle.mode_spec`` of ``knobs``
        (``resolve_knobs``) at ``K_n`` the core width and ``K_hat`` the
        other modes' factor widths ``min(L_j, K_j)`` — the numbers the
        local path derives, so P=1 trajectories coincide. The backend:
        ``path="auto"`` honors a plan costed with ``path="auto"`` or
        compares the mode's analytic comm models; P=1 is ``local``."""
        parts = pl.parts
        eff = [min(int(k), int(mp.L)) for k, mp in zip(core_dims, parts)]
        recorded = None
        if path == "auto" and pl.cost.path == "auto" and self.P > 1 \
                and len(pl.cost.mode_backends) == len(parts):
            recorded = pl.cost.mode_backends
        specs = []
        for n, mp in enumerate(parts):
            if recorded is not None:
                backend = resolve_backend(recorded[n], self.P)
            else:
                backend = resolve_backend(
                    path, self.P, pl.comm(n) if path == "auto" else None)
            specs.append(mode_spec(knobs, core_dims[n], mp.L,
                                   math.prod(eff[:n] + eff[n + 1:]),
                                   backend=backend))
        return specs

    # ------------------------------------------------------------- caches
    def _kernel_label(self) -> str:
        # the device decides the Z-build: the CUDA kernel on the card
        return "kern" if self.device.type == "cuda" else "ref"

    def _step_key(self, mp, spec: ModeSpec) -> tuple:
        # the static signature of one mode step, the reference's: all that
        # shapes the step besides array shapes, so distinct variants never
        # share a step and the rerun contract holds per variant
        return (spec.backend, self._kernel_label(),
                "fused" if spec.use_fused else "plain", mp.mode, mp.R_pad,
                mp.Lp, mp.S_pad, self.P, spec.K_n, spec.niter,
                spec.precision, spec.block_size,
                "fz" if spec.fused_zbuild else "zb", spec.objective,
                spec.warm_start, self.groups)

    def _cache_step(self, skey: tuple, make: Callable) -> Callable:
        with self._lock:
            step = self._steps.get(skey)
            if step is not None:
                # LRU touch: hot steps survive the bound
                self._steps[skey] = self._steps.pop(skey)
                return step
            step = self._steps[skey] = make()
            while len(self._steps) > MAX_COMPILED_STEPS:
                self._evict(next(iter(self._steps)))
        return step

    def _evict(self, old: tuple) -> None:
        """Drop a step: a re-made one counts its compilations again and
        captures anew."""
        del self._steps[old]
        self._seen_shapes = {s for s in self._seen_shapes if s[0] != old}
        homes = list(self._uploads.values()) \
            + list(self._stoch_uploads.values())
        for up in homes:
            for gkey in [g for g in up.graphs if g[0] == old]:
                del up.graphs[gkey]

    def _get_step(self, mp, spec: ModeSpec):
        """The cached step of ``spec`` over ``mp``'s pads: a mode step, or
        the Z-build alone for ``backend="zbuild"``."""
        skey = self._step_key(mp, spec)
        make = make_zbuild_step_fn if spec.backend == "zbuild" \
            else make_mode_step_fn
        return skey, self._cache_step(
            skey, lambda: make(step_spec(mp, spec), mesh=self._spread))

    def _note_shapes(self, skey, shapes, tally: dict) -> None:
        # a compilation is the first call of a (step, shapes) signature —
        # the reference's jit cache-miss condition; ``tally`` is this run's
        # own ledger, apart from concurrent runs on a shared executor
        with self._lock:
            if (skey, shapes) in self._seen_shapes:
                self._stats["step_cache_hits"] += 1
                tally["step_cache_hits"] += 1
            else:
                self._seen_shapes.add((skey, shapes))
                self._stats["step_compilations"] += 1
                tally["step_compilations"] += 1

    @staticmethod
    def _shapes(arrs: dict, factors) -> tuple:
        return tuple(tuple(a.shape) for a in _flat(arrs)) + tuple(
            tuple(f.shape) for f in factors)

    def _invoke(self, skey, step, home, arrs: dict, factors, key,
                tally: dict):
        """Run a cached step: eagerly on the CPU and over a mesh whose
        groups lie on distinct cards (a graph that spans cards cannot be
        checked on one card); otherwise on the card its graphs, captured
        over ``arrs`` on the first call (kept in ``home.graphs``, beside the
        arrays), a mesh's groups as branches on their streams."""
        if self._home is None:
            return step(arrs, factors, key)
        gkey = (skey, self._shapes(arrs, factors))
        with self._home.lock:
            graph = home.graphs.get(gkey)
            if graph is None:
                graph, out = StepGraph.capture(self._home, step, arrs,
                                               factors, key,
                                               mesh=self._spread)
                home.graphs[gkey] = graph
                with self._lock:
                    self._stats["step_captures"] += 1
                    tally["step_captures"] += 1
                return out
        out = graph(arrs, factors, key)
        with self._lock:
            self._stats["graph_replays"] += 1
            tally["graph_replays"] += 1
        return out

    def _call_step(self, skey, step, home, arrs: dict, factors, key,
                   tally: dict):
        self._note_shapes(skey, self._shapes(arrs, factors), tally)
        return self._invoke(skey, step, home, arrs, factors, key, tally)

    def _get_upload(self, pl: PartitionPlan, t: SparseTensor,
                    tally: dict) -> _PlanUpload:
        with self._lock:
            up = self._uploads.get(pl)
            if up is None:
                up = self._uploads_by_parts.get(id(pl.parts))
                if up is not None:  # a plan copy sharing resident arrays
                    self._uploads[pl] = up
            if up is not None:
                self._stats["upload_cache_hits"] += 1
                tally["upload_cache_hits"] += 1
                return _read_here(up, self._spread)
        mover = _Uploader(self.device)
        if self._spread is None:
            arrs = tuple(upload_mode(mp, self.device, mover.put)
                         for mp in pl.parts)
            zarrs = tuple({k: a[k] for k in ("coords", "values", "rows")}
                          for a in arrs)
            movers = [mover]
        else:
            arrs, zarrs, movers = self._upload_groups(pl, mover)
        row_perms = tuple(mover.put(mp.row_perm) for mp in pl.parts)
        coords = mover.put(t.coords, np.int32)
        values = mover.put(t.values, np.float32)
        for m in movers:
            m.finish()
        up = _PlanUpload(
            arrs=arrs, zarrs=zarrs, row_perms=row_perms, coords=coords,
            values=values, n_arrays=sum(m.count for m in movers))
        with self._lock:
            won = self._uploads.setdefault(pl, up)
            if won is up:
                self._uploads_by_parts[id(pl.parts)] = up
            # the setdefault loser still moved its arrays: count them
            self._stats["uploads"] += up.n_arrays
            tally["uploads"] += up.n_arrays
        return _read_here(won, self._spread)

    def _upload_groups(self, pl: PartitionPlan, home: _Uploader):
        """A plan's per-mode arrays over the mesh: each group's ranks'
        elements through an uploader on its device, the maps at home.
        Returns the step arrays, the Z-build step's and the uploaders."""
        mesh = self._spread
        movers = [home] + [_Uploader(d) for d in mesh.devices[1:]]
        arrs, zarrs = [], []
        for mp in pl.parts:
            groups = tuple(
                upload_mode(mp, mesh.devices[g], movers[g].put,
                            ranks=mesh.ranks_of(g))
                for g in range(mesh.G))
            host_maps = comm_maps(mp)
            space = tuple(
                _put_packed(gm, movers[g].put) for g, gm in enumerate(
                    group_maps(host_maps, mp.P, mp.R_pad, mp.Lp, mesh.G)))
            maps = {name: home.put(idx) for name, idx in host_maps.items()}
            arrs.append({"groups": groups, "space": space, **maps})
            zarrs.append({"groups": groups})
        return tuple(arrs), tuple(zarrs), movers

    # ------------------------------------------------------------ staging
    @on_own_device
    def stage_upload(self, pl: PartitionPlan, t: SparseTensor) -> dict:
        """Put a plan's arrays on the device now, off the hot path.

        Safe from a producer thread: the copies run on a stream of their
        own and are waited for before this returns, and nothing is
        computed; a following ``run`` on the same plan uploads nothing.
        Idempotent: a resident plan moves nothing.
        """
        tally = _tally()
        self._get_upload(pl, t, tally)
        return {"uploads": tally["uploads"],
                "already_resident": tally["upload_cache_hits"] > 0}

    @on_own_device
    def prepare(
        self,
        t: SparseTensor,
        core_dims: Sequence[int],
        scheme: str | Scheme | PartitionPlan = "auto",
        *,
        path: str = "liteopt",
        plan_seed: int = 0,
        pad_geometric: bool = False,
        objective=None,
        metrics=None,
    ) -> tuple[PartitionPlan, dict]:
        """The host half of a run: build or fetch the plan and stage its
        uploads. Returns the plan and ``stage_upload``'s report; a following
        ``run(t, core_dims, plan)`` (with the same objective) is then device
        work only. ``objective`` shapes the staged view (completion stages
        its training entries); ``metrics`` (prebuilt ``Scheme`` only)
        supplies incrementally maintained ``SchemeMetrics``.
        """
        if path not in RUN_PATHS:
            raise ValueError(f"unknown path {path!r} (expected one of "
                             f"{RUN_PATHS})")
        obj = resolve_objective(objective)
        t = obj.prepare_tensor(t)
        pl, _ = self._plan(t, core_dims, scheme, path, plan_seed,
                           pad_geometric, obj, metrics)
        return pl, self.stage_upload(pl, t)

    # ------------------------------------------------------------ observe
    def stats(self) -> dict:
        """Cumulative counters and cache occupancy; ``groups`` and
        ``group_bytes`` (the mesh's bytes between groups so far)."""
        with self._lock:
            return dict(self._stats, cached_steps=len(self._steps),
                        cached_plans=len(self._uploads), groups=self.groups,
                        group_bytes=sum(self._moved_by_kind().values()))

    def _moved_by_kind(self) -> dict:
        return dict.fromkeys(MOVE_KINDS, 0) if self._spread is None \
            else self._spread.moved_by_kind

    def _labels(self) -> dict:
        """What every calibration sample of this executor carries besides
        its numbers: a mesh of several groups is told apart from stacked
        ranks, so ``fit_cost_model`` never mixes their rates."""
        return {} if self._spread is None else {"groups": self.groups}

    def modeled_u_bytes(self, pl: PartitionPlan, core_dims: Sequence[int],
                        *, path: str = "liteopt",
                        lanczos_block: int | None = None,
                        fused_zbuild: bool | None = None,
                        warm_start: str | None = None) -> dict:
        """Per mode, the ``"u"`` bytes one sweep of ``run`` moves between
        the mesh's groups by ``distributed.mesh.u_space_bytes``, for the
        modes that run the boundary backend (the knobs as ``run`` resolves
        them). Over one group: nothing."""
        specs = self._mode_specs(pl, core_dims, path, resolve_knobs(
            lanczos_block=lanczos_block, fused_zbuild=fused_zbuild,
            warm_start=warm_start))
        eff = [min(int(k), int(mp.L)) for k, mp in zip(core_dims, pl.parts)]
        out = {}
        for n, (mp, sp) in enumerate(zip(pl.parts, specs)):
            if self._spread is None or sp.backend != "boundary":
                continue
            G = self._spread.G
            sketch = sp.warm_start == "sketch"
            S_x = crossing_slots(group_maps(comm_maps(mp), mp.P, mp.R_pad,
                                            mp.Lp, G))
            out[n] = u_space_bytes(
                self.P, G, S_x, math.prod(eff[:n] + eff[n + 1:]), sp.K_n,
                sp.niter, sp.block_size, blockish=sp.block_driver,
                seed_cols=min(sp.block_size, eff[n]) if sketch else 0,
                power_iters=DEFAULT_POWER_ITERS if sketch else 0)
        return out

    def calibration_samples(self) -> list[dict]:
        """Measured sweeps (flops, bytes, seconds) for ``fit_cost_model``."""
        with self._lock:
            return [dict(s) for s in self._samples]

    def _sync(self) -> None:
        if self._spread is not None:
            self._spread.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @on_own_device
    def profile_phases(
        self,
        t: SparseTensor,
        core_dims: Sequence[int],
        scheme: str | Scheme | PartitionPlan = "lite",
        *,
        path: str = "liteopt",
        plan_seed: int = 0,
        use_fused_oracle: bool | None = None,
        precision: str | None = None,
        lanczos_block: int | None = None,
        fused_zbuild: bool | None = None,
        warm_start: str | None = None,
        repeats: int = 3,
        seed: int = 0,
        objective=None,
        draw: Draw | None = None,
    ) -> dict:
        """Per-phase sweep times: the Z-build (TTM) against the rest.

        Per mode, the Z-build-only step and the full step, both through the
        step cache (captured on the card), each run once and then timed
        over ``repeats`` calls. Appends a pure-TTM sample (``svd_flops=0,
        comm_bytes=0``) and a full-sweep sample, so ``fit_cost_model`` gets
        a full-rank per-phase design from one plan; ``precision`` labels
        them (a bf16 probe feeds the bf16 TTM rate). Returns ``ttm_s``,
        ``full_s``, ``svd_s`` (their difference), per mode and in total.
        """
        if path not in RUN_PATHS:
            raise ValueError(f"unknown path {path!r} (expected one of "
                             f"{RUN_PATHS})")
        tally = _tally()
        full_precision_matmul()
        obj = resolve_objective(objective)
        t = obj.prepare_tensor(t)
        pl, _ = self._plan(t, core_dims, scheme, path, plan_seed, False, obj)
        N = t.ndim
        parts = pl.parts
        knobs = resolve_knobs(precision, lanczos_block, fused_zbuild,
                              warm_start, use_fused_oracle, obj.name)
        prec = knobs.precision
        specs = self._mode_specs(pl, core_dims, path, knobs)
        up = self._get_upload(pl, t, tally)
        key = make_key(seed, draw)
        factors = random_factors(t.shape, core_dims, key, self.device)
        on_card = self.device.type == "cuda"

        def timed(skey, step, arrs, kk):
            self._invoke(skey, step, up, arrs, factors, kk, tally)
            self._sync()
            t0 = time.perf_counter()
            for _ in range(repeats):
                self._invoke(skey, step, up, arrs, factors, kk, tally)
            self._sync()
            return (time.perf_counter() - t0) / repeats

        per_mode = {}
        ttm_s = full_s = 0.0
        for n in range(N):
            sp = specs[n]
            zkey, zstep = self._get_step(parts[n], ModeSpec(
                backend="zbuild", K_n=sp.K_n, precision=sp.precision))
            skey, step = self._get_step(parts[n], sp)
            kk = key.fold_in(7000 + n)
            # the signatures a run() on these shapes would note, so a later
            # run counts them as seen and its first sweep is not cold
            self._note_shapes(zkey, self._shapes(up.zarrs[n], factors), tally)
            self._note_shapes(skey, self._shapes(up.arrs[n], factors), tally)
            tz = timed(zkey, zstep, up.zarrs[n], kk)
            tf = timed(skey, step, up.arrs[n], kk)
            per_mode[n] = {"ttm_s": tz, "full_s": tf,
                           "svd_s": max(tf - tz, 0.0)}
            ttm_s += tz
            full_s += tf
        m = pl.metrics
        label = _backend_label(specs)
        with self._lock:
            self._samples.append({
                "critical_path_flops": m.ttm_flops_max,
                "ttm_flops": m.ttm_flops_max, "svd_flops": 0,
                "comm_bytes": 0.0, "seconds": ttm_s, "warm": True,
                "P": self.P, "path": path, "scheme": pl.name,
                "phase": "ttm", "kernel": on_card,
                "comm_backend": label, "precision": prec, **self._labels(),
            })
            self._samples.append({
                "critical_path_flops": m.critical_path_flops,
                "ttm_flops": m.ttm_flops_max,
                "svd_flops": m.svd_flops_max,
                "comm_bytes": _run_comm_bytes(pl, specs),
                "seconds": full_s,
                "warm": True, "P": self.P, "path": path, "scheme": pl.name,
                "phase": "sweep", "kernel": on_card,
                "comm_backend": label, "precision": prec, **self._labels(),
            })
        return {"ttm_s": ttm_s, "full_s": full_s,
                "svd_s": max(full_s - ttm_s, 0.0),
                "per_mode": per_mode,
                "z_kernel": {n: on_card for n in range(N)}}

    # ---------------------------------------------------------------- run
    @on_own_device
    def run(
        self,
        t: SparseTensor,
        core_dims: Sequence[int],
        scheme: str | Scheme | PartitionPlan = "lite",
        *,
        n_invocations: int = 3,
        path: str = "liteopt",
        seed: int = 0,
        plan_seed: int = 0,
        use_fused_oracle: bool | None = None,
        precision: str | None = None,
        lanczos_block: int | None = None,
        fused_zbuild: bool | None = None,
        warm_start: str | None = None,
        init_factors: Sequence | None = None,
        pad_geometric: bool = False,
        objective=None,
        draw: Draw | None = None,
        on_sweep: Callable[[int, float, float], None] | None = None,
    ) -> tuple[Decomposition, DistHooiStats]:
        """One distributed HOOI decomposition.

        ``scheme`` is a scheme name (including ``"auto"``), a ``Scheme``,
        or a ``PartitionPlan``; names and schemes go through the
        content-keyed plan cache with ``plan_seed`` (and ``pad_geometric``,
        part of its key). A cached plan reuses this executor's uploads and
        steps: a rerun compiles and uploads nothing. ``path`` selects the
        comm backend family: ``"baseline"`` (psum), ``"liteopt"``
        (boundary) or ``"auto"`` (per mode); P=1 always runs ``local``.
        ``use_fused_oracle`` routes the Lanczos products through
        ``oracle_pair``; ``precision`` (``"auto"`` consults the fitted cost
        model), ``lanczos_block`` and ``fused_zbuild`` are the reference's
        roofline knobs (each None honors its ``REPRO_*`` variable), and
        every knob is part of the step key. ``warm_start`` (``"none"``,
        ``"sketch"``, ``"auto"``; None honors ``REPRO_WARM_START``) seeds
        the block driver with the factor-sketched panel. ``objective``
        (None honors ``REPRO_OBJECTIVE``; a name or an ``Objective``)
        selects what the sweeps optimize: the plan partitions its view of
        ``t``, and a prebuilt plan must have been built for it.
        ``init_factors`` replaces the seeded random start; a factor wider
        than ``min(L_n, K_n)`` is truncated and a narrower one completed
        with orthonormalized draws at ``fold_in(key, 4100 + n)``.
        ``draw`` fills the random-draw seam (``repro_torch.random``);
        ``on_sweep(it, seconds, fit)`` observes every sweep.
        """
        with tracing.span("dist_hooi") as call:
            if path not in RUN_PATHS:
                raise ValueError(f"unknown path {path!r} (expected one of "
                                 f"{RUN_PATHS})")
            t_start = time.perf_counter()
            with tracing.span("executor.setup"):
                tally = _tally()
                dev = self.device
                full_precision_matmul()
                obj = resolve_objective(objective)
                t = obj.prepare_tensor(t)
                knobs = resolve_knobs(precision, lanczos_block, fused_zbuild,
                                      warm_start, use_fused_oracle, obj.name)

                t_plan = time.perf_counter()
                pl, cache_hit = self._plan(t, core_dims, scheme, path,
                                           plan_seed, pad_geometric, obj)
                partition_build_s = time.perf_counter() - t_plan

                N = t.ndim
                key = make_key(seed, draw)
                if init_factors is None:
                    factors = random_factors(t.shape, core_dims, key, dev)
                else:
                    factors = _coerce_factors(init_factors, t.shape,
                                              core_dims, key, dev)
                parts = pl.parts
                specs = self._mode_specs(pl, core_dims, path, knobs)
                steps = [self._get_step(mp, sp)
                         for mp, sp in zip(parts, specs)]
                up = self._get_upload(pl, t, tally)
                label = _backend_label(specs)
                run_bytes = _run_comm_bytes(pl, specs)
                on_card = dev.type == "cuda"
                setup_s = time.perf_counter() - t_start

            spectra: dict = {}

            def mode_step(n, facs, kk):
                skey, step = steps[n]
                F, sv = self._call_step(skey, step, up, up.arrs[n], facs, kk,
                                        tally)
                if isinstance(F, GroupTensor):  # the groups' shards come home
                    F = F.home("factors")
                spectra[n] = sv
                # the stacked (P, Lp, k) rows are in relabelled order:
                # flatten over the ranks, restore the original row order,
                # then let the objective refine the full-row factor — the
                # update the local path applies, so P=1 parity covers every
                # objective
                return obj.refine_factor(
                    F.reshape(-1, F.shape[-1])[up.row_perms[n]], sv)

            sweep_s: list[float] = []
            cold = {"seen": 0}

            def report(it, seconds, fit):
                sweep_s.append(seconds)
                paid = tally["step_compilations"] + tally["step_captures"]
                with self._lock:
                    self._samples.append({
                        "critical_path_flops":
                            pl.metrics.critical_path_flops,
                        "ttm_flops": pl.metrics.ttm_flops_max,
                        "svd_flops": pl.metrics.svd_flops_max,
                        "comm_bytes": run_bytes,
                        "seconds": seconds,
                        # a sweep that compiled or captured measures that,
                        # not the machine's rates
                        "warm": paid == cold["seen"],
                        "P": self.P, "path": path, "scheme": pl.name,
                        "kernel": on_card,
                        "comm_backend": label, "precision": knobs.precision,
                        **self._labels(),
                    })
                cold["seen"] = paid
                if on_sweep is not None:
                    on_sweep(it, seconds, fit)

            objective_metrics: dict = {}
            moved = self._moved_by_kind()
            dec, fits = run_hooi_sweeps(up.coords, up.values, t, factors, key,
                                        n_invocations, mode_step,
                                        on_sweep=report, objective=obj,
                                        metrics_out=objective_metrics)
            moved = {k: v - moved[k] for k, v in self._moved_by_kind().items()}
            stats = self._run_stats(
                knobs, specs, tally, spectra, objective_metrics,
                fits=fits, sweep_s=sweep_s,
                comm={n: pl.comm(n) for n in range(N)},
                r_pad={n: parts[n].R_pad for n in range(N)},
                e_pad={n: parts[n].E_pad for n in range(N)},
                scheme=pl.name,
                selection=pl.candidates,
                partition_build_s=partition_build_s,
                setup_s=setup_s,
                plan_cache_hit=cache_hit,
                plan_cache=plan_cache_stats(),
                z_passes={n: count_z_passes(
                    sp.niter, sp.fused_zbuild, warm_start=sp.warm_start,
                    power_iters=DEFAULT_POWER_ITERS
                    if sp.warm_start == "sketch" else 0)
                    for n, sp in enumerate(specs)},
                groups=self.groups,
                group_bytes=sum(moved.values()),
                group_bytes_u=moved["u"],
                group_bytes_factors=moved["factors"],
            )
        if call is not None:
            stats.spans = tracing.summary(call=call)
        return dec, stats

    def _run_stats(self, knobs: ModeSpec, specs: Sequence[ModeSpec],
                   tally: dict, spectra: dict, objective_metrics: dict,
                   **fields) -> DistHooiStats:
        """What ``run`` and ``run_stochastic`` report alike: this call's
        tally, the executor's counters with the call counted as a run, the
        knobs and, per mode, what its spec ran; ``fields`` the rest."""
        with self._lock:
            self._stats["runs"] += 1
        on_card = self.device.type == "cuda"
        return DistHooiStats(
            step_compilations=tally["step_compilations"],
            step_cache_hits=tally["step_cache_hits"],
            step_captures=tally["step_captures"],
            graph_replays=tally["graph_replays"],
            uploads=tally["uploads"],
            upload_cache_hit=tally["upload_cache_hits"] > 0,
            executor=self.stats(),
            z_kernel={n: on_card for n in range(len(specs))},
            comm_backends={n: sp.backend for n, sp in enumerate(specs)},
            fused_oracle=knobs.use_fused,
            precision=knobs.precision,
            lanczos_block={n: sp.block_size for n, sp in enumerate(specs)},
            fused_zbuild=knobs.fused_zbuild,
            objective=knobs.objective,
            objective_metrics=objective_metrics or None,
            warm_start={n: sp.warm_start for n, sp in enumerate(specs)},
            mode_spectra={n: v.cpu().numpy() for n, v in spectra.items()}
            or None,
            **fields)

    # ----------------------------------------------------- stochastic rung
    def _get_stoch_step(self, mode: int, num_rows: int, spec: ModeSpec,
                        sample_fraction: float, sample_seed: int):
        """The minibatch step, in the same cache as the distributed steps;
        its key carries the sampling policy (a rerun of the same refine
        compiles nothing) and every static parameter, and the padded
        minibatch shape is counted by ``_note_shapes``."""
        skey = ("stoch", int(mode), int(num_rows), spec.K_n, spec.niter,
                spec.block_size, spec.precision, self._kernel_label(),
                spec.objective, float(sample_fraction), int(sample_seed))

        def make():
            return make_stochastic_step_fn(int(mode), int(num_rows),
                                           spec.K_n, spec.niter,
                                           spec.block_size,
                                           precision=spec.precision)

        return skey, self._cache_step(skey, make)

    def _get_stoch_core(self):
        """The rung's full-snapshot core (``core_from_factors``), in the
        same cache as the steps, as the reference keeps its jitted core
        there. It runs eagerly over the unpadded snapshot."""
        skey = ("stochcore",)
        return skey, self._cache_step(skey, lambda: core_from_factors)

    def _get_stoch_upload(self, t: SparseTensor, obj, sb, covered_nnz: int,
                          sample_fraction: float, sample_seed: int,
                          replay_nnz: int, tally: dict) -> _StochUpload:
        """The refine's minibatch and the whole snapshot on the device,
        keyed on everything ``sample_batch``'s output is a pure function
        of, so a rerun of the same refine moves nothing."""
        ukey = (t.fingerprint(), obj.cache_token(), float(sample_fraction),
                int(sample_seed), int(covered_nnz), int(replay_nnz))
        with self._lock:
            up = self._stoch_uploads.get(ukey)
            if up is not None:
                self._stoch_uploads.move_to_end(ukey)
                self._stats["upload_cache_hits"] += 1
                tally["upload_cache_hits"] += 1
                return _read_here(up)
        mover = _Uploader(self.device)
        arrs = {"coords": mover.put(sb.coords, np.int32),
                "values": mover.put(sb.values, np.float32)}
        coords = mover.put(t.coords, np.int32)
        values = mover.put(t.values, np.float32)
        mover.finish()
        up = _StochUpload(arrs=arrs, coords=coords, values=values,
                          n_arrays=mover.count)
        with self._lock:
            won = self._stoch_uploads.setdefault(ukey, up)
            self._stoch_uploads.move_to_end(ukey)
            while len(self._stoch_uploads) > MAX_STOCH_UPLOADS:
                self._stoch_uploads.popitem(last=False)
            self._stats["uploads"] += up.n_arrays
            tally["uploads"] += up.n_arrays
        return _read_here(won)

    @on_own_device
    def run_stochastic(
        self,
        t: SparseTensor,
        core_dims: Sequence[int],
        pl: PartitionPlan,
        *,
        init_factors: Sequence,
        covered_nnz: int,
        sample_fraction: float,
        sample_seed: int = 0,
        replay_nnz: int = 1024,
        step_size: float = 0.5,
        step_decay: float = 0.5,
        step_index: int = 0,
        n_invocations: int = 1,
        seed: int = 0,
        precision: str | None = None,
        objective=None,
        draw: Draw | None = None,
    ) -> tuple[Decomposition, DistHooiStats]:
        """One stochastic-refine pass: update carried factors from a
        deterministic minibatch of the appended elements (plus a replay
        reservoir of the refined prefix) instead of a full sweep.

        ``pl`` is the stream's adopted plan: it is not rebuilt and not
        checked against ``t`` (the snapshot has grown past it), only for P,
        objective and ``core_dims``. Each mode runs the cached minibatch
        step (``engine.steps.make_stochastic_step_fn``, captured on the
        card), the returned basis is blended into the carried factor at
        ``eta = step_size / (1 + step_decay * step_index)``
        (``core.stochastic.blend_factor``), and the objective refines the
        blend. The one pass over the whole snapshot is the final core: the
        reference pads the snapshot to a power of two so one compiled shape
        serves many appends; here it runs eagerly over the unpadded
        snapshot (padding would put every pad element on row 0), counted
        at the padded shape as the reference counts it.

        ``init_factors`` is required: a cold stream takes the full path.
        """
        t_start = time.perf_counter()
        tally = _tally()
        full_precision_matmul()
        obj = resolve_objective(objective)
        t = obj.prepare_tensor(t)
        if pl.P != self.P:
            raise ValueError(
                f"plan built for P={pl.P}, executor has P={self.P}")
        if pl.objective != obj.name:
            raise ValueError(
                f"plan was built for objective={pl.objective!r}, asked to "
                f"refine under {obj.name!r}")
        if tuple(pl.core_dims) != tuple(int(k) for k in core_dims):
            raise ValueError(
                f"plan modeled core_dims={pl.core_dims}, asked to refine "
                f"{tuple(core_dims)}")
        if init_factors is None:
            raise ValueError("stochastic refine needs carried factors "
                             "(init_factors) — a cold stream takes the "
                             "full plan path")

        N = t.ndim
        key = make_key(seed, draw)
        factors = _coerce_factors(init_factors, t.shape, core_dims, key,
                                  self.device)
        sb = sample_batch(t.coords, t.values, covered_nnz, sample_fraction,
                          sample_seed, replay_nnz=replay_nnz)
        up = self._get_stoch_upload(t, obj, sb, covered_nnz,
                                    sample_fraction, sample_seed,
                                    replay_nnz, tally)

        # every mode runs the sketch at the panel it widens to from 1
        knobs = resolve_knobs(precision, 1, False, "sketch",
                              objective=obj.name)
        eff = [min(int(k), int(L)) for k, L in zip(core_dims, t.shape)]
        specs = [mode_spec(knobs, eff[n], t.shape[n],
                           math.prod(eff[:n] + eff[n + 1:]))
                 for n in range(N)]
        eta = step_eta(step_size, step_decay, step_index)
        steps = [self._get_stoch_step(n, t.shape[n], sp, sample_fraction,
                                      sample_seed)
                 for n, sp in enumerate(specs)]

        spectra: dict = {}

        def mode_step(n, facs, kk):
            skey, step = steps[n]
            left, sv = self._call_step(skey, step, up, up.arrs, facs, kk,
                                       tally)
            spectra[n] = sv
            return obj.refine_factor(blend_factor(facs[n], left, eta), sv)

        # the sweeps score the minibatch (O(minibatch) like the steps); the
        # true core and fit come once afterwards from the whole snapshot
        sweep_s: list[float] = []
        setup_s = time.perf_counter() - t_start
        dec, fits = run_hooi_sweeps(up.arrs["coords"], up.arrs["values"], t,
                                    factors, key, n_invocations, mode_step,
                                    on_sweep=lambda it, sec, fit:
                                    sweep_s.append(sec), objective=obj)
        padded = next_pow2(int(t.nnz))
        ckey, core_fn = self._get_stoch_core()
        self._note_shapes(ckey, ((padded, N), (padded,)) + tuple(
            tuple(f.shape) for f in dec.factors), tally)
        core = obj.finalize_core(core_fn(up.coords, up.values, dec.factors),
                                 dec.factors)
        dec = Decomposition(core=core, factors=dec.factors)
        fits = fits[:-1] + [obj.fit(t, core, dec.factors)]
        objective_metrics: dict = {}
        obj.sweep_metrics(objective_metrics, t, core, dec.factors)
        stats = self._run_stats(
            knobs, specs, tally, spectra, objective_metrics,
            fits=fits, sweep_s=sweep_s, comm={}, r_pad={}, e_pad={},
            scheme=pl.name, setup_s=setup_s,
            sample_fraction=float(sample_fraction),
            sample_nnz=int(sb.sample_nnz),
            replay_nnz=int(sb.replay_nnz),
            step_size=float(eta),
        )
        return dec, stats


def _coerce_factors(factors, shape: Sequence[int], core_dims: Sequence[int],
                    key: Key, device: torch.device) -> list[torch.Tensor]:
    """Fit carried factors to this run's (shape, core_dims), on ``device``.

    When a mode's ``K_n`` changed (the scheduler's adaptive rank), a wider
    factor is truncated and a narrower one completed with an
    orthonormalized random complement: the draw at ``fold_in(key, 4100 +
    n)``, and a QR on the host (LAPACK), as ``random_factors``'.
    """
    out = []
    for n, (L, K) in enumerate(zip(shape, core_dims)):
        F = convert.factors([factors[n]], device)[0]
        if int(F.shape[0]) != int(L):
            raise ValueError(
                f"init_factors[{n}] has {F.shape[0]} rows, tensor mode has "
                f"{L} — factors carry across runs on the same mode sizes")
        K = min(int(K), int(L))  # random_factors' reduced-QR clamp
        if int(F.shape[1]) > K:
            F = F[:, :K].contiguous()
        elif int(F.shape[1]) < K:
            extra = key.fold_in(4100 + n).normal(
                (int(L), K - int(F.shape[1])), "cpu")
            F, _ = torch.linalg.qr(torch.cat([F.cpu(), extra], dim=1))
            F = F.to(device)
        out.append(F)
    return out


def _backend_label(specs: Sequence[ModeSpec]) -> str:
    """One calibration label per run: the uniform backend or 'mixed'."""
    names = {sp.backend for sp in specs}
    return names.pop() if len(names) == 1 else "mixed"


def _run_comm_bytes(pl: PartitionPlan, specs: Sequence[ModeSpec]) -> float:
    """Modeled comm bytes of the backends that ran (a plan may run under
    another backend family than it was costed for), so fitted per-backend
    bandwidths pair seconds with the bytes actually moved."""
    total = pl.metrics.fm_volume * 4.0
    for n, sp in enumerate(specs):
        total += backend_comm_bytes(sp.backend, pl.comm(n))
    return total


# ------------------------------------------------------- shared executors
_SHARED: dict[tuple, HooiExecutor] = {}  # (P, device) -> executor
# given meshes, keyed by content (``RankMesh.key``: equal meshes share one
# executor) and LRU-bounded, as the reference keys and bounds them
_SHARED_BY_MESH: dict[tuple, HooiExecutor] = {}
_SHARED_LOCK = threading.Lock()


def shared_executor(P_ranks: int, device: str | torch.device | None = None,
                    *, mesh: RankMesh | None = None) -> HooiExecutor:
    """The process-wide executor for (P, device), or for (P, mesh), which
    ``dist_hooi`` runs on, so repeated calls (and interleaved calls on
    different cached tensors) reuse steps and uploads with no plumbing.
    Without a mesh the ranks share one device; a mesh is keyed by its
    content, as the reference keys it."""
    if mesh is not None:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both: the "
                             "mesh's first device is its home")
        key = (int(P_ranks), mesh.key())
        with _SHARED_LOCK:
            ex = _SHARED_BY_MESH.pop(key, None)  # LRU touch
            if ex is None:
                ex = HooiExecutor(P_ranks, mesh=mesh)
            _SHARED_BY_MESH[key] = ex
            while len(_SHARED_BY_MESH) > MAX_SHARED_MESH_EXECUTORS:
                _SHARED_BY_MESH.pop(next(iter(_SHARED_BY_MESH)))
            return ex
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = (int(P_ranks), str(dev))
    with _SHARED_LOCK:
        ex = _SHARED.get(key)
        if ex is None:
            ex = _SHARED[key] = HooiExecutor(P_ranks, dev)
        return ex
