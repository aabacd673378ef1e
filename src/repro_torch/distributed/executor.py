"""HooiExecutor: distributed HOOI over P ranks stacked on one device.

The port of ``src/repro/distributed/executor.py``'s ``HooiExecutor.run``.
The reference runs the P ranks on P devices of a ``ranks`` mesh, through
``shard_map`` steps it compiles and caches, over device uploads it caches
per plan. Here the P ranks are a leading dimension of every partition array
on one device (the card, or the CPU when asked), and a ``psum`` is a sum
over that dimension in rank order (``engine.comm``). The executor owns no
math of its own: every mode step is ``engine.steps.make_mode_step_fn``
(Z-build -> oracle -> comm backend) and the sweep loop is the shared
``engine.sweep.run_hooi_sweeps``.

What ``run`` does: takes the objective's view of the tensor, builds or
reuses the plan for it (``repro_torch.core.plan``, content-cached on the
host), derives each mode's static step parameters exactly as the reference
does (``_mode_specs``, which settles ``warm_start="auto"`` per mode),
uploads each ``ModePartition`` to the device as it is (plus the comm
spaces' gather maps), and runs the sweeps; the objective refines each
mode's factor after the row-perm restore. The reference's compiled-step
and upload caches, ``prepare``/``stage_upload``, ``profile_phases``,
calibration samples and the stochastic rung are ROADMAP Queue A items 10
and 11.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.coo import SparseTensor
from repro_torch.core.distribution import Scheme
from repro_torch.core.hooi import Decomposition, random_factors
from repro_torch.core.lanczos import effective_block_size, lanczos_niter
from repro_torch.core.plan import (PartitionPlan, last_plan_call_cache_hit,
                                   plan as build_plan, plan_cache_stats)
from repro_torch.core.sketch import (DEFAULT_POWER_ITERS, sketch_block_size,
                                     sketch_niter)
from repro_torch.device import full_precision_matmul, resolve_device
from repro_torch.engine.comm import comm_maps, resolve_backend
from repro_torch.engine.objective import resolve_objective
from repro_torch.engine.oracle import (choose_warm_start, count_z_passes,
                                       resolve_block_size, resolve_warm_start)
from repro_torch.engine.steps import make_mode_step_fn
from repro_torch.engine.sweep import run_hooi_sweeps
from repro_torch.engine.zbuild import resolve_fused_zbuild, resolve_precision
from repro_torch.random import Draw, make_key

from .partition import comm_model  # noqa: F401 — re-export

__all__ = ["HooiExecutor", "DistHooiStats", "comm_model", "upload_mode",
           "RUN_PATHS"]

RUN_PATHS = ("baseline", "liteopt", "auto")


@dataclasses.dataclass
class DistHooiStats:
    """What one ``run`` reports; the reference's fields that mean the same.

    * ``fits`` — fit after each sweep;
    * ``sweep_s`` — each sweep's wall seconds (its mode steps, up to the
      device finishing; the core and fit come after);
    * ``comm`` — the plan's analytic per-mode comm model;
    * ``r_pad``/``e_pad`` — per mode, padded local rows and elements per rank;
    * ``scheme``/``selection`` — the scheme that ran (``auto`` resolves to a
      candidate) and, for ``auto``, each candidate's modeled seconds;
    * ``partition_build_s`` — host seconds spent in ``plan()`` this call
      (about 0 on a plan-cache hit or a passed-in plan);
    * ``plan_cache_hit``/``plan_cache`` — this call's cache outcome and the
      cache's counters after it;
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
      estimates.
    """

    fits: list
    sweep_s: list
    comm: dict
    r_pad: dict
    e_pad: dict
    scheme: str = ""
    selection: dict | None = None
    partition_build_s: float = 0.0
    plan_cache_hit: bool = False
    plan_cache: dict | None = None
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


@dataclasses.dataclass(frozen=True)
class _ModeSpec:
    """Static per-mode step parameters."""

    backend: str
    K_n: int
    niter: int  # block iterations when the block driver runs
    precision: str = "f32"
    block_size: int = 1  # effective (clamped) Lanczos panel width
    fused_zbuild: bool = False
    warm_start: str = "none"  # resolved per mode ("none" | "sketch")


def upload_mode(mp, dev: torch.device) -> dict:
    """One ``ModePartition`` on ``dev``: its elements flattened over the
    ranks, with each rank's local rows offset by ``p*R_pad`` (still sorted,
    one Z-build for all ranks), and the comm spaces' gather maps."""
    P, E_pad, N = mp.coords.shape
    if P * mp.R_pad >= 2**31:
        raise ValueError(f"P*R_pad = {P * mp.R_pad} rows exceed int32")
    rows = torch.from_numpy(mp.local_rows).to(dev)
    rows = (rows + (torch.arange(P, dtype=torch.int32, device=dev)
                    * mp.R_pad)[:, None]).reshape(-1)
    arrs = {"coords": torch.from_numpy(mp.coords.reshape(P * E_pad, N)).to(dev),
            "values": torch.from_numpy(mp.values.reshape(-1)).to(dev),
            "rows": rows.contiguous()}
    for name, idx in comm_maps(mp).items():
        arrs[name] = torch.from_numpy(idx).to(dev)
    return arrs


class HooiExecutor:
    """Runs distributed HOOI sweeps over ``P_ranks`` ranks stacked on one
    device (default: the card)."""

    def __init__(self, P_ranks: int, device: str | torch.device | None = None):
        self.P = int(P_ranks)
        if self.P < 1:
            raise ValueError(f"P_ranks must be >= 1, got {P_ranks}")
        self.device = resolve_device(device)

    def _check_plan(self, pl: PartitionPlan, t: SparseTensor,
                    core_dims: Sequence[int], path: str,
                    objective: str = "tucker") -> None:
        """Refuse a prebuilt plan that does not describe this run (``t`` is
        the objective's view)."""
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

    def _mode_specs(self, pl: PartitionPlan, core_dims: Sequence[int],
                    path: str, precision: str = "f32", block_size: int = 1,
                    fused_zbuild: bool = False,
                    warm_start: str = "none") -> list[_ModeSpec]:
        """Per-mode static step parameters, the reference's arithmetic.

        * ``backend``: ``path="auto"`` honors a plan costed with
          ``path="auto"`` or compares the mode's analytic comm models; P=1
          is ``local``.
        * ``niter``: the shared Lanczos iteration count, clamped by the
          true row count and the effective K_hat (factor widths
          ``min(L_n, K_n)``) — the numbers the local path derives, so P=1
          trajectories coincide. Block iterations under the block driver.
        * ``block_size``: clamped per mode with ``effective_block_size``.
        * ``warm_start``: ``"auto"`` settles per mode (``choose_warm_start``
          on the geometry the local path sees, so P=1 parity holds). A
          sketch mode runs the widened ``sketch_block_size`` panel, the
          ``sketch_niter`` budget and never the fused build.
        """
        parts = pl.parts
        eff = tuple(min(int(k), int(mp.L))
                    for k, mp in zip(core_dims, parts))
        recorded = None
        if path == "auto" and pl.cost.path == "auto" and self.P > 1 \
                and len(pl.cost.mode_backends) == len(parts):
            recorded = pl.cost.mode_backends
        specs = []
        for n, mp in enumerate(parts):
            K_n = int(core_dims[n])
            khat = int(np.prod([eff[j] for j in range(len(eff)) if j != n]))
            if recorded is not None:
                backend = resolve_backend(recorded[n], self.P)
            else:
                backend = resolve_backend(
                    path, self.P, pl.comm(n) if path == "auto" else None)
            s_eff = effective_block_size(K_n, int(mp.L), khat, block_size)
            ws = choose_warm_start(warm_start, K_n, int(mp.L), khat, s_eff,
                                   fused_zbuild)
            fz_n = fused_zbuild and ws != "sketch"
            if ws == "sketch":
                s_eff = sketch_block_size(K_n, int(mp.L), khat, block_size)
                niter = sketch_niter(K_n, int(mp.L), khat, s_eff)
            else:
                niter = lanczos_niter(K_n, int(mp.L), khat,
                                      s_eff if (fz_n or s_eff > 1) else 1)
            specs.append(_ModeSpec(
                backend=backend, K_n=K_n, niter=niter, precision=precision,
                block_size=s_eff, fused_zbuild=fz_n, warm_start=ws))
        return specs

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
        objective=None,
        draw: Draw | None = None,
        on_sweep: Callable[[int, float, float], None] | None = None,
    ) -> tuple[Decomposition, DistHooiStats]:
        """One distributed HOOI decomposition.

        ``scheme`` is a scheme name (including ``"auto"``), a ``Scheme``,
        or a ``PartitionPlan``; names and schemes go through the
        content-keyed plan cache with ``plan_seed``. ``path`` selects the
        comm backend family: ``"baseline"`` (psum), ``"liteopt"``
        (boundary) or ``"auto"`` (per mode); P=1 always runs ``local``.
        ``use_fused_oracle`` routes the Lanczos products through
        ``oracle_pair``; ``precision``, ``lanczos_block`` and
        ``fused_zbuild`` are the reference's roofline knobs (each None
        honors its ``REPRO_*`` variable). ``warm_start`` (``"none"``,
        ``"sketch"``, ``"auto"``; None honors ``REPRO_WARM_START``) seeds the
        block driver with the factor-sketched panel. ``objective`` (None
        honors ``REPRO_OBJECTIVE``; a name or an ``Objective``) selects what
        the sweeps optimize: the plan partitions its view of ``t``, and a
        prebuilt plan must have been built for it. ``init_factors`` replaces
        the seeded random start (factors of shape ``(L_n, min(L_n, K_n))``).
        ``draw`` fills the random-draw seam (``repro_torch.random``);
        ``on_sweep(it, seconds, fit)`` observes every sweep.
        """
        if path not in RUN_PATHS:
            raise ValueError(f"unknown path {path!r} (expected one of "
                             f"{RUN_PATHS})")
        dev = self.device
        full_precision_matmul()
        obj = resolve_objective(objective)
        t = obj.prepare_tensor(t)
        prec = resolve_precision(precision)
        blk = resolve_block_size(lanczos_block)
        fz = resolve_fused_zbuild(fused_zbuild)
        warm = resolve_warm_start(warm_start)
        fused = bool(use_fused_oracle)

        t_plan = time.perf_counter()
        if isinstance(scheme, PartitionPlan):
            pl = scheme
            self._check_plan(pl, t, core_dims, path, obj.name)
            cache_hit = False
        else:
            pl = build_plan(t, scheme, self.P, core_dims=tuple(core_dims),
                            path=path, seed=plan_seed, objective=obj)
            cache_hit = last_plan_call_cache_hit()
        partition_build_s = time.perf_counter() - t_plan

        N = t.ndim
        key = make_key(seed, draw)
        if init_factors is None:
            factors = random_factors(t.shape, core_dims, key, dev)
        else:
            factors = convert.factors(init_factors, dev)
        parts = pl.parts
        specs = self._mode_specs(pl, core_dims, path, precision=prec,
                                 block_size=blk, fused_zbuild=fz,
                                 warm_start=warm)
        steps = [make_mode_step_fn(
            dict(mode=n, R_pad=mp.R_pad, Lp=mp.Lp, P=mp.P, use_fused=fused,
                 precision=sp.precision, block_size=sp.block_size,
                 fused_zbuild=sp.fused_zbuild, warm_start=sp.warm_start),
            sp.backend, sp.K_n, sp.niter)
            for n, (mp, sp) in enumerate(zip(parts, specs))]
        arrs = [upload_mode(mp, dev) for mp in parts]
        row_perms = [torch.from_numpy(mp.row_perm).to(dev) for mp in parts]
        coords, values = convert.device_coords(t, dev)

        spectra: dict = {}

        def mode_step(n, facs, kk):
            F, sv = steps[n](arrs[n], facs, kk)
            spectra[n] = sv
            # the stacked (P, Lp, k) rows are in relabelled order: flatten
            # over the ranks, restore the original row order, then let the
            # objective refine the full-row factor — the update the local
            # path applies, so P=1 parity covers every objective
            return obj.refine_factor(F.reshape(-1, F.shape[-1])[row_perms[n]],
                                     sv)

        sweep_s: list[float] = []

        def report(it, seconds, fit):
            sweep_s.append(seconds)
            if on_sweep is not None:
                on_sweep(it, seconds, fit)

        objective_metrics: dict = {}
        dec, fits = run_hooi_sweeps(coords, values, t, factors, key,
                                    n_invocations, mode_step,
                                    on_sweep=report, objective=obj,
                                    metrics_out=objective_metrics)
        stats = DistHooiStats(
            fits=fits, sweep_s=sweep_s,
            comm={n: pl.comm(n) for n in range(N)},
            r_pad={n: parts[n].R_pad for n in range(N)},
            e_pad={n: parts[n].E_pad for n in range(N)},
            scheme=pl.name,
            selection=pl.candidates,
            partition_build_s=partition_build_s,
            plan_cache_hit=cache_hit,
            plan_cache=plan_cache_stats(),
            comm_backends={n: specs[n].backend for n in range(N)},
            fused_oracle=fused,
            precision=prec,
            lanczos_block={n: specs[n].block_size for n in range(N)},
            fused_zbuild=fz,
            z_passes={n: count_z_passes(
                specs[n].niter, specs[n].fused_zbuild,
                warm_start=specs[n].warm_start,
                power_iters=DEFAULT_POWER_ITERS
                if specs[n].warm_start == "sketch" else 0)
                for n in range(N)},
            objective=obj.name,
            objective_metrics=objective_metrics or None,
            warm_start={n: specs[n].warm_start for n in range(N)},
            mode_spectra={n: v.cpu().numpy() for n, v in spectra.items()}
            or None,
        )
        return dec, stats
