"""HOOI (Higher-Order Orthogonal Iteration) — single-process entry point.

The port of ``src/repro/core/hooi.py``; the procedure of paper Fig 2:

    for each mode n:
        Z_(n)  <- TTM-chain skipping n, unfolded       (engine Z-build stage)
        F~_n   <- leading K_n left singular vectors    (engine oracle stage)
    core   <- T x_1 F~_1^T ... x_N F~_N^T              (once per sweep)

``hooi`` drives ``engine.sweep.run_hooi_sweeps`` with ``engine.steps``'s
local mode step. On the card the Z-builds (the core's included) run the
CUDA ``kron_segsum`` kernel, with ``fused_zbuild=True`` the mode steps run
``kron_segsum_oracle`` instead, and with ``use_fused_oracle=True`` the
Lanczos products run the CUDA ``oracle_pair`` kernel.

Signatures follow the reference where the arguments mean the same. The
reference's ``use_kernels`` is absent: here the device chooses the Z-build
(kernel on the card, plain PyTorch on the CPU). Added: ``device`` (default
the card), ``draw`` (the random-draw seam, ``repro_torch.random``),
``on_sweep``, and ``init`` also accepting explicit initial factors.
``lanczos_block`` (block Lanczos), ``fused_zbuild``, ``warm_start`` (the
sketch warm start, ``core.sketch``) and ``objective`` (tucker, completion
and nonnegative, ``engine.objective``) are the reference's.
``precision="auto"`` picks bf16 when the current fitted ``CostModel``
measured a bf16 TTM rate above 1.05 times the f32 one, as the reference
does (``engine.zbuild.resolve_precision``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch import convert, tracing
from repro_torch.core.coo import SparseTensor
from repro_torch.device import (full_precision_matmul, on_device,
                                resolve_device)
from repro_torch.random import Draw, Key, make_key

__all__ = ["Decomposition", "random_factors", "hosvd_init", "hooi_invocation",
           "hooi", "fit_score"]


@dataclasses.dataclass
class Decomposition:
    core: torch.Tensor | None  # (K_1..K_N); None until finalized
    factors: list[torch.Tensor]  # F_n: (L_n, K_n), orthonormal columns

    @property
    def core_dims(self) -> tuple[int, ...]:
        return tuple(int(f.shape[1]) for f in self.factors)


def random_factors(shape: Sequence[int], core_dims: Sequence[int], key: Key,
                   device: str | torch.device | None = None
                   ) -> list[torch.Tensor]:
    """Random orthonormal factor matrices (paper: valid HOOI bootstrap).

    The QR runs on the host (LAPACK) and the result moves to ``device``, so
    the card and the CPU start from the same factors, signs included.
    """
    dev = resolve_device(device)
    factors = []
    for n, (L, K) in enumerate(zip(shape, core_dims)):
        g = key.fold_in(n).normal((L, K), "cpu")
        q, _ = torch.linalg.qr(g)
        factors.append(q.to(dev))
    return factors


def hosvd_init(t: SparseTensor, core_dims: Sequence[int],
               device: str | torch.device | None = None) -> list[torch.Tensor]:
    """HOSVD bootstrap via dense unfoldings — small tensors / tests only."""
    dev = resolve_device(device)
    dense = torch.as_tensor(t.todense(), dtype=torch.float32).to(dev)
    factors = []
    for n, K in enumerate(core_dims):
        M = dense.movedim(n, 0).reshape(t.shape[n], -1)
        u, _, _ = torch.linalg.svd(M, full_matrices=False)
        factors.append(u[:, :K])
    return factors


def _local_specs(knobs, factors: Sequence[torch.Tensor], shape,
                 lanczos_iters: int | None) -> list:
    """Each mode's ``engine.oracle.mode_spec`` from the request ``knobs``:
    ``K_n`` and ``K_hat`` from the factors' widths, the given
    ``lanczos_iters`` as the reference's ``hooi`` takes it."""
    from repro_torch.engine.oracle import mode_spec

    widths = [int(f.shape[1]) for f in factors]
    return [mode_spec(knobs, widths[n], int(L),
                      math.prod(widths[:n] + widths[n + 1:]), lanczos_iters)
            for n, L in enumerate(shape)]


def hooi_invocation(
    t: SparseTensor,
    factors: list[torch.Tensor],
    key: Key,
    lanczos_iters: int | None = None,
    timings: dict | None = None,
    use_fused_oracle: bool | None = None,
    precision: str | None = None,
    lanczos_block: int | None = None,
    fused_zbuild: bool | None = None,
    warm_start: str | None = None,
    objective=None,
    device: str | torch.device | None = None,
) -> list[torch.Tensor]:
    """One HOOI invocation: refine all factor matrices (no core update).

    Per-mode keys are ``key.fold_in(n)``, the reference's convention for
    this entry point. ``factors`` must lie on ``device`` (default the card).
    ``objective`` post-processes each mode's solve (``refine_factor``); as
    in the reference, this entry point applies no ``prepare_tensor`` view.
    """
    from repro_torch.engine import steps
    from repro_torch.engine.objective import resolve_objective
    from repro_torch.engine.oracle import resolve_knobs

    dev = resolve_device(device)
    full_precision_matmul()
    obj = None if objective is None else resolve_objective(objective)
    knobs = resolve_knobs(precision, lanczos_block, fused_zbuild, warm_start,
                          use_fused_oracle)
    specs = _local_specs(knobs, factors, t.shape, lanczos_iters)
    new_factors = list(factors)
    with on_device(dev):  # the kernels launch on the current device
        coords, values = convert.device_coords(t, dev)
        for n in range(t.ndim):
            new_factors[n] = steps.local_mode_step(
                coords, values, new_factors, n, t.shape[n], key.fold_in(n),
                specs[n], timings=timings, objective=obj)
    return new_factors


def fit_score(t: SparseTensor, dec: Decomposition) -> float:
    """Fit = 1 - ||T - Z||_F / ||T||_F.

    With orthonormal factors and core = T x_n F_n^T, ||T - Z||^2 =
    ||T||^2 - ||G||^2, so no reconstruction is materialized.

    ``sum(values**2)`` equals ||T||^2 only for duplicate-free COO; a tensor
    carrying duplicate coordinates (a stream's value updates, see
    ``repro_torch.streaming``) provides the true norm as ``_true_norm2``
    and it takes precedence, as in the reference.
    """
    with tracing.span("sweep.norm2"):
        true_norm2 = getattr(t, "_true_norm2", None)
        t_norm2 = float(true_norm2) if true_norm2 is not None \
            else float(np.sum(t.values**2))
    g_norm2 = float(torch.sum(dec.core**2))
    err2 = max(t_norm2 - g_norm2, 0.0)
    return 1.0 - float(np.sqrt(err2) / (np.sqrt(t_norm2) + 1e-30))


def hooi(
    t: SparseTensor,
    core_dims: Sequence[int],
    n_invocations: int = 5,
    init: str | Sequence = "random",
    seed: int = 0,
    lanczos_iters: int | None = None,
    verbose: bool = False,
    use_fused_oracle: bool | None = None,
    precision: str | None = None,
    lanczos_block: int | None = None,
    fused_zbuild: bool | None = None,
    warm_start: str | None = None,
    objective=None,
    metrics_out: dict | None = None,
    *,
    device: str | torch.device | None = None,
    draw: Draw | None = None,
    on_sweep: Callable[[int, float, float], None] | None = None,
) -> tuple[Decomposition, list[float]]:
    """Full HOOI driver: bootstrap, invoke repeatedly, finalize core.

    ``init`` is ``"random"`` (orthonormalized draws along the reference's
    key chain), ``"hosvd"``, or a sequence of initial factor matrices.
    ``use_fused_oracle`` routes the Lanczos products through the
    ``oracle_pair`` kernel. ``precision`` is ``"f32"``/``"bf16"``/None
    (None honors ``REPRO_PRECISION``). ``lanczos_block`` is the requested
    Lanczos panel width (None honors ``REPRO_LANCZOS_BLOCK``), clamped per
    mode; ``fused_zbuild`` fuses the Z-build with the first panel product
    (None honors ``REPRO_FUSED_ZBUILD``). ``warm_start`` is ``"none"``,
    ``"sketch"`` or ``"auto"`` (None honors ``REPRO_WARM_START``):
    ``"sketch"`` seeds the block driver with the factor-sketched panel under
    the reduced budget, ``"auto"`` takes it per mode where it reads Z fewer
    times. ``objective`` selects what the sweeps optimize (None honors
    ``REPRO_OBJECTIVE``, default tucker; a name or an
    ``engine.objective.Objective``); its ``prepare_tensor`` view is applied
    here, before anything goes to the device. ``metrics_out`` (a dict)
    collects the objective's extra per-sweep stats (held-out RMSE).

    ``draw`` replaces the default seeded draws (``repro_torch.random``);
    ``on_sweep(it, seconds, fit)`` observes every sweep.

    The sweeps read ``t``'s coordinates and values from
    ``convert.device_coords``, which keeps them with ``t`` on ``device``:
    the first call on a tensor copies them there, later calls on the same
    instance reuse that copy (the span ``hooi.upload`` then counts 0
    ``hooi.upload_bytes`` and 1 ``hooi.upload_reused``). The copy stays on
    the device, about ``nnz * (4 N + 4)`` bytes, for as long as ``t`` lives;
    it is shared and never written.
    """
    from repro_torch.engine import steps
    from repro_torch.engine.objective import resolve_objective
    from repro_torch.engine.oracle import resolve_knobs
    from repro_torch.engine.sweep import run_hooi_sweeps

    dev = resolve_device(device)
    # the kernels launch on the current device: make it the run's
    with tracing.span("hooi"), on_device(dev):
        with tracing.span("hooi.setup"):
            full_precision_matmul()
            obj = resolve_objective(objective)
            knobs = resolve_knobs(precision, lanczos_block, fused_zbuild,
                                  warm_start, use_fused_oracle, obj.name)
            t = obj.prepare_tensor(t)

            key = make_key(seed, draw)
            if isinstance(init, str):
                if init == "random":
                    factors = random_factors(t.shape, core_dims, key, dev)
                elif init == "hosvd":
                    factors = hosvd_init(t, core_dims, dev)
                else:
                    raise ValueError(f"unknown init {init!r}")
            else:
                factors = convert.factors(init, dev)
                got = tuple((int(f.shape[0]), int(f.shape[1]))
                            for f in factors)
                if got != tuple(zip(t.shape, core_dims)):
                    raise ValueError(f"initial factors have shapes {got}, "
                                     f"expected "
                                     f"{tuple(zip(t.shape, core_dims))}")
            specs = _local_specs(knobs, factors, t.shape, lanczos_iters)

            with tracing.span("hooi.upload"):
                reused = convert.kept_coords(t, dev) is not None
                coords, values = convert.device_coords(t, dev)
                # the bytes that crossed: none when the copy was kept
                tracing.count("hooi.upload_bytes", 0 if reused
                              else coords.nbytes + values.nbytes)
                if reused:
                    tracing.count("hooi.upload_reused", 1)

        def mode_step(n, facs, kk):
            return steps.local_mode_step(coords, values, facs, n, t.shape[n],
                                         kk, specs[n], objective=obj)

        def report(it, seconds, fit):
            if verbose:
                print(f"  HOOI invocation {it}: fit={fit:.4f}")
            if on_sweep is not None:
                on_sweep(it, seconds, fit)

        return run_hooi_sweeps(coords, values, t, factors, key,
                               n_invocations, mode_step, on_sweep=report,
                               objective=obj, metrics_out=metrics_out)
