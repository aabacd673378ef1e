#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each fatal on failure (nothing is caught):

1. environment: torch and CUDA versions, the card's name and power limit,
   the ``REPRO_*`` knobs as resolved (``envknobs.snapshot()``);
2. build: ``nvcc`` compiles every kernel of ``src/repro_torch/kernels/csrc``
   (one process per source, in parallel);
3. kernels against their plain PyTorch versions on the card:
   ``kron_segsum`` on the first 8M elements of the main-path tensor sorted
   by each mode's rows (f32 and bf16), an empty input, a 4-mode K̂ = 1000
   case and a hub case with 30% of the elements in one row, each in the
   row form (the TPU function's signature) and, bitwise equal to it, in the
   gather form the main path calls (factor rows gathered in the kernel);
   ``oracle_pair`` on the main path's Z with s = 1, s = 8 and the sketch
   panel's s = 10 (a full pass of 8 columns and a tail of 2), both halves
   and each half alone (as the Lanczos loop calls it); each also rerun and
   required bitwise equal;
4. the single-process path: ``repro_torch.core.hooi.hooi`` on the
   nell-2-sized tensor ``synth_tensor((12092, 9184, 28818), 76_879_419,
   alphas=(0.9, 0.9, 1.0), seed=0)``, core (10, 10, 10), 3 invocations,
   ``use_fused_oracle=True``, with both kernels' launch counts read around
   it; then the low-rank recipe (fit > 0.99) and a small tensor on the card
   against the port's plain CPU path;
5. where a sweep's time goes: ``torch.profiler`` over one more invocation
   of that path, device time by kernel and the device's busy share;
6. timings at that path's shapes, against each kernel's bound:
   ``kron_segsum``'s gather form against ``_split_ab`` plus the row form
   (what the path paid before) and the row form alone; ``oracle_pair`` per
   main-path call (one half), as call time back to back and as device time
   (the profiler's kernel sum), beside one ``torch.matmul``, at s = 1 and
   at the sketch panel's s = 10; ``kron_segsum_oracle``'s gather form at
   ``range_finder``'s s = k + oversample = 14;
7. ``kron_segsum_oracle`` against its plain version: the first 8M elements
   of the main-path tensor sorted by each mode's rows, f32 and bf16,
   panels of s = 1, 4, 8 and 14 (the gather form too at s = 8 and 14), the
   4-mode K̂ = 1000 case and the hub case; reruns bitwise equal and Z
   bitwise equal to ``kron_segsum``'s;
8. the distributed path: ``repro_torch.distributed.dist_hooi.dist_hooi`` on
   the same tensor over a Lite plan for P = 4 ranks stacked on the card
   (the plan is built once on the host, costed for ``path="auto"``), with
   ``lanczos_block=8, fused_zbuild=True, use_fused_oracle=True``, 3
   invocations, on the process-wide ``shared_executor(4)``, every step a
   captured CUDA graph: on ``path="liteopt"`` (boundary) run 1 (3 captures,
   the plan's arrays uploaded), ``stage_upload`` (already resident), run 2
   with another seed (0 captures, 0 uploads, 9 step-cache hits); then
   ``path="baseline"`` (psum), each with every kernel's launch count, set-up
   seconds and peak memory read around it; then a small tensor on the
   card against the CPU, a ``torch.profiler`` pass over one invocation
   (with the host's graph and kernel launches); at the distributed shapes
   (each mode's padded stacked
   partition) the gather form of ``kron_segsum_oracle`` checked bitwise
   against the row form and timed against its bound, the row form,
   ``_split_ab`` plus the row form, its plain version and ``kron_segsum``
   plus one ``torch.matmul``; and the stacked ``oracle_pair`` (P = 4,
   s = 8 and the sketch panel's s = 10) checked against its plain version
   and bitwise against P single calls, timed against P single calls plus
   ``torch.stack``;
9. the sketch warm start on the distributed path: ``dist_hooi`` with
   ``warm_start="sketch"`` (``lanczos_block=8``, 3 invocations) on the Lite
   plan phase 8 cached, a plan-cache hit (no second build);
10. the sketch warm start on the single-process path at full width:
    ``hooi`` as in phase 4 with ``warm_start="sketch"`` and then ``"auto"``
    (sketch for every mode at these widths: 6 counted Z passes against
    41), each logging fits and their gap to phase 4's, counted Z passes,
    every kernel's launches per sweep, steady sweep seconds and peak
    memory; then a ``torch.profiler`` pass over one sketch invocation;
11. the objectives at full width, single process:
    ``CompletionObjective(holdout_fraction=0.2)`` with the held-out RMSE
    per sweep, and ``objective="nn"`` (factors exactly nonnegative, fits
    finite in [0, 1]);
12. every objective × warm start on a small tensor on the card against the
    port's CPU path, single process and P = 4 on both backends;
13. captured against eager: each mode step of the cached plan in three
    configurations (``fused_block8`` on boundary and on psum, the sketch
    warm start), the uncached step function once eagerly, then the
    executor's cached step twice on the same inputs, F and S bitwise equal;
14. ``HooiExecutor.profile_phases`` on the cached plan (f32 and bf16), the
    TTM and the rest per mode, then ``fit_cost_model`` of the executor's
    calibration samples and what ``precision="auto"`` picks under it (the
    default model restored after);
15. the stochastic-refine rung at full width: the snapshot with its last 1%
    (613,798 elements) as the append, ``sample_fraction=0.25,
    sample_seed=7, replay_nnz=1024``, three chained refines from phase 8's
    factors (seconds, minibatch, fits and their gap to the full run), the
    first again (0 captures, 0 uploads, bitwise equal), and a small tensor
    on the card against the CPU;
16. ``StreamScheduler`` on a fresh shared executor (P = 4, the earlier
    phases' plan released) through the refresh ladder, the stream seeded
    with every second element of the nell-2-sized tensor (30,689,886
    elements, its skew kept; cut for time), geometric pads, its own plan
    build:
    ``plan`` (then a direct run bitwise its fits), ``reuse`` (0
    compilations, captures, uploads), 1% new elements ->
    ``stochastic-refine`` (the snapshot's ``_true_norm2`` spares its fits
    the host's sum of squares), value updates at 1% of the coordinates ->
    ``repartition`` (``correction_every=2``; the scheme and the padded
    shapes kept, no step compiled), ``reuse``, a hub batch of 18% of the
    elements at one coordinate -> ``reselect``; per rung the decision,
    drift, ``prepare_s``/``run_s``/``queue_wait_s``, captures, uploads,
    replays and fits, then ``scheduler.stats()``, the appends' seconds and
    the host's peak RSS; then, on the reselect plan's stacked partitions
    (E_pad 2^24 per rank, the hub batch's elements in a few rows of every
    mode, the largest row's count logged), the gather-form ``kron_segsum``
    against its plain version (summed in element chunks) and
    ``oracle_pair`` on that Z against its plain version, each rerun
    bitwise; the stream and the reselect plan (``PartitionPlan.save``
    bytes) go on to phase 17;
17. ``ExecutorPool(device_count, 4, CORE, scheme="lite", path="auto",
    pad_geometric=True, n_invocations=3, use_fused_oracle=True)`` behind
    ``StreamRouter(pool, max_pending=4)``, one lane per card:
    ``device_slices`` refuses too many lanes and two lanes on one card;
    the reselect plan loaded against the stream's snapshot and adopted by
    lane 0, whose first interactive submit is a ``reuse`` with 0 uploads
    (its fits bitwise a direct run on the plan and seed), a sticky
    resubmit with 0 compilations, captures and uploads; admission behind
    an interactive nell-2 run in flight (the ``serve_pool`` example's
    small batch one-shots: one admitted, then ``PoolSaturated``; an
    interactive one still admitted); one SLO missed (1 ms) and four met;
    ``drain()`` in submission order, ``stats()`` the lanes' sums,
    ``backlog_s`` back to 0, ``reroute`` refused on one lane; the current
    CUDA device inside every lane run; no lane thread left after
    ``close()``; per submit the decision, lane, stage seconds,
    compilations, captures and uploads, and the launch counts and peak
    memory of the phase.

18. the paper's scheme comparison at nell-2 size (right after phase 15):
    a CoarseG plan (``coarse``, LPT) and a MediumG plan (``medium``) for
    P = 4, each built outside the plan cache and run with ``fused_block8``
    on boundary and psum through captured steps, each rerun bitwise with 0
    captures and 0 uploads, held to phase 8's Lite runs (fits within 1e-4,
    the final core's energy share within 2e-6 relative of the nearer of
    Lite's psum and boundary runs); per scheme the
    plan's host seconds, the replayed sweep, ``E_pad``/``R_pad``/``Lp``,
    ``SchemeMetrics``, the modeled bytes per sweep by kind, peak memory,
    and what ``auto`` would pick from the plans' modeled seconds;
19. the mesh (after the pool, phase 17): P = 4 over ``[cuda:0] * G`` for
    G = 2 and 4 (``make_ranks_mesh``, ``HooiExecutor(4, mesh=)``, each
    group on its own stream), ``fused_block8`` on psum and boundary and
    one vector run (G = 2), each against the stacked captured run of the
    same plan, seed and draws (bitwise, or within the f32 bars: rows
    straddle a chunk at a group's start); the stacked boundary run also
    timed eagerly; a rerun bitwise with 0 uploads and 0 compilations;
    fits, steady seconds per sweep, launches per sweep, bytes between
    groups per sweep by kind (``"u"``: the comm space and the Lanczos
    body; ``"factors"``) beside ``comm_model``'s and beside what the run
    moved with its u-space at home (psum's accounting: a psum run moves
    exactly that, a boundary run, its u-space sharded over the groups,
    must move less, its ``"u"`` bytes exactly ``modeled_u_bytes``), peak
    memory; every group's arrays on its device, every kernel launch with
    its group's device current and on its group's stream, every u-space
    shard (``GroupTensor`` part) on its group's device and made on its
    group's stream; the device ops one boundary invocation dispatches
    (``mesh_census``), stacked eager and per mesh; with two or more cards
    a mesh over distinct cards too (else the skip is logged). Those mesh
    runs are eager (their executor's captures off); then each mesh on one
    card runs every row again on the same executor, its steps captured as
    CUDA graphs: captures on the first run, held to the stacked captured
    run (bitwise, or within the f32 bars) and to the same mesh run eagerly
    (bitwise, or the verdict logged within the f32 bars), bytes between
    groups by kind equal to the eager run's, every launch recorded on its
    group's stream; a rerun with 0 captures, compilations and uploads,
    replays, bitwise; per row the segments per step, steady seconds per
    sweep captured beside eager, graph launches and their host seconds
    (``cudaGraphLaunch``) per sweep, kernel executions per replayed sweep
    (the launches the captures recorded, and the core's), and peak memory
    captured beside eager;
    on phase 17's geometric-pad reselect plan (E_pad 2^24, every group's
    first element at a multiple of CHUNK), against a fresh stacked
    executor: every run bitwise against the stacked run (eager rows
    against the stacked eager run, captured rows against the stacked
    captured run). Cut for time: the default-pad plan's mesh rows, which
    earlier runs also drove;
20. the scheme comparison at medium size: nell-2's shape with 1,000,000
    draws (the paper runs HyperG on medium tensors only: its partitioner
    loops over the elements in Python), Lite, CoarseG, MediumG and HyperG
    (``hypergraph``) side by side as in phase 18, each held to Lite's runs;
21. four modes at FROSTT enron's size, nothing cut: ``synth_tensor((6066,
    5699, 244268, 1176), 54_202_099)`` under the repo's ``enron-s`` skew
    and hub (``SUITE_SPECS``), seed 0, core (10, 10, 10, 10), K̂ = 1000, on
    a fresh shared executor: ``hooi`` for one invocation; every kernel at
    its shapes (the gather-form ``kron_segsum``, both leading factors
    gathered by the two-lead walk, against its plain Z summed in element chunks,
    the chunk walk and the hub row's fix-up timed apart; ``oracle_pair`` at
    K = 1000 beside ``torch.matmul``); a Lite plan for P = 4 and
    ``dist_hooi`` with ``fused_block8`` on boundary and psum through
    captured steps, each rerun on the cached plan with 0 captures and 0
    uploads, bitwise; ``kron_segsum_oracle`` and the stacked
    ``oracle_pair`` at the distributed shapes; then the paper suite's
    enron-s mirror (``paper_suite``) on the card against the CPU, single
    process and P = 4 on both backends (fits within 1e-4).

Phase 21 runs first, right after the build (nothing else resident, and
the profiler still records its kernels); the distributed phases (7, 8, 9,
13, 14, 15, 18, 16, 17, 19, 20) run right after the kernel checks (3); when
the run is late, the single-process paths are cut to one invocation (never
their shape).

Then one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name and power
limit line, and as the last line ``{"ok": true, "device": {...}}``. Without
CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import gc
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

MAIN_SHAPE = (12092, 9184, 28818)  # FROSTT nell-2
MAIN_NNZ = 76_879_419  # nell-2's nonzeros, drawn before deduplication
MAIN_ALPHAS = (0.9, 0.9, 1.0)  # the repo's nell2-s spec
CORE = (10, 10, 10)  # the paper's default core
INVOCATIONS = 3
CHECK_ELEMENTS = 8_000_000  # main-path elements in the kron_segsum checks
FOUR_MODE = ((200, 300, 400, 500), 2_000_000)  # K̂ = 1000 at K = 10
HUB = (4_000_000, 50_000, 0.3)  # elements, rows, share in one row
DEVICE = "cuda"
SKETCH_PANEL = 10  # the sketch warm start's panel: k at K = 10
RANGE_PANEL = 14  # range_finder's k + oversample at K = 10
FUSED_PANELS = (1, 4, 8, RANGE_PANEL)  # kron_segsum_oracle check widths
DIST_P = 4  # ranks stacked on the card
DIST_BLOCK = 8  # the repo's roofline configuration (benchmarks/run.py)
DIST_INVOCATIONS = 3
DIST_SMALL = ((60, 50, 40), 20_000, (5, 5, 5))  # card vs CPU

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

# |kernel - plain| <= TOL * max|plain|: both sum in f32 but in another order
# (chunked sequential sums and fixed-order partials against index_add_'s
# atomics and cuBLAS's reductions); rows of up to ~10^6 terms keep the
# relative rounding near 1e-5
TOL = 2e-4
# the run must end within 1200 s; past this point the main path is cut to
# one invocation (never the shape)
CUT_INVOCATIONS_AFTER_S = 600.0

# kernel records a profiled session must keep for their mean device time
# when it kept fewer than half of its kernels (see device_ms)
MIN_RECORDS = 32

T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def clocks_line() -> str:
    """The card's SM clock, its maximum and the power draw right now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events over ``reps``."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(got, want) -> tuple[float, float]:
    """(max |got - want|, that over max |want|)."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def check(name: str, got, want, again) -> float:
    import torch

    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    bitwise = torch.equal(got, again)
    log(f"  {name}: max_abs_err={err:.3e} rel={rel:.3e} "
        f"rerun_bitwise={bitwise}")
    if not rel <= TOL:
        raise AssertionError(f"{name}: relative error {rel:.3e} > {TOL}")
    if not bitwise:
        raise AssertionError(f"{name}: rerun not bitwise equal")
    return err


def kron_bound_ms(E: int, Ka: int, Kb: int, num_rows: int) -> tuple[float, str]:
    bytes_ = E * 4 * (1 + Ka + Kb) + num_rows * Ka * Kb * 4
    flops = 2 * E * Ka * Kb
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def oracle_half_bound_ms(R: int, K: int, s: int) -> tuple[float, str]:
    """One product, Z @ x or Zᵀ @ y: Z read once, (K + R) * s in and out."""
    bytes_ = 4 * (R * K + K * s + R * s)
    flops = 2 * R * K * s
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def gather_bound_ms(E: int, N: int, Ka: int, Kb: int, num_rows: int,
                    factor_rows: int, gathered_a: bool = True
                    ) -> tuple[float, str]:
    """The gather form: per element its row id, value (when a is gathered)
    and N coordinates, read once; the factors (or a, for N >= 4) read once
    and Z written once; Ka*Kb products and Ka value products per element."""
    per_elem = 4 * (1 + N) + (4 if gathered_a else 4 * Ka)
    bytes_ = E * per_elem + factor_rows * 4 + num_rows * Ka * Kb * 4
    flops = 2 * E * Ka * Kb + (E * Ka if gathered_a else 0)
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def factor_rows_read(factors, mode) -> int:
    """Floats of the factors the gather form reads (all but the mode's)."""
    return sum(int(f.numel()) for j, f in enumerate(factors) if j != mode)


def device_ms(fn, reps: int, match: str | None = None,
              per_call: int = 1) -> float:
    """Mean device time of ``fn()`` in ms from ``torch.profiler``'s kernel
    records over ``reps`` calls, so host time and launch gaps are left out.

    Without ``match``: all kernels' time over ``reps``. With ``match``: the
    kernels whose name holds it, each call launching ``per_call`` of them,
    as the mean recorded kernel time times ``per_call``. The profiler on
    the card drops some records of a session (the first kernel nearly
    always; late in a run it keeps 39–42 of 100 in every session), so a
    session that recorded fewer than half of the ``reps * per_call``
    kernels, and fewer than ``MIN_RECORDS``, is profiled again, up to three
    times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    want = reps * per_call
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [(ms, n) for ms, n, key in profile_rows(prof)
                if match is None or match in key]
        total = sum(ms for ms, _ in hits)
        seen = sum(n for _, n in hits)
        if total > 0 and match is None:
            return total / reps
        if total > 0 and (2 * seen >= want or seen >= MIN_RECORDS):
            return total / seen * per_call
        log(f"  profiler recorded {seen} of {want} {match} kernels; "
            "profiling again")
    raise AssertionError(f"profiler did not record the device time of "
                         f"{match} in three sessions")


def sorted_elements(coords, values, mode):
    """Elements sorted by the mode's rows: (rows, coords, values)."""
    import torch

    order = torch.argsort(coords[:, mode], stable=True)
    c = coords[order]
    return c[:, mode].contiguous(), c, values[order]


def check_gather(name, rows, c, v, factors, mode, R, prec, z_row,
                 X=None, zx_row=None) -> float:
    """The gather form (as the main path calls it) against its plain
    version, rerun bitwise, and bitwise equal to the row form's Z (and
    ZX) on the host's ``_split_ab`` operands."""
    import torch
    from repro_torch.kernels import ops, ref

    def run():
        if X is None:
            return ops.penultimate_sorted(c, v, rows, factors, mode, R,
                                          precision=prec)
        return ops.penultimate_sorted_oracle(c, v, rows, factors, mode, R,
                                             X, precision=prec)

    got, again = run(), run()
    if X is not None:
        (got, gx), (again, ax) = got, again
    a, b = ops._split_ab(c, v, factors, mode)
    want = ref.kron_segsum_ref(rows, a, b, R, prec)
    del a, b
    err = check(f"gather {name}", got, want, again)
    if not torch.equal(got, z_row):
        raise AssertionError(f"gather {name}: Z differs from the row form's")
    if X is not None:
        err = max(err, check(f"gather {name} ZX", gx, want @ X, ax))
        if not torch.equal(gx, zx_row):
            raise AssertionError(f"gather {name}: ZX differs from the row "
                                 "form's")
    log(f"  gather {name}: Z bitwise equal to the row form's"
        + ("" if X is None else ", ZX too"))
    return err


def phase_kernel_checks(coords, values, factors, shape) -> dict:
    import torch
    from repro_torch.core import hooi
    from repro_torch.data.tensors import synth_tensor
    from repro_torch.convert import device_coords
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.kron_segsum import kron_segsum
    from repro_torch.kernels.oracle_fused import oracle_pair
    from repro_torch.random import make_key

    errs = {"kron_segsum": 0.0, "oracle_pair": 0.0}
    dev = coords.device
    E = min(CHECK_ELEMENTS, coords.shape[0])
    log(f"kron_segsum vs plain on the first {E} elements, tolerance "
        f"{TOL} x max|plain| (summation order)")
    for mode in range(len(shape)):
        rows, c, v = sorted_elements(coords[:E], values[:E], mode)
        a, b = ops._split_ab(c, v, factors, mode)
        for prec in ("f32", "bf16"):
            got = kron_segsum(rows, a, b, shape[mode], precision=prec)
            again = kron_segsum(rows, a, b, shape[mode], precision=prec)
            want = ref.kron_segsum_ref(rows, a, b, shape[mode], prec)
            errs["kron_segsum"] = max(errs["kron_segsum"], check(
                f"mode {mode} {prec} E={E} K={a.shape[1] * b.shape[1]}",
                got, want, again), check_gather(
                f"mode {mode} {prec}", rows, c, v, factors, mode,
                shape[mode], prec, got))
        del rows, c, v, a, b, got, again, want

    empty = kron_segsum(torch.zeros((0,), dtype=torch.int32, device=dev),
                        torch.zeros((0, 10), device=dev),
                        torch.zeros((0, 10), device=dev), 7)
    if not torch.equal(empty, torch.zeros((7, 100), device=dev)):
        raise AssertionError("kron_segsum on no elements is not zero")
    log("  empty input: zeros")

    t4 = synth_tensor(FOUR_MODE[0], FOUR_MODE[1], alphas=1.0, seed=1)
    c4, v4 = device_coords(t4, dev)
    f4 = hooi.random_factors(t4.shape, (10, 10, 10, 10), make_key(4), dev)
    rows, c, v = sorted_elements(c4, v4, 0)
    a, b = ops._split_ab(c, v, f4, 0)
    got = kron_segsum(rows, a, b, t4.shape[0])
    again = kron_segsum(rows, a, b, t4.shape[0])
    want = ref.kron_segsum_ref(rows, a, b, t4.shape[0])
    errs["kron_segsum"] = max(errs["kron_segsum"], check(
        f"4-mode K={a.shape[1] * b.shape[1]} E={t4.nnz}", got, want, again),
        check_gather("4-mode", rows, c, v, f4, 0, t4.shape[0], "f32", got))
    del rows, c, v, a, b, got, again, want, c4, v4

    # the gather form on a hub: 30% of the main-path elements moved into one
    # mode-0 slice
    g = torch.Generator(device=dev).manual_seed(5)
    E_hub, _, share = HUB
    ch = coords[:E_hub].clone()
    ch[torch.rand(E_hub, device=dev, generator=g) < share, 0] = shape[0] // 3
    rows, c, v = sorted_elements(ch, values[:E_hub], 0)
    for prec in ("f32", "bf16"):
        z_row = kron_segsum(rows, *ops._split_ab(c, v, factors, 0), shape[0],
                            precision=prec)
        errs["kron_segsum"] = max(errs["kron_segsum"], check_gather(
            f"hub {prec}: {int((rows == shape[0] // 3).sum())} of {E_hub} "
            "elements in one row", rows, c, v, factors, 0, shape[0], prec,
            z_row))
    del ch, rows, c, v, z_row

    E_hub, R_hub, share = HUB
    rows = torch.randint(0, R_hub, (E_hub,), device=dev, generator=g)
    rows[torch.rand(E_hub, device=dev, generator=g) < share] = R_hub // 3
    rows = torch.sort(rows).values.to(torch.int32)
    a = torch.randn((E_hub, 10), device=dev, generator=g)
    b = torch.randn((E_hub, 10), device=dev, generator=g)
    got = kron_segsum(rows, a, b, R_hub)
    again = kron_segsum(rows, a, b, R_hub)
    want = ref.kron_segsum_ref(rows, a, b, R_hub)
    hub = int((rows == R_hub // 3).sum())
    errs["kron_segsum"] = max(errs["kron_segsum"], check(
        f"hub: {hub} of {E_hub} elements in one row", got, want, again))
    del rows, a, b, got, again, want

    log(f"oracle_pair vs plain on the main path's Z, tolerance {TOL} x "
        "max|plain|")
    mode = int(np.argmax(shape))
    Z = ops.penultimate(coords, values, factors, mode, shape[mode])
    R, K = Z.shape
    for s in (1, 8, SKETCH_PANEL):
        xs, ys = ((K,), (R,)) if s == 1 else ((K, s), (R, s))
        x = torch.randn(xs, device=dev, generator=g)
        y = torch.randn(ys, device=dev, generator=g)
        gx, gy = oracle_pair(Z, x, y)
        ax, ay = oracle_pair(Z, x, y)
        wx, wy = ref.oracle_pair_ref(Z, x, y)
        hx = oracle_pair(Z, x, None)[0]
        hy = oracle_pair(Z, None, y)[1]
        errs["oracle_pair"] = max(
            errs["oracle_pair"],
            check(f"Z@x   Z={R}x{K} s={s}", gx, wx, ax),
            check(f"Z^T@y Z={R}x{K} s={s}", gy, wy, ay),
            check(f"Z@x   alone s={s}", hx, wx, oracle_pair(Z, x, None)[0]),
            check(f"Z^T@y alone s={s}", hy, wy, oracle_pair(Z, None, y)[1]))
    torch.cuda.empty_cache()
    return errs


def invocations_now(label: str) -> int:
    """INVOCATIONS, or 1 once the run is past CUT_INVOCATIONS_AFTER_S."""
    elapsed = time.perf_counter() - T_START
    if elapsed > CUT_INVOCATIONS_AFTER_S:
        log(f"CUT: {elapsed:.0f} s used before {label}; invocations "
            f"{INVOCATIONS} -> 1, shape unchanged")
        return 1
    return INVOCATIONS


def z_passes_per_mode(shape, warm: str) -> list[int]:
    """Counted Z passes per mode of one single-process sweep at CORE with
    ``use_fused_oracle`` and no block or fused build: the knobs as ``hooi``
    settles them, counted by ``engine.oracle.count_z_passes``."""
    from repro_torch.core.sketch import DEFAULT_POWER_ITERS
    from repro_torch.engine.oracle import ModeSpec, count_z_passes, mode_spec

    out = []
    for n, L in enumerate(shape):
        khat = int(np.prod([CORE[j] for j in range(len(CORE)) if j != n]))
        sp = mode_spec(ModeSpec(warm_start=warm), CORE[n], L, khat)
        out.append(count_z_passes(sp.niter, warm_start=sp.warm_start,
                                  power_iters=DEFAULT_POWER_ITERS
                                  if sp.warm_start == "sketch" else 0))
    return out


def run_single(t, label: str, invocations: int, fits_ok=None, core=CORE,
               **kw) -> dict:
    """``hooi`` on the card at ``core`` with ``use_fused_oracle=True`` and
    ``kw``, every kernel's launches read around it; logs fits, launches
    per sweep, sweep seconds and peak memory."""
    import torch
    from repro_torch.core.hooi import hooi

    sweeps = []

    def on_sweep(it, seconds, fit):
        sweeps.append(seconds)
        log(f"  {label} sweep {it}: {seconds:.3f} s (mode steps), "
            f"fit={fit:.6f}")

    metrics: dict = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    dec, fits = hooi(t, core, n_invocations=invocations, seed=0,
                     use_fused_oracle=True, on_sweep=on_sweep,
                     metrics_out=metrics, device=DEVICE, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(sweeps[1:] or sweeps))
    per_sweep = {k: v / invocations for k, v in launches.items()}
    log(f"{label}: nnz={t.nnz} invocations={invocations} wall={wall:.3f} s "
        f"fits={fits} launches={launches} per sweep {per_sweep} "
        f"steady_s_per_sweep={steady:.4f} "
        f"max_memory_allocated={peak / 2**30:.3f} GiB"
        + (f" metrics={metrics}" if metrics else ""))
    (fits_ok or check_fits)(fits, label)
    for name in ("kron_segsum", "oracle_pair"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on {label}")
    for n, F in enumerate(dec.factors):
        if tuple(F.shape) != (t.shape[n], core[n]) or \
                not bool(torch.isfinite(F).all()):
            raise AssertionError(f"{label} factor {n} bad: "
                                 f"{tuple(F.shape)}")
    return {"launches": launches, "fits": fits, "sweeps": sweeps,
            "invocations": invocations, "peak_bytes": peak, "wall_s": wall,
            "steady_s": steady, "metrics": metrics,
            "factor_min": min(float(F.min()) for F in dec.factors)}


def phase_main_path(t) -> dict:
    return run_single(t, "single-process path", invocations_now(
        "the single-process path"))


def phase_small_checks() -> None:
    from repro_torch.core.coo import SparseTensor
    from repro_torch.core.hooi import hooi
    from repro_torch.data.tensors import synth_tensor

    r = np.random.default_rng(3)  # the repo's low-rank test recipe
    G = r.standard_normal((2, 2, 2))
    A = [r.standard_normal((L, 2)) for L in (12, 10, 8)]
    dense = np.einsum("abc,ia,jb,kc->ijk", G, A[0], A[1], A[2])
    low = SparseTensor.fromdense(dense.astype(np.float32))
    _, fits = hooi(low, (2, 2, 2), n_invocations=3, seed=0,
                   use_fused_oracle=True, device=DEVICE)
    log(f"lowrank recipe on the card: fits={fits}")
    if not fits[-1] > 0.99:
        raise AssertionError(f"low-rank fit {fits[-1]} <= 0.99")

    t = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9), seed=3)
    _, fits_gpu = hooi(t, (5, 5, 5), n_invocations=3, seed=2,
                       use_fused_oracle=True, device=DEVICE)
    _, fits_cpu = hooi(t, (5, 5, 5), n_invocations=3, seed=2,
                       use_fused_oracle=True, device="cpu")
    diff = float(np.max(np.abs(np.subtract(fits_gpu, fits_cpu))))
    log(f"small tensor card vs CPU plain path: fits {fits_gpu} vs "
        f"{fits_cpu}, max diff {diff:.2e} (tolerance 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"card and CPU fits differ by {diff}")


def phase_sketch(t, default: dict) -> dict:
    """The sketch warm start on the single-process path at full width:
    ``"sketch"``, then ``"auto"`` (sketch for every mode at these widths),
    each beside the default run (phase 4)."""
    base = z_passes_per_mode(t.shape, "none")
    out = {}
    for warm in ("sketch", "auto"):
        label = f"hooi warm_start={warm}"
        run = run_single(t, label, invocations_now(label), warm_start=warm)
        passes = z_passes_per_mode(t.shape, warm)
        n = min(len(run["fits"]), len(default["fits"]))
        gap = [run["fits"][i] - default["fits"][i] for i in range(n)]
        pairs = [r["launches"]["oracle_pair"] / r["invocations"]
                 for r in (run, default)]
        log(f"{label}: counted Z passes per sweep {sum(passes)} {passes} "
            f"against {sum(base)} {base} (default); oracle_pair launches per "
            f"sweep {pairs[0]:g} against {pairs[1]:g}; "
            f"steady s per sweep {run['steady_s']:.4f} against "
            f"{default['steady_s']:.4f}; fit minus the default's per sweep "
            f"{gap}; peak {run['peak_bytes'] / 2**30:.3f} GiB against "
            f"{default['peak_bytes'] / 2**30:.3f} GiB")
        out[warm] = run
    return out


def check_unit_fits(fits, what: str) -> None:
    """Finite fits in [0, 1]; the NN objective's trajectory need not rise."""
    if not all(np.isfinite(fits)) or not all(0.0 <= f <= 1.0 for f in fits):
        raise AssertionError(f"{what}: fits not finite in [0, 1]: {fits}")


def phase_objectives(t) -> dict:
    """Completion (held-out RMSE per sweep) and NN (factors exactly
    nonnegative) on the single-process path at full width."""
    from repro_torch.engine.objective import CompletionObjective

    label = "hooi objective=completion(0.2)"
    comp = run_single(t, label, invocations_now(label),
                      objective=CompletionObjective(holdout_fraction=0.2))
    rmse = comp["metrics"].get("holdout_rmse", [])
    if len(rmse) != comp["invocations"] or not all(np.isfinite(rmse)):
        raise AssertionError(f"{label}: held-out RMSE {rmse}")
    log(f"{label}: held-out RMSE per sweep {rmse}")
    label = "hooi objective=nn"
    nn = run_single(t, label, invocations_now(label), fits_ok=check_unit_fits,
                    objective="nn")
    if nn["factor_min"] < 0.0:
        raise AssertionError(f"{label}: a factor entry is negative "
                             f"({nn['factor_min']})")
    log(f"{label}: smallest factor entry {nn['factor_min']} (>= 0)")
    return {"completion": comp, "nn": nn}


def phase_objective_matrix() -> None:
    """Every objective × warm start on a small tensor, on the card against
    the port's CPU path: single process and P = 4 on both backends."""
    from repro_torch.core.hooi import hooi
    from repro_torch.data.tensors import synth_tensor
    from repro_torch.distributed.dist_hooi import dist_hooi

    shape, nnz, core = DIST_SMALL
    t = synth_tensor(shape, nnz, alphas=(1.1, 1.0, 0.9), seed=3)
    worst = {"fit": 0.0, "rmse": 0.0}

    def compare(label, fits_g, fits_c, m_g, m_c):
        diff = float(np.max(np.abs(np.subtract(fits_g, fits_c))))
        r = float(np.max(np.abs(np.subtract(m_g.get("holdout_rmse", [0]),
                                            m_c.get("holdout_rmse", [0])))))
        worst["fit"], worst["rmse"] = max(worst["fit"], diff), \
            max(worst["rmse"], r)
        if not (diff <= 1e-4 and r <= 1e-5):
            raise AssertionError(f"{label}: card and CPU differ: fits by "
                                 f"{diff}, held-out RMSE by {r}")

    for objective in ("tucker", "completion", "nn"):
        for warm in ("none", "sketch", "auto"):
            kw = dict(n_invocations=2, seed=2, use_fused_oracle=True,
                      warm_start=warm, objective=objective)
            m_g, m_c = {}, {}
            _, fg = hooi(t, core, metrics_out=m_g, device=DEVICE, **kw)
            _, fc = hooi(t, core, metrics_out=m_c, device="cpu", **kw)
            compare(f"small hooi {objective} {warm}", fg, fc, m_g, m_c)
            for path in ("liteopt", "baseline"):
                dkw = dict(kw, path=path, lanczos_block=DIST_BLOCK,
                           fused_zbuild=True)
                _, sg = dist_hooi(t, core, DIST_P, device=DEVICE, **dkw)
                _, sc = dist_hooi(t, core, DIST_P, device="cpu", **dkw)
                compare(f"small dist_hooi {path} {objective} {warm}",
                        sg.fits, sc.fits, sg.objective_metrics or {},
                        sc.objective_metrics or {})
    log(f"objective x warm start on {shape} ({nnz} drawn), card against "
        f"CPU, single process and P={DIST_P} on both backends: largest fit "
        f"difference {worst['fit']:.2e} (tolerance 1e-4), largest held-out "
        f"RMSE difference {worst['rmse']:.2e} (tolerance 1e-5)")


def phase_profile(t, **kw) -> None:
    """Device time by kernel over one invocation of the single-process path
    (with ``kw``: set-up, one sweep, core and fit), and the share of the
    wall time the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.hooi import hooi

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hooi(t, CORE, n_invocations=1, seed=0, use_fused_oracle=True,
             device=DEVICE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = profile_rows(prof)
    busy = sum(r[0] for r in rows)
    args = "".join(f", {k}={v!r}" for k, v in kw.items())
    log(f"profile of hooi(n_invocations=1{args}): "
        f"wall {wall * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (wall * 1e3):.1f}%)")
    for ms, count, key in rows[:14]:
        log(f"  {ms:9.3f} ms {count:5d}x  {key[:90]}")


def phase_timings(coords, values, factors, shape) -> dict:
    """Each kernel at the single-process path's shapes: the gather form
    against its bound and against what the path paid before (``_split_ab``
    plus the row form); ``oracle_pair`` per main-path call (one product) as
    call time back to back and as device time, beside one ``torch.matmul``."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.kron_segsum import kron_segsum
    from repro_torch.kernels.oracle_fused import oracle_pair

    out = {"kron_segsum": [], "oracle_pair": [], "oracle_pair_s10": [],
           "kron_segsum_oracle_s14": []}
    dev = coords.device
    g = torch.Generator(device=dev).manual_seed(7)
    for mode in range(len(shape)):
        rows, c, v = sorted_elements(coords, values, mode)
        R = shape[mode]
        E = int(rows.shape[0])
        Ka, Kb = ops.split_kron_dims([f.shape[1] for f in factors], mode)

        def gather():
            return ops.penultimate_sorted(c, v, rows, factors, mode, R)

        def split_row():
            return kron_segsum(rows, *ops._split_ab(c, v, factors, mode), R)

        split_ms = cuda_ms(split_row, reps=3)
        ms = cuda_ms(gather, reps=5)
        ms2 = cuda_ms(gather, reps=5)
        split_ms2 = cuda_ms(split_row, reps=3)
        a, b = ops._split_ab(c, v, factors, mode)
        row_ms = cuda_ms(lambda: kron_segsum(rows, a, b, R), reps=5)
        plain = cuda_ms(lambda: ref.kron_segsum_ref(rows, a, b, R), reps=2)
        bound, by = gather_bound_ms(E, len(shape), Ka, Kb, R,
                                    factor_rows_read(factors, mode))
        row_bound, _ = kron_bound_ms(E, Ka, Kb, R)
        log(f"kron_segsum mode {mode}: E={E} K={Ka * Kb} rows={R} gather "
            f"ms={ms:.4f}/{ms2:.4f} bound_ms={bound:.4f} ({by}); before: "
            f"_split_ab+row form ms={split_ms:.4f}/{split_ms2:.4f}, row "
            f"form alone ms={row_ms:.4f} (bound {row_bound:.4f}); "
            f"plain_ms={plain:.4f}")
        out["kron_segsum"].append(dict(
            ms=(ms + ms2) / 2, plain=plain, bound=bound, by=by,
            row_ms=row_ms, row_bound=row_bound,
            split_row_ms=(split_ms + split_ms2) / 2))

        # range_finder's (Z, Z·Ω) at s = k + oversample, gather form
        X14 = torch.randn((Ka * Kb, RANGE_PANEL), device=dev, generator=g)
        ms14 = cuda_ms(lambda: ops.penultimate_sorted_oracle(
            c, v, rows, factors, mode, R, X14), reps=5)
        plain14 = cuda_ms(lambda: ref.kron_segsum_oracle_ref(rows, a, b, R,
                                                             X14), reps=2)
        nonempty = int(torch.unique_consecutive(rows).numel())
        bound14, by14 = fused_gather_bound_ms(
            E, len(shape), Ka, Kb, R, factor_rows_read(factors, mode),
            nonempty, RANGE_PANEL)
        log(f"kron_segsum_oracle mode {mode} at s={RANGE_PANEL} "
            f"(range_finder, single-process shapes): gather ms={ms14:.4f} "
            f"bound_ms={bound14:.4f} ({by14}) plain_ms={plain14:.4f}; "
            f"kron_segsum alone ms={(ms + ms2) / 2:.4f}")
        out["kron_segsum_oracle_s14"].append(dict(
            ms=ms14, plain=plain14, bound=bound14, by=by14))
        del rows, c, v, a, b
        torch.cuda.empty_cache()

        Z = ops.penultimate(coords, values, factors, mode, R)
        K = Z.shape[1]
        x = torch.randn((K,), device=dev, generator=g)
        y = torch.randn((R,), device=dev, generator=g)

        # per call, over the main path's two calls (Z @ x, then Zᵀ @ y)
        def pair():
            oracle_pair(Z, x, None)
            oracle_pair(Z, None, y)

        def lib_pair():
            torch.matmul(Z, x)
            torch.matmul(y, Z)

        ms = cuda_ms(pair, reps=100, warmup=3) / 2
        dev_ms = device_ms(pair, reps=100, match="oracle_kernel",
                           per_call=2) / 2
        zx_dev = device_ms(lambda: oracle_pair(Z, x, None), reps=100,
                           match="oracle_kernel")
        zty_dev = device_ms(lambda: oracle_pair(Z, None, y), reps=100,
                            match="oracle_kernel")
        lib_zx = device_ms(lambda: torch.matmul(Z, x), reps=100)
        lib_zty = device_ms(lambda: torch.matmul(y, Z), reps=100)
        plain = cuda_ms(lambda: (ref.oracle_pair_ref(Z, x, None),
                                 ref.oracle_pair_ref(Z, None, y)),
                        reps=100, warmup=3) / 2
        lib = cuda_ms(lib_pair, reps=100, warmup=3) / 2
        lib_dev = device_ms(lib_pair, reps=100) / 2
        bound, by = oracle_half_bound_ms(R, K, 1)
        log(f"  clocks after the oracle_pair timings (sm, max sm, power): "
            f"{clocks_line()}")
        log(f"oracle_pair mode {mode}: Z={R}x{K} s=1 one half per call "
            f"ms={ms:.4f} device_ms={dev_ms:.4f} (Z@x {zx_dev:.4f}, Z^T@y "
            f"{zty_dev:.4f}) plain_ms={plain:.4f} library_ms={lib:.4f} "
            f"library_device_ms={lib_dev:.4f} (Z@x {lib_zx:.4f}, y@Z "
            f"{lib_zty:.4f}) bound_ms={bound:.4f} ({by})")
        out["oracle_pair"].append(dict(ms=ms, device_ms=dev_ms, plain=plain,
                                       bound=bound, by=by, lib=lib,
                                       lib_device_ms=lib_dev,
                                       zx_device_ms=zx_dev,
                                       zty_device_ms=zty_dev))

        # the sketch panel: seed, power iteration and block driver products
        xp = torch.randn((K, SKETCH_PANEL), device=dev, generator=g)
        yp = torch.randn((R, SKETCH_PANEL), device=dev, generator=g)

        def pair_p():
            oracle_pair(Z, xp, None)
            oracle_pair(Z, None, yp)

        def lib_p():
            torch.matmul(Z, xp)
            torch.matmul(Z.T, yp)

        ms = cuda_ms(pair_p, reps=100, warmup=3) / 2
        dev_ms = device_ms(pair_p, reps=100, match="oracle_kernel",
                           per_call=2) / 2
        zx_dev = device_ms(lambda: oracle_pair(Z, xp, None), reps=100,
                           match="oracle_kernel")
        zty_dev = device_ms(lambda: oracle_pair(Z, None, yp), reps=100,
                            match="oracle_kernel")
        plain = cuda_ms(lambda: (ref.oracle_pair_ref(Z, xp, None),
                                 ref.oracle_pair_ref(Z, None, yp)),
                        reps=100, warmup=3) / 2
        lib = cuda_ms(lib_p, reps=100, warmup=3) / 2
        lib_dev = device_ms(lib_p, reps=100) / 2
        bound, by = oracle_half_bound_ms(R, K, SKETCH_PANEL)
        log(f"oracle_pair mode {mode}: Z={R}x{K} s={SKETCH_PANEL} one half "
            f"per call ms={ms:.4f} device_ms={dev_ms:.4f} (Z@X "
            f"{zx_dev:.4f}, Z^T@Y {zty_dev:.4f}) plain_ms={plain:.4f} "
            f"library_ms={lib:.4f} library_device_ms={lib_dev:.4f} "
            f"bound_ms={bound:.4f} ({by})")
        out["oracle_pair_s10"].append(dict(
            ms=ms, device_ms=dev_ms, plain=plain, bound=bound, by=by,
            lib=lib, lib_device_ms=lib_dev, zx_device_ms=zx_dev,
            zty_device_ms=zty_dev))
        del Z
    return out


def check_fused(name: str, got, again, want, z_kron) -> float:
    """kron_segsum_oracle's (Z, ZX) against the plain version; reruns
    bitwise equal, Z bitwise equal to kron_segsum's."""
    import torch

    err = max(check(f"{name} Z", got[0], want[0], again[0]),
              check(f"{name} ZX", got[1], want[1], again[1]))
    if not torch.equal(got[0], z_kron):
        raise AssertionError(f"{name}: Z differs from kron_segsum's")
    return err


def phase_fused_checks(coords, values, factors, shape) -> float:
    import torch
    from repro_torch.convert import device_coords
    from repro_torch.core import hooi
    from repro_torch.data.tensors import synth_tensor
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.kron_segsum import kron_segsum, kron_segsum_oracle
    from repro_torch.random import make_key

    dev = coords.device
    g = torch.Generator(device=dev).manual_seed(11)
    E = min(CHECK_ELEMENTS, coords.shape[0])
    err = 0.0
    log(f"kron_segsum_oracle vs plain on the first {E} elements, panels "
        f"s={FUSED_PANELS}, tolerance {TOL} x max|plain|; Z must equal "
        "kron_segsum's bit for bit")
    for mode in range(len(shape)):
        rows, c, v = sorted_elements(coords[:E], values[:E], mode)
        a, b = ops._split_ab(c, v, factors, mode)
        K = a.shape[1] * b.shape[1]
        for prec in ("f32", "bf16"):
            z_kron = kron_segsum(rows, a, b, shape[mode], precision=prec)
            for s in FUSED_PANELS:
                X = torch.randn((K, s), device=dev, generator=g)
                got = kron_segsum_oracle(rows, a, b, shape[mode], X,
                                         precision=prec)
                err = max(err, check_fused(
                    f"mode {mode} {prec} s={s}", got,
                    kron_segsum_oracle(rows, a, b, shape[mode], X,
                                       precision=prec),
                    ref.kron_segsum_oracle_ref(rows, a, b, shape[mode], X,
                                               prec), z_kron))
                if s in (DIST_BLOCK, RANGE_PANEL):
                    err = max(err, check_gather(
                        f"oracle mode {mode} {prec} s={s}", rows, c, v,
                        factors, mode, shape[mode], prec, got[0], X, got[1]))
                del got
            del z_kron
        del rows, c, v, a, b

    t4 = synth_tensor(FOUR_MODE[0], FOUR_MODE[1], alphas=1.0, seed=1)
    c4, v4 = device_coords(t4, dev)
    f4 = hooi.random_factors(t4.shape, (10, 10, 10, 10), make_key(4), dev)
    rows, c, v = sorted_elements(c4, v4, 0)
    a, b = ops._split_ab(c, v, f4, 0)
    X = torch.randn((a.shape[1] * b.shape[1], 8), device=dev, generator=g)
    err = max(err, check_fused(
        f"4-mode K={a.shape[1] * b.shape[1]} s=8",
        kron_segsum_oracle(rows, a, b, t4.shape[0], X),
        kron_segsum_oracle(rows, a, b, t4.shape[0], X),
        ref.kron_segsum_oracle_ref(rows, a, b, t4.shape[0], X),
        kron_segsum(rows, a, b, t4.shape[0])))
    del rows, c, v, a, b, c4, v4

    E_hub, R_hub, share = HUB
    rows = torch.randint(0, R_hub, (E_hub,), device=dev, generator=g)
    rows[torch.rand(E_hub, device=dev, generator=g) < share] = R_hub // 3
    rows = torch.sort(rows).values.to(torch.int32)
    a = torch.randn((E_hub, 10), device=dev, generator=g)
    b = torch.randn((E_hub, 10), device=dev, generator=g)
    X = torch.randn((100, 8), device=dev, generator=g)
    for prec in ("f32", "bf16"):
        err = max(err, check_fused(
            f"hub {prec} s=8",
            kron_segsum_oracle(rows, a, b, R_hub, X, precision=prec),
            kron_segsum_oracle(rows, a, b, R_hub, X, precision=prec),
            ref.kron_segsum_oracle_ref(rows, a, b, R_hub, X, prec),
            kron_segsum(rows, a, b, R_hub, precision=prec)))
    torch.cuda.empty_cache()
    return err


def launch_counts() -> dict:
    from repro_torch.kernels.kron_segsum import kron_segsum, kron_segsum_oracle
    from repro_torch.kernels.oracle_fused import oracle_pair

    return {"kron_segsum": kron_segsum.launches,
            "kron_segsum_oracle": kron_segsum_oracle.launches,
            "oracle_pair": oracle_pair.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels.kron_segsum import kron_segsum, kron_segsum_oracle
    from repro_torch.kernels.oracle_fused import oracle_pair

    kron_segsum.launches = kron_segsum_oracle.launches = 0
    oracle_pair.launches = 0


def check_fits(fits, what: str) -> None:
    if not all(np.isfinite(fits)) or not all(0.0 <= f <= 1.0 for f in fits):
        raise AssertionError(f"{what}: fits not finite in [0, 1]: {fits}")
    if any(b < a - 1e-3 for a, b in zip(fits, fits[1:])):
        raise AssertionError(f"{what}: fits decrease by more than 1e-3: "
                             f"{fits}")


def dist_kwargs() -> dict:
    return dict(lanczos_block=DIST_BLOCK, fused_zbuild=True,
                use_fused_oracle=True, seed=0, device=DEVICE)


def launch_census(prof) -> dict:
    """Host-side launches in a profile: graph replays, kernel launches and
    copies, by the runtime calls that issue them."""
    out = {"graph_launches": 0, "kernel_launches": 0, "copies": 0}
    for e in prof.key_averages():
        name = e.key
        if name.startswith("cudaGraphLaunch"):
            out["graph_launches"] += e.count
        elif name.startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            out["kernel_launches"] += e.count
        elif name.startswith("cudaMemcpy"):
            out["copies"] += e.count
    return out


def dist_run(t, pl, path: str, label: str, core=CORE, **kw):
    """One ``dist_hooi`` call on the shared executor at ``core``, launch
    counts and peak memory read around it; returns (dec, stats, record),
    the record with the final core's energy share."""
    import torch
    from repro_torch.distributed.dist_hooi import dist_hooi

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    args = dict(dist_kwargs(), **kw)
    dec, st = dist_hooi(t, core, DIST_P, scheme=pl, path=path,
                        n_invocations=DIST_INVOCATIONS, **args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = st.sweep_s[1:] or st.sweep_s
    log(f"dist_hooi {label} path={path} backends={st.comm_backends}: "
        f"wall={wall:.3f} s setup_s={st.setup_s:.4f} "
        f"sweeps={[round(x, 4) for x in st.sweep_s]} "
        f"steady_s_per_sweep={float(np.mean(steady)):.4f} "
        f"fits={st.fits} step_compilations={st.step_compilations} "
        f"step_captures={st.step_captures} "
        f"graph_replays={st.graph_replays} "
        f"step_cache_hits={st.step_cache_hits} uploads={st.uploads} "
        f"upload_cache_hit={st.upload_cache_hit} "
        f"partition_build_s={st.partition_build_s:.3f} "
        f"z_passes={st.z_passes} lanczos_block={st.lanczos_block} "
        f"launches={launches} max_memory_allocated={peak / 2**30:.3f} GiB")
    check_fits(st.fits, f"dist_hooi {label}")
    if st.step_captures + st.graph_replays != len(core) * DIST_INVOCATIONS:
        raise AssertionError(f"{label}: {st.step_captures} captures and "
                             f"{st.graph_replays} replays, not one a step")
    # a capture's eager warm-up launches every kernel of the step; a run
    # that only replays launches none from the wrappers, and the profiled
    # replay (phase_dist_profile) shows the recorded kernels running
    for name, n in launches.items():
        if n <= 0 and st.step_captures and (
                name != "kron_segsum_oracle"
                or kw.get("warm_start") != "sketch"):
            raise AssertionError(f"{name} was not launched on the "
                                 f"distributed path ({label})")
    for n, F in enumerate(dec.factors):
        if tuple(F.shape) != (t.shape[n], core[n]) or \
                not bool(torch.isfinite(F).all()):
            raise AssertionError(f"dist factor {n} bad: {tuple(F.shape)}")
    return dec, st, {"stats": st, "launches": launches, "peak_bytes": peak,
                     "wall_s": wall, "steady_s": float(np.mean(steady)),
                     "core_share": core_share(t, dec.core)}


def phase_dist(t) -> dict:
    """The distributed main path on both comm backends, through captured
    steps on the shared executor. On boundary: run 1 captures its three
    steps and uploads the plan; ``stage_upload`` then finds it resident;
    run 2 (another seed) captures and uploads nothing and replays every
    step. Then psum on the same resident plan."""
    from repro_torch.core.plan import plan
    from repro_torch.distributed.dist_hooi import shared_executor

    t0 = time.perf_counter()
    pl = plan(t, "lite", DIST_P, core_dims=CORE, path="auto")
    build_s = time.perf_counter() - t0
    log(f"dist plan: lite, P={DIST_P}, built on the host in {build_s:.1f} s; "
        f"E_pad={[mp.E_pad for mp in pl.parts]} "
        f"R_pad={[mp.R_pad for mp in pl.parts]} "
        f"Lp={[mp.Lp for mp in pl.parts]} "
        f"S_pad={[mp.S_pad for mp in pl.parts]}")
    out = {"plan": pl, "plan_build_s": build_s, "runs": {}}
    _, st1, out["runs"]["liteopt"] = dist_run(t, pl, "liteopt", "run 1")
    if st1.step_compilations != len(CORE) or st1.step_captures != len(CORE):
        raise AssertionError(f"run 1: {st1.step_compilations} compilations, "
                             f"{st1.step_captures} captures, not {len(CORE)}")
    staged = shared_executor(DIST_P).stage_upload(pl, t)
    log(f"stage_upload on the resident plan: {staged}")
    if not staged["already_resident"] or staged["uploads"]:
        raise AssertionError(f"stage_upload moved arrays again: {staged}")
    dec, st2, rec = dist_run(t, pl, "liteopt", "run 2 (captured)", seed=1)
    out["runs"]["captured"] = rec
    if (st2.step_compilations, st2.step_captures, st2.uploads) != (0, 0, 0) \
            or not st2.upload_cache_hit \
            or st2.step_cache_hits != len(CORE) * DIST_INVOCATIONS:
        raise AssertionError(
            f"run 2 on the cached plan: {st2.step_compilations} "
            f"compilations, {st2.step_captures} captures, {st2.uploads} "
            f"uploads, hit={st2.upload_cache_hit}, "
            f"{st2.step_cache_hits} step cache hits")
    log(f"replayed steps: steady sweep "
        f"{rec['steady_s']:.4f} s (run 1 {out['runs']['liteopt']['steady_s']:.4f}"
        f" s); set-up {st1.setup_s:.4f} s (run 1) -> {st2.setup_s:.4f} s "
        f"(run 2)")
    out["factors"] = dec.factors
    out["fit"] = st2.fits[-1]
    _, st3, out["runs"]["baseline"] = dist_run(t, pl, "baseline", "psum")
    if st3.uploads or not st3.upload_cache_hit:
        raise AssertionError("psum run uploaded the plan again")
    return out


def eager_and_cached_steps(ex, t, pl, path: str, warm_start: str) -> list:
    """Per mode of ``pl`` at the distributed knobs: the step's arrays, an
    uncached step built with ``make_mode_step_fn`` and a call of the
    executor's cached step (captured on its first call), each
    ``fn(arrs, factors, key) -> (F, S)``."""
    from repro_torch.distributed.executor import _tally, step_spec
    from repro_torch.engine.oracle import ModeSpec
    from repro_torch.engine.steps import make_mode_step_fn

    specs = ex._mode_specs(pl, CORE, path, ModeSpec(
        block_size=DIST_BLOCK, fused_zbuild=True, warm_start=warm_start,
        use_fused=True))
    up = ex._get_upload(pl, t, _tally())
    out = []
    for mp, sp in zip(pl.parts, specs):
        skey, step = ex._get_step(mp, sp)

        def cached(arrs, factors, key, skey=skey, step=step):
            return ex._call_step(skey, step, up, arrs, factors, key,
                                 _tally())

        out.append((up.arrs[mp.mode], make_mode_step_fn(step_spec(mp, sp)),
                    cached))
    return out


def phase_capture_bitwise(t, pl) -> None:
    """Each mode step of the cached plan in three configurations
    (``fused_block8`` on boundary and on psum, and the sketch warm start):
    the uncached step once eagerly, then the executor's cached step twice
    (captured or replayed) on the same inputs; F and S bitwise equal."""
    import torch
    from repro_torch.core.hooi import random_factors
    from repro_torch.distributed.dist_hooi import shared_executor
    from repro_torch.random import make_key

    ex = shared_executor(DIST_P)
    factors = random_factors(t.shape, CORE, make_key(21), DEVICE)
    for label, path, warm_start in (
            ("fused_block8 boundary", "liteopt", "none"),
            ("fused_block8 psum", "baseline", "none"),
            ("sketch", "auto", "sketch")):
        steps = eager_and_cached_steps(ex, t, pl, path, warm_start)
        for n, (arrs, eager, cached) in enumerate(steps):
            key = make_key(22).fold_in(1000 + n)
            want = eager(arrs, factors, key)
            for call in range(2):
                got = cached(arrs, factors, key)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"captured step {label} mode {n} "
                                         f"call {call} differs from eager")
        log(f"captured == eager bitwise, {label}: 3 modes x (eager, 2 "
            f"cached calls)")
    # (backend or zbuild, mode, warm start, precision) -> segments
    segs = sorted({(k[0][0], k[0][3], k[0][14], k[0][10], len(g.segments))
                   for k, g in ex._uploads[pl].graphs.items()})
    log(f"captured steps on the plan (step, mode, warm start, precision, "
        f"segments): {segs}")


def phase_reuse_profile_and_calibration(t, pl) -> dict:
    """``profile_phases`` on the cached plan (f32, then bf16 for the bf16
    TTM rate), ``fit_cost_model`` of the executor's samples, and what
    ``precision="auto"`` picks under the fitted model (restored after)."""
    from repro_torch.core.calibrate import fit_cost_model, set_cost_model
    from repro_torch.distributed.dist_hooi import shared_executor
    from repro_torch.engine.zbuild import resolve_precision

    ex = shared_executor(DIST_P)
    kw = dict(path="liteopt", lanczos_block=DIST_BLOCK, fused_zbuild=True,
              use_fused_oracle=True, repeats=3)
    out = {}
    for prec in ("f32", "bf16"):
        prof = ex.profile_phases(t, CORE, pl, precision=prec, **kw)
        per = {n: {k: round(v, 6) for k, v in m.items()}
               for n, m in prof["per_mode"].items()}
        log(f"profile_phases {prec}: ttm_s={prof['ttm_s']:.6f} "
            f"svd_s={prof['svd_s']:.6f} full_s={prof['full_s']:.6f} "
            f"per mode {per}")
        out[prec] = prof
    samples = ex.calibration_samples()
    cm = fit_cost_model(samples)
    try:
        set_cost_model(cm)
        picked = resolve_precision("auto")
    finally:
        set_cost_model(None)
    log(f"fit_cost_model over {len(samples)} samples "
        f"({sum(1 for s in samples if s['warm'])} warm): source={cm.source} "
        f"flop_rate={cm.flop_rate:.6e} ttm_flop_rate={cm.ttm_flop_rate} "
        f"svd_flop_rate={cm.svd_flop_rate} "
        f"ttm_flop_rate_bf16={cm.ttm_flop_rate_bf16} "
        f"net_bandwidth={cm.net_bandwidth:.6e} "
        f"psum_bandwidth={cm.psum_bandwidth} "
        f"boundary_bandwidth={cm.boundary_bandwidth}; "
        f"precision='auto' picks {picked}")
    out["model"] = cm
    out["auto"] = picked
    return out


APPEND_NNZ = 613_798  # the last 1% of the nell-2-sized tensor's elements


def phase_stochastic(t, pl, factors, full_fit: float) -> dict:
    """The stochastic-refine rung at full width: the snapshot with its
    last 1% as the append, three chained refines (``step_index`` 0, 1, 2)
    from the factors of the distributed run, then refine 0 again (nothing
    captured or moved, the same bits), and a small tensor on the card
    against the CPU."""
    import torch
    from repro_torch.core.stochastic import next_pow2
    from repro_torch.data.tensors import synth_tensor
    from repro_torch.distributed.dist_hooi import shared_executor
    from repro_torch.distributed.executor import HooiExecutor

    ex = shared_executor(DIST_P)
    kw = dict(covered_nnz=t.nnz - APPEND_NNZ, sample_fraction=0.25,
              sample_seed=7, replay_nnz=1024, seed=0)
    out = {"refines": []}
    carried = factors
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in range(3):
        reset_launch_counts()
        t0 = time.perf_counter()
        dec, st = ex.run_stochastic(t, CORE, pl, init_factors=carried,
                                    step_index=k, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        padded = next_pow2(st.sample_nnz + st.replay_nnz)
        log(f"refine step_index={k}: {wall:.4f} s (setup_s "
            f"{st.setup_s:.4f}, sweep {st.sweep_s}) sample_nnz="
            f"{st.sample_nnz} replay_nnz={st.replay_nnz} padded minibatch "
            f"{padded} eta={st.step_size} fits={st.fits} delta from the "
            f"full run {st.fits[-1] - full_fit:+.3e} "
            f"step_compilations={st.step_compilations} "
            f"step_captures={st.step_captures} uploads={st.uploads} "
            f"launches={launches}")
        check_fits(st.fits, f"refine {k}")
        if launches["kron_segsum"] <= 0:
            raise AssertionError("kron_segsum was not launched on the "
                                 "stochastic rung")
        out["refines"].append({"stats": st, "wall_s": wall,
                               "launches": launches, "padded": padded})
        if k == 0:
            first = (dec, st)
        carried = dec.factors
    peak = torch.cuda.max_memory_allocated()
    dec0, st0 = first
    dec, st = ex.run_stochastic(t, CORE, pl, init_factors=factors,
                                step_index=0, **kw)
    same = st.fits == st0.fits and all(
        torch.equal(a, b) for a, b in zip(dec.factors, dec0.factors))
    log(f"refine 0 again: step_compilations={st.step_compilations} "
        f"step_captures={st.step_captures} uploads={st.uploads} fits "
        f"{st.fits} bitwise equal={same}; peak over the refines "
        f"{peak / 2**30:.3f} GiB")
    if (st.step_compilations, st.step_captures, st.uploads) != (0, 0, 0) \
            or not same:
        raise AssertionError("the refine rerun is not 0/0 and bitwise")
    out["peak_bytes"] = peak
    from torch.profiler import ProfilerActivity, profile

    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = ex.run_stochastic(t, CORE, pl, init_factors=factors,
                                  step_index=0, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out["replayed"] = {"launches": launch_counts(),
                       "executions": kernel_executions(prof)}
    log(f"cached refine: graph_replays={st.graph_replays}; wrapper "
        f"launches {out['replayed']['launches']}; kernel executions on the "
        f"card (profiler) {out['replayed']['executions']}")
    if st.step_captures or not st.graph_replays or \
            out["replayed"]["executions"]["kron_segsum"] <= \
            out["replayed"]["launches"]["kron_segsum"]:
        raise AssertionError("the cached refine did not run kron_segsum "
                             "from its replayed steps")
    rows = profile_rows(prof)
    busy = sum(r[0] for r in rows)
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)[:8]
    log(f"profile of a cached refine: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%); host launches "
        f"{launch_census(prof)}; device: "
        + "; ".join(f"{ms:.3f} ms {c}x {k[:50]}" for ms, c, k in rows[:6])
        + "; host self time: "
        + "; ".join(f"{ms:.1f} ms {c}x {k[:40]}" for ms, c, k in host))
    from repro_torch.core.stochastic import sample_batch

    t0 = time.perf_counter()
    sample_batch(t.coords, t.values, kw["covered_nnz"], kw["sample_fraction"],
                 kw["sample_seed"], replay_nnz=kw["replay_nnz"])
    t1 = time.perf_counter()
    float(np.sum(t.values ** 2))
    t2 = time.perf_counter()
    out["norm2_s"] = t2 - t1
    log(f"host work of a refine: sample_batch {t1 - t0:.4f} s; ‖T‖² over "
        f"the snapshot's values {t2 - t1:.4f} s (fit_score computes it for "
        f"every fit: twice a refine)")
    small = synth_tensor((60, 50, 40), 20_000, alphas=(1.1, 1.0, 0.9),
                         seed=3)
    from repro_torch.core.hooi import random_factors
    from repro_torch.core.plan import plan
    from repro_torch.random import make_key

    spl = plan(small, "lite", DIST_P, core_dims=(5, 5, 5))
    init = random_factors(small.shape, (5, 5, 5), make_key(4), "cpu")
    skw = dict(init_factors=init, covered_nnz=small.nnz - small.nnz // 100,
               sample_fraction=0.25, sample_seed=7, replay_nnz=256,
               n_invocations=2, seed=1)
    _, gpu = ex.run_stochastic(small, (5, 5, 5), spl, **skw)
    _, cpu = HooiExecutor(DIST_P, "cpu").run_stochastic(small, (5, 5, 5),
                                                        spl, **skw)
    diff = float(np.max(np.abs(np.subtract(gpu.fits, cpu.fits))))
    log(f"small refine card vs CPU: fits {gpu.fits} vs {cpu.fits}, max "
        f"diff {diff:.2e} (tolerance 1e-4)")
    if not diff <= 1e-4:
        raise AssertionError(f"refine card and CPU fits differ by {diff}")
    return out


# the scheduler phase: appends that walk the refresh ladder at nell-2 size
LADDER = ("plan", "reuse", "stochastic-refine", "repartition", "reuse",
          "reselect")
LADDER_DRIFT_TOL = 0.25  # StreamScheduler's default
HUB_SHARE = 0.18  # hub batch over the seed's elements (see phase_scheduler)
# the ladder's stream is seeded with every LADDER_STRIDE-th element of the
# nell-2-sized tensor (its skew and every slice kept): cut for time, so that
# the four-mode and scheme phases run at full size
LADDER_STRIDE = 2


def host_peak_rss_gib() -> float:
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def phase_scheduler(t, stoch: dict) -> dict:
    """``StreamScheduler`` on the shared executor through every rung of the
    refresh ladder, the stream seeded with every ``LADDER_STRIDE``-th
    element of the nell-2-sized tensor ``t``:

    1. ``plan``: the seed snapshot, its Lite plan built with geometric pads
       (the scheduler's default); then a direct ``ex.run`` on that plan,
       seed and knobs must give the rung's fits bitwise;
    2. ``reuse``, submitted behind rung 1 (nothing appended): 0
       compilations, captures and uploads;
    3. 1% new elements of the same skew (``synth_tensor`` at another
       seed): ``stochastic-refine`` (``sample_fraction=0.25,
       sample_seed=7, replay_nnz=1024``, as ``phase_stochastic``);
    4. value updates at 1% of the existing coordinates: with
       ``correction_every=2`` the second low-drift append takes
       ``repartition``: the scheme and every padded shape kept, so no step
       compiles; the steps are captured again over the new arrays (a
       graph is bound to the arrays it was captured over);
    5. ``reuse`` again, submitted behind rung 4;
    6. a hub batch, ``HUB_SHARE`` of the seed's elements at one
       coordinate: ``reselect``. At P = 4 a rank holding E/P elements that
       gains H more crosses 1.25x a balanced baseline only when
       H > 0.09 E; 0.18 E is clear of the tolerance.

    Launch counts are reset before each submit that waits for nothing
    ahead of it and read after the results it waited for. Then
    ``_hub_checks`` holds the kernels against their plain versions on the
    reselect plan's partitions.
    """
    import torch
    from repro_torch.data.tensors import synth_tensor
    from repro_torch.distributed.dist_hooi import shared_executor
    from repro_torch.engine.scheduler import StreamScheduler
    from repro_torch.streaming import StreamingTensor

    t0 = time.perf_counter()
    stream = StreamingTensor.from_tensor(
        t.take(np.arange(0, t.nnz, LADDER_STRIDE)), name="nell-2")
    snap = stream.snapshot()
    out = {"rungs": [], "append_s": [], "launches_by_group": [],
           "seed_append_s": time.perf_counter() - t0}
    log(f"CUT: the ladder's stream seeded with every {LADDER_STRIDE}th "
        f"element of the main tensor ({snap.nnz} of {t.nnz}) in "
        f"{out['seed_append_s']:.3f} s (append and snapshot); host peak RSS "
        f"{host_peak_rss_gib():.3f} GiB")
    ex = shared_executor(DIST_P)
    nnz = snap.nnz
    rng = np.random.default_rng(11)
    new = synth_tensor(MAIN_SHAPE, MAIN_NNZ // (100 * LADDER_STRIDE),
                       alphas=MAIN_ALPHAS, seed=1)
    updates = snap.coords[rng.integers(0, nnz, nnz // 100)]
    hub = int(HUB_SHARE * nnz)
    appends = [None, None, (new.coords, new.values),
               (updates, 0.1 * rng.standard_normal(len(updates))), None,
               (np.tile(snap.coords[0], (hub, 1)),
                rng.standard_normal(hub))]
    del snap, new, updates
    sched = StreamScheduler(
        ex, CORE, scheme="lite", path="auto", plan_seed=0,
        pad_geometric=True, n_invocations=DIST_INVOCATIONS,
        sample_fraction=0.25, sample_seed=7, replay_nnz=1024,
        correction_every=2, use_fused_oracle=True)
    try:
        pending = []
        for k, batch in enumerate(appends):
            if batch is not None:
                t0 = time.perf_counter()
                stream.append(*batch)
                out["append_s"].append(time.perf_counter() - t0)
                log(f"scheduler: appended {len(batch[0])} elements before "
                    f"submit {k + 1} in {out['append_s'][-1]:.3f} s")
            if not pending:
                torch.cuda.synchronize()
                reset_launch_counts()
            pending.append(sched.submit(stream, name="nell-2", seed=k))
            # a rung with nothing appended before it is submitted behind
            # the one before (its prepare waits for that one's), so the
            # two overlap; every other submit waits for its result first
            if k + 1 < len(appends) and appends[k + 1] is None:
                continue
            results = [fut.result() for fut in pending]
            launches = launch_counts()
            out["launches_by_group"].append(
                {"rungs": [r.seq + 1 for r in results], **launches})
            for res in results:
                out["rungs"].append(_ladder_rung(res))
            log(f"launches over rungs {[r.seq + 1 for r in results]}: "
                f"{launches}")
            pending = []
            if k == 1:
                _ladder_direct_check(ex, stream, out["rungs"][0])
    finally:
        sched.close()
    out["stats"] = sched.stats()
    decisions = [r["decision"] for r in out["rungs"]]
    st = out["stats"]
    log(f"scheduler ladder {decisions}; stats host_s={st['host_s']:.4f} "
        f"device_s={st['device_s']:.4f} wall_s={st['wall_s']:.4f} "
        f"overlap_s={st['overlap_s']:.4f} queue_wait_s="
        f"{st['queue_wait_s']:.4f} decisions={st['decisions']}; host peak "
        f"RSS {host_peak_rss_gib():.3f} GiB")
    if decisions != list(LADDER):
        raise AssertionError(f"ladder decisions {decisions}, expected "
                             f"{list(LADDER)}")
    rungs = out["rungs"]
    for r in (rungs[1], rungs[4]):
        st_ = r["stats"]
        if (st_.step_compilations, st_.step_captures, st_.uploads) != \
                (0, 0, 0) or r["plan"] is not rungs[r["seq"] - 1]["plan"]:
            raise AssertionError(
                f"reuse rung {r['seq'] + 1} moved or captured: "
                f"{st_.step_compilations} compilations, "
                f"{st_.step_captures} captures, {st_.uploads} uploads")
    rep, first = rungs[3], rungs[0]["plan"]

    def padded(pl):
        return [(mp.E_pad, mp.R_pad, mp.Lp) for mp in pl.parts]

    log(f"repartition: padded (E_pad, R_pad, Lp) {padded(rep['plan'])}, "
        f"the plan rung's {padded(first)}; "
        f"{rep['stats'].step_compilations} compilations, "
        f"{rep['stats'].step_captures} captures")
    if rep["plan"].scheme.name != first.scheme.name or \
            rep["plan"].candidates is not None or \
            padded(rep["plan"]) != padded(first) or \
            rep["stats"].step_compilations:
        raise AssertionError(
            f"repartition: scheme {rep['plan'].scheme.name}, padded "
            f"{padded(rep['plan'])} against {padded(first)}, "
            f"{rep['stats'].step_compilations} compilations")
    if not rungs[5]["drift"]["worst"] > 1 + LADDER_DRIFT_TOL:
        raise AssertionError(f"reselect at drift {rungs[5]['drift']}")
    total = {name: sum(g[name] for g in out["launches_by_group"])
             for name in ("kron_segsum", "kron_segsum_oracle",
                          "oracle_pair")}
    out["launches"] = total
    for name in ("kron_segsum", "oracle_pair"):
        if total[name] <= 0:
            raise AssertionError(f"{name} was not launched on the "
                                 "scheduler path")
    refine = rungs[2]
    cached = stoch["refines"][1:]
    log(f"stochastic refine wall: through the scheduler run_s="
        f"{refine['run_s']:.4f} s ({refine['stats'].step_captures} "
        f"captures, {refine['stats'].uploads} uploads; prepare_s "
        f"{refine['prepare_s']:.4f} s; the snapshot carries _true_norm2); "
        f"phase_stochastic's cached refines on the plain tensor "
        f"(sum(values**2) per fit) "
        + ", ".join(f"{r['wall_s']:.4f}" for r in cached)
        + f" s, its host pass over the values {stoch['norm2_s']:.4f} s")
    out["hub"] = _hub_checks(ex, rungs[5]["plan"], rungs[5]["factors"])
    # the stream and the reselect plan go on to the pool phase, the plan as
    # the bytes a router's reroute would carry (no third Lite build there)
    t0 = time.perf_counter()
    buf = io.BytesIO()
    rungs[5]["plan"].save(buf)
    out["plan_bytes"] = buf.getvalue()
    del buf
    log(f"reselect plan saved: {len(out['plan_bytes'])} bytes in "
        f"{time.perf_counter() - t0:.3f} s (uncompressed); "
        + zlib_rate(rungs[5]["plan"], len(out["plan_bytes"])))
    out["stream"] = stream
    # the ladder's plans (and with them their uploads) go now; the plan
    # cache held the repartition's and the reselect's
    for r in rungs:
        del r["plan"], r["factors"]
    from repro_torch.core.plan import plan_cache_clear

    plan_cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    return out


ZLIB_SAMPLE = 1 << 22  # elements of a plan's arrays timed under zlib


def zlib_rate(pl, total: int) -> str:
    """What a compressed ``save`` (``np.savez_compressed``, the
    reference's plan file format) would cost: zlib timed over the first ``ZLIB_SAMPLE`` padded
    elements of mode 0's arrays, scaled to the plan's ``total`` bytes."""
    mp = pl.parts[0]
    sample = {"coords": mp.coords.reshape(-1, mp.N)[:ZLIB_SAMPLE],
              "values": mp.values.reshape(-1)[:ZLIB_SAMPLE],
              "local_rows": mp.local_rows.reshape(-1)[:ZLIB_SAMPLE]}
    nbytes = sum(a.nbytes for a in sample.values())
    t0 = time.perf_counter()
    np.savez_compressed(io.BytesIO(), **sample)
    rate = nbytes / (time.perf_counter() - t0)
    return (f"zlib over {nbytes} bytes of its mode-0 arrays ran at "
            f"{rate / 1e6:.1f} MB/s, so a compressed save would take about "
            f"{total / rate:.0f} s")


def _ladder_rung(res) -> dict:
    """Log and check one scheduler result."""
    st = res.stats
    worst = None if res.drift is None else res.drift["worst"]
    log(f"scheduler rung {res.seq + 1}: decision={res.decision} "
        f"drift_worst={worst} prepare_s={res.prepare_s:.4f} "
        f"run_s={res.run_s:.4f} queue_wait_s={res.queue_wait_s:.4f} "
        f"step_compilations={st.step_compilations} "
        f"step_captures={st.step_captures} uploads={st.uploads} "
        f"graph_replays={st.graph_replays} fits={st.fits} "
        f"fit_delta={st.fit_delta} sample_nnz={st.sample_nnz} "
        f"stream_version={res.stream_version} scheme={res.plan.name} "
        f"E_pad={[mp.E_pad for mp in res.plan.parts]}")
    check_fits(st.fits, f"scheduler rung {res.seq + 1}")
    return {"seq": res.seq, "decision": res.decision, "drift": res.drift,
            "prepare_s": res.prepare_s, "run_s": res.run_s,
            "queue_wait_s": res.queue_wait_s, "stats": st, "plan": res.plan,
            "factors": res.decomposition.factors, "fits": list(st.fits)}


def _ladder_direct_check(ex, stream, first: dict) -> None:
    """A direct ``ex.run`` on the plan rung's plan, seed and knobs (the
    scheduler is idle) gives its fits bitwise."""
    snap = stream.snapshot()
    _, st = ex.run(snap, CORE, first["plan"], n_invocations=DIST_INVOCATIONS,
                   path="auto", seed=0, use_fused_oracle=True)
    log(f"direct run on the plan rung's plan: fits {st.fits} "
        f"(scheduler {first['fits']}), step_captures={st.step_captures} "
        f"uploads={st.uploads}")
    if st.fits != first["fits"]:
        raise AssertionError("the scheduler's first run is not bitwise a "
                             "direct run on the same plan and seed")


HUB_CHUNK = 1 << 20  # elements per partial sum of the plain Z (hub checks)


def _hub_checks(ex, pl, factors) -> dict:
    """The kernels at the reselect rung's shapes, on the arrays its steps
    ran over (the executor's resident upload of ``pl``: every mode's
    stacked partition, E_pad a power of two per rank, a few rows holding
    the hub batch) and the rung's factors, each rerun bitwise:

    * the gather-form ``kron_segsum`` (``penultimate_sorted``, f32, as the
      vector-Lanczos step calls it) against its plain version, summed over
      ``HUB_CHUNK``-element slices (``plain_z``);
    * ``oracle_pair`` on that Z as the vector Lanczos calls it: ``Z @ x``
      over all stacked rows and the stacked ``Zᵀ y`` (P ranks, s = 1),
      against its plain version.
    """
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.oracle_fused import oracle_pair

    up = ex._uploads[pl]
    dev = factors[0].device
    g = torch.Generator(device=dev).manual_seed(17)
    errs = {"kron_segsum": 0.0, "oracle_pair": 0.0}
    for mp, arrs in zip(pl.parts, up.zarrs):
        c, v, rows = arrs["coords"], arrs["values"], arrs["rows"]
        mode, P, R_pad = mp.mode, mp.P, mp.R_pad
        R = P * R_pad
        E = int(rows.shape[0])
        per_row = torch.bincount(rows.long(), minlength=R)
        hub_row = int(per_row.argmax())
        got = ops.penultimate_sorted(c, v, rows, factors, mode, R)
        again = ops.penultimate_sorted(c, v, rows, factors, mode, R)
        want = plain_z(rows, c, v, factors, mode, R, HUB_CHUNK)
        errs["kron_segsum"] = max(errs["kron_segsum"], check(
            f"reselect plan mode {mode}: gather kron_segsum E={E} "
            f"(P={P} x E_pad {mp.E_pad}) rows={R} K={got.shape[1]}, hub "
            f"row {hub_row} holds {int(per_row[hub_row])} elements",
            got, want, again))
        x = torch.randn(got.shape[1], device=dev, generator=g)
        y = torch.randn((P, R_pad), device=dev, generator=g)
        want_x, want_y = ref.oracle_pair_ref(got, x, y, P)
        for name, fn, w in (
                ("Z@x", lambda: oracle_pair(got, x, None)[0], want_x),
                ("stacked Z^T@y", lambda: oracle_pair(got, None, y, P)[1],
                 want_y)):
            errs["oracle_pair"] = max(errs["oracle_pair"], check(
                f"reselect plan mode {mode}: oracle_pair {name} rows={R} "
                f"K={got.shape[1]} P={P}", fn(), w, fn()))
        del got, again, want, per_row
        torch.cuda.empty_cache()
    return errs


POOL_MAX_PENDING = 4  # the bounded queue: batch may fill 0.5 x 4 = 2
POOL_DEADLINE_S = 600.0  # a generous SLO
POOL_TIGHT_S = 0.001  # an SLO no run can meet
POOL_BATCH = ((80, 70, 60), 3_000)  # the serve_pool example's one-shots
LANE_THREADS = ("sched-prepare", "sched-run")


def _pool_submit_line(label: str, res) -> dict:
    """Log one pool result (decision, lane, stage seconds, what it built
    and moved) and check its fits."""
    st = res.stats
    log(f"pool {label}: decision={res.decision} lane={st.lane} "
        f"prepare_s={res.prepare_s:.4f} run_s={res.run_s:.4f} "
        f"queue_wait_s={res.queue_wait_s:.4f} "
        f"step_compilations={st.step_compilations} "
        f"step_captures={st.step_captures} uploads={st.uploads} "
        f"graph_replays={st.graph_replays} slo_met={res.slo_met} "
        f"fits={st.fits}")
    check_fits(st.fits, f"pool {label}")
    return {"label": label, "decision": res.decision, "lane": st.lane,
            "prepare_s": res.prepare_s, "run_s": res.run_s,
            "queue_wait_s": res.queue_wait_s,
            "compilations": st.step_compilations,
            "captures": st.step_captures, "uploads": st.uploads,
            "slo_met": res.slo_met}


def _lane_threads() -> list:
    import threading

    return [th.name for th in threading.enumerate()
            if th.is_alive() and th.name.startswith(LANE_THREADS)]


def phase_pool(ladder: dict) -> dict:
    """``ExecutorPool`` and ``StreamRouter`` over every card, P = 4 ranks
    stacked on each lane's device, at nell-2 size, each check fatal:

    1. ``device_slices`` refuses one lane more than there are cards, and
       ``["cuda", "cuda:0"]`` (the same card); every lane's executor is on
       its own ``cuda:i``;
    2. the ladder's reselect plan, loaded from its saved bytes against the
       stream's snapshot (the fingerprint checked), adopted by lane 0; the
       first interactive submit is a ``reuse`` on lane 0 with 0 uploads
       (adopt staged them), its steps built and captured on the fresh
       executor; a direct ``run`` on the same plan and seed gives its fits
       bitwise (the ladder's rung started from carried factors);
    3. a sticky resubmit: lane 0, ``reuse``, 0 compilations, captures,
       uploads;
    4. admission: behind an interactive nell-2 submit in flight, the first
       small batch one-shot is admitted, the next are refused with
       ``PoolSaturated`` at once, an interactive one is still admitted;
    5. the SLO: the 1 ms deadline is missed, the generous ones met;
    6. ``drain()`` in submission order, ``stats()`` the lanes' sums,
       ``backlog_s`` back to 0, ``reroute`` on a one-lane pool refused
       (on several cards: a warm-start reroute, ``reuse``, 0 uploads);
    7. inside every lane run the current CUDA device is the lane's;
    8. after ``router.close()`` no lane thread is alive.
    """
    import torch
    from repro_torch.engine import ExecutorPool, StreamRouter, device_slices

    count = torch.cuda.device_count()
    for devs, n in ((None, count + 1), (["cuda", "cuda:0"], 2)):
        try:
            device_slices(n, DIST_P, devices=devs)
        except ValueError as e:
            log(f"device_slices({n}, {DIST_P}, devices={devs}) refused: {e}")
        else:
            raise AssertionError(f"device_slices({n}, {DIST_P}, "
                                 f"devices={devs}) was not refused")
    stream = ladder.pop("stream")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool = ExecutorPool(count, DIST_P, CORE, scheme="lite", path="auto",
                        pad_geometric=True, n_invocations=DIST_INVOCATIONS,
                        use_fused_oracle=True, workers=2)
    router = StreamRouter(pool, max_pending=POOL_MAX_PENDING)
    out = {}
    lanes_devices = [lane.executor.device for lane in pool.lanes]
    log(f"pool: {pool.n_lanes} lanes, executors on {lanes_devices}")
    if lanes_devices != [torch.device("cuda", i) for i in range(count)]:
        raise AssertionError(f"lane executors on {lanes_devices}")
    # every step a lane runs records the current device (check 7)
    seen = {i: set() for i in range(pool.n_lanes)}
    for lane in pool.lanes:
        def call_step(*a, _real=lane.executor._call_step, _i=lane.index):
            seen[_i].add(torch.cuda.current_device())
            return _real(*a)
        lane.executor._call_step = call_step
    try:
        out.update(_pool_checks(pool, router, stream, ladder, seen))
    finally:
        router.close()
        for lane in pool.lanes:
            del lane.executor._call_step
    left = _lane_threads()
    log(f"after router.close(): lane threads alive {left}")
    if left:
        raise AssertionError(f"lane threads left after close: {left}")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"pool phase peak device memory {out['peak_gib']:.3f} GiB")
    del pool, router
    return out


def _pool_checks(pool, router, stream, ladder, seen) -> dict:
    import torch
    from repro_torch.core.plan import PartitionPlan
    from repro_torch.data.tensors import synth_tensor
    from repro_torch.engine import PoolSaturated

    out = {"submits": []}
    lane0 = pool.lane(0)
    snap = stream.snapshot()
    t0 = time.perf_counter()
    pl = PartitionPlan.load(io.BytesIO(ladder.pop("plan_bytes")), snap)
    out["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    adopted = lane0.scheduler.adopt(stream, pl)
    out["adopt_s"] = time.perf_counter() - t0
    log(f"warm start: PartitionPlan.load against the {snap.nnz}-element "
        f"snapshot (fingerprint checked) {out['load_s']:.3f} s; lane 0 "
        f"adopt (stages the uploads) {out['adopt_s']:.3f} s -> {adopted}")
    if not adopted:
        raise AssertionError("lane 0 refused the ladder's reselect plan")
    futs = []

    def submit(label, src, **kw):
        fut = router.submit(src, **kw)
        futs.append((label, fut))
        return fut

    seed = 5  # the ladder's reselect rung's
    torch.cuda.synchronize()
    reset_launch_counts()
    first = submit("warm start", stream, seed=seed, priority="interactive",
                   deadline_s=POOL_DEADLINE_S).result()
    out["warm_launches"] = launch_counts()
    rec = _pool_submit_line("warm start", first)
    out["submits"].append(rec)
    log(f"launches in the warm-started run: {out['warm_launches']}")
    if (rec["decision"], rec["lane"], rec["uploads"]) != ("reuse", 0, 0) \
            or first.plan is not pl:
        raise AssertionError(f"warm start: {rec}")
    sticky = submit("sticky resubmit", stream, seed=seed + 1,
                    priority="interactive",
                    deadline_s=POOL_DEADLINE_S).result()
    rec = _pool_submit_line("sticky resubmit", sticky)
    out["submits"].append(rec)
    if (rec["decision"], rec["lane"], rec["compilations"], rec["captures"],
            rec["uploads"]) != ("reuse", 0, 0, 0, 0):
        raise AssertionError(f"sticky resubmit: {rec}")
    # admission: the batch share is 0.5 x 4 = 2 of the bounded queue
    batch = [synth_tensor(POOL_BATCH[0], POOL_BATCH[1], seed=50 + s)
             for s in range(3)]
    small = synth_tensor(POOL_BATCH[0], POOL_BATCH[1], seed=60)
    busy = submit("in flight", stream, seed=seed + 2, priority="interactive",
                  deadline_s=POOL_DEADLINE_S)
    admitted, refused = [], []
    for s, bt in enumerate(batch):
        t0 = time.perf_counter()
        try:
            submit(f"batch {s}", bt, name=f"batch-{s}", priority="batch",
                   deadline_s=POOL_DEADLINE_S)
            admitted.append(s)
        except PoolSaturated as e:
            refused.append((s, (time.perf_counter() - t0) * 1e6, str(e)))
    submit("interactive tight", small, name="tight", priority="interactive",
           deadline_s=POOL_TIGHT_S)
    in_flight = busy.done()
    for s, us, msg in refused:
        log(f"batch {s} refused in {us:.1f} us: {msg}")
    log(f"admission: batch admitted {admitted}, refused "
        f"{[s for s, _, _ in refused]}; an interactive submit admitted "
        f"behind them; the nell-2 run done by then: {in_flight}")
    if admitted != [0] or [s for s, _, _ in refused] != [1, 2] \
            or in_flight:
        raise AssertionError(f"admission: batch admitted {admitted}, "
                             f"refused {refused}, nell-2 done {in_flight}")
    out["refused_us"] = [us for _, us, _ in refused]

    drained = router.drain()
    if [id(r) for r in drained] != [id(f.result()) for _, f in futs]:
        raise AssertionError("drain() is not in submission order")
    for (label, _), res in zip(futs[2:], drained[2:]):
        out["submits"].append(_pool_submit_line(label, res))
    end = time.monotonic() + 30
    while router.pending() and time.monotonic() < end:
        time.sleep(0.01)
    st = router.stats()
    slo = [r.slo_met for r in drained]
    log(f"router.stats(): submitted={st.submitted} completed="
        f"{st.completed} failed={st.failed} slo_hit={st.slo_hit} "
        f"slo_miss={st.slo_miss} rejected={st.rejected} "
        f"rejected_by_priority={st.rejected_by_priority} rerouted="
        f"{st.rerouted} backlog_s={st.backlog_s} decisions={st.decisions} "
        f"host_s={st.host_s:.4f} device_s={st.device_s:.4f} "
        f"queue_wait_s={st.queue_wait_s:.4f}; slo_met by submit {slo}")
    if slo != [True, True, True, True, False]:
        raise AssertionError(f"slo_met {slo}")
    lanes = [lane.scheduler.stats() for lane in pool.lanes]
    for k in ("submitted", "completed", "failed", "slo_hit", "slo_miss"):
        if getattr(st, k) != sum(ls[k] for ls in lanes):
            raise AssertionError(f"router.stats().{k} is not the lanes' sum")
    if (st.submitted, st.completed, st.failed, st.slo_hit, st.slo_miss) \
            != (5, 5, 0, 4, 1) or st.rejected_by_priority != {"batch": 2}:
        raise AssertionError(f"router stats {st}")
    if any(abs(b) > 1e-12 for b in st.backlog_s):
        raise AssertionError(f"backlog_s {st.backlog_s} after the drain")
    out["stats"] = {k: getattr(st, k) for k in (
        "submitted", "completed", "failed", "slo_hit", "slo_miss",
        "rejected_by_priority", "decisions", "host_s", "device_s",
        "queue_wait_s")}
    if pool.n_lanes == 1:
        try:
            router.reroute(stream)
        except ValueError as e:
            log(f"reroute on a one-lane pool refused: {e!r}")
        else:
            raise AssertionError("reroute on a one-lane pool moved")
    else:
        lane = router.reroute(stream)
        res = router.submit(stream, seed=seed,
                            priority="interactive").result()
        rec = _pool_submit_line(f"rerouted to lane {lane}", res)
        out["submits"].append(rec)
        if (rec["decision"], rec["lane"], rec["uploads"]) != \
                ("reuse", lane, 0):
            raise AssertionError(f"reroute: {rec}")
    out["launches"] = launch_counts()
    log(f"launches over the pool phase: {out['launches']}; current devices "
        f"seen inside lane runs {seen}")
    for i, devs in seen.items():
        if devs - {i} or (i == 0 and not devs):
            raise AssertionError(f"lane {i} ran steps with current device "
                                 f"{devs}")
    for name in ("kron_segsum", "oracle_pair"):
        if out["launches"][name] <= 0:
            raise AssertionError(f"{name} was not launched on the pool path")
    # the lanes are idle: a direct run on lane 0's executor, same plan and
    # seed, after the pool path's counts were read (it skips the router)
    _, direct = lane0.executor.run(snap, CORE, pl,
                                   n_invocations=DIST_INVOCATIONS,
                                   path="auto", seed=seed,
                                   use_fused_oracle=True)
    reselect = ladder["rungs"][5]
    log(f"warm-start fits {first.stats.fits}; direct run on lane 0, same "
        f"plan and seed: {direct.fits}; the ladder's reselect rung (same "
        f"plan bytes and seed, started from the factors the ladder "
        f"carried, init_factors): {reselect['fits']}")
    if direct.fits != first.stats.fits:
        raise AssertionError("the warm-started run is not bitwise a direct "
                             "run on the same plan and seed")
    out["fits"] = {"warm_start": list(first.stats.fits),
                   "direct": list(direct.fits),
                   "ladder_reselect": reselect["fits"]}
    out["plan"], out["snap"] = pl, snap  # on to the mesh phase
    return out


# the mesh phases: P = 4 ranks over [cuda:0] * G device groups
MESH_GROUPS = (2, 4)
MESH_RUNS = (  # (label, path, knobs) beside dist_kwargs()
    ("fused_block8 psum", "baseline", {}),
    ("fused_block8 boundary", "liteopt", {}),
    ("vector boundary", "liteopt", dict(lanczos_block=1, fused_zbuild=False)),
)


def kernel_spies(seen: list):
    """Patches for ``kernels.ops``' two launch sites: each call records
    (current device, the operand's device, the current stream, whether it
    is capturing, the kernel) and goes on to the wrapper (which counts its
    launch unless it is recorded into a graph)."""
    import torch
    from repro_torch.kernels import ops

    def spy(real, kind):
        def call(*a, **k):
            name = kind if kind != "kron_segsum" or k.get("X") is None \
                else "kron_segsum_oracle"
            seen.append((torch.cuda.current_device(), a[0].device.index,
                         torch.cuda.current_stream().cuda_stream,
                         torch.cuda.is_current_stream_capturing(), name))
            return real(*a, **k)
        return call

    return [(ops, "kron_segsum_gather",
             spy(ops.kron_segsum_gather, "kron_segsum")),
            (ops, "_oracle_pair_kernel",
             spy(ops._oracle_pair_kernel, "oracle_pair"))]


def replay_timer(spent: list):
    """A patch for ``torch.cuda.CUDAGraph.replay``: each replay's host
    seconds (the ``cudaGraphLaunch`` call) appended to ``spent``."""
    import torch

    real = torch.cuda.CUDAGraph.replay

    def replay(self):
        t0 = time.perf_counter()
        real(self)
        spent.append(time.perf_counter() - t0)

    return torch.cuda.CUDAGraph, "replay", replay


def shard_spy(seen: list):
    """A patch for ``GroupTensor.__init__``: each u-space value made
    records its parts' devices and the streams they were made on."""
    from repro_torch.distributed.mesh import GroupTensor

    real = GroupTensor.__init__

    def init(self, *a, **k):
        real(self, *a, **k)
        seen.append((tuple(p.device for p in self.parts), self.made_on))

    return GroupTensor, "__init__", init


def unsharded_group_bytes(ex, pl, shape, path: str, knobs: dict) -> int:
    """Bytes per sweep between a mesh's groups with the u-space at home:
    each non-home group gets the factors its Z-build reads, and per
    product ``x`` (or its ranks' rows of ``y``) out and its ``(P/G*R_pad)``
    (or ``(P/G, K_hat)``) answer home, the fused first panel out and its
    product home, the sketch's gathered factor rows out and partials home.
    What a psum run moves, and what a boundary run moved before its
    u-space was sharded."""
    from repro_torch.core.sketch import DEFAULT_POWER_ITERS
    from repro_torch.engine.oracle import ModeSpec

    specs = ex._mode_specs(pl, CORE, path, ModeSpec(
        block_size=knobs.get("lanczos_block", 1),
        fused_zbuild=knobs.get("fused_zbuild", False),
        warm_start=knobs.get("warm_start", "none")))
    G = ex.mesh.G
    q = DIST_P // G
    eff = [min(k, L) for k, L in zip(CORE, shape)]
    words = 0
    for n, (mp, sp) in enumerate(zip(pl.parts, specs)):
        khat = int(np.prod([e for j, e in enumerate(eff) if j != n]))
        sketch = sp.warm_start == "sketch"
        words += sum(L * k for j, (L, k) in enumerate(zip(shape, eff))
                     if j != n)
        products = sp.niter + (DEFAULT_POWER_ITERS if sketch else 0)
        words += products * sp.block_size * (khat + q * mp.R_pad)  # Z @ x
        words += products * sp.block_size * q * (mp.R_pad + khat)  # Zᵀ @ y
        if sketch:
            words += min(sp.block_size, eff[n]) * q * (mp.R_pad + khat)
    return 4 * (G - 1) * words


def core_share(t, core) -> float:
    """‖G‖²/‖T‖², summed in f64 (‖T‖ by ``SparseTensor.norm``)."""
    tt = getattr(t, "_true_norm2", None)
    tt = float(tt) if tt is not None else t.norm() ** 2
    return float(np.sum(core.double().cpu().numpy() ** 2)) / tt


def held_to_stacked(t, got, want, what: str, bitwise: bool) -> str:
    """A mesh run against the stacked run of the same plan, seed and draws:
    bitwise (factors, core, fits), or where ``bitwise`` is False within
    the f32 bars (fits 1e-4, the energy share 1e-6 relative near a fit of
    1, cores' share 2e-6 relative). Returns the verdict."""
    import torch

    (dec, st), (wdec, wst) = got, want
    if st.fits == wst.fits and torch.equal(dec.core, wdec.core) and all(
            torch.equal(a, b) for a, b in zip(dec.factors, wdec.factors)):
        return "bitwise"
    if bitwise:
        raise AssertionError(f"{what}: not bitwise: fits {st.fits} "
                             f"against {wst.fits}")
    f, w = np.asarray(st.fits), np.asarray(wst.fits)
    near = w > 1 - 1e-3
    share = (np.abs((1 - (1 - f[near]) ** 2) - (1 - (1 - w[near]) ** 2))
             <= 1e-6 * (1 - (1 - w[near]) ** 2)).all()
    cores = (core_share(t, dec.core), core_share(t, wdec.core))
    if not (np.abs(f[~near] - w[~near]) <= 1e-4).all() or not share or \
            abs(cores[0] - cores[1]) > 2e-6 * cores[1]:
        raise AssertionError(f"{what}: outside the f32 bars of the stacked "
                             f"run: fits {st.fits} against {wst.fits}, "
                             f"cores' share {cores}")
    return (f"within the f32 bars (max fit gap "
            f"{float(np.max(np.abs(f - w))):.3e}, cores' share "
            f"{cores[0]!r} against {cores[1]!r})")


def mesh_run(ex, t, pl, label: str, path: str, kw: dict, mesh=None):
    """One run on ``ex`` with launch counts, spies and peak memory read
    around it: each launch's device, stream and whether it was recorded
    into a graph (``recorded``: per kernel, the launches the run's
    captures recorded), and the host seconds of every graph replay.
    Returns ((dec, stats), record)."""
    import torch

    seen: list = []
    shards: list = []
    spent: list = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    patches = kernel_spies(seen) + [shard_spy(shards),
                                    replay_timer(spent)] \
        if mesh is not None else []
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    args = {k: v for k, v in dist_kwargs().items() if k != "device"}
    try:
        dec, st = ex.run(t, CORE, pl, n_invocations=DIST_INVOCATIONS,
                         path=path, **dict(args, **kw))
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    sweeps = len(st.fits)
    rec = {"stats": st, "launches": launches, "peak_bytes": peak,
           "steady_s": float(np.mean(st.sweep_s[1:] or st.sweep_s)),
           "group_bytes_per_sweep": st.group_bytes / sweeps,
           "u_bytes_per_sweep": st.group_bytes_u / sweeps,
           "factor_bytes_per_sweep": st.group_bytes_factors / sweeps,
           "recorded": {k: sum(1 for x in seen if x[3] and x[4] == k)
                        for k in launches},
           "replay_host_s_per_sweep": sum(spent) / sweeps,
           "graph_launches_per_sweep": len(spent) / sweeps}
    check_fits(st.fits, label)
    if mesh is not None:
        streams = {s.cuda_stream for s in mesh.streams}
        home = torch.cuda.current_stream().cuda_stream
        wrong = [x for x in seen if x[0] != x[1]]
        used = {x[2] for x in seen}
        recorded_on = {x[2] for x in seen if x[3]}
        replayed_only = st.graph_replays and not st.step_captures
        if wrong or not (replayed_only or streams <= used) or \
                used - streams - {home} or not recorded_on <= streams:
            raise AssertionError(
                f"{label}: launches with another current device {wrong[:4]}"
                f" or off the groups' streams ({len(used)} streams used, "
                f"groups {len(streams)})")
        rec["launch_sites"] = len(seen)
        # a run that only replays launches none of the steps' kernels from
        # the wrappers (its captures recorded them)
        for name in ("kron_segsum", "oracle_pair"):
            if launches[name] <= 0 and not replayed_only:
                raise AssertionError(f"{name} not launched on the mesh "
                                     f"path ({label})")
        knobs = dict(args, **kw)
        knobs.pop("use_fused_oracle", None)
        knobs.pop("seed", None)
        rec["unsharded_bytes_per_sweep"] = unsharded_group_bytes(
            ex, pl, t.shape, path, knobs)
        sharded = set(st.comm_backends.values()) == {"boundary"}
        off = [(devs, made) for devs, made in shards
               if devs != mesh.devices or made != tuple(
                   s.cuda_stream for s in mesh.streams)]
        if off or sharded != bool(shards):
            raise AssertionError(
                f"{label}: {len(shards)} u-space values, {len(off)} with a "
                f"part off its group's device or stream: {off[:2]}")
        rec["u_shards"] = len(shards)
        if sharded:
            modeled = sum(ex.modeled_u_bytes(pl, CORE, path=path,
                                             **knobs).values())
            rec["modeled_u_bytes_per_sweep"] = modeled
            if st.group_bytes_u != modeled * sweeps or \
                    rec["group_bytes_per_sweep"] >= \
                    rec["unsharded_bytes_per_sweep"]:
                raise AssertionError(
                    f"{label}: u bytes {st.group_bytes_u} against the "
                    f"formula's {modeled * sweeps}, {st.group_bytes} bytes "
                    f"in all against {rec['unsharded_bytes_per_sweep']} a "
                    f"sweep with the u-space at home")
        elif st.group_bytes != rec["unsharded_bytes_per_sweep"] * sweeps:
            raise AssertionError(
                f"{label}: psum moved {st.group_bytes} bytes, not "
                f"{rec['unsharded_bytes_per_sweep'] * sweeps}")
    log(f"mesh {label}: groups={st.groups} fits={st.fits} "
        f"sweeps={[round(x, 4) for x in st.sweep_s]} "
        f"steady_s_per_sweep={rec['steady_s']:.4f} setup_s={st.setup_s:.4f} "
        f"compilations={st.step_compilations} captures={st.step_captures} "
        f"uploads={st.uploads} launches per sweep "
        + str({k: v / sweeps for k, v in launches.items()})
        + f" group_bytes per sweep {rec['group_bytes_per_sweep']:.0f} "
        f"(u {rec['u_bytes_per_sweep']:.0f}, factors "
        f"{rec['factor_bytes_per_sweep']:.0f}) "
        f"max_memory_allocated={peak / 2**30:.3f} GiB")
    return (dec, st), rec


def mesh_census(ex, t, pl, label: str, device_type: str = "cuda") -> dict:
    """The device ops one invocation (one sweep, the core and the fit) of
    the ``fused_block8`` boundary run on ``ex`` issues: aten ops that are
    not views and return a tensor on ``device_type``, counted as they are
    dispatched (about one launch each; the port's own kernels are the
    launch counts)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not func.is_view and any(
                    isinstance(o, torch.Tensor) and o.device.type ==
                    device_type for o in tree_leaves(out)):
                Count.ops += 1
            return out

    args = {k: v for k, v in dist_kwargs().items() if k != "device"}
    with Count():
        ex.run(t, CORE, pl, n_invocations=1, path="liteopt", **args)
    out = {"device_ops": Count.ops}
    log(f"census {label}: one invocation {out}")
    return out


def phase_mesh(t, pl, name: str, bitwise: bool) -> dict:
    """P = 4 ranks over ``[cuda:0] * G`` meshes, G in ``MESH_GROUPS``, on
    plan ``pl`` of ``t``: each of ``MESH_RUNS`` against the stacked run of
    the same plan, seed and draws run eagerly, as a mesh's steps run (a
    fresh stacked executor with its captures off):
    bitwise where ``bitwise`` (every group's first element at a multiple
    of the chunk kernel's CHUNK) and else bitwise or within the f32 bars;
    a rerun bitwise with 0 uploads and 0 compilations; every group's
    arrays on its device; every kernel launch with its group's device
    current and on its group's stream, every u-space shard on its
    group's device and stream; bytes between groups by kind, a boundary
    run's ``"u"`` bytes the formula's and its total below what it moved
    with the u-space at home, a psum run's that amount exactly. The
    stacked runs are also timed captured, and held to the eager ones
    (bitwise or the f32 bars: a captured step may round apart from the
    same step run eagerly). With two or more cards, a mesh over distinct
    cards too (eager only). Then each mesh on one card again with its
    steps captured (the same executor, its captures on): each
    row captures on its first run, with every check above, bitwise the
    stacked captured run where ``bitwise`` (else within the f32 bars), held
    to the mesh's eager run (bitwise, or the verdict logged within the f32
    bars), its bytes between groups by kind the eager run's; then a
    rerun captures, compiles and uploads nothing, replays and gives the
    first run's bits, with the host seconds of its graph launches per
    sweep; the kernels' executions per replayed sweep, segments per step
    and peak memory beside the eager run's. Ends with one ``mesh bytes`` JSON line of
    every run."""
    import torch
    from repro_torch.distributed.dist_hooi import (HooiExecutor,
                                                   make_ranks_mesh)
    from repro_torch.kernels.kron_segsum import CHUNK

    sweeps = DIST_INVOCATIONS
    comm = {k: sum(float(pl.comm(n)[k]) for n in range(len(CORE)))
            for k in ("baseline_bytes", "liteopt_bytes")}
    aligned = all(mp.E_pad % CHUNK == 0 for mp in pl.parts)
    log(f"mesh phase on the {name} plan: E_pad={[mp.E_pad for mp in pl.parts]}"
        f" (group starts at multiples of CHUNK={CHUNK}: {aligned}); "
        f"comm_model per sweep: baseline_bytes {comm['baseline_bytes']:.0f}, "
        f"liteopt_bytes {comm['liteopt_bytes']:.0f}")
    if bitwise and not aligned:
        raise AssertionError(f"{name} plan: groups would not start at a "
                             "chunk boundary")
    out = {"runs": {}, "comm": comm, "captured": {}, "stacked": {},
           "census": {}}
    stacked = HooiExecutor(DIST_P)
    for label, path, kw in MESH_RUNS:
        out["captured"][label] = mesh_run(
            stacked, t, pl, f"stacked captured {label}", path, kw)
    home, stacked._home = stacked._home, None  # its captures off
    try:
        for label, path, kw in MESH_RUNS:
            out["stacked"][label] = mesh_run(
                stacked, t, pl, f"stacked eager {label}", path, kw)
            verdict = held_to_stacked(t, out["captured"][label][0],
                                      out["stacked"][label][0],
                                      f"stacked captured {label}", False)
            log(f"stacked captured {label} ({name}) against eager: "
                f"{verdict}")
        out["census"]["stacked eager"] = mesh_census(
            stacked, t, pl, f"stacked eager boundary ({name})")
    finally:
        stacked._home = home
    meshes = [(f"G={G}", [torch.device("cuda", 0)] * G) for G in MESH_GROUPS]
    if torch.cuda.device_count() >= 2:
        meshes.append(("two cards", [torch.device("cuda", i)
                                     for i in range(2)]))
    else:
        log("mesh over distinct cards skipped: one card")
    out["captured_runs"] = {}
    for mlabel, devices in meshes:
        mesh = make_ranks_mesh(DIST_P, devices=devices)
        ex = HooiExecutor(DIST_P, mesh=mesh)
        # its captures off for the eager rows (None over distinct cards)
        capture_home, ex._home = ex._home, None
        t0 = time.perf_counter()
        staged = ex.stage_upload(pl, t)
        stage_s = time.perf_counter() - t0
        up = ex._uploads[pl]
        for m in up.arrs:
            for g, ga in enumerate(m["groups"]):
                if any(a.device != mesh.devices[g] for a in ga.values()):
                    raise AssertionError(f"{mlabel}: group {g}'s arrays "
                                         "off its device")
        log(f"mesh {mlabel} on {name}: stage_upload {staged} in "
            f"{stage_s:.3f} s; every group's arrays on its device")
        results = {}
        for label, path, kw in MESH_RUNS:
            if mlabel != "G=2" and label.startswith("vector"):
                continue  # one vector run
            got, rec = results[label] = mesh_run(
                ex, t, pl, f"{mlabel} {label} ({name})", path, kw, mesh=mesh)
            verdict = held_to_stacked(
                t, got, out["stacked"][label][0], f"{mlabel} {label}",
                bitwise)
            rec["verdict"] = verdict
            log(f"mesh {mlabel} {label} ({name}) against the stacked eager "
                f"run: {verdict}; steady sweep {rec['steady_s']:.4f} s "
                f"against stacked eager "
                f"{out['stacked'][label][1]['steady_s']:.4f} s and captured "
                f"{out['captured'][label][1]['steady_s']:.4f} s; bytes "
                f"between groups per sweep "
                f"{rec['group_bytes_per_sweep']:.0f}: u "
                f"{rec['u_bytes_per_sweep']:.0f} (formula "
                f"{rec.get('modeled_u_bytes_per_sweep', '-')}), factors "
                f"{rec['factor_bytes_per_sweep']:.0f}; with the u-space at "
                f"home {rec['unsharded_bytes_per_sweep']}; "
                f"{rec['u_shards']} u-space values on their groups "
                f"(comm_model: baseline {comm['baseline_bytes']:.0f}, "
                f"liteopt {comm['liteopt_bytes']:.0f})")
            if got[1].step_captures or got[1].graph_replays:
                raise AssertionError(f"{mlabel}: a mesh step was captured")
            out["runs"][f"{mlabel} {label}"] = rec
        out["census"][mlabel] = mesh_census(
            ex, t, pl, f"{mlabel} boundary ({name})")
        label, path, kw = MESH_RUNS[1]
        first = results[label][0]
        again, _ = mesh_run(ex, t, pl, f"{mlabel} {label} rerun ({name})",
                            path, kw, mesh=mesh)
        st = again[1]
        if (st.uploads, st.step_compilations) != (0, 0) or \
                held_to_stacked(t, again, first, f"{mlabel} rerun",
                                True) != "bitwise":
            raise AssertionError(f"{mlabel} rerun: {st.uploads} uploads, "
                                 f"{st.step_compilations} compilations")
        log(f"mesh {mlabel} rerun ({name}): 0 uploads, 0 compilations, "
            f"bitwise the first run; stats() {ex.stats()}")
        if capture_home is not None:  # the same plan's arrays, captured
            ex._home = capture_home
            out["captured_runs"].update(mesh_captured(
                ex, t, pl, name, bitwise, mlabel, mesh, results, out))
        del ex, up, results, first, again
        gc.collect()
        torch.cuda.empty_cache()
    print("mesh bytes " + json.dumps({"plan": name, "runs": {
        k: {"bytes": r["group_bytes_per_sweep"],
            "u": r["u_bytes_per_sweep"],
            "factors": r["factor_bytes_per_sweep"],
            "u_formula": r.get("modeled_u_bytes_per_sweep"),
            "u_space_at_home": r["unsharded_bytes_per_sweep"],
            "steady_s": r["steady_s"], "verdict": r["verdict"]}
        for k, r in out["runs"].items()},
        "captured": {
            k: {"bytes": r["group_bytes_per_sweep"],
                "u": r["u_bytes_per_sweep"],
                "factors": r["factor_bytes_per_sweep"],
                "steady_s": r["steady_s"], "eager_steady_s": r["eager_s"],
                "graph_launch_s_per_sweep": r["graph_launch_s_per_sweep"],
                "graph_launches_per_sweep": r["graph_launches_per_sweep"],
                "executions_per_sweep": r["executions_per_sweep"],
                "segments": r["segments"],
                "peak_gib": r["peak_bytes"] / 2**30,
                "eager_peak_gib": r["eager_peak_bytes"] / 2**30,
                "verdict_stacked_captured": r["verdict"],
                "verdict_mesh_eager": r["verdict_eager"]}
            for k, r in out["captured_runs"].items()},
        "census": out["census"],
        "liteopt_bytes": comm["liteopt_bytes"],
        "baseline_bytes": comm["baseline_bytes"]}), flush=True)
    return out


def mesh_captured(ex, t, pl, name: str, bitwise: bool, mlabel: str, mesh,
                  eager: dict, out: dict) -> dict:
    """Each of ``MESH_RUNS`` on ``ex`` over ``mesh`` (one card; the
    executor of the eager rows, its plan resident), its steps now
    captured: the first run captures; held bitwise (``bitwise``)
    or within the f32 bars to the stacked captured run, and to the mesh's
    eager run (``eager``: bitwise, or the verdict logged within the f32
    bars); its bytes between groups by kind the eager run's; then a
    rerun with 0 captures, compilations and uploads, replays, the first
    run's bits. Returns the rows' records."""
    rows = {}
    for label, path, kw in MESH_RUNS:
        if label not in eager:
            continue
        what = f"{mlabel} captured {label} ({name})"
        got, rec = mesh_run(ex, t, pl, what, path, kw, mesh=mesh)
        st, (_, est) = got[1], eager[label][0]
        erec = eager[label][1]
        if not st.step_captures:
            raise AssertionError(f"{what}: no step captured")
        if (st.group_bytes_u, st.group_bytes_factors) != \
                (est.group_bytes_u, est.group_bytes_factors):
            raise AssertionError(
                f"{what}: bytes between groups u {st.group_bytes_u}, "
                f"factors {st.group_bytes_factors} against the eager run's "
                f"{est.group_bytes_u}, {est.group_bytes_factors}")
        rec["verdict"] = held_to_stacked(
            t, got, out["captured"][label][0], f"{what} against the stacked "
            "captured run", bitwise)
        rec["verdict_eager"] = held_to_stacked(
            t, got, eager[label][0], f"{what} against the mesh eager run",
            False)
        rec["segments"] = sorted({len(g.segments)
                                  for g in ex._uploads[pl].graphs.values()})
        again, arec = mesh_run(ex, t, pl, f"{what} rerun", path, kw,
                               mesh=mesh)
        ast = again[1]
        if (ast.step_captures, ast.step_compilations, ast.uploads) != \
                (0, 0, 0) or not ast.graph_replays or held_to_stacked(
                    t, again, got, f"{what} rerun", True) != "bitwise":
            raise AssertionError(
                f"{what} rerun: {ast.step_captures} captures, "
                f"{ast.step_compilations} compilations, {ast.uploads} "
                f"uploads, {ast.graph_replays} replays")
        sweeps = len(ast.fits)
        zbuild = "kron_segsum_oracle" if kw.get("fused_zbuild", True) \
            else "kron_segsum"
        if rec["recorded"][zbuild] <= 0 or rec["recorded"]["oracle_pair"] \
                <= 0:
            raise AssertionError(f"{what}: the captures recorded "
                                 f"{rec['recorded']}")
        # a replayed sweep runs every step's recorded launches once (the
        # first run captured each step once) and the core's Z-build eagerly
        rec.update(
            eager_s=erec["steady_s"], eager_peak_bytes=erec["peak_bytes"],
            graph_launch_s_per_sweep=arec["replay_host_s_per_sweep"],
            graph_launches_per_sweep=arec["graph_launches_per_sweep"],
            executions_per_sweep={
                k: rec["recorded"][k] + arec["launches"][k] / sweeps
                for k in rec["recorded"]},
            replays=ast.graph_replays)
        log(f"mesh {what}: captures {st.step_captures}, segments per step "
            f"{rec['segments']}; against the stacked captured run: "
            f"{rec['verdict']}; against the mesh eager run: "
            f"{rec['verdict_eager']}; steady sweep {rec['steady_s']:.4f} s "
            f"captured against {erec['steady_s']:.4f} s eager (stacked "
            f"captured {out['captured'][label][1]['steady_s']:.4f} s); "
            f"bytes between groups per sweep "
            f"{rec['group_bytes_per_sweep']:.0f} (u "
            f"{rec['u_bytes_per_sweep']:.0f}, factors "
            f"{rec['factor_bytes_per_sweep']:.0f}) = the eager run's; peak "
            f"{rec['peak_bytes'] / 2**30:.3f} GiB captured against "
            f"{erec['peak_bytes'] / 2**30:.3f} GiB eager; rerun: 0 "
            f"captures, 0 compilations, 0 uploads, {ast.graph_replays} "
            f"replays, bitwise; per sweep {rec['graph_launches_per_sweep']:g}"
            f" graph launches taking {rec['graph_launch_s_per_sweep']:.4f} s "
            f"of host time (cudaGraphLaunch), kernel executions "
            f"{rec['executions_per_sweep']}")
        rows[f"{mlabel} {label}"] = rec
    return rows


def phase_dist_sketch(t) -> dict:
    """The sketch warm start on the distributed path, on the Lite plan
    ``phase_dist`` left in the plan cache (``path="auto"`` is its key, so
    the plan is not built again)."""
    import torch
    from repro_torch.distributed.dist_hooi import dist_hooi

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    dec, st = dist_hooi(t, CORE, DIST_P, scheme="lite", path="auto",
                        n_invocations=DIST_INVOCATIONS, warm_start="sketch",
                        **dist_kwargs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steady = float(np.mean(st.sweep_s[1:] or st.sweep_s))
    per_sweep = {k: v / len(st.fits) for k, v in launches.items()}
    log(f"dist_hooi warm_start=sketch (lanczos_block={DIST_BLOCK}, "
        f"fused_zbuild=True asked) backends={st.comm_backends}: "
        f"plan_cache_hit={st.plan_cache_hit} "
        f"partition_build_s={st.partition_build_s:.3f} wall={wall:.3f} s "
        f"sweeps={[round(x, 4) for x in st.sweep_s]} "
        f"steady_s_per_sweep={steady:.4f} fits={st.fits} "
        f"warm_start={st.warm_start} z_passes={st.z_passes} "
        f"lanczos_block={st.lanczos_block} launches={launches} per sweep "
        f"{per_sweep} "
        f"max_memory_allocated={peak / 2**30:.3f} GiB")
    if not st.plan_cache_hit:
        raise AssertionError("dist sketch: the plan was built again")
    if set(st.warm_start.values()) != {"sketch"}:
        raise AssertionError(f"dist sketch ran {st.warm_start}")
    check_fits(st.fits, "dist_hooi sketch")
    for name in ("kron_segsum", "oracle_pair"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the "
                                 "distributed sketch path")
    if launches["kron_segsum_oracle"]:
        raise AssertionError("a sketch mode ran the fused Z-build")
    for n, F in enumerate(dec.factors):
        if tuple(F.shape) != (t.shape[n], CORE[n]) or \
                not bool(torch.isfinite(F).all()):
            raise AssertionError(f"dist sketch factor {n} bad")
    return {"stats": st, "launches": launches, "peak_bytes": peak,
            "wall_s": wall, "steady_s": steady}


def phase_dist_small() -> None:
    from repro_torch.data.tensors import synth_tensor
    from repro_torch.distributed.dist_hooi import dist_hooi

    shape, nnz, core = DIST_SMALL
    t = synth_tensor(shape, nnz, alphas=(1.1, 1.0, 0.9), seed=3)
    kw = dist_kwargs()
    for path in ("liteopt", "baseline"):
        _, gpu = dist_hooi(t, core, DIST_P, path=path, n_invocations=3, **kw)
        kw_cpu = dict(kw, device="cpu")
        _, cpu = dist_hooi(t, core, DIST_P, path=path, n_invocations=3,
                           **kw_cpu)
        diff = float(np.max(np.abs(np.subtract(gpu.fits, cpu.fits))))
        log(f"small dist_hooi {path} card vs CPU: fits {gpu.fits} vs "
            f"{cpu.fits}, max diff {diff:.2e} (tolerance 1e-4)")
        if not diff <= 1e-4:
            raise AssertionError(f"dist card and CPU fits differ by {diff}")


def profile_rows(prof) -> list:
    """(device ms, calls, name) per kernel, largest first."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def kernel_executions(prof) -> dict:
    """Each ported kernel's executions in a profile's device activity
    (a graph's recorded launches included): ``oracle_kernel`` per
    ``oracle_pair`` call, ``zx_kernel`` per ``kron_segsum_oracle`` call,
    and one ``chunk_kernel`` per call of either ``kron_segsum`` form."""
    seen = {"chunk_kernel": 0, "zx_kernel": 0, "oracle_kernel": 0}
    for _, count, key in profile_rows(prof):
        for name in seen:
            if name + "<" in key or name + "(" in key:
                seen[name] += count
    return {"kron_segsum": seen["chunk_kernel"] - seen["zx_kernel"],
            "kron_segsum_oracle": seen["zx_kernel"],
            "oracle_pair": seen["oracle_kernel"]}


def phase_dist_profile(t, pl) -> dict:
    """Device time by kernel over one invocation of the distributed path
    (boundary backend; set-up, one sweep, core and fit) on the cached
    plan: every step replays its graphs, so the wrappers launch none of
    the step's kernels, and the profiler's device activity shows them
    running. Returns both counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed.dist_hooi import dist_hooi

    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = dist_hooi(t, CORE, DIST_P, scheme=pl, path="liteopt",
                          n_invocations=1, **dist_kwargs())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch_counts()
    ran = kernel_executions(prof)
    log(f"replayed invocation: step_captures={st.step_captures} "
        f"graph_replays={st.graph_replays}; wrapper launches {launches}; "
        f"kernel executions on the card (profiler) {ran}")
    if st.step_captures or st.graph_replays != len(CORE):
        raise AssertionError(f"the profiled invocation captured "
                             f"{st.step_captures} steps and replayed "
                             f"{st.graph_replays}, not {len(CORE)}")
    for name in ("kron_segsum_oracle", "oracle_pair"):
        if ran[name] <= launches[name]:
            raise AssertionError(f"{name}: {ran[name]} executions on the "
                                 f"card against {launches[name]} wrapper "
                                 f"launches: the replayed steps did not "
                                 f"run it")
    rows = profile_rows(prof)
    busy = sum(r[0] for r in rows)
    log(f"profile of dist_hooi(liteopt, n_invocations=1) on the cached "
        f"plan: wall {wall * 1e3:.1f} ms (sweep {st.sweep_s[0] * 1e3:.1f} "
        f"ms), device busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%)"
        f"; host launches (one sweep, core and fit) {launch_census(prof)}")
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)[:10]
    log("  host self time: " + "; ".join(f"{ms:.1f} ms {c}x {k[:40]}"
                                          for ms, c, k in host))
    for ms, count, key in rows[:16]:
        log(f"  {ms:9.3f} ms {count:5d}x  {key[:90]}")
    return {"launches": launches, "executions": ran}


def fused_bound_ms(E: int, Ka: int, Kb: int, num_rows: int, nonempty: int,
                   s: int) -> tuple[float, str]:
    """Elements read once, Z and ZX written once, X read once; products for
    every element and a ZX row for every row that holds elements."""
    K = Ka * Kb
    bytes_ = E * 4 * (1 + Ka + Kb) + num_rows * (K + s) * 4 + K * s * 4
    flops = 2 * E * K + 2 * nonempty * K * s
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def fused_gather_bound_ms(E: int, N: int, Ka: int, Kb: int, num_rows: int,
                          factor_rows: int, nonempty: int, s: int
                          ) -> tuple[float, str]:
    """The gather form's bound (``gather_bound_ms``) plus ZX written, X
    read and a ZX row for every row that holds elements."""
    K = Ka * Kb
    bytes_ = (E * 4 * (2 + N) + factor_rows * 4 + num_rows * (K + s) * 4
              + K * s * 4)
    flops = 2 * E * K + E * Ka + 2 * nonempty * K * s
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def phase_dist_timings(pl, factors) -> dict:
    """At the distributed shapes, each mode's stacked partition (all ranks,
    one launch, padding included): the gather form of ``kron_segsum_oracle``
    with a width-8 panel checked bitwise against the row form and timed
    against its bound, the row form, ``_split_ab`` plus the row form, its
    plain version and ``kron_segsum`` plus one ``torch.matmul``; then the
    stacked ``oracle_pair`` (P ranks, s = 8) checked against its plain
    version and bitwise against P single calls, and timed against P single
    calls plus ``torch.stack``."""
    import torch
    from repro_torch.core.lanczos import block_start_panel
    from repro_torch.distributed.executor import upload_mode
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.kron_segsum import kron_segsum, kron_segsum_oracle
    from repro_torch.kernels.oracle_fused import oracle_pair
    from repro_torch.random import make_key

    dev = torch.device(DEVICE)
    g = torch.Generator(device=dev).manual_seed(13)
    out = {"kron_segsum_oracle": [], "stacked": [], "stacked_s10": [],
           "err": 0.0, "stacked_err": 0.0}
    for mode, mp in enumerate(pl.parts):
        arrs = upload_mode(mp, dev)
        c, v, rows = arrs["coords"], arrs["values"], arrs["rows"]
        del arrs
        P, R_pad = mp.P, mp.R_pad
        R = P * R_pad
        E = int(rows.shape[0])
        Ka, Kb = ops.split_kron_dims([f.shape[1] for f in factors], mode)
        X = block_start_panel(make_key(0), Ka * Kb, DIST_BLOCK, dev)
        nonempty = int(torch.unique_consecutive(rows).numel())
        pad = int((mp.e_per_rank < mp.E_pad).sum())

        def gather():
            return ops.penultimate_sorted_oracle(c, v, rows, factors, mode,
                                                 R, X)

        def split_row():
            return kron_segsum_oracle(
                rows, *ops._split_ab(c, v, factors, mode), R, X)

        a, b = ops._split_ab(c, v, factors, mode)
        z_row = kron_segsum_oracle(rows, a, b, R, X)
        out["err"] = max(out["err"], check_gather(
            f"dist mode {mode} (P={P}, {pad} padded ranks, "
            f"{E - int(mp.e_per_rank.sum())} padding elements)", rows, c, v,
            factors, mode, R, "f32", z_row[0], X, z_row[1]))
        row_ms = cuda_ms(lambda: kron_segsum_oracle(rows, a, b, R, X),
                         reps=5)
        two = cuda_ms(lambda: torch.matmul(kron_segsum(rows, a, b, R), X),
                      reps=5)
        plain = cuda_ms(lambda: ref.kron_segsum_oracle_ref(rows, a, b, R, X),
                        reps=2)
        del a, b
        torch.cuda.empty_cache()
        split_ms = cuda_ms(split_row, reps=3)
        ms = cuda_ms(gather, reps=5)
        ms2 = cuda_ms(gather, reps=5)
        split_ms2 = cuda_ms(split_row, reps=3)
        bound, by = fused_gather_bound_ms(E, len(factors), Ka, Kb, R,
                                          factor_rows_read(factors, mode),
                                          nonempty, DIST_BLOCK)
        row_bound, _ = fused_bound_ms(E, Ka, Kb, R, nonempty, DIST_BLOCK)
        log(f"kron_segsum_oracle mode {mode}: E={E} K={Ka * Kb} rows={R} "
            f"(non-empty {nonempty}) s={DIST_BLOCK} gather ms={ms:.4f}/"
            f"{ms2:.4f} bound_ms={bound:.4f} ({by}); before: _split_ab+row "
            f"form ms={split_ms:.4f}/{split_ms2:.4f}, row form alone "
            f"ms={row_ms:.4f} (bound {row_bound:.4f}), "
            f"kron_segsum+matmul_ms={two:.4f}; plain_ms={plain:.4f}")
        out["kron_segsum_oracle"].append(dict(
            ms=(ms + ms2) / 2, plain=plain, bound=bound, by=by, row_ms=row_ms,
            row_bound=row_bound, split_row_ms=(split_ms + split_ms2) / 2,
            two=two))

        Z = gather()[0]
        K = Z.shape[1]
        y = torch.randn((P, R_pad, DIST_BLOCK), device=dev, generator=g)
        xs = torch.randn((K, DIST_BLOCK), device=dev, generator=g)
        got = oracle_pair(Z, None, y, P)[1]
        again = oracle_pair(Z, None, y, P)[1]
        want = ref.oracle_pair_ref(Z, None, y, P)[1]
        single = [oracle_pair(Z[p * R_pad:(p + 1) * R_pad], None, y[p])[1]
                  for p in range(P)]
        out["stacked_err"] = max(out["stacked_err"], check(
            f"stacked oracle_pair Z^T@y mode {mode} P={P} R_pad={R_pad} "
            f"K={K} s={DIST_BLOCK}", got, want, again))
        if not all(torch.equal(got[p], single[p]) for p in range(P)):
            raise AssertionError(f"stacked oracle_pair mode {mode}: not "
                                 "bitwise equal to single calls")
        log("  stacked oracle_pair: bitwise equal to P single calls")

        def stacked():
            oracle_pair(Z, None, y, P)

        def singles():
            torch.stack([oracle_pair(Z[p * R_pad:(p + 1) * R_pad], None,
                                     y[p])[1] for p in range(P)])

        def zmv():
            oracle_pair(Z, xs, None)

        st_ms = cuda_ms(stacked, reps=100, warmup=3)
        st_dev = device_ms(stacked, reps=100, match="oracle_kernel")
        sg_ms = cuda_ms(singles, reps=100, warmup=3)
        sg_dev = device_ms(singles, reps=100)
        zmv_ms = cuda_ms(zmv, reps=100, warmup=3)
        zmv_dev = device_ms(zmv, reps=100, match="oracle_kernel")
        lib = cuda_ms(lambda: torch.bmm(Z.view(P, R_pad, K).transpose(1, 2),
                                        y), reps=100, warmup=3)
        bound, by = oracle_half_bound_ms(R, K, DIST_BLOCK)
        bound = bound + 1e3 * 4 * (P - 1) * K * DIST_BLOCK / HBM_BYTES_PER_S
        log(f"stacked oracle_pair mode {mode}: Z^T@y ms={st_ms:.4f} "
            f"device_ms={st_dev:.4f} vs {P} single calls+torch.stack "
            f"ms={sg_ms:.4f} device_ms={sg_dev:.4f}; one torch.bmm "
            f"ms={lib:.4f}; bound_ms={bound:.4f} ({by}); Z@X (zmv, "
            f"{R} rows) ms={zmv_ms:.4f} device_ms={zmv_dev:.4f}")
        out["stacked"].append(dict(ms=st_ms, device_ms=st_dev, single_ms=sg_ms,
                                   single_device_ms=sg_dev, lib=lib,
                                   bound=bound, zmv_ms=zmv_ms,
                                   zmv_device_ms=zmv_dev))

        # the sketch panel on the stacked ranks: the seed's and the power
        # iteration's products at s = 10
        y10 = torch.randn((P, R_pad, SKETCH_PANEL), device=dev, generator=g)
        x10 = torch.randn((K, SKETCH_PANEL), device=dev, generator=g)
        got = oracle_pair(Z, None, y10, P)[1]
        out["stacked_err"] = max(out["stacked_err"], check(
            f"stacked oracle_pair Z^T@y mode {mode} P={P} R_pad={R_pad} "
            f"K={K} s={SKETCH_PANEL}", got,
            ref.oracle_pair_ref(Z, None, y10, P)[1],
            oracle_pair(Z, None, y10, P)[1]),
            check(f"oracle_pair Z@x mode {mode} rows={R} K={K} "
                  f"s={SKETCH_PANEL}", oracle_pair(Z, x10, None)[0],
                  ref.oracle_pair_ref(Z, x10, None)[0],
                  oracle_pair(Z, x10, None)[0]))
        if not all(torch.equal(got[p], oracle_pair(
                Z[p * R_pad:(p + 1) * R_pad], None, y10[p])[1])
                for p in range(P)):
            raise AssertionError(f"stacked oracle_pair s={SKETCH_PANEL} "
                                 f"mode {mode}: not bitwise equal to single "
                                 "calls")
        log("  stacked oracle_pair s=10: bitwise equal to P single calls")
        st_ms = cuda_ms(lambda: oracle_pair(Z, None, y10, P), reps=100,
                        warmup=3)
        st_dev = device_ms(lambda: oracle_pair(Z, None, y10, P), reps=100,
                           match="oracle_kernel")
        sg_ms = cuda_ms(lambda: torch.stack([oracle_pair(
            Z[p * R_pad:(p + 1) * R_pad], None, y10[p])[1]
            for p in range(P)]), reps=100, warmup=3)
        zmv_ms = cuda_ms(lambda: oracle_pair(Z, x10, None), reps=100,
                         warmup=3)
        zmv_dev = device_ms(lambda: oracle_pair(Z, x10, None), reps=100,
                            match="oracle_kernel")
        lib = cuda_ms(lambda: torch.bmm(Z.view(P, R_pad, K).transpose(1, 2),
                                        y10), reps=100, warmup=3)
        plain = cuda_ms(lambda: ref.oracle_pair_ref(Z, None, y10, P),
                        reps=100, warmup=3)
        bound, by = oracle_half_bound_ms(R, K, SKETCH_PANEL)
        bound = bound + 1e3 * 4 * (P - 1) * K * SKETCH_PANEL \
            / HBM_BYTES_PER_S
        log(f"stacked oracle_pair mode {mode} s={SKETCH_PANEL}: Z^T@Y "
            f"ms={st_ms:.4f} device_ms={st_dev:.4f} vs {P} single "
            f"calls+torch.stack ms={sg_ms:.4f}; one torch.bmm ms={lib:.4f}; "
            f"plain_ms={plain:.4f}; bound_ms={bound:.4f} ({by}); Z@X ({R} "
            f"rows) ms={zmv_ms:.4f} device_ms={zmv_dev:.4f}")
        out["stacked_s10"].append(dict(ms=st_ms, device_ms=st_dev,
                                       single_ms=sg_ms, lib=lib, plain=plain,
                                       bound=bound, zmv_ms=zmv_ms,
                                       zmv_device_ms=zmv_dev))
        del c, v, rows, Z, y, got, again, want, single, z_row, y10, x10
        torch.cuda.empty_cache()
    return out


# the four-mode phase: FROSTT enron's shape and nonzeros drawn under the
# repo's enron-s skew and hub (SUITE_SPECS), nothing cut
ENRON_SHAPE = (6066, 5699, 244268, 1176)
ENRON_NNZ = 54_202_099
CORE4 = (10, 10, 10, 10)  # the paper's 10 per mode: K̂ = 1000
PLAIN_CHUNK = 1 << 18  # elements per partial sum of a plain Z at K̂ = 1000
# the scheme comparison: CoarseG and MediumG beside Lite at nell-2 size; all
# four at medium size, where HyperG's partitioner (a Python loop over the
# elements) can run, as the paper runs HyperG on medium tensors only
MEDIUM_NNZ = 1_000_000


def plain_z(rows, c, v, factors, mode, R, chunk: int):
    """The plain Z of sorted elements, summed over ``chunk``-element
    slices (``ref.kron_segsum_ref`` on each, added up in float64), so it
    fits beside the operands and one f32 ``index_add_`` over a hub row's
    millions of terms does not carry its own rounding into the
    comparison."""
    import torch
    from repro_torch.kernels import ops, ref

    E = int(rows.shape[0])
    want = None
    for lo in range(0, E, chunk):
        sl = slice(lo, min(E, lo + chunk))
        a, b = ops._split_ab(c[sl], v[sl], factors, mode)
        part = ref.kron_segsum_ref(rows[sl], a, b, R)
        del a, b
        if want is None:
            want = torch.zeros(part.shape, dtype=torch.float64,
                               device=part.device)
        want += part
        del part
    return want.float()


def four_mode_single_checks(t4, factors) -> dict:
    """The kernels at the four-mode single-process shapes (every mode's
    elements sorted by its rows, K̂ = 1000): the gather-form
    ``kron_segsum`` (both leading factors gathered by the two-lead walk, no
    fold of ``a``) against its chunked plain version, rerun bitwise, timed
    against its bound, the chunk walk and the fix-up timed apart (the fix-up adds a
    row's chunk partials in series: mode 0's hub row); ``oracle_pair`` on
    that Z as the vector Lanczos calls it (one half per call, s = 1)
    against its plain version and timed beside ``torch.matmul``."""
    import torch
    from repro_torch.convert import device_coords
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.oracle_fused import oracle_pair

    dev = factors[0].device
    coords, values = device_coords(t4, dev)
    g = torch.Generator(device=dev).manual_seed(23)
    torch.cuda.reset_peak_memory_stats()
    out = {"kron_segsum": [], "oracle_pair": [], "err": {}}
    errs = {"kron_segsum": 0.0, "oracle_pair": 0.0}
    for mode in range(t4.ndim):
        rows, c, v = sorted_elements(coords, values, mode)
        R, E = t4.shape[mode], int(rows.shape[0])
        Ka, Kb = ops.split_kron_dims([f.shape[1] for f in factors], mode)
        hub = int(torch.bincount(rows.long(), minlength=R).max())

        def gather():
            return ops.penultimate_sorted(c, v, rows, factors, mode, R)

        got, again = gather(), gather()
        errs["kron_segsum"] = max(errs["kron_segsum"], check(
            f"four-mode mode {mode}: gather kron_segsum E={E} rows={R} "
            f"K={Ka * Kb} (Ka={Ka}, Kb={Kb}), largest row {hub} elements",
            got, plain_z(rows, c, v, factors, mode, R, PLAIN_CHUNK), again))
        del again
        torch.cuda.empty_cache()
        ms = cuda_ms(gather, reps=3)
        walk = device_ms(gather, reps=3, match="chunk_kernel")
        fixup = device_ms(gather, reps=3, match="fixup_kernel")
        bound, by = gather_bound_ms(E, t4.ndim, Ka, Kb, R,
                                    factor_rows_read(factors, mode))
        log(f"four-mode kron_segsum mode {mode}: gather ms={ms:.4f} (two-"
            f"lead walk, no fold of a) chunk walk device_ms="
            f"{walk:.4f} fix-up device_ms={fixup:.4f} (largest row {hub} "
            f"elements, {-(-hub // 1024)} chunks of partials) bound_ms="
            f"{bound:.4f} ({by}); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        out["kron_segsum"].append(dict(ms=ms, walk_ms=walk, fixup_ms=fixup,
                                       bound=bound, by=by, hub=hub))
        del rows, c, v

        Z, K = got, got.shape[1]
        x = torch.randn((K,), device=dev, generator=g)
        y = torch.randn((R,), device=dev, generator=g)
        wx, wy = ref.oracle_pair_ref(Z, x, y)
        for name, fn, w in (("Z@x", lambda: oracle_pair(Z, x, None)[0], wx),
                            ("Z^T@y", lambda: oracle_pair(Z, None, y)[1],
                             wy)):
            errs["oracle_pair"] = max(errs["oracle_pair"], check(
                f"four-mode mode {mode}: oracle_pair {name} Z={R}x{K} s=1",
                fn(), w, fn()))

        def pair():
            oracle_pair(Z, x, None)
            oracle_pair(Z, None, y)

        def lib_pair():
            torch.matmul(Z, x)
            torch.matmul(y, Z)

        ms = cuda_ms(pair, reps=20, warmup=2) / 2
        dev_ms = device_ms(pair, reps=20, match="oracle_kernel",
                           per_call=2) / 2
        lib = cuda_ms(lib_pair, reps=20, warmup=2) / 2
        lib_dev = device_ms(lib_pair, reps=20) / 2
        plain = cuda_ms(lambda: (ref.oracle_pair_ref(Z, x, None),
                                 ref.oracle_pair_ref(Z, None, y)),
                        reps=20, warmup=2) / 2
        bound, by = oracle_half_bound_ms(R, K, 1)
        log(f"four-mode oracle_pair mode {mode}: Z={R}x{K} s=1 one half per "
            f"call ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain:.4f} "
            f"torch.matmul ms={lib:.4f} device_ms={lib_dev:.4f} "
            f"bound_ms={bound:.4f} ({by})")
        out["oracle_pair"].append(dict(ms=ms, device_ms=dev_ms, plain=plain,
                                       lib=lib, lib_device_ms=lib_dev,
                                       bound=bound, by=by))
        del Z, got, x, y, wx, wy
        torch.cuda.empty_cache()
    out["err"] = errs
    return out


def four_mode_dist_checks(ex, pl, factors) -> dict:
    """The kernels at the four-mode distributed shapes, on the arrays the
    steps ran over (the executor's resident upload of ``pl``, every mode's
    stacked partition): ``kron_segsum_oracle``'s gather form with the
    ``fused_block8`` panel against its chunked plain version (Z and
    Z @ X), rerun bitwise, timed against its bound; the stacked
    ``oracle_pair`` (P ranks, s = 8) on that Z against its plain version,
    rerun bitwise, timed beside one ``torch.bmm``."""
    import torch
    from repro_torch.core.lanczos import block_start_panel
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.oracle_fused import oracle_pair
    from repro_torch.random import make_key

    up = ex._uploads[pl]
    dev = factors[0].device
    g = torch.Generator(device=dev).manual_seed(29)
    out = {"kron_segsum_oracle": [], "stacked": []}
    errs = {"kron_segsum_oracle": 0.0, "oracle_pair": 0.0}
    for mp, arrs in zip(pl.parts, up.zarrs):
        c, v, rows = arrs["coords"], arrs["values"], arrs["rows"]
        mode, P, R_pad = mp.mode, mp.P, mp.R_pad
        R, E = P * R_pad, int(rows.shape[0])
        Ka, Kb = ops.split_kron_dims([f.shape[1] for f in factors], mode)
        X = block_start_panel(make_key(0), Ka * Kb, DIST_BLOCK, dev)

        def gather():
            return ops.penultimate_sorted_oracle(c, v, rows, factors, mode,
                                                 R, X)

        got, again = gather(), gather()
        want = plain_z(rows, c, v, factors, mode, R, PLAIN_CHUNK)
        errs["kron_segsum_oracle"] = max(
            errs["kron_segsum_oracle"],
            check(f"four-mode dist mode {mode}: kron_segsum_oracle Z "
                  f"E={E} (P={P} x E_pad {mp.E_pad}) rows={R} "
                  f"K={Ka * Kb} s={DIST_BLOCK}", got[0], want, again[0]),
            check(f"four-mode dist mode {mode}: kron_segsum_oracle ZX",
                  got[1], want @ X, again[1]))
        del want, again
        torch.cuda.empty_cache()
        ms = cuda_ms(gather, reps=3)
        nonempty = int(torch.unique_consecutive(rows).numel())
        bound, by = fused_gather_bound_ms(E, len(factors), Ka, Kb, R,
                                          factor_rows_read(factors, mode),
                                          nonempty, DIST_BLOCK)
        log(f"four-mode kron_segsum_oracle mode {mode}: gather ms={ms:.4f} "
            f"bound_ms={bound:.4f} ({by})")
        out["kron_segsum_oracle"].append(dict(ms=ms, bound=bound, by=by))

        Z, K = got[0], got[0].shape[1]
        y = torch.randn((P, R_pad, DIST_BLOCK), device=dev, generator=g)
        errs["oracle_pair"] = max(errs["oracle_pair"], check(
            f"four-mode stacked oracle_pair Z^T@y mode {mode} P={P} "
            f"R_pad={R_pad} K={K} s={DIST_BLOCK}",
            oracle_pair(Z, None, y, P)[1], ref.oracle_pair_ref(Z, None, y,
                                                               P)[1],
            oracle_pair(Z, None, y, P)[1]))
        st_ms = cuda_ms(lambda: oracle_pair(Z, None, y, P), reps=20,
                        warmup=2)
        st_dev = device_ms(lambda: oracle_pair(Z, None, y, P), reps=20,
                           match="oracle_kernel")
        lib = cuda_ms(lambda: torch.bmm(Z.view(P, R_pad, K).transpose(1, 2),
                                        y), reps=20, warmup=2)
        bound, by = oracle_half_bound_ms(R, K, DIST_BLOCK)
        bound += 1e3 * 4 * (P - 1) * K * DIST_BLOCK / HBM_BYTES_PER_S
        log(f"four-mode stacked oracle_pair mode {mode}: Z^T@Y ms="
            f"{st_ms:.4f} device_ms={st_dev:.4f} one torch.bmm ms={lib:.4f}"
            f" bound_ms={bound:.4f} ({by})")
        out["stacked"].append(dict(ms=st_ms, device_ms=st_dev, lib=lib,
                                   bound=bound, by=by))
        del Z, got, y
        torch.cuda.empty_cache()
    out["err"] = errs
    return out


def captured_pair(t, pl, path: str, label: str, core=CORE, uploads=None):
    """``dist_run`` twice on the shared executor: the first run captures
    every mode step (over a new plan's arrays) and uploads ``uploads``
    arrays; the rerun captures, compiles and uploads nothing, replays every
    step and gives the first run's bits. Returns (dec, stats, record) of
    the first run with the rerun's record as ``record["rerun"]``."""
    dec, st, rec = dist_run(t, pl, path, label, core=core)
    if st.step_captures != len(core) or (uploads is not None
                                         and st.uploads != uploads):
        raise AssertionError(f"{label}: {st.step_captures} captures, "
                             f"{st.uploads} uploads (want {len(core)}, "
                             f"{uploads})")
    dec2, st2, rec2 = dist_run(t, pl, path, f"{label} rerun", core=core)
    if (st2.step_captures, st2.step_compilations, st2.uploads) != (0, 0, 0) \
            or st2.graph_replays != len(core) * DIST_INVOCATIONS \
            or held_to_stacked(t, (dec2, st2), (dec, st), f"{label} rerun",
                               True) != "bitwise":
        raise AssertionError(
            f"{label} rerun: {st2.step_captures} captures, "
            f"{st2.step_compilations} compilations, {st2.uploads} uploads, "
            f"{st2.graph_replays} replays; fits {st2.fits} against "
            f"{st.fits}")
    log(f"{label} rerun: 0 captures, 0 compilations, 0 uploads, "
        f"{st2.graph_replays} replays, bitwise the first run; steady sweep "
        f"{rec2['steady_s']:.4f} s replayed")
    rec["rerun"] = rec2
    return dec, st, rec


def phase_four_mode_small() -> None:
    """The paper suite's enron-s mirror at core 10^4 on the card against
    the port's CPU path: single process and P = 4 on both backends."""
    from repro_torch.core.hooi import hooi
    from repro_torch.data.tensors import paper_suite
    from repro_torch.distributed.dist_hooi import dist_hooi

    t = paper_suite(1.0, 0)["enron-s"]
    kw = dict(n_invocations=3, seed=2, use_fused_oracle=True)
    worst = 0.0
    _, fg = hooi(t, CORE4, device=DEVICE, **kw)
    _, fc = hooi(t, CORE4, device="cpu", **kw)
    runs = [("hooi", fg, fc)]
    for path in ("liteopt", "baseline"):
        dkw = dict(kw, path=path, lanczos_block=DIST_BLOCK, fused_zbuild=True)
        _, sg = dist_hooi(t, CORE4, DIST_P, device=DEVICE, **dkw)
        _, sc = dist_hooi(t, CORE4, DIST_P, device="cpu", **dkw)
        runs.append((f"dist_hooi {path}", sg.fits, sc.fits))
    for label, g, c in runs:
        check_fits(g, f"enron-s {label}")
        diff = float(np.max(np.abs(np.subtract(g, c))))
        worst = max(worst, diff)
        log(f"enron-s mirror {t.shape} nnz {t.nnz} core {CORE4} {label} "
            f"card against CPU: fits {g} against {c}, max diff {diff:.2e} "
            f"(tolerance 1e-4)")
        if not diff <= 1e-4:
            raise AssertionError(f"enron-s {label}: card and CPU fits "
                                 f"differ by {diff}")


def phase_four_mode() -> dict:
    """HOOI over four modes at FROSTT enron's size (nothing cut), core
    10^4: single-process ``hooi`` for one invocation, the kernels at its
    shapes; a Lite plan for P = 4 and ``dist_hooi`` with ``fused_block8``
    on boundary and psum, captured, each rerun on the cached plan (0
    captures, 0 uploads, bitwise); the kernels at the distributed shapes;
    then the enron-s mirror on the card against the CPU. Runs on a fresh
    shared executor, nothing of the nell-2 phases resident."""
    import torch
    from repro_torch.core import hooi
    from repro_torch.core.plan import plan
    from repro_torch.data.tensors import SUITE_SPECS, synth_tensor
    from repro_torch.distributed.dist_hooi import shared_executor
    from repro_torch.random import make_key

    spec = next(s for s in SUITE_SPECS if s.name == "enron-s")
    t0 = time.perf_counter()
    t4 = synth_tensor(ENRON_SHAPE, ENRON_NNZ, alphas=spec.alphas,
                      hub_fraction=spec.hub_fraction,
                      hub_modes=spec.hub_modes, seed=0)
    gen_s = time.perf_counter() - t0
    hub = int(t4.slice_sizes(0).max())
    log(f"four-mode tensor: FROSTT enron's shape {t4.shape}, {ENRON_NNZ} "
        f"drawn under {spec.name}'s skew alphas={spec.alphas} and hub "
        f"(fraction {spec.hub_fraction} on modes {spec.hub_modes}), seed "
        f"0: {t4.nnz} unique after deduplication, generated in {gen_s:.1f} "
        f"s; mode 0's largest slice {hub} elements; core {CORE4}, K̂ = "
        f"{int(np.prod(CORE4[1:]))}")
    out = {"nnz": t4.nnz, "gen_s": gen_s, "hub": hub}
    out["single"] = run_single(t4, "four-mode single-process path", 1,
                               core=CORE4)
    dev = torch.device(DEVICE)
    factors = hooi.random_factors(t4.shape, CORE4, make_key(0), dev)
    out["single_checks"] = four_mode_single_checks(t4, factors)

    t0 = time.perf_counter()
    pl = plan(t4, "lite", DIST_P, core_dims=CORE4, path="auto")
    out["plan_build_s"] = time.perf_counter() - t0
    log(f"four-mode plan: lite, P={DIST_P}, built on the host in "
        f"{out['plan_build_s']:.1f} s; E_pad={[mp.E_pad for mp in pl.parts]} "
        f"R_pad={[mp.R_pad for mp in pl.parts]} "
        f"Lp={[mp.Lp for mp in pl.parts]} "
        f"S_pad={[mp.S_pad for mp in pl.parts]}")
    out["runs"] = {}
    for path, uploads in (("liteopt", 10 * len(CORE4) + 2), ("baseline", 0)):
        out["runs"][path] = captured_pair(
            t4, pl, path, f"four-mode {path}", core=CORE4,
            uploads=uploads)[2]
    out["dist_checks"] = four_mode_dist_checks(shared_executor(DIST_P), pl,
                                               factors)
    del pl, factors
    phase_four_mode_small()
    return out


def scheme_row(t, pl, label: str, wall: float) -> dict:
    """A plan's row of the scheme table: host seconds, padded shapes per
    mode, elements held, ``SchemeMetrics``, the modeled bytes a sweep
    moves by kind (the plan's comm model: psum's and boundary's
    collectives, the factor rows) and modeled seconds; logged."""
    m, N = pl.metrics, len(pl.parts)
    rec = {
        "build_s": pl.build_s, "wall_s": wall,
        "E_pad": [mp.E_pad for mp in pl.parts],
        "R_pad": [mp.R_pad for mp in pl.parts],
        "Lp": [mp.Lp for mp in pl.parts],
        "S_pad": [mp.S_pad for mp in pl.parts],
        "elements_held": [int(mp.e_per_rank.sum()) for mp in pl.parts],
        "metrics": {k: int(getattr(m, k)) for k in (
            "ttm_flops_max", "svd_flops_max", "fm_volume", "svd_volume")},
        "bytes_per_sweep": {
            "psum": sum(float(pl.comm(n)["baseline_bytes"])
                        for n in range(N)),
            "boundary": sum(float(pl.comm(n)["liteopt_bytes"])
                            for n in range(N)),
            "factors": 4.0 * m.fm_volume},
        "modeled_s": pl.cost.total_s, "runs": {}}
    log(f"{label} {pl.name}: plan built on the host in {pl.build_s:.2f} s "
        f"({wall:.2f} s wall), uni={pl.scheme.uni}; E_pad={rec['E_pad']} "
        f"R_pad={rec['R_pad']} Lp={rec['Lp']} S_pad={rec['S_pad']} "
        f"elements held {rec['elements_held']} of {t.nnz}; metrics "
        f"{rec['metrics']}; bytes per sweep {rec['bytes_per_sweep']}; "
        f"modeled {pl.cost.total_s:.6f} s")
    return rec


def phase_schemes(t, names, label: str, lite: dict | None = None,
                  lite_plan=None) -> dict:
    """The paper's schemes on ``t``: each of ``names`` planned for P = 4
    (costed for ``path="auto"``, outside the plan cache, so a plan and its
    uploads go when the scheme is done) and run with ``fused_block8`` on
    boundary and psum through the shared executor's captured steps, each
    rerun bitwise with 0 captures and 0 uploads. Every run is held to the
    Lite runs of the same tensor and seed (``lite``: by path, from an
    earlier phase on ``lite_plan``; else Lite is the first of ``names``):
    fits within 1e-4
    of the same backend's, the final core's energy share within 2e-6
    relative of the nearer of Lite's two (psum and boundary). Per scheme:
    the plan's host seconds, the steady seconds per sweep (replayed), the
    padded shapes per mode, ``SchemeMetrics``, the bytes a sweep moves by
    kind (the plan's comm model: psum's and boundary's collectives, the
    factor rows) and peak memory; then what ``auto`` picks from the plans'
    modeled seconds, without a plan built twice. One ``schemes`` JSON line."""
    import torch
    from repro_torch.core.plan import AUTO_CANDIDATES, plan

    N = len(CORE)
    rows, costs = {}, {}
    if lite_plan is not None:  # its runs are an earlier phase's (first runs)
        rows["lite"] = scheme_row(t, lite_plan, label, lite_plan.build_s)
        rows["lite"]["runs"] = {p: {"first_steady_s": r["steady_s"],
                                    "peak_gib": r["peak_bytes"] / 2**30,
                                    "fit": r["stats"].fits[-1]}
                                for p, r in lite.items()}
        costs["lite"] = lite_plan.cost.total_s
    for name in names:
        t0 = time.perf_counter()
        pl = plan(t, name, DIST_P, core_dims=CORE, path="auto",
                  use_cache=False)
        rec = scheme_row(t, pl, label, time.perf_counter() - t0)
        costs[name] = pl.cost.total_s
        for i, path in enumerate(("liteopt", "baseline")):
            dec, st, run = captured_pair(
                t, pl, path, f"{label} {name} {path}",
                uploads=10 * N + 2 if i == 0 else 0)
            if lite is None:
                lite = {}
            if name == "lite" and path not in lite:
                lite[path] = run
            want = lite[path]
            gap = float(np.max(np.abs(np.subtract(st.fits,
                                                  want["stats"].fits))))
            # the core's energy against each of Lite's runs: they are two
            # f32 roundings of one decomposition (their own gap, psum
            # against boundary, reached 2.04e-6 relative at 1M draws), so
            # the bar holds against the nearer one
            rels = {p: abs(run["core_share"] - r["core_share"])
                    / r["core_share"] for p, r in lite.items()}
            rel, near = rels[path], min(rels.values())
            log(f"{label} {name} {path} against Lite: max fit gap "
                f"{gap:.3e} (tolerance 1e-4), core's energy share "
                f"{run['core_share']!r} against {want['core_share']!r} "
                f"(relative {rel:.3e}; against Lite's runs {rels}, the "
                f"nearer {near:.3e}, tolerance 2e-6)")
            if not (gap <= 1e-4 and near <= 2e-6):
                raise AssertionError(f"{label} {name} {path}: fits or core "
                                     f"energy off Lite's")
            rec["runs"][path] = {
                "steady_s": run["rerun"]["steady_s"],
                "first_steady_s": run["steady_s"],
                "setup_s": st.setup_s,
                "peak_gib": run["peak_bytes"] / 2**30,
                "fit": st.fits[-1], "fit_gap": gap, "core_rel": rel,
                "core_rel_nearer": near}
        rows[name] = rec
        del pl, dec, st
        gc.collect()
        torch.cuda.empty_cache()
    pick = min((c for c in AUTO_CANDIDATES if c in costs),
               key=lambda c: costs[c])
    log(f"{label}: auto would pick {pick} from the modeled seconds "
        f"{ {c: costs[c] for c in AUTO_CANDIDATES if c in costs} }")
    print(f"schemes {label} " + json.dumps(
        {"nnz": t.nnz, "shape": list(t.shape), "auto_pick": pick,
         "schemes": rows}), flush=True)
    return {"rows": rows, "auto": pick, "lite": lite}


def four_mode_entry(four: dict, name: str) -> dict:
    """The kernel's numbers at the four-mode shapes (K̂ = 1000) for the
    ``kernels`` line: ms, bound and launches per sweep on each path,
    ``torch.matmul``'s (``torch.bmm``'s stacked) time for an oracle half."""
    def avg(rows, key):
        return float(np.mean([r[key] for r in rows]))

    def worst(rows):
        return rows[int(np.argmax([r["bound"] for r in rows]))]["by"]

    sweeps = len(four["runs"]["liteopt"]["stats"].fits)
    out = {"launches_per_sweep": {
        "hooi": four["single"]["launches"][name]
        / four["single"]["invocations"],
        **{f"dist_{p}": four["runs"][p]["launches"][name] / sweeps
           for p in ("liteopt", "baseline")}}}
    single, dist = four["single_checks"], four["dist_checks"]
    if name == "kron_segsum":
        rows = single["kron_segsum"]
        out.update(ms=avg(rows, "ms"), bound_ms=avg(rows, "bound"),
                   bound_by=worst(rows), walk_ms=avg(rows, "walk_ms"),
                   fixup_ms=[r["fixup_ms"] for r in rows],
                   largest_row=[r["hub"] for r in rows])
    elif name == "kron_segsum_oracle":
        rows = dist["kron_segsum_oracle"]
        out.update(ms=avg(rows, "ms"), bound_ms=avg(rows, "bound"),
                   bound_by=worst(rows), s=DIST_BLOCK)
    else:
        rows, st = single["oracle_pair"], dist["stacked"]
        out.update(ms=avg(rows, "ms"), device_ms=avg(rows, "device_ms"),
                   plain_ms=avg(rows, "plain"), bound_ms=avg(rows, "bound"),
                   bound_by=worst(rows), library_ms=avg(rows, "lib"),
                   library_device_ms=avg(rows, "lib_device_ms"),
                   stacked={"s": DIST_BLOCK, "ms": avg(st, "ms"),
                            "device_ms": avg(st, "device_ms"),
                            "bound_ms": avg(st, "bound"),
                            "library_ms": avg(st, "lib")})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script runs the port on "
              "the card only", file=sys.stderr)
        return 1
    from repro_torch.data.tensors import synth_tensor
    from repro_torch.convert import device_coords
    from repro_torch.core import hooi
    from repro_torch.core.plan import plan_cache_clear
    from repro_torch.device import full_precision_matmul
    from repro_torch.distributed import executor
    from repro_torch.envknobs import snapshot
    from repro_torch.kernels import build
    from repro_torch.random import make_key

    smi = nvidia_smi_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(smi, flush=True)
    log(f"knobs (REPRO_* as resolved): {json.dumps(snapshot())}")
    full_precision_matmul()

    t0 = time.perf_counter()
    report = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {sorted(report)} "
        + ", ".join(f"{k} {v['seconds']:.2f} s" for k, v in report.items()))
    for name, info in report.items():
        for line in info["log"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas {name}: {line.strip()}")

    def release(before: str) -> None:
        # nothing of the phases before stays resident: their plans (held
        # by the caller and the plan cache), uploads and graphs, and the
        # shared executor's refine snapshots
        plan_cache_clear()
        executor._SHARED.clear()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"resident before {before}: "
            f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated, "
            f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB reserved")

    # four modes first: the profiler times its chunk walk and fix-up apart,
    # and late in the run (after many graph replays) its sessions recorded
    # none of those kernels
    four = phase_four_mode()
    release("the nell-2 phases")

    t0 = time.perf_counter()
    t = synth_tensor(MAIN_SHAPE, MAIN_NNZ, alphas=MAIN_ALPHAS, seed=0)
    log(f"main tensor: shape {t.shape} nnz {t.nnz} (of {MAIN_NNZ} drawn) "
        f"generated in {time.perf_counter() - t0:.1f} s")
    dev = torch.device(DEVICE)
    coords, values = device_coords(t, dev)
    factors = hooi.random_factors(t.shape, CORE, make_key(0), dev)

    errs = phase_kernel_checks(coords, values, factors, t.shape)
    errs["kron_segsum_oracle"] = phase_fused_checks(coords, values, factors,
                                                    t.shape)
    for checks in (four["single_checks"], four["dist_checks"]):
        for name, err in checks["err"].items():
            errs[name] = max(errs[name], err)
    del coords, values
    torch.cuda.empty_cache()

    dist = phase_dist(t)
    phase_dist_small()
    dist_replayed = phase_dist_profile(t, dist["plan"])
    dist_timing = phase_dist_timings(dist["plan"], dist["factors"])
    errs["kron_segsum_oracle"] = max(errs["kron_segsum_oracle"],
                                     dist_timing["err"])
    errs["oracle_pair"] = max(errs["oracle_pair"],
                              dist_timing["stacked_err"])
    torch.cuda.empty_cache()
    dist_sketch = phase_dist_sketch(t)
    phase_capture_bitwise(t, dist["plan"])
    calibration = phase_reuse_profile_and_calibration(t, dist["plan"])
    stoch = phase_stochastic(t, dist["plan"], dist["factors"], dist["fit"])
    log("CUT: the mesh rows run on the geometric-pad reselect plan only, "
        "not on this default-pad plan too (time)")
    schemes_full = phase_schemes(
        t, ("coarse", "medium"), "nell-2 size",
        lite={p: dist["runs"][p] for p in ("liteopt", "baseline")},
        lite_plan=dist["plan"])

    del dist["factors"], dist["plan"]
    release("the scheduler ladder")
    ladder = phase_scheduler(t, stoch)
    for name, err in ladder["hub"].items():
        errs[name] = max(errs[name], err)
    log(f"seed append {ladder['seed_append_s']:.3f} s; later appends "
        f"{[round(x, 3) for x in ladder['append_s']]} s")
    release("the pool phase")
    pool = phase_pool(ladder)
    mesh_geo = phase_mesh(pool.pop("snap"), pool.pop("plan"),
                          "geometric-pad reselect", bitwise=True)
    release("the scheme comparison at medium size")
    t0 = time.perf_counter()
    t1 = synth_tensor(MAIN_SHAPE, MEDIUM_NNZ, alphas=MAIN_ALPHAS, seed=0)
    log(f"medium tensor: nell-2's shape, {MEDIUM_NNZ} drawn under nell2-s's "
        f"skew, seed 0: {t1.nnz} unique, generated in "
        f"{time.perf_counter() - t0:.1f} s")
    schemes_medium = phase_schemes(t1, ("lite", "coarse", "medium",
                                        "hypergraph"), "medium size")
    del t1
    release("the single-process phases")

    main = phase_main_path(t)
    phase_small_checks()
    phase_profile(t)
    sketch = phase_sketch(t, main)
    phase_profile(t, warm_start="sketch")
    objectives = phase_objectives(t)
    phase_objective_matrix()

    coords, values = device_coords(t, dev)
    timing = phase_timings(coords, values, factors, t.shape)
    timing["kron_segsum_oracle"] = dist_timing["kron_segsum_oracle"]
    run = dist["runs"]["liteopt"]
    log(f"sweep seconds (steady): hooi {main['steady_s']:.4f}, sketch "
        f"{sketch['sketch']['steady_s']:.4f}, auto "
        f"{sketch['auto']['steady_s']:.4f}, completion "
        f"{objectives['completion']['steady_s']:.4f}, nn "
        f"{objectives['nn']['steady_s']:.4f}; dist liteopt "
        f"{run['steady_s']:.4f}, baseline "
        f"{dist['runs']['baseline']['steady_s']:.4f}, sketch "
        f"{dist_sketch['steady_s']:.4f}, liteopt rerun on the cached plan "
        f"{dist['runs']['captured']['steady_s']:.4f}; refines "
        + ", ".join(f"{r['wall_s']:.4f}" for r in stoch["refines"])
        + "; scheduler rungs (run_s) "
        + ", ".join(f"{r['decision']} {r['run_s']:.4f}"
                    for r in ladder["rungs"])
        + f"; precision='auto' after calibration: {calibration['auto']}"
        + "; schemes (replayed boundary, psum) "
        + ", ".join(f"{label} {name} {r['runs']['liteopt']['steady_s']:.4f}/"
                    f"{r['runs']['baseline']['steady_s']:.4f}"
                    for label, sch in (("nell-2", schemes_full),
                                       ("1M", schemes_medium))
                    for name, r in sch["rows"].items()
                    if "steady_s" in r["runs"]["liteopt"])
        + f"; four-mode hooi {four['single']['steady_s']:.4f}, dist "
        + ", ".join(f"{p} {four['runs'][p]['rerun']['steady_s']:.4f}"
                    for p in ("liteopt", "baseline")))
    dist_sweeps = len(run["stats"].fits)
    by_path = {
        name: {"hooi": main["launches"][name],
               "dist_liteopt": dist["runs"]["liteopt"]["launches"][name],
               "dist_baseline": dist["runs"]["baseline"]["launches"][name],
               "hooi_sketch": sketch["sketch"]["launches"][name],
               "hooi_auto": sketch["auto"]["launches"][name],
               "dist_sketch": dist_sketch["launches"][name],
               "dist_captured": dist["runs"]["captured"]["launches"][name],
               "dist_replayed_profiled": dist_replayed["launches"][name],
               "stochastic_refine": stoch["refines"][1]["launches"][name],
               "scheduler_ladder": ladder["launches"][name],
               "pool_router": pool["launches"][name],
               "hooi_completion": objectives["completion"]["launches"][name],
               "hooi_nn": objectives["nn"]["launches"][name],
               **{f"mesh geometric-pad {label}": rec["launches"][name]
                  for label, rec in mesh_geo["runs"].items()},
               "four_mode_hooi": four["single"]["launches"][name],
               **{f"four_mode_dist_{path}": four["runs"][path]["launches"][
                   name] for path in ("liteopt", "baseline")}}
        for name in ("kron_segsum", "kron_segsum_oracle", "oracle_pair")}
    log(f"launches by path: {by_path}; executions on the card in replayed "
        f"runs (profiler): dist {dist_replayed['executions']}, refine "
        f"{stoch['replayed']['executions']}; per sweep on dist liteopt: "
        + ", ".join(f"{k} {v / dist_sweeps:g}"
                    for k, v in run["launches"].items()))

    def mean(name, key):
        return float(np.mean([r[key] for r in timing[name]]))

    def bound_by(name):
        rows = timing[name]
        return rows[int(np.argmax([r["bound"] for r in rows]))]["by"]

    kernels = []
    for name, source, replaces in (
            ("kron_segsum", "src/repro_torch/kernels/csrc/kron_segsum.cu",
             "src/repro/kernels/kron_segsum.py:154"),
            ("oracle_pair", "src/repro_torch/kernels/csrc/oracle_pair.cu",
             "src/repro/kernels/oracle_fused.py:56"),
            ("kron_segsum_oracle",
             "src/repro_torch/kernels/csrc/kron_segsum.cu",
             "src/repro/kernels/kron_segsum.py:289")):
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": run["launches"][name],
            "launches_per_sweep": run["launches"][name] / dist_sweeps,
            "launches_by_path": by_path[name],
            # the scheduler ladder's wrapper launches, by group of rungs
            # (a reuse rung is submitted behind the rung before it)
            "launches_by_rung": {
                "+".join(str(k) for k in g["rungs"]): g[name]
                for g in ladder["launches_by_group"]},
            # executions on the card, read from the profiler, in a replayed
            # invocation and a cached refine (the wrappers' counts there
            # are in launches_by_path)
            "executions_replayed": {
                "dist_replayed_profiled": dist_replayed["executions"][name],
                "stochastic_refine_cached":
                    stoch["replayed"]["executions"][name]},
            # per replayed sweep of a captured mesh's rows: the launches
            # its captures recorded, and the core's
            "mesh_replayed_per_sweep": {
                f"geometric-pad {label}": rec["executions_per_sweep"][name]
                for label, rec in mesh_geo["captured_runs"].items()},
            "max_abs_err": errs[name], "ms": mean(name, "ms"),
            "plain_ms": mean(name, "plain"), "bound_ms": mean(name, "bound"),
            "bound_by": bound_by(name),
            "library_ms": mean(name, "lib") if name == "oracle_pair"
            else None,
        }
        if name == "oracle_pair":
            stacked = dist_timing["stacked"]
            entry.update(
                device_ms=mean(name, "device_ms"),
                zx_device_ms=mean(name, "zx_device_ms"),
                zty_device_ms=mean(name, "zty_device_ms"),
                library_device_ms=mean(name, "lib_device_ms"),
                stacked={k: float(np.mean([r[k] for r in stacked]))
                         for k in stacked[0]},
                sketch_panel=dict(
                    s=SKETCH_PANEL, ms=mean("oracle_pair_s10", "ms"),
                    device_ms=mean("oracle_pair_s10", "device_ms"),
                    zx_device_ms=mean("oracle_pair_s10", "zx_device_ms"),
                    zty_device_ms=mean("oracle_pair_s10", "zty_device_ms"),
                    plain_ms=mean("oracle_pair_s10", "plain"),
                    bound_ms=mean("oracle_pair_s10", "bound"),
                    library_ms=mean("oracle_pair_s10", "lib"),
                    library_device_ms=mean("oracle_pair_s10",
                                           "lib_device_ms"),
                    stacked={k: float(np.mean([r[k] for r in
                                               dist_timing["stacked_s10"]]))
                             for k in dist_timing["stacked_s10"][0]}))
        else:  # the gather form's numbers, then the row form's
            entry.update(
                form="gather", row_form_ms=mean(name, "row_ms"),
                row_form_bound_ms=mean(name, "row_bound"),
                split_ab_plus_row_form_ms=mean(name, "split_row_ms"))
        entry["four_mode"] = four_mode_entry(four, name)
        if name == "kron_segsum_oracle":
            entry["kron_segsum_plus_matmul_ms"] = mean(name, "two")
            entry["range_finder_panel"] = dict(
                s=RANGE_PANEL, ms=mean("kron_segsum_oracle_s14", "ms"),
                plain_ms=mean("kron_segsum_oracle_s14", "plain"),
                bound_ms=mean("kron_segsum_oracle_s14", "bound"),
                bound_by=bound_by("kron_segsum_oracle_s14"))
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
