"""One cell, one run: set-up, warm-up, the measured window, the check.

The harness is driven by data. A cell of ``BENCHMARK.json`` names a
configuration (``configs/<config>.json``: the tensor's shape, nonzeros,
skew and core) and a traffic mix (``workloads/<traffic>.json``: the entry
kind and its knobs). The code that drives an entry kind is
``entries/<entry>.py``, each per-layer metric's reader is
``metrics/<metric>.py`` and the limits of a cell's check are
``limits/<cell>.json``. A later cell, entry kind or metric is added as
files; no file here names one.

The window is a closed loop with one client: decompositions of the same
tensor, each started when the previous one returns, until ``--seconds``
are up; the last one runs to its end. ``--trace 1`` instead profiles the
traffic's ``trace_decompositions`` decompositions right after warm-up and
reports the per-layer metrics.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from tuckerbench import gen, roofline, trace as tracing
from tuckerbench.inputs import Draws, derive, init_factors, start_panel
from tuckerbench.reference import partition as ref_partition
from tuckerbench.reference import tucker as ref

__all__ = ["Spec", "load_spec", "run", "forbidden_modules", "FORBIDDEN",
           "BenchError"]

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke")
CONTROLS = ("bf16",)


class BenchError(RuntimeError):
    """A run that cannot report: it prints no result and exits non-zero."""


def log(msg: str) -> None:
    print(f"[tuckerbench] {msg}", file=sys.stderr, flush=True)


# ------------------------------------------------------------ finding files
class Spec:
    """A cell with everything it names, read from files."""

    def __init__(self, cell: dict, config: dict, traffic: dict,
                 e2e: list, per_layer: list, limits: dict):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.e2e, self.per_layer, self.limits = e2e, per_layer, limits


def _read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise BenchError(f"no file for {what}: {path}")
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(name: str, root: Path = ROOT) -> Spec:
    """The cell ``name`` of ``root/BENCHMARK.json`` and its files."""
    bench = _read_json(root / "BENCHMARK.json", "the benchmark")
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"unknown cell {name!r}; the benchmark has "
                         f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in configs:
        raise BenchError(f"cell {name} names unknown configuration "
                         f"{cell['config']!r}")
    config = _read_json(root / configs[cell["config"]]["file"],
                        f"configuration {cell['config']}")
    traffic = _read_json(HERE / "workloads" / f"{cell['traffic']}.json",
                         f"traffic {cell['traffic']}")
    limits = _read_json(HERE / "limits" / f"{name}.json",
                        f"the limits of {name}")
    e2e = [m for m in bench["end_to_end"] if _in_cell(m, name)]
    per_layer = [m for m in bench["per_layer"] if _in_cell(m, name)]
    return Spec(cell, config, traffic, e2e, per_layer, limits)


def _load_module(path: Path, name: str):
    if not path.is_file():
        raise BenchError(f"no file for {name}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"tuckerbench_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry_module(kind: str):
    return _load_module(HERE / "entries" / f"{kind}.py", f"entry {kind}")


def metric_module(name: str):
    return _load_module(HERE / "metrics" / f"{name}.py", f"metric {name}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    the benchmark may not load."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


# ---------------------------------------------------------------- devices
def _device_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60, check=True)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError,
            IndexError) as e:
        log(f"power limit not read: {e!r}")
    return info


def _find_device(chips: int) -> torch.device:
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: this benchmark runs on the card "
                         "only")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------- the run
class Context:
    """What the per-layer readers read (see ``metrics/``)."""

    def __init__(self, records, summary, zbuilds, oracle_calls, setup):
        self.records = records
        self.setup = setup  # the entry's set-up timings (``setup_metrics``)
        self.trace = summary
        self.zbuilds = zbuilds
        self.oracle_calls = oracle_calls
        self.sweeps = sum(len(r["sweep_s"]) for r in records)
        self.log = log
        self.roofline = roofline
        self.kernel_records = tracing.kernel_records


def _make_tensor(config: dict, seed: int, device: torch.device):
    from repro_torch.core.coo import SparseTensor

    t0 = time.perf_counter()
    coords, values = gen.draw_tensor(
        config["shape"], int(config["nnz"]), config["alphas"],
        hub_fraction=float(config.get("hub_fraction", 0.0)),
        hub_modes=tuple(config.get("hub_modes", ())),
        seed=derive(seed, "tensor"), device=device)
    t = SparseTensor(coords, values, tuple(config["shape"]))
    log(f"tensor {config['name']}: shape {t.shape}, {t.nnz} distinct "
        f"nonzeros, drawn in {time.perf_counter() - t0:.2f} s")
    return t


def _decompose(driver, seed: int, index, shape, core, device,
               in_window: bool = True) -> dict:
    """One decomposition with its own inputs; returns its record. Inside
    the window, set-up work (compilations, captures, uploads) is a fault."""
    from tuckerbench.program import Recorder

    init = init_factors(shape, core, derive(seed, "init", index), device)
    rec = Recorder()
    try:
        with record_function("tuckerbench.decompose"):
            out = driver.decompose(
                init, Draws(derive(seed, "lanczos", index)), rec)
    except Exception as e:  # a decomposition that raises has failed
        log(f"decomposition {index} raised {type(e).__name__}: {e}")
        return {"index": index, "failed": f"{type(e).__name__}: {e}"}
    out["index"] = index
    fits = out["fits"]
    failed = None
    if not fits or not all(math.isfinite(f) for f in fits):
        failed = f"fits not finite: {fits}"
    elif in_window and any(out["paid"].values()):
        failed = f"set-up work inside the window: {out['paid']}"
    log(f"decomposition {index}: {out['wall_s']:.4f} s, sweeps "
        f"{[round(x, 4) for x in out['sweep_s']]}")
    if failed:
        log(f"decomposition {index} failed: {failed}")
    out["failed"] = failed
    # keep what the check follows: the first step and the last two sweeps
    N, S = len(shape), len(out["sweep_s"])
    steps = rec.steps
    out["steps"] = {j: steps[j] for j in
                    [0] + list(range(max(S - 2, 0) * N, S * N))
                    if j < len(steps)}
    return out


def _step_inputs(rec: dict, init, it: int, n: int, N: int) -> list:
    facs = []
    for j in range(N):
        if j == n:
            facs.append(None)
        elif j < n:
            facs.append(rec["steps"][it * N + j])
        else:
            facs.append(init[j] if it == 0 else rec["steps"][(it - 1) * N + j])
    return facs


def _check(spec: Spec, t, rec: dict, parts, seed: int, device,
           control: str | None) -> dict:
    """The compared numbers of one decomposition (and, for a distributed
    cell, of the plan's partitions)."""
    core = tuple(int(k) for k in spec.config["core_dims"])
    N, shape = len(core), t.shape
    tr = spec.traffic
    t0 = time.perf_counter()
    coords = torch.from_numpy(t.coords).to(device)
    values = torch.from_numpy(np.asarray(t.values, np.float64)).to(device)
    numbers = {}
    if parts is not None:
        key = ref_partition.key(coords, shape)  # sorted: drawn so
        numbers["partition_mismatch"] = sum(
            ref_partition.mismatches(ranks, key, values, shape, device)
            for ranks in parts)
        del key
    init = init_factors(shape, core, derive(seed, "init", rec["index"]),
                        device)
    S = len(rec["sweep_s"])
    checked = [(0, 0)] + [(S - 1, n) for n in range(N)]
    dseed = derive(seed, "lanczos", rec["index"])
    worst = 0.0
    Z_last = None
    for it, n in checked:
        facs = _step_inputs(rec, init, it, n, N)
        facs[n] = torch.zeros((shape[n], core[n]), device=device)
        order = torch.argsort(coords[:, n])
        Z = ref.penultimate(coords, values, facs, n, shape[n], order)
        khat = int(Z.shape[1])
        s, blocks, _ = roofline.lanczos_shape(
            core[n], shape[n], khat, int(tr["lanczos_block"]),
            bool(tr["fused_zbuild"]))
        X = start_panel(dseed, it, N, n, khat, s).to(device)
        U, Sv = ref.krylov_left(Z, X, blocks)
        got = ref.step_numbers(rec["steps"][it * N + n], U, Sv)
        log(f"step (sweep {it}, mode {n}): {got}")
        worst = max(worst, got["deficit"])
        if (it, n) == (S - 1, N - 1):
            Z_last, order_last = Z, order
        del Z, U
    numbers["step_deficit"] = worst
    norm2 = float(torch.sum(values ** 2))
    F_last = rec["steps"][(S - 1) * N + N - 1]
    G = ref.core_of(F_last, Z_last, core)
    got_core = rec["dec"].core.to(torch.float64)
    numbers["core_rel"] = float(torch.linalg.norm(got_core - G)
                                / torch.linalg.norm(G))
    numbers["fit_gap"] = abs(rec["fits"][-1] - ref.fit_of(norm2, G))
    if control == "bf16":
        # the reference put in the program's place at bf16: its core and fit
        facs = _step_inputs(rec, init, S - 1, N - 1, N)
        facs[N - 1] = F_last
        Zb = ref.penultimate(coords, values, facs, N - 1, shape[N - 1],
                             order_last, precision="bf16")
        Gb = ref.core_of(F_last, Zb, core)
        numbers["core_rel"] = float(torch.linalg.norm(Gb - G)
                                    / torch.linalg.norm(G))
        numbers["fit_gap"] = abs(ref.fit_of(norm2, Gb) - ref.fit_of(norm2, G))
    log(f"reference check of decomposition {rec['index']}: "
        f"{time.perf_counter() - t0:.2f} s")
    return numbers


def run(spec: Spec, seed: int, seconds: float, trace: bool,
        t_start: float, device: torch.device | None = None,
        control: str | None = None) -> dict:
    """One run of a cell; returns the result line's object. ``device``
    None looks for the card (and fails without one); tests pass a CPU
    device. ``control`` runs the lower-precision control instead of the
    program as configured: its ``correct`` must come out false."""
    if device is None:
        device = _find_device(int(spec.cell["chips"]))
    if control is not None and control not in CONTROLS:
        raise BenchError(f"unknown control {control!r}")
    config, traffic = spec.config, dict(spec.traffic)
    if control == "bf16":
        traffic["precision"] = "bf16"
    core = tuple(int(k) for k in config["core_dims"])
    entry = entry_module(traffic["entry"])
    readers = {m["name"]: metric_module(m["name"]) for m in spec.per_layer} \
        if trace else {}

    t = _make_tensor(config, seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    driver = entry.prepare(t, core, traffic, device)
    w0 = time.perf_counter()
    warm = _decompose(driver, seed, "warm", t.shape, core, device,
                      in_window=False)
    if warm["failed"]:
        raise BenchError(f"warm-up decomposition failed: {warm['failed']}")
    log(f"warm-up decomposition: {time.perf_counter() - w0:.3f} s, set-up "
        f"work {warm['paid']}")
    del warm
    _sync(device)

    records, summary = [], None
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(int(traffic["trace_decompositions"])):
                records.append(_decompose(driver, seed, i, t.shape,
                                          core, device))
            _sync(device)
            window_s = time.perf_counter() - t0
        summary = tracing.summarize(prof, window_s)
        del prof
    else:
        i = 0
        while True:
            records.append(_decompose(driver, seed, i, t.shape, core,
                                      device))
            i += 1
            if time.perf_counter() - t_window >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t_window
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    done = [r for r in records if not r["failed"]]
    log(f"window: {len(records)} decompositions, {len(done)} completed, "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s; peak "
        f"{peak / 2**30:.3f} GiB")

    metrics = {}
    if trace:
        st = driver.structure()
        ctx = Context(done, summary,
                      roofline.sweep_zbuilds(
                          t.shape, core, t.nnz, int(traffic["lanczos_block"]),
                          bool(traffic["fused_zbuild"]), st["z_rows"],
                          st["rows_with_elements"]),
                      roofline.sweep_oracle_calls(
                          t.shape, core, int(traffic["lanczos_block"]),
                          bool(traffic["fused_zbuild"]), st["z_rows"]),
                      driver.setup_metrics)
        for m in spec.per_layer:
            value = readers[m["name"]].read(ctx) if done else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif done:
        measured = {"decomp_s": window_s / len(done),
                    "peak_gib": peak / 2 ** 30, "setup_s": setup_s,
                    **driver.setup_metrics}
        for m in spec.e2e:
            if m["name"] in measured:
                metrics[m["name"]] = {"value": measured[m["name"]],
                                      "unit": m["unit"]}

    # the check, once the window has closed and the peak is read
    parts = driver.partitions()
    driver.release()
    del driver
    numbers = {}
    if done:
        pick = done[derive(seed, "sample") % len(done)]
        for r in records:
            if r is not pick:
                r.clear()
        _release_program(device)
        numbers = _check(spec, t, pick, parts, seed, device, control)
    del parts
    checks = {}
    correct = bool(done) and len(done) == len(records)
    for name, limit in spec.limits["limits"].items():
        if name not in numbers:
            continue
        checks[name] = {"value": numbers[name], "limit": limit}
        if not numbers[name] <= limit:
            correct = False
    if spec.limits["limits"].keys() - numbers.keys() and done:
        missing = sorted(spec.limits["limits"].keys() - numbers.keys())
        raise BenchError(f"no reading for the limits {missing}")
    device_info = _device_info(device)
    device_info["memory_peak_bytes"] = int(peak)
    if trace:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    result = {"correct": correct, "attempted": len(records),
              "failed": len(records) - len(done), "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": summary["top_device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    if control is not None:
        result["control"] = control
    result["checks"] = checks
    return result


def _release_program(device) -> None:
    from tuckerbench.program import release

    release()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
