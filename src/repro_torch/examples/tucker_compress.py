"""Tucker-compress an embedding-style weight table with the paper's machinery.

The port of ``examples/tucker_compress.py``. Synthesizes a
low-rank-plus-noise embedding table (the spectrum trained token embeddings
actually have), reshapes it to a 3-way tensor, sparsifies by magnitude
(top-k%), and runs the sparse Tucker pipeline: real-time scheme selection,
the distributed executor (P=8 ranks stacked on one device) with its reuse
caches, measured calibration, and finally the streaming scheduler serving
a stream of updated tables with host partitioning overlapped against
device sweeps.

  PYTHONPATH=src python -m repro_torch.examples.tucker_compress [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.calibrate import fit_cost_model, set_cost_model
from repro_torch.core.coo import SparseTensor
from repro_torch.core.hooi import hooi
from repro_torch.core.plan import plan
from repro_torch.distributed.executor import HooiExecutor
from repro_torch.engine.scheduler import StreamScheduler
from repro_torch.streaming import StreamingTensor

P_EXEC = 8  # ranks stacked on the executor's device


def make_table(V: int = 4096, d1: int = 16, d2: int = 16,
               seed: int = 0, noise: float = 0.02) -> np.ndarray:
    """A (V, d1*d2) embedding table with genuine Tucker structure.

    Trained embeddings factor into token clusters x feature subspaces; we
    emulate that spectrum directly: a rank-(16,4,4) Tucker tensor over the
    reshaped table plus a small dense residual.
    """
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((16, 4, 4))
    A = rng.standard_normal((V, 16)) / 4
    B = rng.standard_normal((d1, 4)) / 2
    C = rng.standard_normal((d2, 4)) / 2
    T = np.einsum("abc,ia,jb,kc->ijk", G, A, B, C)
    T += rng.standard_normal(T.shape) * noise
    return T.astype(np.float32).reshape(V, d1 * d2)


def sparsify(W: np.ndarray, keep: float = 0.20) -> SparseTensor:
    """Reshape (V, d) -> (V, d1, d2) and keep the top-|keep| magnitudes."""
    V, d = W.shape
    d1 = int(np.sqrt(d))
    while d % d1:
        d1 -= 1
    T3 = W.reshape(V, d1, d // d1)
    thresh = np.quantile(np.abs(T3), 1.0 - keep)
    return SparseTensor.fromdense(T3 * (np.abs(T3) > thresh))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the sweeps run (default: the card)")
    dev = ap.parse_args(argv).device

    W = make_table()
    V, d = W.shape
    print(f"[compress] embedding table {V}x{d} "
          f"({W.size * 4 / 1e6:.2f} MB fp32)")
    t = sparsify(W)
    print(f"[compress] sparsified: {t}")

    core_dims = (32, 4, 4)
    dec, fits = hooi(t, core_dims, n_invocations=4, seed=0, device=dev)
    dense_bytes = t.nnz * (8 + 3 * 8)
    tucker_bytes = (int(np.prod(core_dims))
                    + sum(t.shape[n] * core_dims[n] for n in range(3))) * 4
    print(f"[compress] fit={fits[-1]:.4f}  "
          f"sparse-COO {dense_bytes/1e6:.2f} MB -> Tucker "
          f"{tucker_bytes/1e6:.2f} MB ({dense_bytes/tucker_bytes:.1f}x)")

    # distribution quality for the compression job itself at P=16: the
    # real-time selector picks the scheme; candidate plans land in the plan
    # cache, so the per-scheme report below costs no extra partitioning.
    P = 16
    auto = plan(t, "auto", P, core_dims=core_dims)
    print(f"[compress] auto selector picked {auto.name!r} "
          f"(modeled s/invocation: "
          + ", ".join(f"{c}={v:.2e}" for c, v in auto.candidates.items())
          + f"; built in {auto.build_s*1e3:.0f} ms)")
    for name in ("lite", "coarse"):
        sm = plan(t, name, P, core_dims=core_dims).metrics
        print(f"[compress] scheme={name:7s} "
              f"E_imb={max(m.ttm_imbalance for m in sm.per_mode):.2f} "
              f"R_red={max(m.svd_redundancy for m in sm.per_mode):.2f}")
    assert fits[-1] > 0.15, "Tucker failed to capture structure"

    # run the compression distributed on the engine: the second run (e.g.
    # recompressing after a fine-tune step) reuses the cached mode steps
    # and the device-resident partition arrays: nothing built, nothing
    # moved host->device
    ex = HooiExecutor(P_EXEC, dev)
    # path="auto": the plan also scores the comm backends (psum vs
    # boundary) per mode and the engine runs the modelled-cheapest one
    pl8 = plan(t, "auto", P_EXEC, core_dims=core_dims, path="auto")
    print(f"[compress] comm backends per mode: "
          f"{','.join(pl8.cost.mode_backends)} "
          f"(modeled comm s: "
          + ", ".join(f"{b}={v:.2e}" for b, v in pl8.cost.backend_s.items())
          + ")")
    _, st1 = ex.run(t, core_dims, pl8, n_invocations=2, seed=0, path="auto")
    _, st2 = ex.run(t, core_dims, pl8, n_invocations=2, seed=1, path="auto")
    print(f"[compress] executor run 1: fit={st1.fits[-1]:.4f} "
          f"built {st1.step_compilations} mode steps, "
          f"captured {st1.step_captures}, uploaded {st1.uploads} arrays")
    print(f"[compress] executor run 2: fit={st2.fits[-1]:.4f} "
          f"new steps={st2.step_compilations}, "
          f"new captures={st2.step_captures}, "
          f"new uploads={st2.uploads} (cached plan)")
    assert (st2.step_compilations, st2.step_captures, st2.uploads) == \
        (0, 0, 0)

    # probe the per-phase split (TTM Z build vs Lanczos/SVD), then calibrate
    # the analytic selector from the measured sweeps and re-score: with
    # separable phase columns the fit returns distinct TTM/SVD rates, and
    # auto trades E_max against R_max under the rates this machine achieves
    prof = ex.profile_phases(t, core_dims, pl8, repeats=2)
    print(f"[compress] phase profile: ttm={prof['ttm_s']*1e3:.1f} ms "
          f"svd={prof['svd_s']*1e3:.1f} ms per sweep "
          f"(kernel={any(prof['z_kernel'].values())})")
    samples = [s for s in ex.calibration_samples() if s["warm"]]
    cm = set_cost_model(fit_cost_model(samples))
    recal = plan(t, "auto", P_EXEC, core_dims=core_dims)
    rt, rs = cm.phase_rates()
    print(f"[compress] calibrated {cm.source}: "
          f"flop_rate={cm.flop_rate:.2e} flop/s "
          f"(ttm={rt:.2e}, svd={rs:.2e}) -> "
          f"auto picks {recal.name!r} "
          f"(modeled {recal.cost.total_s:.2e} s/invocation, "
          f"ttm {recal.cost.ttm_s:.2e} + svd {recal.cost.svd_s:.2e})")
    set_cost_model(None)

    # ---- serve a STREAM of recompressions through the scheduler ---------
    # the fine-tune loop keeps nudging weights: each batch is a set of
    # value updates at existing coordinates. The scheduler overlaps the
    # host-side refresh (invalidation check + policy extension + staging)
    # of update k+1 with the device sweeps of update k, and only reruns
    # the auto selector when the §4 imbalance actually drifts.
    print("[stream] serving 3 table updates through StreamScheduler")
    rng = np.random.default_rng(1)
    stream = StreamingTensor.from_tensor(t, name="embeddings")
    with StreamScheduler(ex, core_dims, n_invocations=1,
                         path="liteopt") as sched:
        futs = [sched.submit(stream, seed=0)]
        for k in range(1, 3):
            idx = rng.integers(0, t.nnz, 200)  # touch existing coordinates
            stream.append(t.coords[idx], rng.standard_normal(200) * 0.01)
            futs.append(sched.submit(stream, seed=k))
        for r in (f.result() for f in futs):
            print(f"[stream] v{r.stream_version}: decision={r.decision:11s} "
                  f"fit={r.fits[-1]:.4f} prep={r.prepare_s*1e3:.0f}ms "
                  f"run={r.run_s*1e3:.0f}ms "
                  f"new_steps={r.stats.step_compilations} "
                  f"captures={r.stats.step_captures} "
                  f"hot_path_uploads={r.stats.uploads}")
        st = sched.stats()
    print(f"[stream] pipeline: wall={st['wall_s']:.2f}s vs "
          f"host {st['host_s']:.2f}s + device {st['device_s']:.2f}s "
          f"(overlap hid {st['overlap_s']:.2f}s); decisions={st['decisions']}")


if __name__ == "__main__":
    main()
