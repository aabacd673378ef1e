"""Decomposition-as-a-service: pooled executors, routing, SLOs.

The port of ``examples/serve_pool.py``. Spins up an ExecutorPool (P=2
ranks stacked on each lane's device), fronts it with a StreamRouter, and
serves a mix of traffic classes:

  * interactive streams with tight SLO deadlines,
  * batch tensors that the router may refuse under load (PoolSaturated:
    backpressure surfaces to the caller, nothing queues unboundedly),
  * a growing stream that is rerouted between lanes while it is served,
    carrying its partition plan via PartitionPlan.save()/load() so the new
    lane replays it warm (the refresh ladder reports "reuse", not a
    re-plan).

On the card the pool has one lane per CUDA device; the reroute needs two
lanes and is skipped, saying so, on a machine with one card. With
``--device cpu`` it has two lanes on the CPU, as the reference has two
slices of its simulated host devices. Work never moves to the CPU on its
own.

Ends by printing the PoolStats aggregate: per-lane completions, SLO
hit/miss counts, admission rejections and the routing decisions taken.

  PYTHONPATH=src python -m repro_torch.examples.serve_pool [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.data.tensors import synth_tensor
from repro_torch.engine import ExecutorPool, PoolSaturated, StreamRouter
from repro_torch.streaming import StreamingTensor

CORE = (6, 6, 6)
CPU_LANES = 2  # the reference's pool: 2 executors


def make_stream(seed: int, name: str) -> StreamingTensor:
    t = synth_tensor((120, 100, 90), 8_000, alphas=(1.2, 1.05, 1.05),
                     hub_fraction=0.1, hub_modes=(0,), seed=seed)
    return StreamingTensor.from_tensor(t, name=name)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: one lane per CUDA device (default); cpu: "
                    f"{CPU_LANES} lanes on the CPU")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        n_lanes, devices = CPU_LANES, ["cpu"] * CPU_LANES
    else:
        if not torch.cuda.is_available():
            raise SystemExit("serve_pool: no CUDA device; pass --device cpu "
                             "to serve from lanes on the CPU")
        n_lanes, devices = torch.cuda.device_count(), None
    rng = np.random.default_rng(0)
    with ExecutorPool(n_lanes, 2, CORE, devices=devices, workers=2,
                      n_invocations=1, pad_geometric=True) as pool:
        router = StreamRouter(pool, max_pending=8)
        print(f"== pool: {pool.n_lanes} lanes on "
              + ", ".join(str(l.devices[0]) for l in pool.lanes) + " ==")

        print("== mixed traffic: 4 interactive streams + batch one-shots ==")
        streams = [make_stream(s, f"client-{s}") for s in range(4)]
        for s in streams:
            router.submit(s, priority="interactive", deadline_s=120.0)
        rejected = 0
        for s in range(8):  # batch tries to pile on behind them
            try:
                router.submit(synth_tensor((80, 70, 60), 3_000, seed=50 + s),
                              priority="batch", deadline_s=120.0)
            except PoolSaturated as e:
                rejected += 1
                print(f"  batch submit refused: {e}")
        for r in router.drain():
            print(f"  {r.name:>10s}  lane={r.stats.lane}  "
                  f"decision={r.decision:<6s}  "
                  f"queue_wait={r.queue_wait_s:.2f}s  slo_met={r.slo_met}")

        print("\n== streams are sticky: resubmits replay warm ==")
        for s in streams:
            router.submit(s, priority="interactive", deadline_s=120.0)
        for r in router.drain():
            print(f"  {r.name:>10s}  lane={r.stats.lane}  "
                  f"decision={r.decision:<6s}  "
                  f"new_steps={r.stats.step_compilations}  "
                  f"captures={r.stats.step_captures}  "
                  f"uploads={r.stats.uploads}")

        s0 = streams[0]
        if pool.n_lanes > 1:
            print("\n== warm-start reroute: move client-0 to another lane ==")
            new_lane = router.reroute(s0)  # plan carried via save()/load()
            r = router.submit(s0, priority="interactive").result()
            print(f"  client-0 now on lane {new_lane}: "
                  f"decision={r.decision}  "
                  f"new_steps={r.stats.step_compilations}  "
                  f"captures={r.stats.step_captures}  "
                  f"uploads={r.stats.uploads}")
        else:
            print("\n== warm-start reroute: skipped, it needs two lanes and "
                  "this pool has one ==")

        batch = np.stack([rng.integers(0, L, 200)
                          for L in s0.shape], axis=1)
        s0.append(batch, rng.standard_normal(200))  # it keeps growing
        r = router.submit(s0, priority="interactive").result()
        drift = (r.stats.stream_drift or {}).get("worst", float("nan"))
        print(f"  after an appended batch: decision={r.decision}  "
              f"drift_worst={drift:.3f} (the ladder continues on lane "
              f"{r.stats.lane})")

        st = router.stats()
        print("\n== PoolStats ==")
        print(f"  lanes={st.n_lanes}  submitted={st.submitted}  "
              f"completed={st.completed}  failed={st.failed}")
        print(f"  slo: {st.slo_hit} hit / {st.slo_miss} miss   "
              f"rejected={st.rejected} {st.rejected_by_priority}   "
              f"rerouted={st.rerouted}")
        print(f"  decisions={st.decisions}")
        for ls in st.lane_stats:
            print(f"  lane: completed={ls['completed']}  "
                  f"host_s={ls['host_s']:.2f}  device_s={ls['device_s']:.2f}  "
                  f"queue_wait_s={ls['queue_wait_s']:.2f}")
        router.close()


if __name__ == "__main__":
    main()
