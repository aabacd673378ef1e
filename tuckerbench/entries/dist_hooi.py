"""Entry kind ``dist_hooi``: a decomposition distributed over P ranks
stacked on the device, on a plan built once in set-up.

Set-up builds the plan with one ``repro_torch.core.plan.plan`` call (timed
on the host clock as ``plan_s``, which the per-layer metric
``plan.build_s`` reports); each decomposition is one
``repro_torch.distributed.dist_hooi.dist_hooi`` call on that plan. A call
that compiles, captures or uploads anything once set-up is done is a fault
of the executor's step cache, not a cost.
"""

from __future__ import annotations

import time

__all__ = ["prepare"]


class Driver:
    def __init__(self, t, core_dims, traffic: dict, device):
        from repro_torch.core.plan import plan

        self.t = t
        self.core_dims = tuple(int(k) for k in core_dims)
        self.traffic = traffic
        self.device = device
        t0 = time.perf_counter()
        self.plan = plan(t, traffic["scheme"], int(traffic["P"]),
                         core_dims=self.core_dims,
                         path=traffic.get("plan_path", "liteopt"))
        self.setup_metrics = {"plan_s": time.perf_counter() - t0}

    def decompose(self, init, draw, objective) -> dict:
        from repro_torch.distributed.dist_hooi import dist_hooi

        tr = self.traffic
        t0 = time.perf_counter()
        dec, st = dist_hooi(
            self.t, self.core_dims, int(tr["P"]), scheme=self.plan,
            n_invocations=int(tr["n_invocations"]), path=tr["path"],
            lanczos_block=int(tr["lanczos_block"]),
            fused_zbuild=bool(tr["fused_zbuild"]),
            use_fused_oracle=bool(tr["use_fused_oracle"]),
            precision=tr["precision"], warm_start=tr["warm_start"],
            init=init, draw=draw,
            objective=objective, device=self.device)
        wall = time.perf_counter() - t0
        paid = {"compilations": st.step_compilations,
                "captures": st.step_captures, "uploads": st.uploads}
        return {"dec": dec, "fits": list(st.fits),
                "sweep_s": list(st.sweep_s), "call_setup_s": st.setup_s,
                "wall_s": wall, "paid": paid}

    def structure(self) -> dict:
        """Rows each mode's Z-build writes and its Lanczos products read:
        the stacked ranks' real local rows."""
        rows = [int(mp.r_per_rank.sum()) for mp in self.plan.parts]
        return {"z_rows": rows, "rows_with_elements": rows}

    def partitions(self) -> list:
        """Per mode, per rank: (coordinates, values, real elements)."""
        return [[(mp.coords[p], mp.values[p], mp.e_per_rank[p])
                 for p in range(mp.P)] for mp in self.plan.parts]

    def release(self) -> None:
        self.plan = None


def prepare(t, core_dims, traffic: dict, device) -> Driver:
    return Driver(t, core_dims, traffic, device)
