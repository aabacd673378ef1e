"""Entry kind ``hooi``: the single-process decomposition, eager, through
``repro_torch.core.hooi.hooi``. No plan, no executor, no captured steps."""

from __future__ import annotations

import time

__all__ = ["prepare"]


class Driver:
    def __init__(self, t, core_dims, traffic: dict, device):
        self.t = t
        self.core_dims = tuple(int(k) for k in core_dims)
        self.traffic = traffic
        self.device = device
        self.setup_metrics = {}

    def decompose(self, init, draw, objective) -> dict:
        from repro_torch.core.hooi import hooi

        tr = self.traffic
        sweep_s = []
        t0 = time.perf_counter()
        dec, fits = hooi(
            self.t, self.core_dims, n_invocations=int(tr["n_invocations"]),
            init=init, use_fused_oracle=bool(tr["use_fused_oracle"]),
            precision=tr["precision"], warm_start=tr["warm_start"],
            lanczos_block=int(tr["lanczos_block"]),
            fused_zbuild=bool(tr["fused_zbuild"]), objective=objective,
            device=self.device, draw=draw,
            on_sweep=lambda it, seconds, fit: sweep_s.append(seconds))
        wall = time.perf_counter() - t0
        return {"dec": dec, "fits": list(fits), "sweep_s": sweep_s,
                "call_setup_s": None, "wall_s": wall, "paid": {}}

    def structure(self) -> dict:
        """Rows each mode's Z-build writes and its Lanczos products read:
        the mode's length. (Rows that hold elements matter to the fused
        build only, which this entry does not run.)"""
        rows = [int(L) for L in self.t.shape]
        return {"z_rows": rows, "rows_with_elements": rows}

    def partitions(self) -> None:
        return None

    def release(self) -> None:
        pass


def prepare(t, core_dims, traffic: dict, device) -> Driver:
    return Driver(t, core_dims, traffic, device)
