"""sweep.outside_s: per decomposition, its wall seconds less its sweeps'
mode steps: the call's set-up, each sweep's core and fit (the host's
||T||² pass included) and what surrounds them. Mean over the traced
decompositions. Layer: the sweep loop's finalize (``engine/objective.py``,
``core/ttm.py``)."""


def read(ctx):
    vals = [r["wall_s"] - sum(r["sweep_s"]) for r in ctx.records]
    return sum(vals) / len(vals) if vals else None
