"""sweep.steps_s: seconds of one sweep's mode steps up to the device
finishing them, as the program reports them (``DistHooiStats.sweep_s``;
``hooi``'s ``on_sweep`` seconds), mean over every sweep of the traced
decompositions. Layer: the sweep loop (``engine/sweep.py``,
``core/hooi.py``)."""


def read(ctx):
    vals = [s for r in ctx.records for s in r["sweep_s"]]
    return sum(vals) / len(vals) if vals else None
