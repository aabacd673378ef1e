"""executor.call_setup_s: host seconds from a dist_hooi call's start to its
first sweep on the built plan (initial factors, cached steps and uploads
looked up), ``DistHooiStats.setup_s``, mean over the traced
decompositions. Layer: the executor (``distributed/executor.py``,
``distributed/dist_hooi.py``)."""


def read(ctx):
    vals = [r["call_setup_s"] for r in ctx.records
            if r.get("call_setup_s") is not None]
    return sum(vals) / len(vals) if vals else None
