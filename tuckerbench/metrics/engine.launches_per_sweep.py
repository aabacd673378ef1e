"""engine.launches_per_sweep: kernel launches, graph launches, copies and
memsets the host issued per sweep, counted from the profiler's host records
of the traced decompositions (``trace.LAUNCH_CALLS``), the core, fit and
call set-up included. Layer: the engine's eager path (``engine/oracle.py``,
``core/lanczos.py``, ``kernels/ops.py``)."""


def read(ctx):
    n = sum(ctx.trace["launches"].values())
    if not n or not ctx.sweeps:
        return None
    return n / ctx.sweeps
