"""graphs.launch_ms: host milliseconds spent in ``cudaGraphLaunch`` per
sweep, from the profiler's host records of the traced decompositions (the
replays of the captured steps). Nothing to read where no step is captured.
Layer: captured steps (``graphs.py``)."""


def read(ctx):
    secs = ctx.trace["launch_s"].get("cudaGraphLaunch")
    if not secs or not ctx.sweeps:
        return None
    return 1e3 * secs / ctx.sweeps
