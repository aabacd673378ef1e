"""sweep.finalize_s: host seconds of a sweep's finalize, the program's
spans ``sweep.core`` (the core's Z-build and ``finalize_core``) and
``sweep.fit`` (the objective's fit, the host's ||T||^2 pass included), per
sweep of the traced decompositions. Layer: the sweep loop
(``engine/sweep.py``, ``core/ttm.py``, ``engine/objective.py``). Nothing to
read from a program without ``repro_torch.tracing``."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.summary()
    sweeps = spans.get("sweep", {}).get("count")
    if not sweeps or "sweep.core" not in spans or "sweep.fit" not in spans:
        return None
    return (spans["sweep.core"]["host_s"]
            + spans["sweep.fit"]["host_s"]) / sweeps
