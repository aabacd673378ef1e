"""graphs.replay_ms: device milliseconds of the captured steps' replays,
between the CUDA events of the program's span ``graphs.replay`` (every
segment of one step call and the host cuts between them, on the caller's
stream), per sweep of the traced decompositions. Layer: captured steps
(``graphs.py``). Nothing to read where no step replays, on the CPU or from
a program without ``repro_torch.tracing``."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.summary()
    sweeps = spans.get("sweep", {}).get("count")
    s = spans.get("graphs.replay")
    if not sweeps or not s or s["device_s"] is None:
        return None
    return 1e3 * s["device_s"] / sweeps
