"""graphs.cut_ms: host milliseconds of the host calls that cut a step (the
bidiagonal SVD, the sketch's QRs: their inputs copied out, the call and its
results copied back), the program's span ``graphs.cut``, per sweep of the
traced decompositions; between a replay's segments on the card, the same
host work inline where no step is captured (on the CPU). Layer: captured
steps (``graphs.py``). Nothing to read from a program without
``repro_torch.tracing``."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.summary()
    sweeps = spans.get("sweep", {}).get("count")
    s = spans.get("graphs.cut")
    if not sweeps or not s:
        return None
    return 1e3 * s["host_s"] / sweeps
