"""sweep.norm2_s: host seconds of the fit's ||T||^2 pass (``np.sum`` of the
squared values on the host, or the read of a stream's ``_true_norm2``), the
program's span ``sweep.norm2``, per sweep of the traced decompositions.
Layer: the sweep loop (``core/hooi.py::fit_score``). Nothing to read from a
program without ``repro_torch.tracing``."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.summary()
    sweeps = spans.get("sweep", {}).get("count")
    if not sweeps or "sweep.norm2" not in spans:
        return None
    return spans["sweep.norm2"]["host_s"] / sweeps
