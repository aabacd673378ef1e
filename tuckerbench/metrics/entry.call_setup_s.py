"""entry.call_setup_s: host seconds of a ``hooi`` call from its entry to
its first sweep (the knobs, the initial factors, the coordinates' conversion
and upload), the program's span ``hooi.setup``, mean per call over the
traced decompositions. Layer: the entry (``core/hooi.py``). Nothing to read
from a program without ``repro_torch.tracing``."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    s = tracing.summary().get("hooi.setup")
    if not s or not s["count"]:
        return None
    return s["host_s"] / s["count"]
