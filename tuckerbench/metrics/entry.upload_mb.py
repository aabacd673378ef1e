"""entry.upload_mb: megabytes (10^6 bytes) of coordinates (int32) and
values (float32) a ``hooi`` call hands its sweeps, the program's counter
``hooi.upload_bytes`` (span ``hooi.upload``: ``convert.device_coords``, the
conversion on the host and the copy to the card), per call over the traced
decompositions. Layer: the entry (``core/hooi.py``, ``convert.py``).
Nothing to read from a program without ``repro_torch.tracing``."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.summary()
    calls = spans.get("hooi", {}).get("count")
    up = spans.get("hooi.upload", {}).get("counters", {})
    if not calls or "hooi.upload_bytes" not in up:
        return None
    return up["hooi.upload_bytes"] / 1e6 / calls
