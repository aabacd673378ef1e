"""device.idle_share: the share of the traced decompositions' wall time in
which the device ran nothing: 1 - (union of its kernel, copy and memset
intervals) / (host wall time of the traced window), in %. Layer: the
device (H100)."""


def read(ctx):
    if not ctx.trace["window_s"] or not ctx.trace["busy_s"]:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
