"""engine.zbuild_ms: device milliseconds of one eager Z-build, between the
CUDA events of the program's span ``zbuild`` (the sort and gathers by row,
the fold of the leading factors into ``a``, the chunk walk, the fix-up and
the fused Z @ X), mean per build timed over the traced decompositions:
every mode step's and the core's in ``hooi``, the core's alone where the
mode steps replay captured graphs. Layer: the engine's eager path
(``engine/zbuild.py``, ``core/ttm.py``, ``kernels/ops.py``). Nothing to read
on the CPU or from a program without ``repro_torch.tracing``."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    s = tracing.summary().get("zbuild")
    if not s or s["device_s"] is None or not s["device_count"]:
        return None
    return 1e3 * s["device_s"] / s["device_count"]
