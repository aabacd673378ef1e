"""kernels.oracle_roofline: the Lanczos products' least time over their
device time, in %, against the H100's published peaks (``roofline.py``).

The device time is that of the kernels listed in ``KERNELS``
(``kernels/csrc/oracle_pair.cu``), one execution per product over the P
stacked ranks: the mean time per execution the profiler recorded, times the
products of a sweep (``roofline.sweep_oracle_calls``: two a Lanczos
iteration, less the first Z @ X that the fused Z-build computes). The least
time is each product's Z read once and its panel in and out
(``roofline.oracle_counts``), over the real rows. The profiler drops
device records; the harness prints the executions it saw against those
the sweep implies, and none seen fails the run.
"""

KERNELS = ("oracle_kernel",)


def read(ctx):
    calls = ctx.oracle_calls
    per_sweep = sum(c["calls"] for c in calls)
    seen, secs = ctx.kernel_records(ctx.trace, KERNELS[0])
    ctx.log(f"{KERNELS[0]}: {seen} executions recorded, "
            f"{per_sweep * ctx.sweeps} expected")
    if not seen:
        raise RuntimeError("the profiler recorded no oracle_kernel: "
                           "kernels.oracle_roofline cannot be read")
    measured = secs / seen * per_sweep
    least = 0.0
    for c in calls:
        ms, _ = ctx.roofline.least_ms(*ctx.roofline.oracle_counts(
            c["R"], c["K"], c["s"]))
        least += c["calls"] * ms / 1e3
    return 100.0 * least / measured
