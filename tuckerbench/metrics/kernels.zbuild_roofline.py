"""kernels.zbuild_roofline: the Z-builds' least time over their device
time, in %, against the H100's published peaks (``roofline.py``).

The device time is that of the kernels listed in ``KERNELS``
(``kernels/csrc/kron_segsum.cu``: the chunk walk, the fix-up of rows that
span chunks, and the fused form's Z @ X): each kernel's mean time per
execution the profiler recorded, times its executions in a sweep (one
chunk walk and one fix-up per Z-build, one Z @ X per fused build). The
least time is each of the sweep's Z-builds' (every mode step's and the
core's) operations and bytes (``roofline.zbuild_counts``), over real
elements and rows.

What the time leaves out: at four modes the fold of the leading factors
into ``a`` runs in PyTorch's own kernels (about 14 ms of an 80 ms build at
enron's size), and in one process the sort of the elements by row before
each build; the listed names do not catch them, so the share reads higher
than the whole build's. The profiler drops device records; the harness
prints the executions it saw against those the sweep implies, and a kernel
it saw none of fails the run.
"""

KERNELS = ("chunk_kernel", "fixup_kernel", "zx_kernel")


def read(ctx):
    builds = ctx.zbuilds
    per_sweep = {"chunk_kernel": len(builds), "fixup_kernel": len(builds),
                 "zx_kernel": sum(1 for b in builds if b["s"])}
    measured = 0.0
    for k in KERNELS:
        if not per_sweep[k]:
            continue
        seen, secs = ctx.kernel_records(ctx.trace, k)
        ctx.log(f"{k}: {seen} executions recorded, "
                f"{per_sweep[k] * ctx.sweeps} expected")
        if not seen:
            raise RuntimeError(f"the profiler recorded no {k}: "
                               "kernels.zbuild_roofline cannot be read")
        measured += secs / seen * per_sweep[k]
    least = 0.0
    for b in builds:
        ms, by = ctx.roofline.least_ms(*ctx.roofline.zbuild_counts(
            b["E"], b["N"], b["Ka"], b["Kb"], b["rows"], b["factor_floats"],
            b["s"], b["rows_with_elements"]))
        ctx.log(f"Z-build {b['kind']}: least {ms:.4f} ms ({by})")
        least += ms / 1e3
    return 100.0 * least / measured
