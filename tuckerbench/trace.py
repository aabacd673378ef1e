"""Read a ``torch.profiler`` session of the traced decompositions.

``summarize(prof, window_s)`` reduces the session to what the per-layer
readers need: per device kernel its recorded executions and time, the union
of device activity (busy seconds) and its idle gaps named by what the host
was doing in them, and the host's launch calls (kernel launches, graph
launches, copies) with their counts and host time.
"""

from __future__ import annotations

import bisect
import collections

__all__ = ["summarize", "kernel_records", "LAUNCH_CALLS"]

# host runtime calls that issue work to the device
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaGraphLaunch", "cudaMemcpy", "cudaMemcpyAsync",
                "cudaMemsetAsync", "cudaMemset")
SPANS = ("tuckerbench.", "objective.")  # the harness's own span names
NAME_CHARS = 160  # of a kernel's name in the breakdown (templates run long)
GAP_MIN_US = 5.0  # shorter gaps between device activities are not idle time


def _is_device(e) -> bool:
    """A kernel, copy or memset on the device; not the device-side shadow
    of a ``record_function`` span, which covers the work it encloses."""
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not getattr(
        e, "is_user_annotation", False) and not e.name.startswith(SPANS)


def kernel_records(summary: dict, kernel: str) -> tuple[int, float]:
    """(executions recorded, device seconds) of the kernels whose name holds
    ``kernel<`` or ``kernel(`` (a template or a plain kernel)."""
    n, s = 0, 0.0
    for name, (count, secs) in summary["device_ops"].items():
        if kernel + "<" in name or kernel + "(" in name:
            n += count
            s += secs
    return n, s


def summarize(prof, window_s: float) -> dict:
    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        if _is_device(e):
            device.append((float(tr.start), float(tr.end), e.name))
        else:
            host.append((float(tr.start), float(tr.end), e.name))
    ops: dict = collections.defaultdict(lambda: [0, 0.0])
    for s, t, name in device:
        ops[name][0] += 1
        ops[name][1] += (t - s) / 1e6
    device.sort()
    busy_us, gaps = 0.0, []
    cur_s = cur_t = None
    for s, t, _ in device:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy_us += cur_t - cur_s
                if s - cur_t >= GAP_MIN_US:
                    gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy_us += cur_t - cur_s
    # name each gap by the innermost host event running at its midpoint
    host.sort()
    starts = [h[0] for h in host]
    named: dict = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        name, best = "host code outside any recorded op", None
        for j in range(i, max(i - 256, -1), -1):
            s, t, n = host[j]
            if t >= mid and (best is None or t - s < best):
                name, best = n, t - s
        named[name] += (g1 - g0) / 1e6
    launches = collections.Counter()
    launch_s: dict = collections.defaultdict(float)
    for s, t, name in host:
        if name.startswith(LAUNCH_CALLS):
            base = name.split("(")[0]
            launches[base] += 1
            launch_s[base] += (t - s) / 1e6
    return {
        "window_s": float(window_s),
        "busy_s": busy_us / 1e6,
        "device_ops": {k: (v[0], v[1]) for k, v in ops.items()},
        "top_device_ops": sorted(([k[:NAME_CHARS], v[1]]
                                  for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k[:NAME_CHARS], v] for k, v in named.items()),
                            key=lambda kv: -kv[1])[:10],
        "launches": dict(launches),
        "launch_s": dict(launch_s),
    }
