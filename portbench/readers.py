"""Shared arithmetic of the per-layer readers (`layer_metrics/`): each
reader is a file of its own that calls one of these on what the traced
run kept, and returns None where there is nothing to read."""
from __future__ import annotations

from portbench import peaks


def idle_share(ctx):
    """% of the wall time in which no device operation ran: 1 - the
    traced window's busy time over the wall time of the same work timed
    without the profiler (`wall_s`), since the profiler's own cost on the
    host would read as idle device time."""
    w = ctx.traces.get("window")
    wall = ctx.facts.get("wall_s")
    if w is None or not wall or not len(w.dur_ns):
        return None
    return 100.0 * (1.0 - w.busy_s() / wall)


def busy_ms(ctx, trace):
    """Device-busy ms per unit of the trace's work (a step, a replay)."""
    w = ctx.traces.get(trace)
    if w is None or not len(w.dur_ns) or not w.count:
        return None
    return w.busy_s() / w.count * 1e3


def kernel_roofline(ctx, kernel: str, n_bytes: float):
    """% of a kernel's least time (its bytes a launch over the HBM rate)
    in its measured time a launch, from the kernels in the window whose
    name holds `kernel`."""
    w = ctx.traces.get("window")
    if w is None or not n_bytes:
        return None
    seconds, launches = w.kernel_s(kernel)
    if not launches or seconds <= 0:
        return None
    return 100.0 * peaks.least_s(n_bytes) / (
        seconds / launches)
