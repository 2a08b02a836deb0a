"""Device traces kept in memory: a `torch.profiler` run around a piece
of work, reduced to its kernels (name, start, duration), the host's
ranges, the wall time and the device's busy time.

Nothing is written to disk. The summary is what the per-layer readers
(`layer_metrics/`) and the run's `breakdown` read.
"""
from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


@dataclass
class Trace:
    """One traced piece of work: `wall_s` by the host's clock around it
    (ended by a synchronize), its kernels' names, starts and durations (ns,
    the trace's clock) and the host ranges (name, start, end) it holds."""

    wall_s: float
    names: List[str]
    start_ns: np.ndarray
    dur_ns: np.ndarray
    host: List[Tuple[str, int, int]] = field(default_factory=list)
    count: int = 1  # the units of work traced (steps, replays)

    def busy_s(self) -> float:
        """Seconds in which a kernel ran: the union of their intervals."""
        if not len(self.start_ns):
            return 0.0
        order = np.argsort(self.start_ns, kind="stable")
        s = self.start_ns[order]
        e = s + self.dur_ns[order]
        run_end = np.maximum.accumulate(e)
        gaps = s[1:] - run_end[:-1]
        return float((e.max() - s.min() - gaps[gaps > 0].sum()) * 1e-9)

    def kernel_s(self, part: str) -> Tuple[float, int]:
        """(summed seconds, launches) of the kernels whose name holds
        `part`."""
        hit = [i for i, n in enumerate(self.names) if part in n]
        return float(self.dur_ns[hit].sum() * 1e-9), len(hit)

    def top_kernels(self, n: int = 10) -> List[list]:
        by = defaultdict(int)
        for name, d in zip(self.names, self.dur_ns.tolist()):
            by[name] += d
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], d * 1e-9] for name, d in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device operations, each named by the
        innermost host event open at the gap's start (a CUDA runtime call:
        a launch, a graph launch, a synchronize), or "host" where none
        was: the host was running Python."""
        if len(self.start_ns) < 2:
            return []
        order = np.argsort(self.start_ns, kind="stable")
        s = self.start_ns[order]
        run_end = np.maximum.accumulate(s + self.dur_ns[order])
        gaps = s[1:] - run_end[:-1]
        out = []
        for i in np.argsort(-gaps)[:n]:
            if gaps[i] <= 0:
                break
            at = run_end[i]
            open_ = [(e - b, name) for name, b, e in self.host if b <= at < e]
            what = min(open_)[1] if open_ else "host"
            out.append([what[:200], float(gaps[i]) * 1e-9])
        return out


def _events(prof):
    """(kernels, host ranges) of a finished profile, read from its kineto
    events without building the profiler's Python event tree."""
    names, starts, durs, host = [], [], [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        dur = (e.duration_ns() if hasattr(e, "duration_ns")
               else e.duration_us() * 1000)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation():
                continue  # a range's span on the device, not an operation
            names.append(e.name())  # kernels, copies and fills
            starts.append(start)
            durs.append(dur)
        else:
            host.append((e.name(), start, start + dur))
    return names, np.asarray(starts, np.int64), np.asarray(durs, np.int64), host


def profile(fn: Callable[[], int]) -> Trace:
    """Run `fn()` (which returns how many units of work it did) under the
    profiler, ended by a synchronize; return its Trace. Only the device's
    activity is recorded (its operations and the CUDA runtime calls that
    launch them): recording every host operator as well tripled the wall
    time of a host-bound gym step (4.8 against 1.5 ms), which would have
    been read as idle device time."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        count = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names, starts, durs, host = _events(prof)
    return Trace(wall_s=wall, names=names, start_ns=starts, dur_ns=durs,
                 host=host, count=count)
