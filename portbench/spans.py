"""The program's own spans and counters (`tinycarlo_torch.utils.profiling`)
for the per-layer readers: the spans pass, and the arithmetic the readers
share.

The spans pass is one more piece of traced work, after every piece a
driver traces today: a rollout call (`rollout_pass`), or the gym's
`trace_steps` steps from the same reset (`gym_pass`), run with the
program's tracer on and the profiler off. On the H100, recording every
kernel under `torch.profiler` stretched the replayed rollout steps'
device spans by 5-22% and the gym step's host spans sevenfold (PERF.md
section 6), so the readers read a pass without it; `profiled=True` adds
it, for naming idle gaps and checking the clock. The profiler's device
timestamps drift from the host clock by tens of microseconds over a call,
so a trace meets the spans (`busy_within`, `idle_gaps_by_span`) only
after `on_host_clock` has moved its device operations onto the host
clock, anchored at the mark kernels.

What the pass gives the readers is `facts["program"]`: the host spans
(name, start ns, end ns, parent, call id), the device spans (name, start
ns, end ns, parent, replayed) and the counters, all on the host clock,
with the pass's wall seconds and its steps. Where the program has no
tracer (a commit before it), the pass returns None, and every reader
returns None where `facts` holds no "program".
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional

import numpy as np

from portbench import trace
from portbench.drivers.gym_step import WARMUP_STEPS


def tracer():
    """The program's tracing module, or None where it has none."""
    try:
        from tinycarlo_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "tracing") else None


def program(tr, wall_s: float, steps: int) -> Dict:
    """A finished tracing session as plain numbers (`facts["program"]`)."""
    return {
        "spans": [(s.name, s.start_ns, s.end_ns, s.parent, s.call_id)
                  for s in tr.spans],
        "device_spans": [(s.name, s.start_ns, s.end_ns, s.parent,
                          s.replayed) for s in tr.device_spans()],
        "counters": dict(tr.counters),
        "offsets": {str(k): v for k, v in tr.offsets.items()},
        "wall_s": wall_s,
        "steps": steps,
    }


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def rollout_pass(cell, profiled: bool = False):
    """One more rollout call of the driver's Cell with the tracer on (and
    under the profiler when `profiled`). Returns (the call's Trace or None,
    the program's facts), or (None, None) without a tracer. The driver's
    records for the comparison are left as the traced call made them."""
    prof = tracer()
    if prof is None:
        return None, None
    _sync()
    with prof.tracing() as tr:
        if profiled:
            t = trace.profile(lambda: (cell._call(), cell.steps)[1])
            wall = t.wall_s
        else:
            t0 = time.perf_counter()
            cell._call()
            _sync()
            wall = time.perf_counter() - t0
            t = None
    return t, program(tr, wall, cell.steps)


def gym_pass(cell, profiled: bool = False):
    """The gym's traced steps again with the tracer on: WARMUP_STEPS steps
    (the driver's own warm-up actions) capture the traced mode, then
    `reset(seed)` and `trace_steps` steps (under the profiler when
    `profiled`). Returns (Trace or None, the program's facts, the pass's
    records) or (None, None, None) without a tracer; the driver's records
    are restored."""
    prof = tracer()
    if prof is None:
        return None, None, None
    env, count = cell.env, cell.run.traffic["trace_steps"]
    saved = getattr(cell, "records", None)
    warm = np.random.default_rng(0)
    with prof.tracing():
        for _ in range(WARMUP_STEPS):
            env.step({"car_control": warm.uniform(-1, 1, 2),
                      "maneuver": int(warm.integers(0, 4))})
    env.reset(seed=cell.run.seed)
    with prof.tracing() as tr:
        if profiled:
            t = trace.profile(lambda: cell._steps(count=count)[0])
            steps, wall = t.count, t.wall_s
        else:
            t = None
            steps, wall, _ = cell._steps(count=count)
    records, cell.records = cell.records, saved
    return t, program(tr, wall, steps), records


# -- the readers' arithmetic ------------------------------------------------

def _host(prog, name: str) -> List[tuple]:
    return [s for s in prog["spans"] if s[0] == name]


def replayed_spans(prog, name: str) -> List[tuple]:
    """The device spans of `name` a graph's replay wrote, by start."""
    return sorted((s for s in prog["device_spans"]
                   if s[0] == name and s[4]), key=lambda s: s[1])


def _median(values) -> Optional[float]:
    values = list(values)
    return float(statistics.median(values)) if values else None


def _dur(s) -> int:
    return s[2] - s[1]


def call_start_ms(prog) -> Optional[float]:
    """Host ms a rollout call spends in its eager warm-up steps and its
    capture before the first replay, per call."""
    calls = len(_host(prog, "rollout"))
    if not calls:
        return None
    start = _host(prog, "rollout.warmup") + _host(prog, "rollout.capture")
    return sum(_dur(s) for s in start) / calls / 1e6


def replay_launch_us(prog) -> Optional[float]:
    """Median host us of one `g.replay()` of the rollout's graph."""
    v = _median(_dur(s) for s in _host(prog, "rollout.replay"))
    return None if v is None else v / 1e3


def replayed_ms(prog, name: str) -> Optional[float]:
    """Median device ms of the replayed spans of `name`."""
    v = _median(_dur(s) for s in replayed_spans(prog, name))
    return None if v is None else v / 1e6


def replay_gaps_ns(prog) -> List[int]:
    """Device ns from each replayed rollout step's end to the next
    replayed step's begin (steps of one call: an eager step between two
    ends the pair)."""
    steps = sorted((s for s in prog["device_spans"]
                    if s[0] == "rollout.step"), key=lambda s: s[1])
    return [b[1] - a[2] for a, b in zip(steps, steps[1:]) if a[4] and b[4]]


def replay_gap_us(prog) -> Optional[float]:
    v = _median(replay_gaps_ns(prog))
    return None if v is None else v / 1e3


def live_copy_share(prog) -> Optional[float]:
    """% of the copies the compaction sorts that take a slot."""
    c = prog["counters"]
    if not c.get("render.copies") or "render.live_copies" not in c:
        return None
    return 100.0 * c["render.live_copies"] / c["render.copies"]


def _gym(prog, name: str) -> Optional[float]:
    """ms a step of the gym spans `name` inside steps (call id > 0)."""
    steps = len(_host(prog, "gym.step"))
    if not steps:
        return None
    return sum(_dur(s) for s in _host(prog, name) if s[4]) / steps / 1e6


def gym_host_ms(prog) -> Optional[float]:
    """Host ms a gym step, its wait for the card left out."""
    step, wait = _gym(prog, "gym.step"), _gym(prog, "gym.wait")
    return None if step is None or wait is None else step - wait


def gym_wait_ms(prog) -> Optional[float]:
    """ms a gym step waits on the copy out and its synchronize."""
    return _gym(prog, "gym.wait")


def read(ctx, fn):
    """`fn(facts["program"])`, or None without one."""
    prog = ctx.facts.get("program")
    return None if prog is None else fn(prog)


# -- where a rollout call's time goes (portbench/tools/program_spans.py) ----

def on_host_clock(t: trace.Trace, prog) -> trace.Trace:
    """The trace with its device operations moved onto the host clock.
    The profiler's device timestamps drift from the host's (up to ms over
    a rollout call on the H100) where the tracer's marks do not: each mark
    kernel's profiler start is matched in order with its mark, and each
    operation shifts by the offset of the marks around it (linear between
    them, the nearest's outside). A trace that lost a mark kernel's record
    is returned as it is."""
    is_mark = np.asarray(["mark_kernel" in n for n in t.names], bool)
    kernels = np.sort(t.start_ns[is_mark]) if len(t.names) else t.start_ns
    marks = np.sort(np.asarray(
        [x for s in prog["device_spans"] for x in s[1:3]], np.int64))
    if not len(marks) or len(kernels) != len(marks):
        return t
    shift = np.interp(t.start_ns, kernels, marks - kernels)
    return dataclasses.replace(t, start_ns=t.start_ns
                               + np.rint(shift).astype(np.int64))


def _union(starts, ends):
    """Merged [start, end) intervals, as two arrays."""
    order = np.argsort(starts, kind="stable")
    s, e = np.asarray(starts)[order], np.asarray(ends)[order]
    out_s, out_e = [], []
    for a, b in zip(s.tolist(), e.tolist()):
        if out_e and a <= out_e[-1]:
            out_e[-1] = max(out_e[-1], b)
        else:
            out_s.append(a)
            out_e.append(b)
    return np.asarray(out_s, np.int64), np.asarray(out_e, np.int64)


def busy_within(t: trace.Trace, intervals) -> int:
    """ns of the device's busy time (the union of its operations) inside
    the given [start, end) intervals."""
    if not len(t.start_ns) or not intervals:
        return 0
    ks, ke = _union(t.start_ns, t.start_ns + t.dur_ns)
    total = 0
    for a, b in intervals:
        lo = np.maximum(ks, a)
        hi = np.minimum(ke, b)
        total += int(np.clip(hi - lo, 0, None).sum())
    return total


def rollout_breakdown(t: trace.Trace, prog) -> Dict:
    """A traced rollout call's wall split: the call's start (eager steps
    and capture, host), the replayed steps' device time (busy and idle
    inside the steps), the gaps between replays, and the rest; ms each."""
    steps = replayed_spans(prog, "rollout.step")
    gaps = replay_gaps_ns(prog)
    inside = sum(_dur(s) for s in steps)
    busy_in = busy_within(t, [(s[1], s[2]) for s in steps])
    start = call_start_ms(prog) or 0.0
    wall = prog["wall_s"] * 1e3
    n = len(steps)
    med_step = replayed_ms(prog, "rollout.step") or 0.0
    med_gap = (replay_gap_us(prog) or 0.0) / 1e3
    return {
        "wall_ms": wall,
        "busy_ms": t.busy_s() * 1e3,
        "call_start_ms": start,
        "replayed_steps": n,
        "steps_ms": inside / 1e6,
        "steps_busy_ms": busy_in / 1e6,
        "steps_idle_ms": (inside - busy_in) / 1e6,
        "replay_gaps_ms": sum(gaps) / 1e6,
        "rest_ms": wall - start - inside / 1e6 - sum(gaps) / 1e6,
        # call start + the replayed steps at their median step and gap
        "accounted_share": (start + n * (med_step + med_gap)) / wall,
    }


def idle_gaps_by_span(t: trace.Trace, prog, n: int = 10) -> List[list]:
    """The trace's longest idle gaps, each named by the innermost program
    host span open at its start, and where it lies among the device
    spans: inside a step, between replayed steps, or outside both."""
    gaps = t.idle_gaps(n)
    if not len(t.start_ns):
        return []
    order = np.argsort(t.start_ns, kind="stable")
    s = t.start_ns[order]
    run_end = np.maximum.accumulate(s + t.dur_ns[order])
    lengths = s[1:] - run_end[:-1]
    steps = [d for d in prog["device_spans"] if d[0] == "rollout.step"]
    out = []
    for i in np.argsort(-lengths)[:len(gaps)]:
        at = int(run_end[i])
        open_ = [(e - b, name) for name, b, e, _, _ in prog["spans"]
                 if b <= at < e]
        host = min(open_)[1] if open_ else "outside the program's spans"
        dev = "outside the steps"
        if any(b <= at < e for _, b, e, _, _ in steps):
            dev = "inside a step"
        elif any(a[2] <= at < b[1] for a, b in zip(steps, steps[1:])):
            dev = "between steps"
        runtime = [name for name, b, e in t.host if b <= at < e]
        out.append([host, dev, runtime[0][:60] if runtime else "",
                    float(lengths[i]) * 1e-9])
    return out
