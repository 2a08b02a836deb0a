"""The program's spans and counters in one cell, on the card.

    python3 -m portbench.tools.program_spans --workload <cell> --seed <n> \
        [--cost-seconds <s>] [--out <file>]

In one process: the cell's set-up; the driver's own traced run
(`traced()`, tracing off), whose kernels it lists by name and count and
whose per-layer metrics it reads as the benchmark does; the spans pass of
`portbench/spans.py`, then once more under the profiler; the readers of
the program's spans (`PROGRAM_READERS`) on each pass. For a
rollout cell also the call's breakdown (`spans.rollout_breakdown`) and
its idle gaps named by program span, on the host clock
(`spans.on_host_clock`), and the shared clock: the
`cudaGraphLaunch` each `rollout.replay` span should hold, and each device
span's marks against the mark kernels' own profiler starts. For the gym,
the pass's outputs against the traced window's, from the same reset.
With `--cost-seconds`, the cost of tracing: windows of the cell's own
work (`window()`) with tracing off and on, in turns off, on, on, off.

One JSON line on stdout (and in `--out`). Where the program has no tracer
(a commit before it), only the driver's traced run and the windows with
tracing off are read. The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time

import numpy as np

from portbench import peaks, spans
from portbench import run as harness

PROGRAM_READERS = {
    "rollout": ("call_start_ms.rollout", "replay_launch_us.rollout",
                "step_span_ms.rollout", "replay_gap_us.rollout",
                "render_span_ms.rollout", "compact_span_ms.rollout",
                "vector_step_span_ms.rollout", "live_copy_share.rollout"),
    "gym_step": ("host_ms.gym", "wait_ms.gym"),
}


def read_metrics(names, traces, facts):
    ctx = harness.Readers(traces, facts)
    out = {}
    for name in names:
        reader = harness.load_module(
            os.path.join(harness.PB, "layer_metrics", f"{name}.py"),
            "tool_metric_" + name.replace(".", "_"))
        out[name] = reader.read(ctx)
    return out


def same(a, b) -> bool:
    """Whether two records are equal, bit for bit where they are arrays."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def quartiles(prog, kind):
    """Quartiles (us) of the spans the readers take medians or sums of."""
    def q(values):
        values = sorted(values)
        if len(values) < 2:
            return None
        return [v / 1e3 for v in statistics.quantiles(values, n=4)]

    def dur(spans_, name, replayed=None):
        return [s[2] - s[1] for s in spans_ if s[0] == name
                and (replayed is None or s[4] == replayed)]

    if kind == "rollout":
        dev = prog["device_spans"]
        return {"rollout.replay": q(dur(prog["spans"], "rollout.replay")),
                "rollout.step": q(dur(dev, "rollout.step", True)),
                "replay_gap": q(spans.replay_gaps_ns(prog)),
                "render": q(dur(dev, "render", True)),
                "render.compact": q(dur(dev, "render.compact", True)),
                "vector.step": q(dur(dev, "vector.step", True))}
    host = [s for s in prog["spans"] if s[4]]
    return {name: q(dur(host, name)) for name in
            ("gym.step", "gym.stage_in", "gym.replay", "gym.wait",
             "gym.unpack")}


def clock_checks(t, prog):
    """The shared clock of a profiled rollout pass. Host: the
    `rollout.replay` spans that hold a profiled `cudaGraphLaunch`, and
    the replayed steps that begin after their own replay span did (the
    k-th replayed step is the k-th replay's). Device: the marks against
    the mark kernels' profiler starts, matched in order (each mark less
    its kernel's start: the first, the median, the last, and the spread
    of the intervals between consecutive marks less the kernels')."""
    launches = sorted((b, e) for name, b, e in t.host
                      if "cudaGraphLaunch" in name)
    replays = [s for s in prog["spans"] if s[0] == "rollout.replay"]
    held = sum(any(s[1] <= b and e <= s[2] for b, e in launches)
               for s in replays)
    steps = spans.replayed_spans(prog, "rollout.step")
    after = sum(d[1] >= r[1] for d, r in zip(steps, replays))
    kstarts = np.sort(np.asarray(
        [st for name, st in zip(t.names, t.start_ns.tolist())
         if "mark_kernel" in name], np.int64))
    marks = np.sort(np.asarray(
        [x for s in prog["device_spans"] for x in s[1:3]], np.int64))
    out = {"replay_spans": len(replays),
           "replay_spans_holding_their_launch": int(held),
           "replayed_steps_after_their_replay": int(after),
           "mark_kernels_traced": int(len(kstarts)),
           "marks": int(len(marks))}
    if len(marks) == len(kstarts) and len(marks) > 1:
        diff = (marks - kstarts) / 1e3
        step = (np.diff(marks) - np.diff(kstarts)) / 1e3
        out["mark_minus_kernel_start_us"] = {
            "first": float(diff[0]), "median": float(np.median(diff)),
            "last": float(diff[-1]),
            "interval_abs_p99": float(np.percentile(np.abs(step), 99))}
    return out


def cost(cell, seconds: float):
    """The cell's end-to-end metrics over windows with tracing off and on,
    in turns off, on, on, off."""
    prof = spans.tracer()
    out = {"off": [], "on": []}
    for mode in ("off", "on", "on", "off"):
        if mode == "on" and prof is None:
            continue
        if mode == "on":
            with prof.tracing() as tr:
                r = cell.window(seconds)
            r["metrics"]["marks_lost"] = tr.counters["trace.marks_lost"]
        else:
            r = cell.window(seconds)
        out[mode].append(r["metrics"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--cost-seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_caches()
    import torch

    device = torch.device("cuda", 0)
    manifest, wl, run, driver = harness.prepare(
        args.workload, args.seed, max(args.seconds, args.cost_seconds),
        device)
    torch.cuda.set_device(device)
    t0 = time.time()
    cell = driver.Cell(run)
    torch.cuda.synchronize()
    kind = "rollout" if "rollout" in run.cell else "gym_step"
    out = {"cell": run.cell, "seed": args.seed,
           "device": torch.cuda.get_device_name(device),
           "power_limit_w": peaks.power_limit_w(),
           "setup_s": time.time() - t0,
           "tracer": spans.tracer() is not None}

    traces, facts = cell.traced()
    w = traces["window"]
    out["window_kernels"] = dict(sorted(collections.Counter(w.names).items()))
    out["window_launches"] = len(w.names)
    out["window_mark_kernels"] = sum("mark_kernel" in n for n in w.names)
    out["per_layer"] = read_metrics(
        [m["name"] for m in harness.cell_metrics(manifest, "per_layer",
                                                 run.cell)], traces, facts)

    if kind == "rollout":
        _, bare = spans.rollout_pass(cell)
        t, prog = spans.rollout_pass(cell, profiled=True)
    else:
        _, bare, records = spans.gym_pass(cell)
        t, prog, _ = spans.gym_pass(cell, profiled=True)
    if prog is not None:
        names = PROGRAM_READERS[kind]
        out["program"] = read_metrics(names, traces,
                                      dict(facts, program=bare))
        out["program_profiled"] = read_metrics(
            names, dict(traces, spans=t), dict(facts, program=prog))
        out["counters"] = bare["counters"]
        out["counters_profiled"] = prog["counters"]
        out["offsets_ns"] = bare["offsets"]
        out["pass_wall_s"] = {"bare": bare["wall_s"],
                              "profiled": prog["wall_s"]}
        out["quartiles"] = quartiles(bare, kind)
        out["profiled_busy_s"] = t.busy_s()
        out["idle_gaps_trace"] = t.idle_gaps()
        on_host = spans.on_host_clock(t, prog)
        out["moved_onto_host_clock"] = on_host is not t
        out["idle_gaps_by_span"] = spans.idle_gaps_by_span(on_host, prog)
        if kind == "rollout":
            out["breakdown_profiled"] = spans.rollout_breakdown(on_host,
                                                                prog)
            out["clock"] = clock_checks(t, prog)
        else:
            out["pass_equals_traced_window"] = same(records, cell.records)
    if args.cost_seconds:
        out["cost"] = cost(cell, args.cost_seconds)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
