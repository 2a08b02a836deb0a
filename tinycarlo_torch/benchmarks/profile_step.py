"""Device-timeline profile of the production step on the card: the kernels
of a replayed CUDA graph of the step, by name, from a torch.profiler
trace.

    python -m tinycarlo_torch.benchmarks.profile_step [trace_dir]

The counterpart of benchmarks/profile_step.py (:36-102), which stays the
JAX package's. The workload is the script's: examples/
config_simple_layout.yaml switched to classes (5 layers at 128x160, t =
2), BENCH_ENVS (4096) envs, the constant car_control [0.5, 0.05], maneuver
0, the whole observation summed into the checksum,
`vector.step(render=False, max_episode_steps=1000)`. One step is captured
as a CUDA graph and replayed once warm, then STEPS (10) replays are traced
with CUDA activity. The kernel records are summed by name (its first 60
characters) into device ms a step; the lines print those of at least
0.05 ms, the rest summed, the total device-busy ms a step, the kernel
records a step and the idle share of the traced replays (1 - busy /
wall), then one JSON line. With a `trace_dir` the Chrome trace is written
there.

Traces can lose kernel records (ROADMAP F2): the run raises unless the
masks kernel holds exactly one record a step, so that a lossy trace
prints no ranking.

Runs on the card and raises without a GPU; `run(device="cpu")` runs the
same steps eagerly and aggregates the host operators' self times of a
CPU trace (tests; no device number).
"""
from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import fields
from typing import Dict, Iterable, Optional, Tuple

import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.benchmarks.td3_bench import make_params
from tinycarlo_torch.utils import graphs
from tinycarlo_torch.utils.helper import card_line, resolve_device

N_ENVS = int(os.environ.get("BENCH_ENVS", 4096))
STEPS = 10
THRESHOLD_MS = 0.05
NAME_CHARS = 60


def aggregate(events: Iterable[Tuple[str, float, int]], steps: int,
              threshold: float = THRESHOLD_MS,
              chars: int = NAME_CHARS) -> Dict:
    """Sum trace records by name. `events`: (name, device us, records) per
    distinct name of a trace over `steps` steps. Names are cut to their
    first `chars` characters and summed again. Returns {"rows": [(ms a
    step, name, records a step)] of the names at or above `threshold` ms
    a step, most first; "other_ms": the rest; "total_ms"; "records"
    (records a step)}."""
    ms, records = {}, {}
    for name, us, count in events:
        key = name[:chars]
        ms[key] = ms.get(key, 0.0) + us / 1e3 / steps
        records[key] = records.get(key, 0) + count
    rows = sorted(((v, k, records[k] / steps) for k, v in ms.items()
                   if v >= threshold), key=lambda r: (-r[0], r[1]))
    total = sum(ms.values())
    return {"rows": rows, "other_ms": total - sum(r[0] for r in rows),
            "total_ms": total,
            "records": sum(records.values()) / steps}


def kernel_events(prof, cuda: bool = True):
    """(name, us, records) per distinct name of a torch.profiler trace:
    the CUDA kernels' device time, or (cuda=False) the host operators'
    self CPU time. Profiler ranges (`record_function`) are left out: on
    the device timeline a range spans its first to its last kernel, gaps
    included, and is no kernel."""
    want = (torch.autograd.DeviceType.CUDA if cuda
            else torch.autograd.DeviceType.CPU)
    return [(e.key, e.self_device_time_total if cuda
             else e.self_cpu_time_total, e.count)
            for e in prof.key_averages() if e.device_type == want
            and not getattr(e, "is_user_annotation", False)]


def records_of(events, symbol: str) -> int:
    """The records of the kernels whose name holds `symbol`."""
    return sum(count for name, _, count in events if symbol in name)


def make_body(params, n_envs: int):
    """The script's step: body(vstate, checksum) -> (vstate, checksum)."""
    dev = params.device
    control = torch.tensor([0.5, 0.05], dtype=torch.float32,
                           device=dev).repeat(n_envs, 1)
    maneuver = torch.zeros(n_envs, dtype=torch.int32, device=dev)

    def body(vstate, checksum):
        obs = fenv.render_observation_batch(params, vstate.env)
        checksum = checksum + obs.sum(dtype=torch.int64)
        vstate, _, _, _, _, _ = vector.step(
            params, vstate, {"car_control": control, "maneuver": maneuver},
            render=False, max_episode_steps=1000)
        return vstate, checksum

    return body


def _carried(vstate, checksum):
    car = vstate.env.car
    return ([getattr(car, f.name) for f in fields(car)]
            + list(vstate.counters) + [vstate.episode_step, checksum])


def run(device="cuda", n_envs: int = N_ENVS, steps: int = STEPS,
        threshold: float = THRESHOLD_MS, trace_dir: Optional[str] = None,
        resolution=None) -> Dict:
    """The profile (module docstring); `resolution` cuts the frame
    (tests). Returns the JSON line's dict."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    params = make_params(dev, resolution)
    kernel = fenv.render_kernel(params)
    vstate, _ = vector.reset(params, n_envs, seed=0, render=False)
    state = [vstate, torch.zeros((), dtype=torch.int64, device=dev)]
    body = make_body(params, n_envs)
    if cuda:
        graph, state = graphs.capture_carried(
            body, state, _carried, fenv.render_kernels(params),
            generators=(vstate.generator,),
            warmup=3, what="profile_step")
        step = graph.replay
    else:
        def step():
            state[:] = body(*state)

    step()  # warm
    if cuda:
        torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            step()
        if cuda:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / steps
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    events = kernel_events(prof, cuda)
    agg = aggregate(events, steps, threshold)
    kernel_records = records_of(events, f"{kernel.NAME}_kernel") / steps
    if cuda and kernel_records != 1:
        raise RuntimeError(
            f"profile_step: the trace holds {kernel_records:g} "
            f"{kernel.NAME} kernel records a step, not 1: it lost records "
            "(ROADMAP F2), so its ranking is not printed")
    if int(state[1]) <= 0:
        raise RuntimeError("profile_step: observations were not rendered")
    return {
        "metric": "device ms a step by kernel (replayed graph)" if cuda
        else "host operator ms a step (CPU, eager)",
        "n_envs": n_envs,
        "steps": steps,
        "threshold_ms": threshold,
        "kernels": [{"ms": ms, "name": name, "records": n}
                    for ms, name, n in agg["rows"]],
        "other_ms": agg["other_ms"],
        "busy_ms_per_step": agg["total_ms"],
        "records_per_step": agg["records"],
        "render_kernel": kernel.NAME,
        "render_kernel_records_per_step": kernel_records,
        "wall_ms_per_step": wall_ms,
        "idle_share": 1.0 - agg["total_ms"] / wall_ms if cuda else None,
        "device": card_line() if cuda else "cpu",
    }


def print_profile(result: Dict, unit: str = "step",
                  out=sys.stdout) -> None:
    """The script's lines for a profile's dict."""
    print(f"device time per {unit} ({result['steps']}-{unit} trace, "
          f"{result['n_envs']} envs):", file=out)
    for row in result["kernels"]:
        print(f"  {row['ms']:7.3f} ms  {row['name']}", file=out)
    print(f"  {result['other_ms']:7.3f} ms  (everything under "
          f"{result['threshold_ms']} ms/{unit})", file=out)
    print(f"  total device: {result['busy_ms_per_step']:.3f} ms/{unit}",
          file=out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    resolve_device("cuda")
    result = run(trace_dir=argv[0] if argv else None)
    print_profile(result)
    print(f"  {result['records_per_step']:g} kernel records a step, idle "
          f"share {result['idle_share']:.4f} (wall "
          f"{result['wall_ms_per_step']:.4f} ms a traced step)")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
