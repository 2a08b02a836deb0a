"""Device-timeline profile of the fused TD3 chunk (BASELINE config 4) on
the card: its kernels by name, and its stages.

    python -m tinycarlo_torch.benchmarks.profile_td3 [trace_dir]

The counterpart of benchmarks/profile_td3.py (:29-99), which stays the
JAX package's: examples/config_simple_layout.yaml switched to classes,
`TD3Config()`, `LoopConfig(speed=0.4, replay_size=100_000,
max_episode_steps=1000)` with the observation in BENCH_OBS_DTYPE (uint8
by default, the observation contract and `pre_obs`), BENCH_ENVS4 (64)
envs, the eval wrapper stack, and a float32 TinycarEncoder from seed 1
(td3_bench's `make_params` and `make_encoder`, applied through
`models.tinycar_net.encoder_apply_fn`). Protocol: one warm chunk of STEPS
(20) steps, which captures the chunk's graphs, then 3 chunks, then a
traced chunk of STEPS replayed steps. Prints, as the script does, the
kernels of at least 0.02 ms a loop step, the rest, the total device ms a
loop step and the env-steps/s of that device total; then the kernel
records a step, the idle share of the traced chunk, and one JSON line.

The stages, two ways. `train.td3_loop._step` opens a device span
(utils/profiling.py) around each stage (`td3_loop.STAGES`: policy, env
step, float-obs render, encoder, replay insert, update) and `vector.step`
one around its render. (1) Eager: one more chunk of STEPS steps run
eagerly (`graph=False`) under the profiler and the tracer, whose spans
open profiler ranges there; a stage's device ms is the device time of the
kernels that the operators inside its range launched (an operator in its
innermost range), "other" that of the operators outside every range. The
eager chunk's own busy ms and records a step are printed beside the
graphs'. (2) In the replayed graphs: a chunk under the tracer captures
each kind's graph with its marks, and the next chunk's replays are read;
a stage's device ms is its spans' time less that of the stages inside
them (`graph_stage_ms`), so the two splits count alike. On the CPU both
read host time.

Runs on the card and raises without a GPU; `run(device="cpu")` runs the
chunks eagerly at a tiny size and reads the host operators' self time
(tests; no device number).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional

import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch.benchmarks.profile_step import (aggregate,
                                                     kernel_events,
                                                     print_profile,
                                                     records_of)
from tinycarlo_torch.benchmarks.td3_bench import (DTYPES, make_encoder,
                                                  make_params)
from tinycarlo_torch.models.tinycar_net import encoder_apply_fn
from tinycarlo_torch.train import td3
from tinycarlo_torch.train.evaluate import standard_stack
from tinycarlo_torch.train.td3_loop import (STAGES, LoopConfig, chunk,
                                            init_loop)
from tinycarlo_torch.utils import profiling
from tinycarlo_torch.utils.helper import card_line, resolve_device

N_ENVS = int(os.environ.get("BENCH_ENVS4", 64))
OBS_DTYPE = os.environ.get("BENCH_OBS_DTYPE", "uint8")
STEPS = 20
WARM_CHUNKS = 3
THRESHOLD_MS = 0.02
RENDER_RANGE = "vector.render"


def stage_ms(prof, steps: int, cuda: bool = True) -> Dict[str, float]:
    """ms a step of each labelled range of a trace (td3_loop.STAGES and
    vector.step's render): the device time of the kernels that the
    operators inside it launched (cuda=False: the operators' self host
    time), each operator counted in its innermost labelled range, and
    "other" for the operators outside every range."""
    labels = set(STAGES) | {RENDER_RANGE}
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        us = (sum(k.duration for k in e.kernels) if cuda
              else e.self_cpu_time_total)
        if not us:
            continue
        node = e
        while node is not None and node.name not in labels:
            node = node.cpu_parent
        key = "other" if node is None else node.name
        out[key] = out.get(key, 0.0) + us
    return {name: us / 1e3 / steps for name, us in sorted(out.items())}


def graph_stage_ms(spans, steps: int, replayed: bool = True
                   ) -> Dict[str, float]:
    """ms a step of each labelled stage (td3_loop.STAGES and vector.step's
    render) from device spans (`profiling.Span`; `replayed`: only those a
    graph's replay wrote): a span's time less that of the labelled spans
    nearest inside it, as the eager split counts an operator in its
    innermost range."""
    labels = set(STAGES) | {RENDER_RANGE}
    ns: Dict[str, int] = {}

    def labelled_parent(i):
        p = spans[i].parent
        while p >= 0 and spans[p].name not in labels:
            p = spans[p].parent
        return p

    for i, sp in enumerate(spans):
        if sp.name not in labels or (replayed and not sp.replayed):
            continue
        d = sp.end_ns - sp.start_ns
        ns[sp.name] = ns.get(sp.name, 0) + d
        p = labelled_parent(i)
        if p >= 0:
            ns[spans[p].name] = ns.get(spans[p].name, 0) - d
    return {name: v / 1e6 / steps for name, v in sorted(ns.items())}


def run(device="cuda", n_envs: int = N_ENVS, steps: int = STEPS,
        obs_dtype: str = OBS_DTYPE, warm_chunks: int = WARM_CHUNKS,
        threshold: float = THRESHOLD_MS, trace_dir: Optional[str] = None,
        replay_size: int = 100_000, resolution=None,
        cfg: Optional[td3.TD3Config] = None) -> Dict:
    """The profile (module docstring); `replay_size`, `resolution` and
    `cfg` cut it (tests). Returns the JSON line's dict."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    params = make_params(dev, resolution)
    cfg = cfg or td3.TD3Config()
    loop_cfg = LoopConfig(speed=0.4, replay_size=replay_size,
                          max_episode_steps=1000,
                          obs_dtype=DTYPES[obs_dtype])
    stack = standard_stack()
    encoder_apply = encoder_apply_fn(make_encoder(params, torch.float32))
    state = init_loop(params, cfg, loop_cfg, n_envs, seed=0, stack=stack)
    kernel = fenv.render_kernel(params)

    def one(graph=True):
        return chunk(state, params, cfg, loop_cfg, encoder_apply, steps,
                     stack=stack, graph=graph)[1]

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    for _ in range(1 + warm_chunks):
        out = one()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        out = one()
        sync()
        wall_ms = (time.perf_counter() - start) * 1e3 / steps
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    events = kernel_events(prof, cuda)
    agg = aggregate(events, steps, threshold)
    kernel_records = records_of(events, f"{kernel.NAME}_kernel") / steps
    if cuda and kernel_records != 1:
        raise RuntimeError(
            f"profile_td3: the trace holds {kernel_records:g} {kernel.NAME} "
            "kernel records a step, not 1: it lost records (ROADMAP F2)")
    with profiling.tracing(), profile(activities=activities) as eager_prof:
        one(graph=False)
        sync()
    stages = stage_ms(eager_prof, steps, cuda)
    eager = aggregate(kernel_events(eager_prof, cuda), steps, threshold)
    with profiling.tracing():  # captures the graphs with their marks
        one()
    with profiling.tracing() as tr:
        one()
    graph_stages = graph_stage_ms(tr.device_spans(), steps, replayed=cuda)
    if not all(torch.isfinite(v).all() for v in out.values()):
        raise RuntimeError("profile_td3: a chunk output is not finite")
    busy = agg["total_ms"]
    return {
        "metric": "device ms a loop step by kernel (replayed graphs)"
        if cuda else "host operator ms a loop step (CPU, eager)",
        "n_envs": n_envs,
        "steps": steps,
        "obs_dtype": obs_dtype,
        "threshold_ms": threshold,
        "kernels": [{"ms": ms, "name": name, "records": n}
                    for ms, name, n in agg["rows"]],
        "other_ms": agg["other_ms"],
        "busy_ms_per_step": busy,
        "env_steps_per_s_device": (n_envs / (busy / 1e3)
                                   if cuda and busy > 0 else None),
        "records_per_step": agg["records"],
        "render_kernel_records_per_step": kernel_records,
        "wall_ms_per_step": wall_ms,
        "idle_share": 1.0 - busy / wall_ms if cuda else None,
        "stages_ms_eager": stages,
        "stages_ms_graph": graph_stages,
        # the eager chunk's own totals, beside the replayed graphs'
        "eager_busy_ms_per_step": eager["total_ms"],
        "eager_records_per_step": eager["records"],
        "eager_top_kernels": [{"ms": ms, "name": name, "records": n}
                              for ms, name, n in eager["rows"][:5]],
        "buffer_filled": int(state.buf.filled),
        "device": card_line() if cuda else "cpu",
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run(trace_dir=argv[0] if argv else None)
    print_profile(result, unit="loop step")
    print(f"  (= {result['env_steps_per_s_device']:,.0f} env-steps/s)")
    print(f"  {result['records_per_step']:g} kernel records a step, idle "
          f"share {result['idle_share']:.4f}; stages (device ms a step, an "
          "eager chunk): " + ", ".join(
              f"{k} {v:.4f}" for k, v in result["stages_ms_eager"].items()))
    print("  stages (device ms a step, the replayed graphs' device spans): "
          + ", ".join(f"{k} {v:.4f}"
                      for k, v in result["stages_ms_graph"].items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
