"""BASELINE config 4 on the card: the fused TD3 rollout + replay + update.

    python -m tinycarlo_torch.benchmarks.td3_bench

The counterpart of benchmarks/baseline_configs.py `config4` (:166-262),
which stays the JAX package's: examples/config_simple_layout.yaml switched
to classes (5 layers at 128x160, t = 2), the eval wrapper stack, the
default TD3Config (the temporal actor and critics over a seq_len-10 queue
of 256-d features, batch 256, one update per env-step), a 100 000-slot
replay, speed 0.4, 1000-step episodes, and a frozen, freshly initialised
TinycarEncoder (flax's initialisers, seed 1), its frames rendered by the
masks kernel in `BENCH_OBS_DTYPE` and encoded in `BENCH_ENC_DTYPE`.

Environment variables: BENCH_ENVS4 (comma list, default "1024,64"; the
BASELINE rows 4 and 4b), BENCH_CHUNK4 (steps per chunk, 200),
BENCH_OBS_DTYPE (comma list, default "bfloat16,float32"; "uint8" renders
the observation contract and `pre_obs`), BENCH_ENC_DTYPE (default: the
run's observation dtype, uint8 taking float32). One JSON line per run
(envs x dtypes, in that order of nesting: dtypes outer).

Protocol, config4's: two warm chunks (the first captures the chunk's
graphs, train/td3_loop.py), then the median of 5 chunks each ended by
`torch.cuda.synchronize()` (with min and max), and the pipelined rate: 5
chunks enqueued back to back with one synchronize, the median of 3.
`td3_updates_per_s` is the median rate / envs * updates_per_step. Then
one chunk under torch.profiler: the device-busy ms a step (the kernels'
device time / T; profiler ranges are no kernels and are left out), the
idle share of the traced chunk's wall (the trace's start and end weigh
on a short chunk), the masks kernel's device ms a
step and its records (one a step), the kernel records a step and the ten
kernels that take the most device time; the peak device memory; whether
torch's deterministic algorithms and TF32 were on; the seconds of each
part. Every line carries `device`, the card's name and power limit.
`main` turns TF32 off (cuDNN's default is on), as chip_smoke.py does: the
numbers are float32's where the dtype says float32, and with TF32 on
cuDNN took a 3 ms-a-step TF32 weight-gradient kernel for the temporal
nets' Conv1d (PERF.md §6).

Runs on the card and raises without a GPU; the tests call
`run(device="cpu")` at a tiny size, which steps eagerly and measures no
device number.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time
from dataclasses import replace
from typing import Dict, Optional

import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch.models.tinycar_net import (
    TinycarEncoder,
    encoder_apply_fn,
    encoder_flat_features,
    flax_init_,
)
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.train import td3
from tinycarlo_torch.train.evaluate import standard_stack
from tinycarlo_torch.train.td3_loop import LoopConfig, chunk, init_loop
from tinycarlo_torch.utils.helper import card_line, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "examples", "config_simple_layout.yaml")
DTYPES = {"uint8": None, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def make_params(device, resolution=None):
    """The example yaml switched to classes (baseline_configs.py:180-184),
    at `resolution` when given (tests)."""
    params = fenv.make_env_params(CONFIG, device=device)
    cfg = params.cfg
    cam = cfg.camera if resolution is None else replace(
        cfg.camera, resolution=list(resolution))
    return replace(params, cfg=replace(
        cfg, camera=cam,
        sim=replace(cfg.sim, observation_space_format="classes")))


def make_encoder(params, dtype: torch.dtype, seed: int = 1):
    """A frozen TinycarEncoder of the classes frames, flax-initialised
    from `seed` on the CPU, in `dtype` on the params' device."""
    h, w = params.cfg.camera.resolution
    enc = TinycarEncoder(params.map_data.n_layers,
                         flat_features=encoder_flat_features(h, w))
    flax_init_(enc, torch.Generator().manual_seed(seed))
    return enc.to(params.device, dtype).eval().requires_grad_(False)


def _counts(rt) -> Dict[str, int]:
    """A chunk runtime's replayed and eager steps and captures."""
    s = rt.step_graphs
    return {"replays": s.replays, "captures": s.captures,
            "eager_steps": s.eager}


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(device="cuda", n_envs: int = 1024, chunk_steps: int = 200,
        obs_dtype: str = "bfloat16", enc_dtype: Optional[str] = None,
        warm: int = 2, repeats: int = 5, pipe_chunks: int = 5,
        pipe_rounds: int = 3, profile: bool = True,
        profile_steps: Optional[int] = None,
        replay_size: int = 100_000, resolution=None,
        cfg: Optional[td3.TD3Config] = None) -> Dict:
    """One configuration, the protocol of the module docstring. A
    `profile_steps` other than the chunk's traces chunks of that length
    instead (after an untraced one: a shorter chunk replays the timed
    chunk's graphs, a longer one captures its own there). Returns
    the JSON line's dict, and under "state" and "params" the loop's state
    and params (not printed)."""
    clock = time.perf_counter()
    seconds = {}

    def lap(name):
        nonlocal clock
        now = time.perf_counter()
        seconds[name] = round(now - clock, 2)
        clock = now

    dev = resolve_device(device)
    enc_dtype = enc_dtype or ("float32" if obs_dtype == "uint8"
                              else obs_dtype)
    params = make_params(dev, resolution)
    cfg = cfg or td3.TD3Config()
    loop_cfg = LoopConfig(speed=0.4, replay_size=replay_size,
                          max_episode_steps=1000,
                          obs_dtype=DTYPES[obs_dtype])
    stack = standard_stack()
    encoder_apply = encoder_apply_fn(make_encoder(params,
                                                  DTYPES[enc_dtype]))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    state = init_loop(params, cfg, loop_cfg, n_envs, seed=0, stack=stack)
    overflow = int(fenv.check_segment_overflow(params, state.vstate.env)
                   .sum())
    kernel = fenv.render_kernel(params)
    launches0 = kernel.launches
    front0 = rk.front_kernel.launches

    def one(steps=chunk_steps):
        return chunk(state, params, cfg, loop_cfg, encoder_apply, steps,
                     stack=stack)[1]

    lap("setup")
    for _ in range(warm):
        out = one()
    _sync(dev)
    lap("warm")
    actor0 = [p.detach().clone()
              for p in state.td3_state.actor.parameters()]
    rates = []
    for _ in range(repeats):
        start = time.perf_counter()
        out = one()
        _sync(dev)
        rates.append(n_envs * chunk_steps / (time.perf_counter() - start))
    pipelined = []
    for _ in range(pipe_rounds):
        start = time.perf_counter()
        for _ in range(pipe_chunks):
            out = one()
        _sync(dev)
        pipelined.append(pipe_chunks * n_envs * chunk_steps
                         / (time.perf_counter() - start))
    lap("timed")
    renders = (warm + repeats + pipe_chunks * pipe_rounds) * chunk_steps
    losses = {k: out[k] for k in ("critic1_loss", "critic2_loss",
                                  "actor_loss")}
    counts = _counts(state.runtime)
    busy = idle = k1_ms = k1_records = None
    top = []
    if profile and cuda:
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        steps = profile_steps or chunk_steps
        timed_rt = state.runtime
        if steps != chunk_steps:
            one(steps)  # a longer chunk captures graphs of its own
            renders += steps
        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            one(steps)
            _sync(dev)
            wall_ms = (time.perf_counter() - start) * 1e3 / steps
        renders += steps
        # a longer chunk ran on graphs of its own; a shorter one replayed
        # the timed chunk's
        counts = ({k: counts[k] + v
                   for k, v in _counts(state.runtime).items()}
                  if state.runtime is not timed_rt
                  else _counts(state.runtime))
        # profile_step imports this module: import its helper here
        from tinycarlo_torch.benchmarks.profile_step import kernel_events

        kernels = kernel_events(prof)  # profiler ranges left out
        busy_us = sum(us for _, us, _ in kernels)
        if busy_us > 0:
            busy = busy_us / 1e3 / steps
            idle = 1.0 - busy / wall_ms
        hits = [(us, n) for name, us, n in kernels
                if f"{kernel.NAME}_kernel" in name]
        if len(hits) == 1:
            k1_ms = hits[0][0] / 1e3 / steps
            k1_records = hits[0][1] / steps
        top = [(name[:60], us / 1e3 / steps, n / steps)
               for name, us, n in sorted(kernels, key=lambda e: -e[1])[:10]]
        records = sum(n for _, _, n in kernels) / steps
        lap("profile")
    result = {
        "config": 4,
        "metric": "fused TD3 rollout+replay+update env-steps/s",
        "value": round(statistics.median(rates), 1),
        "spread": [round(min(rates), 1), round(max(rates), 1)],
        "pipelined_value": round(statistics.median(pipelined), 1),
        "pipelined_spread": [round(min(pipelined), 1),
                             round(max(pipelined), 1)],
        "n_envs": n_envs,
        "td3_updates_per_s": round(statistics.median(rates) / n_envs
                                   * loop_cfg.updates_per_step, 1),
        "buffer_filled": int(state.buf.filled),
        "chunk": chunk_steps,
        "obs_dtype": obs_dtype,
        "enc_dtype": enc_dtype,
        "busy_ms_per_step": busy,
        "idle_share": idle,
        "kernel_records_per_step": records if top else None,
        "top_kernels_ms_per_step": top,
        "render_kernel": kernel.NAME,
        "render_kernel_ms_per_step": k1_ms,
        "render_kernel_records_per_step": k1_records,
        "renders": renders,
        "launches": kernel.launches - launches0,
        "front_launches": rk.front_kernel.launches - front0,
        **counts,
        "seconds": seconds,
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if cuda else None),
        "deterministic": torch.are_deterministic_algorithms_enabled(),
        "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                 "cudnn": torch.backends.cudnn.allow_tf32},
        "max_visible_overflow_at_reset": overflow,
        "losses_finite": bool(all(torch.isfinite(v).all()
                                  for v in losses.values())),
        "last_losses": {k: float(v[-1]) for k, v in losses.items()},
        "actor_moved": any(not torch.equal(a, b) for a, b in zip(
            actor0, state.td3_state.actor.parameters())),
        "device": card_line() if cuda else "cpu",
        "state": state,
        "params": params,
    }
    return result


def _list(name: str, default: str):
    return [v.strip() for v in os.environ.get(name, default).split(",")
            if v.strip()]


def main(argv=None) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    envs = [int(v) for v in _list("BENCH_ENVS4", "1024,64")]
    chunk_steps = int(os.environ.get("BENCH_CHUNK4", 200))
    enc = os.environ.get("BENCH_ENC_DTYPE")
    for obs_dtype in _list("BENCH_OBS_DTYPE", "bfloat16,float32"):
        for n in envs:
            result = run(n_envs=n, chunk_steps=chunk_steps,
                         obs_dtype=obs_dtype, enc_dtype=enc)
            for key in ("state", "params"):
                del result[key]
            print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
