"""The port's headline benchmark: env-steps/s at 4096 parallel envs with
classes observations and Stanley control, the step replayed as a CUDA
graph.

    python -m tinycarlo_torch.benchmarks.bench

The counterpart of the repository's bench.py, which stays the JAX
package's bench: the same workload (its CONFIG, bench.py:31-59: the
simple_layout map, 128x160 five-class masks at line thickness 2), the
same step (bench.py:78-103: render, a checksum over rows 60:64 of the
observation, Stanley steering clipped to [-1, 1] at speed 0.5 and K 5,
`vector.step(render=False, max_episode_steps=1000)`), the same
segment-overflow guard before timing (bench.py:129-138) and the same
JSON line (bench.py:204-223), with `device`, the card's name and power
limit, added.

Environment variables, those bench.py reads: BENCH_ENVS (default 4096),
BENCH_CHUNK (steps per timed repeat, 400), BENCH_REPEATS (5; at least 5
run) and BENCH_OBS_FORMAT (classes; rgb times the rank kernel's path).
bench.py's BENCH_UNROLL sets its jitted scan's unroll; a replayed graph
has nothing to unroll, and it is not read.

Timing. bench.py times a jitted CHUNK-step scan. Here one step is
captured with `torch.cuda.CUDAGraph` over static state buffers (the car
state, the episode counters, the info the next step's steering reads,
the checksum): the captured step reads them and writes its new values
back into them, so CHUNK replays chain the steps. Each repeat is CHUNK
replays ended by `torch.cuda.synchronize()`; the line gives the median
of the repeats with their min and max, and every repeat's rate, in the
order they ran, goes to stderr beside the card's SM clock, memory clock,
power draw and temperature (nvidia-smi), read right after the repeat,
outside its timed window. `host_replay_ms` times the host's own cost of
one `graph.replay()` call; it is not run between the repeats (chip_smoke.py
reads it once, after them). The respawn rows come from the
state's own torch.Generator, which is registered with the graph, so
each replay draws the rows an eager step would (`graph_matches_eager`
checks it). Kernels are launched once before capture (warm-up), so the
capture sees only launches.

`baseline_reference_steps_per_s` is bench.py's recorded 132.8 steps/s
of the original numpy simulator on the CPU, with `baseline_measured_live`
false: the port does not time that simulator, which lies outside its
checkout.

Runs on the card and raises without a GPU. `measure(device="cpu")` runs
the same step eagerly, without a graph: a test of the script, not a
measurement of any device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from dataclasses import fields
from typing import Dict

import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.train.stanley import stanley_steering
from tinycarlo_torch.utils import graphs
from tinycarlo_torch.utils.helper import (card_clocks, card_line,
                                          resolve_device)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# bench.py's recorded single-env steps/s of the original numpy simulator
# (BASELINE.md)
RECORDED_REFERENCE_SPS = 132.8
# bench.py:31-59
CONFIG = {
    "sim": {"fps": 30, "observation_space_format":
            os.environ.get("BENCH_OBS_FORMAT", "classes")},
    "car": {
        "wheelbase": 0.0487,
        "track_width": 0.027,
        "max_velocity": 0.15,
        "max_steering_angle": 30,
        "steering_speed": 30,
        "max_acceleration": 0.1,
        "max_deceleration": 1.0,
    },
    "camera": {
        "position": [0.0, -0.005, 0.04],
        "orientation": [22, 0, 0],
        "resolution": [128, 160],
        "fov": 80,
        "max_range": 0.5,
        "line_thickness": 2,
    },
    "map": {
        "json_path": os.path.join(REPO, "examples/maps/simple_layout.json"),
        "pixel_per_meter": 450,
    },
}
N_ENVS = int(os.environ.get("BENCH_ENVS", 4096))
CHUNK = int(os.environ.get("BENCH_CHUNK", 400))
REPEATS = max(int(os.environ.get("BENCH_REPEATS", 5)), 5)
SPEED, K = 0.5, 5.0
MAX_EPISODE_STEPS = 1000
# eager steps before capture: every kernel launched (and its launcher's
# one-time setup done) outside the capture
WARMUP = 3
# host_replay_ms: the replays it times, and the spin that holds the card
# meanwhile (~0.1 s at the H100's 1.98 GHz, far above 10 launches)
HOST_PROBE_REPLAYS = 10
HOST_PROBE_SPIN_CYCLES = 200_000_000


def make_body(params: fenv.EnvParams, n_envs: int,
              max_episode_steps: int = MAX_EPISODE_STEPS):
    """bench.py's step (bench.py:78-103) on the port:
    body(vstate, info, checksum, respawn_rows=None) -> (vstate, info,
    checksum, obs, reward). The observation is rendered, a contiguous
    4-row band of it is added to the int64 checksum, and the Stanley
    steering from `info` drives one `vector.step` without a render; the
    action is float32, as bench.py's. `respawn_rows` (B,) injects the
    rows of the envs that finish (tests); without it they are drawn from
    the state's generator."""
    dev = params.device
    max_steer = params.cfg.car.max_steering_angle
    speed = torch.full((n_envs,), SPEED, dtype=torch.float32, device=dev)
    maneuver = torch.zeros(n_envs, dtype=torch.int32, device=dev)

    def body(vstate, info, checksum, respawn_rows=None):
        obs = fenv.render_observation_batch(params, vstate.env)
        checksum = checksum + obs[..., 60:64, :].sum(dtype=torch.int64)
        steering = torch.clamp(stanley_steering(
            info["cte"], info["heading_error"], SPEED, K, max_steer
        ), -1.0, 1.0)
        action = {"car_control": torch.stack(
                      [speed, steering.to(torch.float32)], dim=-1),
                  "maneuver": maneuver}
        vstate, _, rew, _, _, info = vector.step(
            params, vstate, action, render=False,
            max_episode_steps=max_episode_steps, respawn_rows=respawn_rows,
        )
        return vstate, info, checksum, obs, rew

    return body


def carried(vstate, info, checksum):
    """The tensors one step reads and writes: the car state's fields, the
    wrapper counters, the episode steps, the info the steering reads and
    the checksum."""
    car = vstate.env.car
    return ([getattr(car, f.name) for f in fields(car)]
            + list(vstate.counters)
            + [vstate.episode_step, info["cte"], info["heading_error"],
               checksum])


def capture(params, body, vstate, info, checksum, warmup: int = WARMUP):
    """One step of `body` captured as a CUDA graph over static buffers
    (`graphs.capture_carried`): `warmup` eager steps on a side stream,
    then one step captured over the resulting state (the state's
    generator registered). Returns (graph, (vstate, info, checksum)): the
    static state, which every `graph.replay()` advances by one step.
    Raises unless each render kernel (`env.render_kernels`) was launched
    exactly once during the capture."""
    graph, state = graphs.capture_carried(
        lambda *s: body(*s)[:3], (vstate, info, checksum), carried,
        fenv.render_kernels(params), generators=(vstate.generator,),
        warmup=warmup, what="bench")
    return graph, tuple(state)


def graph_matches_eager(params, n_envs: int, steps: int,
                        max_episode_steps: int, seed: int = 0) -> Dict:
    """S = `steps` steps of the bench body eagerly and S replays of its
    graph from the same state and generator seed. Returns {"equal": every
    carried tensor equal bit for bit, "respawns": the envs respawned in
    the eager run, "offsets": the generator's philox offset after each
    run}. A short `max_episode_steps` makes envs respawn, so the replays
    must draw the same rows as the eager steps, each replay new ones."""
    dev = params.device
    rows = torch.arange(n_envs, device=dev) % params.map_data.spawns.count
    body = make_body(params, n_envs, max_episode_steps)

    def start():
        vstate, _ = vector.reset(params, n_envs, seed=seed, render=False,
                                 spawn_rows=rows)
        info = fenv._info(params, vstate.env)
        return vstate, info, torch.zeros((), dtype=torch.int64, device=dev)

    vstate, info, checksum = start()
    respawns = 0
    for _ in range(steps):
        vstate, info, checksum, _, _ = body(vstate, info, checksum)
        respawns += int((vstate.episode_step == 0).sum())
    eager = [t.clone() for t in carried(vstate, info, checksum)]
    eager_offset = vstate.generator.get_offset()

    vstate, info, checksum = start()
    initial = [t.clone() for t in carried(vstate, info, checksum)]
    initial_rng = vstate.generator.get_state()
    graph, (vstate, info, checksum) = capture(params, body, vstate, info,
                                              checksum)
    # undo the capture's warm-up steps: the state and the generator as the
    # eager run started from them
    for dst, src in zip(carried(vstate, info, checksum), initial):
        dst.copy_(src)
    vstate.generator.set_state(initial_rng)
    for _ in range(steps):
        graph.replay()
    torch.cuda.synchronize()
    replayed = carried(vstate, info, checksum)
    equal = all(torch.equal(a, b) for a, b in zip(eager, replayed))
    return {"equal": equal, "respawns": respawns,
            "offsets": (eager_offset, vstate.generator.get_offset())}


def host_replay_ms(replay, n: int = HOST_PROBE_REPLAYS) -> float:
    """The host's ms per `replay()` call with the card held busy by a spin
    kernel, so that no call waits for the card: what enqueuing one step
    costs the host. Raises if the spin ended before the calls did (then
    they may have waited)."""
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_PROBE_SPIN_CYCLES)
    spun = torch.cuda.Event()
    spun.record()
    start = time.perf_counter()
    for _ in range(n):
        replay()
    ms = (time.perf_counter() - start) / n * 1e3
    held = not spun.query()
    torch.cuda.synchronize()
    if not held:
        raise RuntimeError("the spin kernel ended before the replays were "
                           "enqueued: raise HOST_PROBE_SPIN_CYCLES")
    return ms


def measure(device="cuda", n_envs: int = N_ENVS, chunk: int = CHUNK,
            repeats: int = REPEATS) -> Dict:
    """bench.py's measure_ours on the port: reset (seed 0), the overflow
    guard, one warm-up chunk (its checksum must be > 0), then `repeats`
    chunks of `chunk` steps, each ended by a synchronize. On CUDA the
    step is a replayed graph (`capture`); on the CPU it runs eagerly.
    Returns {"rates" (env-steps/s, in the order the repeats ran),
    "clocks" (on CUDA, `card_clocks()` read after each repeat; empty on
    the CPU), "median", "min", "max",
    "checksum", "graph" (None on the CPU), "state", "params"}."""
    device = resolve_device(device)
    params = fenv.make_env_params(CONFIG, device=device)
    vstate, _ = vector.reset(params, n_envs, seed=0, render=False)
    # segment-budget guard: the benchmark must not be fast by silently
    # dropping visible segments
    overflow = int(fenv.check_segment_overflow(params, vstate.env).sum())
    if overflow:
        raise RuntimeError(f"{overflow} rasterizer slot copies dropped -- "
                           "raise CameraConfig.max_visible_segments")
    info = fenv._info(params, vstate.env)
    checksum = torch.zeros((), dtype=torch.int64, device=device)
    body = make_body(params, n_envs)
    graph = None
    if device.type == "cuda":
        graph, state = capture(params, body, vstate, info, checksum)
        step = graph.replay
    else:
        state = [vstate, info, checksum]

        def step():
            state[:] = body(*state)[:3]

    def run_chunk():
        for _ in range(chunk):
            step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        checksum = int(state[2])
        if checksum <= 0:
            raise RuntimeError("observations were not rendered")
        return checksum

    run_chunk()
    rates, clocks = [], []
    for _ in range(max(repeats, 5)):
        start = time.perf_counter()
        checksum = run_chunk()
        rates.append(n_envs * chunk / (time.perf_counter() - start))
        if device.type == "cuda":
            clocks.append(card_clocks())
    return {"rates": rates, "clocks": clocks,
            "median": statistics.median(rates),
            "min": min(rates), "max": max(rates), "checksum": checksum,
            "graph": graph, "state": state, "params": params}


def result_line(result: Dict, n_envs: int, repeats: int, device: str
                ) -> Dict:
    """bench.py's JSON keys (bench.py:204-223) for `measure`'s result, and
    `device`; the baseline is bench.py's recorded one."""
    ref = RECORDED_REFERENCE_SPS
    fmt = CONFIG["sim"]["observation_space_format"]
    return {
        "metric": f"env-steps/s/chip at {n_envs} envs ({fmt} obs, Stanley)",
        "value": round(result["median"], 1),
        "unit": "env-steps/s",
        # the recorded reference number is of classes observations
        "vs_baseline": (round(result["median"] / ref, 2)
                        if fmt == "classes" else None),
        "baseline_reference_steps_per_s": ref,
        "baseline_measured_live": False,
        "spread_min": round(result["min"], 1),
        "spread_max": round(result["max"], 1),
        "repeats": max(repeats, 5),
        "n_envs": n_envs,
        "device": device,
    }


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]
                            ).parse_args(argv)
    result = measure()
    print("repeats in order (env-steps/s; then the SM clock, memory clock, "
          "power draw, temperature):", file=sys.stderr)
    for rate, clocks in zip(result["rates"], result["clocks"]):
        print(f"  {rate:.1f}; {clocks}", file=sys.stderr)
    print(json.dumps(result_line(result, N_ENVS, REPEATS, card_line())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
