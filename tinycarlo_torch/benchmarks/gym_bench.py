"""Steps/s of the single-env Gymnasium shim (`gym_env.TinyCarloEnv`).

    python -m tinycarlo_torch.benchmarks.gym_bench

Two configs, each at its published widths:
- `config1`: benchmarks/baseline_configs.py:38-51 (BASELINE config 1):
  simple_layout, 64x64 classes masks, line thickness 2;
- `simple_layout`: examples/config_simple_layout.yaml (rgb 128x160, 16
  spawn points).
The workload: `reset(seed=3)`, one step that is not timed (on the card
it captures the step's CUDA graph), then 200 steps of random
actions from `np.random.default_rng(3)` (car_control uniform in [-1, 1],
maneuver uniform in 0-3), resetting on termination or truncation; each
step returns its numpy observation, so its time is the host's wall time
of a whole step, transfers included. Each config runs in three modes:
`graph` (the default on the card: every step a replayed CUDA graph),
`eager` (on the card, `graphs=False`: the step's kernels launched one by
one) and `cpu` (`device="cpu"`, the plain PyTorch path on this machine's
CPU). Prints one JSON line per (config, mode):
steps/s, ms a step, the first step's ms, renders, resets, replays, the
render kernels' launches as their wrappers count them and the launches
expected: on the card, of each kernel a render launches
(`env.render_kernels`), one a render that ran eagerly (the resets and, in
graph mode, the first step) and one for each graph's capture, which
records the launch its replays run (a replay passes no wrapper: a
profiler trace counts its launches); none on the CPU. Then the card's
name and power limit.

Runs on the card and raises without a GPU; `run(env)` drives any shim
(the tests call it on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

from tinycarlo_torch.env import render_kernels
from tinycarlo_torch.gym_env import TinyCarloEnv
from tinycarlo_torch.ops.rasterize_kernels import RENDER_KERNELS
from tinycarlo_torch.utils.helper import card_line, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# benchmarks/baseline_configs.py:38-51
CONFIG1 = {
    "sim": {"fps": 30, "observation_space_format": "classes"},
    "car": {"wheelbase": 0.0487, "track_width": 0.027,
            "max_velocity": 0.15, "max_steering_angle": 30,
            "steering_speed": 30, "max_acceleration": 0.1,
            "max_deceleration": 1.0},
    "camera": {"position": [0.0, -0.005, 0.04],
               "orientation": [22, 0, 0], "resolution": [64, 64],
               "fov": 80, "max_range": 0.5, "line_thickness": 2},
    "map": {"json_path": os.path.join(REPO, "examples/maps/simple_layout.json"),
            "pixel_per_meter": 450},
}
# config 1 under the exact stroke (the exact kernel)
CONFIG1_EXACT = dict(CONFIG1,
                     camera=dict(CONFIG1["camera"], stroke="exact"))
CONFIGS = {
    "config1": CONFIG1,
    "simple_layout": os.path.join(REPO, "examples/config_simple_layout.yaml"),
}
MODES = ("graph", "eager", "cpu")
STEPS = 200
SEED = 3


def actions(n: int, seed: int = SEED) -> List[Dict]:
    """n random actions, as `action_space.sample()` draws them."""
    rng = np.random.default_rng(seed)
    return [{"car_control": rng.uniform(-1.0, 1.0, 2).astype(np.float32),
             "maneuver": int(rng.integers(0, 4))} for _ in range(n)]


def run(env, steps: int = STEPS, seed: int = SEED) -> Dict:
    """The workload on `env`: reset, one untimed step, `steps` timed steps
    (reset on termination or truncation). Returns steps_per_s, ms_step,
    first_ms (the untimed step), renders (reset and step renders) and
    resets (the seeded one included)."""
    acts = actions(steps + 1, seed)
    env.reset(seed=seed)
    start = time.perf_counter()
    env.step(acts[0])
    first_ms = (time.perf_counter() - start) * 1e3
    resets = 1
    start = time.perf_counter()
    for action in acts[1:]:
        _, _, terminated, truncated, _ = env.step(action)
        if terminated or truncated:
            env.reset()
            resets += 1
    seconds = time.perf_counter() - start
    return {"steps_per_s": steps / seconds, "ms_step": seconds / steps * 1e3,
            "first_ms": first_ms, "renders": resets + steps + 1,
            "resets": resets}


def make_env(config, mode: str) -> TinyCarloEnv:
    """The shim of one mode: graph and eager on the card, cpu on the CPU."""
    env = TinyCarloEnv(config=config,
                       device="cpu" if mode == "cpu" else "cuda")
    env.graphs = mode == "graph"
    return env


def measure(name: str, mode: str, steps: int = STEPS, config=None) -> Dict:
    """`run` on a new shim of config `name` (or of `config`) in `mode`
    (`counted_run`)."""
    env = make_env(CONFIGS[name] if config is None else config, mode)
    return counted_run(env, lambda: run(env, steps), config=name, mode=mode,
                       steps=steps)


def counted_run(env, run_fn, **labels) -> Dict:
    """run_fn()'s result on a new shim or twin `env`, the render kernels'
    launch counts set to 0 before it and read after it, beside the
    launches expected (see the module's docstring), with `labels`; closes
    `env`."""
    for kernel in RENDER_KERNELS:
        kernel.launches = 0
    result = run_fn()
    captures, replays = env.step_graphs.captures, env.step_graphs.replays
    want = {k.NAME: 0 for k in RENDER_KERNELS}
    if env.device.type == "cuda":
        want.update((k.NAME, result["renders"] - replays + captures)
                    for k in render_kernels(env.params))
    result.update(**labels, format=env.observation_space_format,
                  replays=replays,
                  captures=captures,
                  launches={k.NAME: k.launches for k in RENDER_KERNELS},
                  want_launches=want)
    env.close()
    return result


def _same(a, b) -> bool:
    """Equal in value, type, dtype and shape, recursively."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def graph_matches_eager(config, steps: int = 20, seed: int = SEED) -> int:
    """Two shims of `config` on the card, one replaying its step graphs
    and one stepping eagerly, from one seed through the same actions
    (resetting on termination or truncation): the first step (the graph's
    capture, itself eager), then `steps` steps, replays on the first shim.
    Returns how many of the `steps` replayed steps returned what the eager
    steps returned (observation, reward, flags, info) bit for bit; raises
    if the resets or the first step differ."""
    graph, eager = make_env(config, "graph"), make_env(config, "eager")
    acts = actions(steps + 1, seed)
    outs = [(graph.reset(seed=seed), eager.reset(seed=seed)),
            (graph.step(acts[0]), eager.step(acts[0]))]
    if not all(_same(a, b) for a, b in outs):
        raise RuntimeError("the shims differ before any replay")
    equal = 0
    for action in acts[1:]:
        out = graph.step(action)
        equal += _same(out, eager.step(action))
        if out[2] or out[3]:
            graph.reset()
            eager.reset()
    graph.close()
    eager.close()
    return equal


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]
                            ).parse_args(argv)
    resolve_device("cuda")
    for name in CONFIGS:
        for mode in MODES:
            print(json.dumps(measure(name, mode)), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
