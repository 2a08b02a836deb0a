"""Steps/s of the digital twin (`real_world.TinyCarloRealWorldEnv`) on the
loopback backend.

    python -m tinycarlo_torch.benchmarks.twin_bench

Two configs: `simple_layout`, examples/config_simple_layout.yaml (rgb
128x160, the rank kernel), and `classes`, bench.py's CONFIG (bench.py:
31-59: simple_layout, 5 classes masks at 128x160, t = 2, the masks
kernel). The "hardware" is `LoopbackCar` (a numpy bicycle model) started
at START, and the camera falls back to the simulated view at the tracked
pose. The workload: `reset(seed=3)` (the loopback car is placed on the
nearest lanepath pose), one untimed step (on the card it captures the
step's CUDA graph), then 300 steps steered by the Stanley law of
examples/stanley_control.py (k = 4, speed 0.4, the left maneuver) from
the last info, resetting on termination or truncation; each step returns
its numpy observation, so its time is the host's wall time of a whole
step. Modes as tinycarlo_torch.benchmarks.gym_bench's: `graph` (every
step a replayed CUDA graph), `eager` (on the card, `graphs=False`) and
`cpu`. One JSON line per (config, mode) -- steps/s, ms a step, the first
step's ms, renders, resets, replays, the render kernels' launches as
their wrappers count them and the launches expected (of each kernel a
render launches, one a render that ran eagerly and one a capture; a
replay passes no wrapper) -- then the
card's name and power limit.

Runs on the card and raises without a GPU; `run(env)` drives any twin
(the tests call it on the CPU).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict

from tinycarlo_torch.benchmarks.gym_bench import _same, counted_run
from tinycarlo_torch.real_world.env import TinyCarloRealWorldEnv
from tinycarlo_torch.real_world.environments.env_loopback import (
    LoopbackCamera,
    LoopbackCar,
)
from tinycarlo_torch.utils.helper import card_line, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# bench.py's CONFIG (bench.py:31-59)
CLASSES = {
    "sim": {"fps": 30, "observation_space_format": "classes"},
    "car": {"wheelbase": 0.0487, "track_width": 0.027,
            "max_velocity": 0.15, "max_steering_angle": 30,
            "steering_speed": 30, "max_acceleration": 0.1,
            "max_deceleration": 1.0},
    "camera": {"position": [0.0, -0.005, 0.04],
               "orientation": [22, 0, 0], "resolution": [128, 160],
               "fov": 80, "max_range": 0.5, "line_thickness": 2},
    "map": {"json_path": os.path.join(REPO, "examples/maps/simple_layout.json"),
            "pixel_per_meter": 450},
}
CONFIGS = {
    "simple_layout": os.path.join(REPO, "examples/config_simple_layout.yaml"),
    "classes": CLASSES,
}
MODES = ("graph", "eager", "cpu")
STEPS = 300
SEED = 3
START = (0.9, 1.2, 0.0)  # the loopback car's pose before the reset's snap
K, SPEED, MANEUVER = 4.0, 0.4, 3  # examples/stanley_control.py


def make_twin(config, mode: str, **kw) -> TinyCarloRealWorldEnv:
    """A twin on a LoopbackCar started at START, in `mode` (graph and
    eager on the card, cpu on the CPU); `kw` goes to the env."""
    env = TinyCarloRealWorldEnv(
        config=config, backend=(LoopbackCar(start=START), LoopbackCamera()),
        device="cpu" if mode == "cpu" else "cuda", **kw)
    env.graphs = mode == "graph"
    return env


def stanley(env, info) -> Dict:
    """examples/stanley_control.py's action from a step's info."""
    steering = ((info["heading_error"] + math.atan2(K * info["cte"], SPEED))
                * 180 / math.pi / env.car.max_steering_angle)
    return {"car_control": [SPEED, steering], "maneuver": MANEUVER}


def run(env, steps: int = STEPS, seed: int = SEED) -> Dict:
    """The workload on `env`: reset, one untimed step, `steps` timed
    Stanley steps (reset on termination or truncation). Returns
    steps_per_s, ms_step, first_ms, renders (reset and step renders) and
    resets (the seeded one included)."""
    _, info = env.reset(seed=seed)
    start = time.perf_counter()
    _, _, _, _, info = env.step(stanley(env, info))
    first_ms = (time.perf_counter() - start) * 1e3
    resets = 1
    start = time.perf_counter()
    for _ in range(steps):
        _, _, terminated, truncated, info = env.step(stanley(env, info))
        if terminated or truncated:
            _, info = env.reset()
            resets += 1
    seconds = time.perf_counter() - start
    return {"steps_per_s": steps / seconds, "ms_step": seconds / steps * 1e3,
            "first_ms": first_ms, "renders": resets + steps + 1,
            "resets": resets}


def measure(name: str, mode: str, steps: int = STEPS) -> Dict:
    """`run` on a new twin of config `name` in `mode`
    (gym_bench.counted_run)."""
    env = make_twin(CONFIGS[name], mode)
    return counted_run(env, lambda: run(env, steps), config=name, mode=mode,
                       steps=steps)


def graph_matches_eager(config, steps: int = 20, seed: int = SEED) -> int:
    """Two twins of `config` on the card, one replaying its step graphs
    and one stepping eagerly, each on its own loopback car, through the
    same Stanley actions (from the replaying twin's info): the resets and
    the first step (the capture, itself eager), then `steps` steps.
    Returns how many of the `steps` replayed steps returned what the
    eager steps returned (observation, reward, flags, info) bit for bit;
    raises if the resets or the first step differ."""
    graph, eager = make_twin(config, "graph"), make_twin(config, "eager")
    outs = [(graph.reset(seed=seed), eager.reset(seed=seed))]
    action = stanley(graph, outs[0][0][1])
    outs.append((graph.step(action), eager.step(action)))
    if not all(_same(a, b) for a, b in outs):
        raise RuntimeError("the twins differ before any replay")
    info, equal = outs[1][0][4], 0
    for _ in range(steps):
        action = stanley(graph, info)
        out = graph.step(action)
        equal += _same(out, eager.step(action))
        info = out[4]
        if out[2] or out[3]:
            _, info = graph.reset()
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
