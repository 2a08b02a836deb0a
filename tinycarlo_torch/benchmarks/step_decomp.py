"""The headline step by stage on the card: modes that enable the stages
of bench.py's step one by one, each a replayed CUDA graph.

    python -m tinycarlo_torch.benchmarks.step_decomp [kin kininfo car proj comp full bench]

The counterpart of benchmarks/step_decomp.py (:48-165), which stays the
JAX package's: bench.py's config (simple_layout, 128x160 classes, t =
2), BENCH_ENVS (4096) envs, Stanley steering at speed 0.5 and K 5,
maneuver 0, `vector.step(render=False, max_episode_steps=1000)`. Modes,
each with the script's checksum:

  kin     : `car.car_step` alone (steering 0.05, maneuver 0), on |position|
  kininfo : + `car.car_info`, on |cte|
  car     : `vector.step` with Stanley actions, on |cte|
  proj    : + the packed projection, on |u0, v0| where drawn
  comp    : + `compact_env_idx_soa` at the budget min(128 * nxb, E * nxb)
            (no kernel), on the sum of the bundle's fields
  full    : + the masks kernel on that bundle, on the masks
  bench   : `render_observation_batch` in place of the three (bench.py's
            step, the production budget), on the masks

`full` runs the port's one compaction of the fast stroke, at gran 16
with the line split, which the masks kernel reads (the script's `full`
takes rasterize_pallas.py's older `compact_env_idx` at gran 8, a layout
the port does not keep); unlike `bench` it passes no layer bounds, as
the script does not. The default modes are the script's: car proj comp
full. The differences between modes price the stages (`stages_ms`):
kininfo - kin `car_info`, car - kininfo the rest of the step, proj - car
the projection, comp - proj the compaction, full - comp the kernel and
the checksum of the whole frame. That checksum is the script's (it sums
every pixel); torch's uint8 -> int64 sum first writes an int64 copy of
the frame, so it costs more than the kernel (profile_step's trace
separates the two).

Timing, the script's protocol: inputs for 6 repeats, each a reset from
its own generator seed (0-5) and its info, built and synced before any
timing; each mode is one captured step, run warm on seed 0's inputs,
then replayed ITERS (30) times on each of seeds 1-5's, copied into the
graph's buffers before the clock starts, the chunk ended by
`torch.cuda.synchronize()`. Prints each mode's median ms a step and all
five, as the script does, then one JSON line.

Runs on the card and raises without a GPU; `run(device="cpu")` runs the
same steps eagerly (tests).
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time
from dataclasses import fields, replace
from typing import Dict, List, Optional

import torch

from tinycarlo_torch import car as car_mod
from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.train.stanley import stanley_steering
from tinycarlo_torch.utils import graphs
from tinycarlo_torch.utils.helper import card_line, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_ENVS = int(os.environ.get("BENCH_ENVS", 4096))
ITERS = 30
REPEATS = 5
H, W, THICK, GRAN, MAXVIS = 128, 160, 2, 8, 128
# step_decomp.py:33-46
CONFIG = {
    "sim": {"fps": 30, "observation_space_format": "classes"},
    "car": {"wheelbase": 0.0487, "track_width": 0.027,
            "max_velocity": 0.15, "max_steering_angle": 30,
            "steering_speed": 30, "max_acceleration": 0.1,
            "max_deceleration": 1.0},
    "camera": {"position": [0.0, -0.005, 0.04], "orientation": [22, 0, 0],
               "resolution": [H, W], "fov": 80, "max_range": 0.5,
               "line_thickness": THICK},
    "map": {"json_path": os.path.join(
        REPO, "examples/maps/simple_layout.json"),
        "pixel_per_meter": 450},
}
SPEED, K = 0.5, 5.0
MODES = ("kin", "kininfo", "car", "proj", "comp", "full", "bench")
DEFAULT_MODES = ("car", "proj", "comp", "full")
# the modes whose step launches the masks kernel (once)
RENDERING = ("full", "bench")


def budget(params) -> int:
    """The script's copy budget: min(MAXVIS * nxb, E * nxb)."""
    nxb = rk._n_xblocks(params.cfg.camera.resolution[1])
    e = params.map_data.packed_edges.shape[-2]
    return min(MAXVIS * nxb, e * nxb)


def stage_values(params, env_state, mode: str):
    """The values a mode's checksum sums: `proj`, the packed projection
    ((B, E, 2) p0 and p1, (B, E) draw); `comp`, the bundle of
    `compact_env_idx_soa` on it; `full`, the masks kernel's masks of
    that bundle."""
    md = params.map_data
    h, w = params.cfg.camera.resolution
    t = params.cfg.camera.line_thickness
    u0, v0, u1, v1, draw = fenv._project_packed_batch_soa(params, env_state)
    if mode == "proj":
        return (torch.stack([u0, v0], -1), torch.stack([u1, v1], -1), draw)
    bundle = rk.compact_env_idx_soa(
        u0, v0, u1, v1, draw, budget(params), h, t,
        edge_layer=md.packed_edge_layer, n_layers=md.n_layers, w=w)
    if mode == "comp":
        return bundle
    return rk.masks_kernel(bundle, md.n_layers, (h, w), t)


def make_step(params, mode: str, n_envs: int):
    """A mode's step: step(vstate, info, checksum) -> (vstate, info,
    checksum) with the script's checksum (int64 here, uint32 there)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: one of {MODES}")
    dev = params.device
    cfg = params.cfg
    max_steer = cfg.car.max_steering_angle
    speed = torch.full((n_envs,), SPEED, dtype=torch.float32, device=dev)
    steer = torch.full((n_envs,), 0.05, dtype=torch.float32, device=dev)
    maneuver = torch.zeros(n_envs, dtype=torch.int32, device=dev)

    def to_int(x):
        return x.to(torch.int64)

    if mode in ("kin", "kininfo"):
        def step(vstate, info, checksum):
            new_car, _ = car_mod.car_step(
                params.map_data, cfg.car, cfg.sim.T, vstate.env.car,
                speed, steer, maneuver)
            vstate = replace(vstate, env=replace(vstate.env, car=new_car))
            checksum = checksum + to_int(new_car.position.abs().sum())
            if mode == "kininfo":
                cte = car_mod.car_info(params.map_data, cfg.car,
                                       new_car)["cte"]
                checksum = checksum + to_int(cte.abs().sum())
            return vstate, info, checksum

        return step

    def step(vstate, info, checksum):
        if mode == "bench":
            obs = fenv.render_observation_batch(params, vstate.env)
            checksum = checksum + obs.sum(dtype=torch.int64)
        elif mode != "car":
            out = stage_values(params, vstate.env, mode)
            if mode == "proj":
                p0, _, draw = out
                checksum = checksum + to_int(
                    torch.where(draw[..., None], p0, 0.0).abs().sum())
            elif mode == "comp":
                checksum = checksum + to_int(
                    sum(x.to(torch.float32).sum() for x in out))
            else:
                checksum = checksum + out.sum(dtype=torch.int64)
        steering = torch.clamp(stanley_steering(
            info["cte"], info["heading_error"], SPEED, K, max_steer),
            -1.0, 1.0)
        action = {"car_control": torch.stack(
            [speed, steering.to(torch.float32)], dim=-1),
            "maneuver": maneuver}
        vstate, _, _, _, _, info = vector.step(
            params, vstate, action, render=False, max_episode_steps=1000)
        checksum = checksum + to_int(info["cte"].abs().sum())
        return vstate, {"cte": info["cte"],
                        "heading_error": info["heading_error"]}, checksum

    return step


def make_inputs(params, n_envs: int, seed: int):
    """(vstate, info, checksum) of a reset from generator seed `seed`."""
    vstate, _ = vector.reset(params, n_envs, seed=seed, render=False)
    info = fenv._info(params, vstate.env)
    return [vstate, {"cte": info["cte"],
                     "heading_error": info["heading_error"]},
            torch.zeros((), dtype=torch.int64, device=params.device)]


def carried(vstate, info, checksum) -> List[torch.Tensor]:
    car = vstate.env.car
    return ([getattr(car, f.name) for f in fields(car)]
            + list(vstate.counters)
            + [vstate.episode_step, info["cte"], info["heading_error"],
               checksum])


def capture_mode(params, mode: str, step, state):
    """One step of `mode` captured over `state` after two eager steps
    (`graphs.capture_carried`). Returns (graph, static state). Raises
    unless the masks kernel was launched once during the capture in a
    rendering mode and never in another."""
    before = rk.masks_kernel.launches
    graph, state = graphs.capture_carried(
        step, state, carried,
        (rk.masks_kernel,) if mode in RENDERING else (),
        generators=(state[0].generator,), warmup=2,
        what=f"step_decomp {mode}")
    if mode not in RENDERING and rk.masks_kernel.launches != before:
        raise RuntimeError(f"step_decomp {mode}: the step launched the "
                           "masks kernel")
    return graph, state


def run_mode(params, mode: str, n_envs: int, iters: int,
             inputs: List) -> Dict:
    """One mode: warm on inputs[0], then `iters` steps on each of
    inputs[1:] (a replayed graph on the card, eager steps on the CPU),
    each copied into the step's own state first. Returns {"mode", "ms"
    (median a step), "all" (each repeat's), and "checksum" (the last
    repeat's)}."""
    step = make_step(params, mode, n_envs)
    cuda = params.device.type == "cuda"
    state = make_inputs(params, n_envs, 0)
    if cuda:
        graph, state = capture_mode(params, mode, step, state)
        replay = graph.replay
    else:
        def replay():
            state[:] = step(*state)

    times = []
    for rep, src in enumerate(inputs):
        graphs.copy_into(carried(*state), carried(*src))
        state[0].generator.set_state(src[0].generator.get_state())
        if cuda:
            torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(iters):
            replay()
        if cuda:
            torch.cuda.synchronize()
        checksum = int(state[2])
        if rep:
            times.append((time.perf_counter() - start) / iters * 1e3)
    return {"mode": mode, "ms": statistics.median(times), "all": times,
            "checksum": checksum}


def run(device="cuda", modes=DEFAULT_MODES, n_envs: int = N_ENVS,
        iters: int = ITERS, repeats: int = REPEATS,
        config: Optional[Dict] = None) -> Dict:
    """The modes at the script's protocol (module docstring); `config`
    replaces the script's (tests). Returns the JSON line's dict."""
    dev = resolve_device(device)
    params = fenv.make_env_params(config or CONFIG, device=dev)
    inputs = [make_inputs(params, n_envs, seed)
              for seed in range(repeats + 1)]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    results = [run_mode(params, mode, n_envs, iters, inputs)
               for mode in modes]
    ms = {r["mode"]: r["ms"] for r in results}
    return {
        "metric": "ms a step by stage (step_decomp modes)",
        "n_envs": n_envs,
        "iters": iters,
        "modes": results,
        # the stages by difference, where both modes ran; full's checksum
        # sums the whole frame, comp's the bundle (module docstring)
        "stages_ms": {name: ms[b] - ms[a] for name, a, b in (
            ("car_step", "kin", "kin"), ("car_info", "kin", "kininfo"),
            ("step_rest", "kininfo", "car"), ("projection", "car", "proj"),
            ("compaction", "proj", "comp"),
            ("kernel_and_frame_checksum", "comp", "full"))
            if a in ms and b in ms},
        "device": card_line() if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    resolve_device("cuda")
    result = run(modes=tuple(argv) or DEFAULT_MODES)
    for r in result["modes"]:
        print(f"{r['mode']}: med {r['ms']:.2f} ms/step  (all: "
              + " ".join(f"{t:.2f}" for t in r["all"]) + ")", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
