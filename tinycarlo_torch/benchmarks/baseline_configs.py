"""BASELINE configs 1, 3 and 4 on the card.

    python -m tinycarlo_torch.benchmarks.baseline_configs [1 3 4]

The counterpart of benchmarks/baseline_configs.py, which stays the JAX
package's. Each config prints the script's JSON line with `device`, the
card's name and power limit, added:

- `config1` (:36-81): the single-env Gymnasium shim on 64x64 classes
  frames, 200 random steps (tinycarlo_torch.benchmarks.gym_bench's
  `config1` workload through the replayed CUDA graph), the line in the
  script's shape: `ours`, and `reference` from the original numpy
  simulator when TINYCARLO_REFERENCE names its checkout (null otherwise,
  as the script's when its checkout is absent).
- `config3` (:84-163): knuffingen at ppm 222, a 480x640 camera at fov 80,
  line thickness 2, max_velocity 0.1, BENCH_ENVS3 (512) envs,
  BENCH_OBS_FORMAT3 (classes; `rank` renders the rank kernel's map). The
  step (:114-135): render, add rows 238:242 of the frame to an int64
  checksum, the constant car_control [0.5, 0.05] (float32), maneuver
  (i + env) % 4, `vector.step(render=False, max_episode_steps=1000)`.
  Protocol: `max_visible_overflow_at_reset`, the largest per-env count of
  `env.check_segment_overflow` at the reset states (printed as measured),
  then one warm chunk and 5 timed chunks of BENCH_CHUNK3 (100) replays of
  one captured step, each chunk ended by `torch.cuda.synchronize()`;
  `value` is the median rate, `spread` the min and max.
- `config4` (:166-262): `td3_bench.run` at the script's defaults,
  BENCH_ENVS4 (64), BENCH_CHUNK4 (200), BENCH_OBS_DTYPE and
  BENCH_ENC_DTYPE (bfloat16).

The step index. The script's scan passes the step index i to its body as
data, and restarts it at 0 every chunk (`jnp.arange(chunk_steps)`). A
captured step cannot take a Python int (it would be frozen at capture,
and every replay would draw the same maneuvers), so the index is a
carried int32 device tensor that the graph itself increments, set to 0
(`fill_`) before each chunk's first replay: any BENCH_CHUNK3 gives the
script's maneuver schedule.

Runs on the card and raises without a GPU; `measure3(device="cpu")` runs
the same step eagerly for the tests (at a frame they choose).
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time
from dataclasses import fields
from typing import Dict, Optional

import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import geometry as geo
from tinycarlo_torch import vector
from tinycarlo_torch.utils import graphs
from tinycarlo_torch.utils.helper import card_line, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the original numpy simulator's checkout, where there is one
REFERENCE = os.environ.get("TINYCARLO_REFERENCE", "")
N_ENVS3 = int(os.environ.get("BENCH_ENVS3", 512))
CHUNK3 = int(os.environ.get("BENCH_CHUNK3", 100))
FORMAT3 = os.environ.get("BENCH_OBS_FORMAT3", "classes")
REPEATS3 = 5
MAX_EPISODE_STEPS = 1000
# the script's checksum band, rows 238:242 of a 480-row frame
BAND3 = (238, 242)
CONTROL3 = (0.5, 0.05)
# eager steps before the capture (bench.WARMUP)
WARMUP = 3
# config4's environment variables and their defaults (:174-198)
CONFIG4_ENV = {"BENCH_ENVS4": 64, "BENCH_CHUNK4": 200,
               "BENCH_OBS_DTYPE": "bfloat16", "BENCH_ENC_DTYPE": "bfloat16"}


def config3_dict(fmt: str = FORMAT3) -> Dict:
    """baseline_configs.py:99-111 with the map path resolved."""
    return {
        "sim": {"fps": 30, "observation_space_format": fmt},
        "car": {"wheelbase": 0.0487, "track_width": 0.027,
                "max_velocity": 0.1, "max_steering_angle": 30,
                "steering_speed": 30, "max_acceleration": 0.1,
                "max_deceleration": 1.0},
        "camera": {"position": [0.0, -0.005, 0.04],
                   "orientation": [22, 0, 0], "resolution": [480, 640],
                   "fov": 80, "max_range": 0.5, "line_thickness": 2},
        "map": {"json_path": os.path.join(
            REPO, "examples/maps/knuffingen.json"),
            "pixel_per_meter": 222},
    }


def make_params3(device="cuda", fmt: str = FORMAT3, resolution=None,
                 thickness=None, dtype=torch.float32) -> fenv.EnvParams:
    """Config 3's params; `resolution` and `thickness` cut the camera
    (tests only)."""
    cfg = config3_dict(fmt)
    if resolution is not None:
        cfg["camera"]["resolution"] = list(resolution)
    if thickness is not None:
        cfg["camera"]["line_thickness"] = thickness
    return fenv.make_env_params(cfg, dtype=dtype, device=device)


def band_rows(h: int):
    """The checksum band of an h-row frame: the script's rows 238:242
    scaled from 480 rows (at least one row)."""
    lo = BAND3[0] * h // 480
    return lo, max(BAND3[1] * h // 480, lo + 1)


def make_body3(params: fenv.EnvParams, n_envs: int,
               max_episode_steps: int = MAX_EPISODE_STEPS):
    """Config 3's step (baseline_configs.py:114-135) on the port:
    body(vstate, checksum, i, respawn_rows=None) -> (vstate, checksum,
    i + 1, obs). `i` is the int32 step index (a 0-d tensor); maneuver
    (i + env) % 4 cycles straight, right, u-turn, left. `respawn_rows`
    (B,) injects the rows of the envs that finish (tests)."""
    dev = params.device
    lo, hi = band_rows(params.cfg.camera.resolution[0])
    control = torch.tensor(CONTROL3, dtype=torch.float32,
                           device=dev).repeat(n_envs, 1)
    env_ids = torch.arange(n_envs, dtype=torch.int32, device=dev)

    def body(vstate, checksum, i, respawn_rows=None):
        obs = fenv.render_observation_batch(params, vstate.env)
        checksum = checksum + obs[..., lo:hi, :].sum(dtype=torch.int64)
        action = {"car_control": control,
                  "maneuver": torch.remainder(i + env_ids, 4)}
        vstate, _, _, _, _, _ = vector.step(
            params, vstate, action, render=False,
            max_episode_steps=max_episode_steps, respawn_rows=respawn_rows)
        return vstate, checksum, i + 1, obs

    return body


def carried3(vstate, checksum, i):
    """The tensors config 3's step reads and writes."""
    car = vstate.env.car
    return ([getattr(car, f.name) for f in fields(car)]
            + list(vstate.counters) + [vstate.episode_step, checksum, i])


def start3(params, n_envs: int, seed: int = 0, spawn_rows=None):
    """(vstate, checksum, i) at reset: seed `seed`, checksum and index 0."""
    dev = params.device
    vstate, _ = vector.reset(params, n_envs, seed=seed, render=False,
                             spawn_rows=spawn_rows)
    return (vstate, torch.zeros((), dtype=torch.int64, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev))


def capture3(params, body, state, warmup: int = WARMUP):
    """`warmup` eager steps, then one step captured over the resulting
    state (`graphs.capture_carried`, the respawn generator registered).
    Returns (graph, [vstate, checksum, i]), the static state each replay
    advances by one step. Raises unless each render kernel
    (`env.render_kernels`) was launched once during the capture."""
    return graphs.capture_carried(
        lambda *s: body(*s)[:3], state, carried3,
        fenv.render_kernels(params),
        generators=(state[0].generator,), warmup=warmup, what="config 3")


def measure3(device="cuda", n_envs: int = N_ENVS3, chunk: int = CHUNK3,
             repeats: int = REPEATS3, fmt: str = FORMAT3,
             resolution=None) -> Dict:
    """config3's protocol (module docstring). On CUDA the step is a
    replayed graph; on the CPU it runs eagerly. Returns {"rates" (in the
    order the chunks ran), "median", "min", "max", "overflow",
    "checksum" (the last chunk's), "graph" (None on the CPU), "state",
    "params"}."""
    device = resolve_device(device)
    params = make_params3(device, fmt, resolution)
    state = start3(params, n_envs)
    overflow = int(fenv.check_segment_overflow(params, state[0].env).max())
    body = make_body3(params, n_envs)
    graph = None
    if device.type == "cuda":
        graph, state = capture3(params, body, state)
        step = graph.replay
    else:
        state = list(state)

        def step():
            state[:] = body(*state)[:3]

    def run_chunk():
        state[1].fill_(0)
        state[2].fill_(0)  # the scan's index restarts every chunk
        for _ in range(chunk):
            step()
        if device.type == "cuda":
            torch.cuda.synchronize()
        checksum = int(state[1])
        if checksum <= 0:
            raise RuntimeError("config 3: observations were not rendered")
        return checksum

    run_chunk()
    rates = []
    for _ in range(repeats):
        start = time.perf_counter()
        checksum = run_chunk()
        rates.append(n_envs * chunk / (time.perf_counter() - start))
    return {"rates": rates, "median": statistics.median(rates),
            "min": min(rates), "max": max(rates), "overflow": overflow,
            "checksum": checksum, "graph": graph, "state": state,
            "params": params}


def line3(result: Dict, n_envs: int, fmt: str, device: str) -> Dict:
    """The script's JSON line (baseline_configs.py:152-161) and `device`."""
    return {
        "config": 3,
        "metric": f"knuffingen 480x640 {fmt} env-steps/s, maneuver"
                  " switching",
        "value": round(result["median"], 1),
        "spread": [round(result["min"], 1), round(result["max"], 1)],
        "n_envs": n_envs,
        "max_visible_overflow_at_reset": result["overflow"],
        "device": device,
    }


def graph_matches_eager3(params, n_envs: int, steps: int,
                         max_episode_steps: int = MAX_EPISODE_STEPS,
                         seed: int = 0) -> Dict:
    """`steps` eager steps of config 3's body and `steps` replays of its
    graph from the same state, index and generator seed. Returns
    {"equal": every carried tensor equal bit for bit, "uturn_entries":
    envs that entered a u-turn in the eager run, "respawns", "offsets":
    the generator's offset after each run}."""
    body = make_body3(params, n_envs, max_episode_steps)
    vstate, checksum, i = start3(params, n_envs, seed)
    entries = respawns = 0
    for _ in range(steps):
        man = torch.remainder(i + torch.arange(
            n_envs, dtype=torch.int32, device=params.device), 4)
        entries += int(((man == 2)
                        & (vstate.env.car.last_maneuver != 2)).sum())
        vstate, checksum, i, _ = body(vstate, checksum, i)
        respawns += int((vstate.episode_step == 0).sum())
    eager = [t.clone() for t in carried3(vstate, checksum, i)]
    eager_offset = vstate.generator.get_offset()

    state = start3(params, n_envs, seed)
    initial = [t.clone() for t in carried3(*state)]
    initial_rng = state[0].generator.get_state()
    graph, state = capture3(params, body, state)
    for dst, src in zip(carried3(*state), initial):
        dst.copy_(src)
    state[0].generator.set_state(initial_rng)
    for _ in range(steps):
        graph.replay()
    torch.cuda.synchronize()
    equal = all(torch.equal(a, b) for a, b in zip(eager, carried3(*state)))
    return {"equal": equal, "uturn_entries": entries, "respawns": respawns,
            "offsets": (eager_offset, state[0].generator.get_offset())}


def _replay_ms(fn, calls: int = 20) -> float:
    """ms per call of fn() captured as a CUDA graph and replayed `calls`
    times between two CUDA events (after a warm replay)."""
    graphs.warm_up(fn, 2)
    graph = graphs.capture(fn)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(calls):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def stage_ms3(params, vstate) -> Dict[str, float]:
    """ms (CUDA events over replayed graphs, on the card) of config 3's
    parts at the state's batch: the render, `vector.step` without a
    render (maneuvers cycling as in the body, index 0), and within the
    step the u-turn re-snap's scan, `nearest_edge_with_orientation_idx`
    over the lanepath's edges, which the port runs for every car on every
    step (car.find_local_path)."""
    n = vstate.episode_step.shape[0]
    dev = params.device
    car = vstate.env.car
    lp = params.map_data.lanepath
    control = torch.tensor(CONTROL3, dtype=torch.float32,
                           device=dev).repeat(n, 1)
    man = torch.remainder(torch.arange(n, dtype=torch.int32, device=dev), 4)
    base_dir = torch.rand(n, generator=torch.Generator(dev).manual_seed(3),
                          device=dev, dtype=car.rotation.dtype) * 6 - 3
    # injected respawn rows: the step draws nothing, and each replay
    # recomputes it from the same (unchanged) state
    rows = torch.zeros(n, dtype=torch.int64, device=dev)
    return {
        "render": _replay_ms(
            lambda: fenv.render_observation_batch(params, vstate.env)),
        "step": _replay_ms(lambda: vector.step(
            params, vstate, {"car_control": control, "maneuver": man},
            render=False, max_episode_steps=MAX_EPISODE_STEPS,
            respawn_rows=rows)),
        "uturn_resnap": _replay_ms(
            lambda: geo.nearest_edge_with_orientation_idx(
                lp.nodes, lp.edges, lp.edge_mask, car.position_front,
                base_dir)),
    }


def config3(fmt: str = FORMAT3) -> Dict:
    """config 3 on the card: the JSON line on stdout; every chunk's rate
    and the parts' ms on stderr. Returns the line."""
    result = measure3(fmt=fmt)
    line = line3(result, N_ENVS3, fmt, card_line())
    print(json.dumps(line), flush=True)
    print("config 3 chunks in order (env-steps/s): "
          + " ".join(f"{r:.1f}" for r in result["rates"]), file=sys.stderr)
    parts = stage_ms3(result["params"], result["state"][0])
    print("config 3 parts (ms, replayed graphs): " + json.dumps(parts),
          file=sys.stderr)
    return line


def config1(steps: Optional[int] = None) -> Dict:
    """config 1: the shim's graph-mode steps/s on gym_bench's `config1`
    (baseline_configs.py:38-51) in the script's line shape."""
    from tinycarlo_torch.benchmarks import gym_bench as gb

    ours = gb.measure("config1", "graph", steps or gb.STEPS)
    ref = None
    if REFERENCE and os.path.isdir(os.path.join(REFERENCE, "tinycarlo")):
        sys.path.insert(0, REFERENCE)
        from tinycarlo.env import TinyCarloEnv

        rcfg = dict(gb.CONFIG1, map=dict(gb.CONFIG1["map"], json_path=(
            os.path.join(REFERENCE, "examples/maps/simple_layout.json"))))
        ref = gb.run(TinyCarloEnv(config=rcfg), steps or gb.STEPS)
        ref = ref["steps_per_s"]
    line = {
        "config": 1,
        "metric": "single-env gym shim steps/s (64x64 classes, random)",
        "ours": round(ours["steps_per_s"], 1),
        "reference": round(ref, 1) if ref else None,
        "device": card_line(),
    }
    print(json.dumps(line), flush=True)
    return line


def config4() -> Dict:
    """config 4: td3_bench.run at the script's defaults (module
    docstring)."""
    from tinycarlo_torch.benchmarks import td3_bench

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    env = {k: os.environ.get(k, v) for k, v in CONFIG4_ENV.items()}
    result = td3_bench.run(
        n_envs=int(env["BENCH_ENVS4"]),
        chunk_steps=int(env["BENCH_CHUNK4"]),
        obs_dtype=env["BENCH_OBS_DTYPE"], enc_dtype=env["BENCH_ENC_DTYPE"])
    for key in ("state", "params"):
        del result[key]
    print(json.dumps(result), flush=True)
    return result


CONFIGS = {"1": config1, "3": config3, "4": config4}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    resolve_device("cuda")
    for which in argv or ["1", "3", "4"]:
        if which not in CONFIGS:
            raise SystemExit(f"unknown config {which!r}: one of 1, 3, 4")
        CONFIGS[which]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
