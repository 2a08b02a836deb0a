"""Stanley lateral-control demo on the port: one env through the
Gymnasium shim, or a batch of envs through `vector.rollout` (--batch N).

The port of examples/stanley_control.py (reference:
examples/stanley_control.py:40-63: k = 4, speed 0.4, the left maneuver),
with its batched mode. The batched rollout runs without a render, each
step's steering from the Stanley law on the current state's cte and
heading error; on the card its steps after the first three replay one
captured CUDA graph. (The JAX example steers from the info its last step
returned, which after an auto-reset is the finished episode's; here a
respawned car steers from its own info at once.)

Usage: python -m tinycarlo_torch.examples.stanley_control [--render]
  [--steps 2000] [--batch N [--steps 500]] [--config PATH]
  [--device cuda|cpu]
"""
import math
import os
import sys
import time
from typing import Dict

import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.examples._common import arg, default_config
from tinycarlo_torch.gym_env import TinyCarloEnv
from tinycarlo_torch.train.stanley import stanley_steering

K = 4.0
SPEED = 0.4
MANEUVER = 3  # left


def single(config: str, render: bool, steps: int, device) -> Dict:
    """`steps` Stanley-steered steps of one env; returns steps/s."""
    env = TinyCarloEnv(config=config,
                       render_mode="human" if render else None,
                       device=device)
    _, info = env.reset(seed=4)
    max_steer = env.unwrapped.car.max_steering_angle
    st = time.perf_counter()
    for _ in range(steps):
        steering = (
            (info["heading_error"] + math.atan2(K * info["cte"], SPEED))
            * 180
            / math.pi
            / max_steer
        )
        _, _, terminated, truncated, info = env.step(
            {"car_control": [SPEED, steering], "maneuver": MANEUVER}
        )
        if terminated or truncated:
            _, info = env.reset()
    rate = steps / (time.perf_counter() - st)
    print(f"single-env: {rate:.2f} steps/s")
    env.close()
    return {"steps_per_s": rate}


def batched(config: str, n_envs: int, steps: int, device) -> Dict:
    """`steps` Stanley-steered steps of `n_envs` envs (after a short
    untimed rollout); returns env-steps/s and the mean |cte|."""
    params = fenv.make_env_params(config, device=device)
    max_steer = params.cfg.car.max_steering_angle
    dtype = params.camera.E.dtype
    speed = torch.full((n_envs,), SPEED, dtype=dtype, device=params.device)
    maneuver = torch.full((n_envs,), MANEUVER, dtype=torch.int32,
                          device=params.device)

    def policy(obs, env_state, generator):
        info = fenv._info(params, env_state)
        steering = torch.clamp(stanley_steering(
            info["cte"], info["heading_error"], SPEED, K, max_steer), -1, 1)
        return {"car_control": torch.stack([speed, steering.to(dtype)], -1),
                "maneuver": maneuver}

    def run(vstate, n):
        return vector.rollout(params, vstate, policy, n, render=False,
                              max_episode_steps=1000)

    vstate, _ = vector.reset(params, n_envs, seed=0, render=False)
    vstate, _ = run(vstate, min(steps, 10))  # first use: lazy set-up
    if params.device.type == "cuda":
        torch.cuda.synchronize(params.device)
    st = time.perf_counter()
    vstate, traj = run(vstate, steps)
    cte = float(traj["cte"].abs().mean())  # waits for the rollout
    rate = n_envs * steps / (time.perf_counter() - st)
    print(f"batched {n_envs} envs: {rate:,.0f} env-steps/s | "
          f"mean |cte| {cte:.4f} m")
    return {"env_steps_per_s": rate, "mean_abs_cte": cte}


def main(argv=None) -> Dict:
    """Run the example with `argv` (default sys.argv[1:]); returns what
    the mode measured."""
    argv = sys.argv[1:] if argv is None else list(argv)
    config = os.path.abspath(arg(argv, "--config", default_config(), str))
    device = arg(argv, "--device", "cuda", str)
    if "--batch" in argv:
        return batched(config, arg(argv, "--batch", 0),
                       arg(argv, "--steps", 500), device)
    return single(config, "--render" in argv, arg(argv, "--steps", 2000),
                  device)


if __name__ == "__main__":
    main()
