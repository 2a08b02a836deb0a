"""Minimal Gymnasium loop with random actions, on the port.

The port of examples/random_control.py (reference:
examples/random_control.py:5-16): the shim on the default config, random
actions, a reset whenever an episode ends. The actions come from a numpy
Generator seeded with --seed (the JAX example samples gymnasium's
action space; the port's stand-in spaces, used where gymnasium is not
installed, do not sample).

Usage: python -m tinycarlo_torch.examples.random_control [--render]
  [--steps 1000] [--seed 2] [--config PATH] [--device cuda|cpu]
"""
import os
import sys
import time
from typing import Dict

import numpy as np

from tinycarlo_torch.examples._common import arg, default_config
from tinycarlo_torch.gym_env import TinyCarloEnv


def main(argv=None) -> Dict:
    """Run the example with `argv` (default sys.argv[1:]); returns the
    steps, resets and steps/s."""
    argv = sys.argv[1:] if argv is None else list(argv)
    seed = arg(argv, "--seed", 2)
    steps = arg(argv, "--steps", 1000)
    env = TinyCarloEnv(
        config=os.path.abspath(arg(argv, "--config", default_config(), str)),
        render_mode="human" if "--render" in argv else None,
        device=arg(argv, "--device", "cuda", str),
    )
    rng = np.random.default_rng(seed)
    env.reset(seed=seed)
    resets = 0
    st = time.perf_counter()
    for _ in range(steps):
        action = {"car_control": rng.uniform(-1, 1, 2).astype(np.float32),
                  "maneuver": int(rng.integers(4))}
        _, _, terminated, truncated, _ = env.step(action)
        if terminated or truncated:
            env.reset()
            resets += 1
    rate = steps / (time.perf_counter() - st)
    env.close()
    print(f"done: {steps} steps, {resets} resets, {rate:.1f} steps/s")
    return {"steps": steps, "resets": resets, "steps_per_s": rate}


if __name__ == "__main__":
    main()
