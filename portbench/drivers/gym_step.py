"""Driver `gym_step`: one env through the Gymnasium entry point,
`gym_env.TinyCarloEnv`, one `env.step()` at a time.

Traffic (the workload file's `traffic`): `reset(seed)`, then actions drawn
from `np.random.default_rng(seed)`: `car_control` uniform in [-1, 1] and
`maneuver` uniform in 0-3; a `reset()` (no seed) after every terminated
or truncated step. Every step's outputs are kept on the host (reward,
flags, cte, heading error, position, orientation, velocity, the laneline
distances, the local path) and its observation every `frame_stride`
steps (from an offset drawn from the seed), for the comparison.

Window: steps until `--seconds` have passed; `gym_steps_per_s` counts the
`step()` calls over the window (resets in it), `gym_step_ms_p95` is the
95th percentile of every step's host wall, call to numpy observation.
Traced: `trace_steps` steps timed without the profiler (`wall_s`), then
the same steps from the same reset under it.
"""
from __future__ import annotations

import time

import numpy as np

from tinycarlo_torch.gym_env import TinyCarloEnv

from portbench import trace
from portbench.reference import gym_check

WARMUP_STEPS = 3


def p95(values) -> float:
    """The 95th percentile of all the values (linear between ranks)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


class Cell:
    def __init__(self, run):
        self.run = run
        t = run.traffic
        self.env = TinyCarloEnv(
            config=run.env_config(t["observation_space_format"]),
            device=run.device)
        rng = np.random.default_rng(run.seed)
        n = int(t["max_steps_per_s"] * max(run.seconds, 1.0)) \
            + t["trace_steps"]
        self.controls = rng.uniform(-1.0, 1.0, (n, 2))
        self.maneuvers = rng.integers(0, 4, n)
        self.frame_offset = int(rng.integers(t["frame_stride"]))
        # the capture of the step's graph, on actions of their own
        warm = np.random.default_rng(0)
        for _ in range(WARMUP_STEPS):
            self.env.step({"car_control": warm.uniform(-1, 1, 2),
                           "maneuver": int(warm.integers(0, 4))})
        self.env.reset(seed=run.seed)

    def _steps(self, seconds=None, count=None):
        """The traffic's steps until `seconds` have passed or `count` steps
        ran; returns (steps, wall seconds, each step's wall)."""
        env, stride = self.env, self.run.traffic["frame_stride"]
        rec = self.records = {"out": [], "frames": {}, "resets": []}
        walls = []
        failed = 0
        start = time.perf_counter()
        i = 0
        while i < len(self.controls):
            action = {"car_control": self.controls[i],
                      "maneuver": int(self.maneuvers[i])}
            t0 = time.perf_counter()
            obs, reward, term, trunc, info = env.step(action)
            t1 = time.perf_counter()
            walls.append(t1 - t0)
            rec["out"].append((reward, term, trunc, info["cte"],
                               info["heading_error"], info["position"],
                               info["orientation"], info["velocity"],
                               tuple(info["laneline_distances"].values()),
                               np.asarray(info["local_path"]).reshape(-1, 2)))
            failed += not np.isfinite(reward)
            if (i + self.frame_offset) % stride == 0:
                rec["frames"][i] = obs
            i += 1
            if term or trunc:
                env.reset()
                rec["resets"].append(i)
            if (count is not None and i >= count) or \
                    (seconds is not None and t1 - start >= seconds):
                break
        self.failed = failed
        return i, time.perf_counter() - start, walls

    def window(self, seconds: float):
        n, wall, walls = self._steps(seconds=seconds)
        return {"metrics": {"gym_steps_per_s": n / wall,
                            "gym_step_ms_p95": p95(walls) * 1e3},
                "attempted": n, "failed": self.failed}

    def traced(self):
        # the steps timed without the profiler, whose own cost on the host
        # (~2.5x a step) would read as idle device time, then the same
        # steps from the same reset traced
        count = self.run.traffic["trace_steps"]
        _, wall, _ = self._steps(count=count)
        self.env.reset(seed=self.run.seed)
        w = trace.profile(lambda: self._steps(count=count)[0])
        return {"window": w}, {"attempted": w.count, "failed": self.failed,
                               "steps": w.count, "wall_s": wall}

    def release(self) -> None:
        self.env.close()
        del self.env

    def check(self, stand_in=None):
        """[(name, value, limit)] of the window's steps against the
        reference (`stand_in`: the control, reference/gym_check.py)."""
        return gym_check.check(self.run, self.records, self.controls,
                               self.maneuvers, stand_in=stand_in)
