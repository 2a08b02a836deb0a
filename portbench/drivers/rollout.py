"""Driver `rollout`: batched rollouts through `vector.rollout`.

Traffic (the workload file's `traffic`): `envs` cars, reset from the seed;
calls of `steps_per_call` steps of (render, policy, `vector.step`), with
`max_episode_steps`, `keep_obs` off. The policy is the benchmark's own
Stanley controller (`portbench.policy`, `speed`, `k`) with the
`maneuver` schedule; it consumes every frame by adding rows
`checksum_rows` of it to a device accumulator, as the port's headline
bench does.

For the comparison the policy also records, inside the captured step,
the car state of `tracked_envs` cars drawn from the seed at every step,
and at each step the frame of one of them (drawn from the seed). The
last call's records, its trajectory (reward, terminated, truncated, cte,
heading error) and the final state are what `check` holds against the
plain reference (`portbench/reference/rollout_check.py`).

Window: whole calls, each ended by a synchronize, until `--seconds` have
passed; `env_steps_per_s` is their env-steps over their seconds. Traced:
one call timed without the profiler (`wall_s`), one call under it, then
a replayed graph of `vector.step(render=False)` alone and one of the
render alone (`decomp_replays` each).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector

from portbench import policy as pol
from portbench import trace
from portbench.reference import rollout_check

# car state bytes a step reads and writes per car: position, front axle
# (2 floats each), yaw, steering angle, radius, velocity; the local path
# (4 x 2 int32), its length and the last maneuver
CAR_STATE_BYTES = 4 * (2 + 2 + 4) + 4 * (8 + 2)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Cell:
    def __init__(self, run):
        self.run = run
        t = run.traffic
        self.fmt = t["observation_space_format"]
        self.params = fenv.make_env_params(run.env_config(self.fmt),
                                           device=run.device)
        self.n_envs, self.steps = t["envs"], t["steps_per_call"]
        rng = np.random.default_rng(run.seed)
        self.tracked = np.sort(rng.choice(self.n_envs, t["tracked_envs"],
                                          replace=False))
        self.frame_env = rng.choice(self.tracked, self.steps)
        self.frame_steps = np.sort(rng.choice(
            self.steps, min(t["frames_checked"], self.steps), replace=False))
        torch_seed = int(rng.integers(1 << 62))
        dev = run.device
        self.vstate, _ = vector.reset(self.params, self.n_envs,
                                      seed=torch_seed, render=False)
        k = len(self.tracked)
        self.idx = torch.as_tensor(self.tracked, device=dev)
        self.frame_env_dev = torch.as_tensor(self.frame_env, device=dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.fbuf = torch.zeros((self.steps, k, 7), device=dev)
        self.ibuf = torch.zeros((self.steps, k, 10), dtype=torch.int32,
                                device=dev)
        self.obs_shape = fenv.observation_shape(self.params)
        self.frames = torch.zeros((self.steps,) + self.obs_shape,
                                  dtype=torch.uint8, device=dev)
        self.checksum = torch.zeros((), dtype=torch.int64, device=dev)
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        self.policy = self._policy()
        self._call()  # builds the kernels and captures once
        _sync(dev)
        if int(self.checksum) <= 0:
            raise RuntimeError("rollout: the frames were not rendered")

    def _policy(self):
        t = self.run.traffic
        car_cfg = self.params.cfg.car
        nodes = self.params.map_data.lanepath.nodes
        dev = self.run.device
        speed = torch.full((self.n_envs,), float(t["speed"]), device=dev)
        env_ids = torch.arange(self.n_envs, dtype=torch.int32, device=dev)
        r0, r1 = t["checksum_rows"]
        idx = self.idx

        def policy(obs, env_state, generator):
            car = env_state.car
            self.checksum.add_(obs[..., r0:r1, :].sum(dtype=torch.int64))
            steer = pol.stanley(nodes, car.position_front, car.rotation,
                                car.local_path, car.local_path_len,
                                float(t["speed"]), float(t["k"]),
                                car_cfg.max_steering_angle)
            f = torch.cat([car.position[idx], car.position_front[idx],
                           car.rotation[idx, None],
                           car.steering_angle[idx, None],
                           car.velocity[idx, None]], dim=1)
            i = torch.cat([car.local_path[idx].reshape(-1, 8),
                           car.local_path_len[idx, None],
                           car.last_maneuver[idx, None]], dim=1)
            self.fbuf.index_copy_(0, self.t, f[None])
            self.ibuf.index_copy_(0, self.t, i[None])
            fe = self.frame_env_dev.index_select(0, self.t)
            self.frames.index_copy_(0, self.t, obs.index_select(0, fe))
            man = pol.maneuvers(t["maneuver"], self.t, env_ids)
            self.t.add_(1)
            return {"car_control": torch.stack([speed, steer], dim=-1),
                    "maneuver": man}

        return policy

    def _call(self) -> None:
        self.t.zero_()
        self.ep0 = self.vstate.episode_step[self.idx].clone()
        self.vstate, traj = vector.rollout(
            self.params, self.vstate, self.policy, self.steps,
            max_episode_steps=self.run.traffic["max_episode_steps"],
            keep_obs=False)
        self.nonfinite += ((~torch.isfinite(traj["reward"]))
                           | (~torch.isfinite(traj["cte"]))).sum()
        self.traj = traj

    def window(self, seconds: float):
        _sync(self.run.device)
        t0 = time.perf_counter()
        calls = 0
        while True:
            self._call()
            _sync(self.run.device)
            calls += 1
            wall = time.perf_counter() - t0
            if wall >= seconds:
                break
        self._snapshot()
        n = calls * self.steps * self.n_envs
        return {"metrics": {"env_steps_per_s": n / wall}, "attempted": n,
                "failed": int(self.nonfinite)}

    def traced(self):
        # one call timed without the profiler, whose own cost on the host
        # would read as idle device time, then one call traced
        _sync(self.run.device)
        t0 = time.perf_counter()
        self._call()
        _sync(self.run.device)
        wall = time.perf_counter() - t0
        self.nonfinite.zero_()
        traces = {"window": trace.profile(
            lambda: (self._call(), self.steps)[1])}
        self._snapshot()
        reps = self.run.traffic["decomp_replays"]
        traces["vector_step"] = self._graph_trace(self._step_fn(), reps)
        traces["render"] = self._graph_trace(
            lambda: fenv.render_observation_batch(self.params,
                                                  self.vstate.env), reps)
        n_layers = self.params.map_data.n_layers
        frame = int(np.prod(self.obs_shape))
        facts = {"attempted": self.steps * self.n_envs,
                 "failed": int(self.nonfinite), "wall_s": wall,
                 "envs": self.n_envs,
                 "steps": self.steps, "n_layers": n_layers,
                 "masks_bytes": (self.n_envs * frame if self.fmt == "classes"
                                 else None),
                 "obs_bytes": self.n_envs * frame,
                 "car_state_bytes": self.n_envs * CAR_STATE_BYTES}
        return traces, facts

    def _step_fn(self):
        """`vector.step(render=False)` of the current state under a fixed
        action, writing the new state back (a step of its own)."""
        vs = self.vstate
        t = self.run.traffic
        car = vs.env.car
        steer = pol.stanley(self.params.map_data.lanepath.nodes,
                            car.position_front, car.rotation, car.local_path,
                            car.local_path_len, float(t["speed"]),
                            float(t["k"]),
                            self.params.cfg.car.max_steering_angle)
        action = {"car_control": torch.stack(
                      [torch.full_like(steer, float(t["speed"])), steer], -1),
                  "maneuver": torch.zeros(self.n_envs, dtype=torch.int32,
                                          device=self.run.device)}

        def fn():
            new, *_ = vector.step(
                self.params, vs, action, render=False,
                max_episode_steps=t["max_episode_steps"])
            for f in ("position", "position_front", "rotation",
                      "steering_angle", "radius", "velocity", "local_path",
                      "local_path_len", "last_maneuver"):
                getattr(vs.env.car, f).copy_(getattr(new.env.car, f))
            vs.episode_step.copy_(new.episode_step)

        return fn

    def _graph_trace(self, fn, replays: int):
        """`fn` captured as a CUDA graph (one eager run on a side stream
        first), warmed by `replays` replays, then `replays` replays traced."""
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.vstate.generator)
        with torch.cuda.graph(graph):
            fn()

        def replay():
            for _ in range(replays):
                graph.replay()
            return replays

        replay()
        return trace.profile(replay)

    def _snapshot(self) -> None:
        """The last call's records, trajectory and final state of the
        tracked cars, and the sampled frames, copied to the host."""
        car = self.vstate.env.car
        idx = self.idx
        final_f = torch.cat([car.position[idx], car.position_front[idx],
                             car.rotation[idx, None],
                             car.steering_angle[idx, None],
                             car.velocity[idx, None]], dim=1)
        final_i = torch.cat([car.local_path[idx].reshape(-1, 8),
                             car.local_path_len[idx, None],
                             car.last_maneuver[idx, None]], dim=1)
        fs = torch.as_tensor(self.frame_steps, device=self.run.device)
        self.records = {
            "f": torch.cat([self.fbuf, final_f[None]]).cpu(),
            "i": torch.cat([self.ibuf, final_i[None]]).cpu(),
            "ep0": self.ep0.cpu(),
            "traj": {k: v[:, idx].cpu() for k, v in self.traj.items()},
            "frames": self.frames[fs].cpu(),
        }

    def release(self) -> None:
        """The program's state freed (the records stay on the host)."""
        del self.vstate, self.traj, self.fbuf, self.ibuf, self.frames
        del self.policy, self.params

    def check(self, stand_in=None):
        """[(name, value, limit)] of the last call against the reference
        (`stand_in`: the control, reference/rollout_check.py)."""
        return rollout_check.check(self.run, self.records, self.frame_env,
                                   self.frame_steps, self.tracked,
                                   stand_in=stand_in)
