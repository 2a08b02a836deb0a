"""Driver `td3`: TD3 training through `train.td3_loop.chunk`, the fused
rollout + replay + update loop of upstream's examples/train_td3.py.

The configuration's `learner` block sets the run: TD3Config (batch,
gamma, tau, policy delay, learning rates, OU noise, the temporal nets
over a `seq_len` feature queue), the frozen TinycarEncoder's filters, the
replay's size, the updates a step, the planned episodes of the per-env
sigma decay, the speed, the episode limit and the wrapper stack's
constants; float32 with TF32 off. The encoder and the nets are seeded
initialisations (flax's initialisers) from the seed.

Traffic (the workload file's `traffic`): `envs` envs, rgb frames, reset
from the seed; whole chunks of `steps_per_chunk` steps.

Set-up: a probe that the program gives what the cell reads (a 2-env,
2-step chunk on the CPU must return `update_losses`; without it the run
stops at once), then the loop and one whole chunk, which captures the
step's graph and fills the replay. Window: whole chunks, each ended by a
synchronize, until `--seconds` have passed; `env_steps_per_s` counts
their env-steps over their seconds. Traced: one chunk timed without the
profiler (`wall_s`), one chunk under it, then the spans pass: a chunk
with the program's tracer on (its traced graph captured in a chunk
before it), the profiler off.

After either, for the comparison (`reference/td3_check.py`): the timed
graph stepped `followed_steps` times, one step a chunk, the loop's state
copied to the host before the first and after each, with each step's
outputs and the port's frames of its post-step state.
"""
from __future__ import annotations

import time
from functools import partial

import numpy as np
import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch.models.tinycar_net import (FEATURE_VEC_SIZE,
                                                TinycarEncoder,
                                                encoder_apply_fn,
                                                encoder_flat_features,
                                                flax_init_)
from tinycarlo_torch.train import td3, td3_loop
from tinycarlo_torch.wrapper.functional import (WrapperStack,
                                                crash_termination,
                                                cte_linear_reward,
                                                cte_termination)

from portbench import spans, td3_work, trace
from portbench.reference import td3_check, td3_ref

TD3_KEYS = ("batch_size", "discount_factor", "tau", "policy_delay",
            "lr_actor", "lr_critic", "noise_theta", "noise_mean",
            "noise_sigma", "seq_len", "maneuver_dim", "action_dim",
            "temporal")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def probe(run) -> None:
    """Raise unless the program's chunk returns every update's losses (a
    2-env, 2-step chunk of 2 updates a step on the CPU, at a 16x20
    camera, a stand-in encoder)."""
    cfg = run.env_config("rgb")
    cfg["camera"] = dict(cfg["camera"], resolution=[16, 20])
    params = fenv.make_env_params(cfg, device="cpu")
    tcfg = td3.TD3Config(batch_size=2, seq_len=2)
    lcfg = td3_loop.LoopConfig(replay_size=8, updates_per_step=2)
    state = td3_loop.init_loop(params, tcfg, lcfg, 2, seed=0)
    _, out = td3_loop.chunk(
        state, params, tcfg, lcfg,
        lambda obs: torch.zeros((obs.shape[0], FEATURE_VEC_SIZE)), 2)
    got = out.get("update_losses")
    if got is None or tuple(got.shape) != (2, 2, 3):
        raise RuntimeError("td3: the program's td3_loop.chunk gives no "
                           "update_losses (T, U, 3); this cell follows "
                           "every update and cannot run on it")


def wrapper_stack(w) -> WrapperStack:
    """The standard wrapper stack with the configuration's constants."""
    return WrapperStack(
        reward_fns=(partial(cte_linear_reward, **w["cte_linear_reward"]),),
        termination_fns=(partial(cte_termination, **w["cte_termination"]),
                         partial(crash_termination,
                                 **w["crash_termination"])))


def snapshot(state) -> dict:
    """The loop's state as plain host tensors keyed by the port's names
    (`td3_ref`'s layout)."""
    ts = state.td3_state
    car = state.vstate.env.car
    return {
        "nets": {n: {k: _host(p) for k, p in
                     getattr(ts, n).named_parameters()}
                 for n in td3_ref.NETS},
        "adam": {n: {"count": _host(o.count),
                     "mu": {k: _host(v) for k, v in o.mu.items()},
                     "nu": {k: _host(v) for k, v in o.nu.items()}}
                 for n, o in (("actor", ts.opt_actor),
                              ("critic1", ts.opt_critic1),
                              ("critic2", ts.opt_critic2))},
        "steps": _host(ts.steps),
        "queue": _host(state.queue), "noise": _host(state.noise),
        "maneuver": _host(state.maneuver), "sigma": _host(state.sigma),
        "ep_count": _host(state.ep_count),
        "car": {k: _host(getattr(car, k)) for k in td3_ref.CAR},
        "counters": _host(torch.stack(state.vstate.counters)),
        "episode_step": _host(state.vstate.episode_step),
        "replay": {k: _host(v) for k, v in state.buf.storage.items()},
        "filled": _host(state.buf.filled),
        "gen_loop": state.generator.get_state(),
        "gen_env": state.vstate.generator.get_state(),
    }


class Cell:
    def __init__(self, run):
        probe(run)
        self.run = run
        t, lc = run.traffic, run.config["learner"]
        dev = run.device
        # the deployment's precision: float32 products in float32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.params = fenv.make_env_params(
            run.env_config(t["observation_space_format"]), device=dev)
        self.n_envs, self.steps = t["envs"], t["steps_per_chunk"]
        if lc["features"] != FEATURE_VEC_SIZE:
            raise ValueError(f"the port's encoder gives {FEATURE_VEC_SIZE} "
                             f"features, not {lc['features']}")
        self.cfg = td3.TD3Config(**{k: lc[k] for k in TD3_KEYS})
        self.loop_cfg = td3_loop.LoopConfig(
            speed=lc["speed"], steering_shift=lc["steering_shift"],
            max_episode_steps=lc["max_episode_steps"],
            replay_size=lc["replay_size"],
            updates_per_step=lc["updates_per_step"],
            total_episodes=lc["total_episodes"])
        self.stack = wrapper_stack(lc["wrappers"])
        rng = np.random.default_rng(run.seed)
        loop_seed, enc_seed = (int(x) for x in rng.integers(1 << 62, size=2))
        h, w = self.params.cfg.camera.resolution
        filters = tuple(lc["encoder_filters"])
        enc = TinycarEncoder(3, filters, encoder_flat_features(h, w, filters))
        self.encoder = flax_init_(enc, torch.Generator().manual_seed(
            enc_seed)).to(dev).eval().requires_grad_(False)
        self.encoder_apply = encoder_apply_fn(self.encoder)
        self.state = td3_loop.init_loop(self.params, self.cfg, self.loop_cfg,
                                        self.n_envs, seed=loop_seed,
                                        stack=self.stack)
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=dev)
        self._chunk()  # captures the step's graph, fills the replay
        _sync(dev)
        self.nonfinite.zero_()

    def _chunk(self, n_steps=None):
        self.state, out = td3_loop.chunk(
            self.state, self.params, self.cfg, self.loop_cfg,
            self.encoder_apply, n_steps or self.steps, stack=self.stack)
        self.nonfinite += ((~torch.isfinite(out["reward"])).sum()
                           + (~torch.isfinite(out["update_losses"])).sum())
        return out

    def window(self, seconds: float):
        dev = self.run.device
        _sync(dev)
        t0 = time.perf_counter()
        chunks = 0
        while True:
            self._chunk()
            _sync(dev)
            chunks += 1
            wall = time.perf_counter() - t0
            if wall >= seconds:
                break
        failed = int(self.nonfinite)
        self._follow()
        n = chunks * self.steps * self.n_envs
        return {"metrics": {"env_steps_per_s": n / wall}, "attempted": n,
                "failed": failed}

    def traced(self):
        # one chunk timed without the profiler, whose own cost on the host
        # would read as idle device time, then one chunk traced
        dev = self.run.device
        _sync(dev)
        t0 = time.perf_counter()
        self._chunk()
        _sync(dev)
        wall = time.perf_counter() - t0
        self.nonfinite.zero_()
        traces = {"window": trace.profile(
            lambda: (self._chunk(), self.steps)[1])}
        failed = int(self.nonfinite)
        facts = {"attempted": self.steps * self.n_envs, "failed": failed,
                 "wall_s": wall, "steps": self.steps, "envs": self.n_envs,
                 "program": self._spans_pass(),
                 **td3_work.step_work(self.run.config, self.n_envs)}
        self._follow()
        return traces, facts

    def _spans_pass(self):
        """One chunk with the program's tracer on and the profiler off,
        after a chunk that captures the traced graph (its marks); the
        program's spans and counters (`spans.program`), or None where the
        program has no tracer."""
        prof = spans.tracer()
        if prof is None:
            return None
        dev = self.run.device
        with prof.tracing():
            self._chunk()
        with prof.tracing() as tr:
            t0 = time.perf_counter()
            self._chunk()
            _sync(dev)
            wall = time.perf_counter() - t0
        return spans.program(tr, wall, self.steps)

    def _follow(self) -> None:
        """The timed graph stepped `followed_steps` times, one step a
        chunk, with the state on the host before and after each, each
        step's outputs and the port's frames of its post-step state."""
        snaps = [snapshot(self.state)]
        outs, frames = [], []
        for _ in range(self.run.traffic["followed_steps"]):
            out = self._chunk(1)
            outs.append({k: _host(out[k]) for k in td3_check.OUT_KEYS})
            snaps.append(snapshot(self.state))
            frames.append(_host(fenv.render_observation_batch(
                self.params, self.state.vstate.env)))
        self.records = {
            "encoder": {k: _host(v)
                        for k, v in self.encoder.state_dict().items()},
            "snaps": snaps, "outs": outs, "frames": frames}

    def release(self) -> None:
        """The program's state freed (the records stay on the host)."""
        del self.state, self.encoder, self.encoder_apply, self.params

    def check(self, stand_in=None):
        """[(name, value, limit)] of the followed steps against the
        reference (`stand_in`: the control, reference/td3_check.py)."""
        return td3_check.check(self.run, self.records, stand_in=stand_in)
