"""Policy evaluation harness: the reference's `evaluate` on the port.

Counterpart of tinycarlo_tpu/train/evaluate.py:31-174 (reference:
examples/benchmark_tinycar_net.py:23-76). Same wrapper stack
(CTELinearReward(0.03, +1/-1) + CTETermination(0.1, 5) +
CrashTermination), same maneuver map and metrics dict (total_reward,
cte_avg/var on |cte|, heading_error_avg/var, terminations, steps_per_s,
positions). The `episodes` run as one batch through `vector.reset` /
`vector.step`; each step is eager PyTorch driven from a Python loop (the
JAX package scans a jitted body; a CUDA graph of the step is ROADMAP M9).
`steps_per_s` counts env-steps, policy included, over the wall time of
the rollout, which ends in `torch.cuda.synchronize()` on the card.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import replace
from functools import partial
from typing import Callable, Dict

import numpy as np
import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.models.tinycar_net import pre_obs
from tinycarlo_torch.wrapper.functional import (
    WrapperStack,
    crash_termination,
    cte_linear_reward,
    cte_termination,
)


def standard_stack() -> WrapperStack:
    """The reference eval wrapper stack (benchmark_tinycar_net.py:32-34)."""
    return WrapperStack(
        reward_fns=(
            partial(cte_linear_reward, min_cte=0.03, max_reward=1.0,
                    min_reward=-1.0),
        ),
        termination_fns=(
            partial(cte_termination, max_cte=0.1, number_of_steps=5),
            partial(crash_termination, velocity_threshold=0.005,
                    number_of_steps=10),
        ),
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(
    act_fn: Callable,
    params: fenv.EnvParams,
    maneuver: int,
    carry_init,
    seed: int = 0,
    speed: float = 0.35,
    steps: int = 5000,
    episodes: int = 5,
    sequential: bool = False,
) -> Dict[str, float]:
    """Run `episodes` rollouts of `steps` each on the params' device.

    `act_fn(obs (B, ...) uint8, maneuver (B,), carry) -> (steering (B,),
    carry)`. Terminated or truncated envs auto-reset; `terminations`
    counts terminated only, like the reference (:60-62).

    `sequential=False`: the episodes run as a parallel batch.
    `sequential=True` reproduces the reference's episode semantics (:46-65):
    one env stepped `steps * episodes` times, respawned on termination and
    also after every step i with i % steps == 0 (i = 0 included), the carry
    rolling on across resets.

    Spawn rows come from a torch.Generator seeded with `seed` (the JAX
    package draws them from `jax.random.key(seed)`; the streams differ).
    """
    stack = standard_stack()
    dev = params.device
    n = 1 if sequential else episodes
    n_steps = steps * episodes if sequential else steps
    m_arr = torch.full((n,), maneuver, dtype=torch.int32, device=dev)
    act_m = torch.where(m_arr != 2, m_arr, 3)

    # segment-budget guard (evaluate.py:122-138): the rasterizer's
    # max_visible_segments budget must fit this map and camera before the
    # metrics are trusted
    vstate, _ = vector.reset(params, n, seed=seed, stack=stack, render=False)
    ov = int(fenv.check_segment_overflow(params, vstate.env).sum())
    if ov:
        warnings.warn(
            f"evaluate: {ov} rasterizer slot copies dropped at spawn states"
            " -- observations are losing pixels; raise"
            " CameraConfig.max_visible_segments"
        )

    _sync(dev)
    start = time.perf_counter()
    vstate, _ = vector.reset(params, n, seed=seed, stack=stack, render=False)
    carry = carry_init
    traj = {k: [] for k in ("reward", "terminated", "cte", "heading_error",
                            "position")}
    for i in range(n_steps):
        obs = fenv.render_observation_batch(params, vstate.env)
        steering, carry = act_fn(obs, m_arr, carry)
        action = {
            "car_control": torch.stack(
                [torch.full_like(steering, speed), steering], dim=-1
            ),
            "maneuver": act_m,
        }
        vstate, _, rew, term, _, info = vector.step(
            params, vstate, action, stack=stack, render=False
        )
        if sequential and i % steps == 0:
            # a fresh episode every `steps` iterations regardless of
            # termination (benchmark_tinycar_net.py:63-65)
            rows = torch.randint(
                params.map_data.spawns.count, (n,),
                generator=vstate.generator, device=dev,
            )
            fresh, _ = vector.reset(params, n, stack=stack, render=False,
                                    spawn_rows=rows)
            vstate = replace(fresh, generator=vstate.generator)
        traj["reward"].append(rew)
        traj["terminated"].append(term)
        traj["cte"].append(torch.abs(info["cte"]))
        traj["heading_error"].append(torch.abs(info["heading_error"]))
        traj["position"].append(info["position"])
    _sync(dev)
    wall = time.perf_counter() - start

    out = {k: torch.stack(v).cpu().numpy() for k, v in traj.items()}
    cte = out["cte"].reshape(-1)
    he = out["heading_error"].reshape(-1)
    return {
        "cte_avg": float(cte.mean()),
        "cte_var": float(cte.var()),
        "heading_error_avg": float(he.mean()),
        "heading_error_var": float(he.var()),
        "terminations": int(out["terminated"].sum()),
        "steps_per_s": steps * episodes / wall,
        "total_reward": float(np.sum(out["reward"])),
        "positions": out["position"].reshape(-1, 2),
    }


def combo_policy(model: torch.nn.Module) -> Callable:
    """act_fn of a (non-temporal) TinycarCombo: obs -> steering, without
    autograd. The carry is unused (pass `carry_init=None`)."""

    def act(obs, m, carry):
        with torch.no_grad():
            mh = torch.nn.functional.one_hot(
                m.long(), model.maneuver_dim
            ).float()
            out = model(pre_obs(obs), mh)
        return out[:, 0], carry

    return act
