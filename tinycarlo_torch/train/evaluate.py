"""Policy evaluation harness: the reference's `evaluate` on the port.

Counterpart of tinycarlo_tpu/train/evaluate.py:31-174 (reference:
examples/benchmark_tinycar_net.py:23-76). Same wrapper stack
(CTELinearReward(0.03, +1/-1) + CTETermination(0.1, 5) +
CrashTermination), same maneuver map and metrics dict (total_reward,
cte_avg/var on |cte|, heading_error_avg/var, terminations, steps_per_s,
positions). The `episodes` run as one batch through `vector.reset` and
`vector.rollout` (the JAX package scans a jitted body): on the card the
rollout's first steps run eagerly and the rest replay one captured CUDA
graph of (render, policy, step); `graph=False` steps eagerly throughout.
`steps_per_s` counts env-steps, policy included, over the wall time of
the rollout (its capture included), which ends in
`torch.cuda.synchronize()` on the card.

`temporal_policy` (evaluate.py:177-189) drives an encoder and a temporal
actor whose carry is the rolled (B, seq_len, F) feature queue.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import replace
from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.models.tinycar_net import one_hot, pre_obs
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
    graph: bool = True,
    stats: Optional[Dict[str, int]] = None,
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

    The carry is a tensor (or None) that `act_fn` returns anew each step;
    the rollout copies it into its own buffer. `stats`, if given, gains
    the rollouts' counts of replayed steps and captures ("replays",
    "captures"; vector.rollout): a replayed render passes no kernel
    wrapper.

    Spawn rows come from a torch.Generator seeded with `seed` (the JAX
    package draws them from `jax.random.key(seed)`; the streams differ).
    """
    stack = standard_stack()
    dev = params.device
    n = 1 if sequential else episodes
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

    # the carry is updated in place, so a captured step carries it on
    carry = None if carry_init is None else carry_init.clone()

    def policy(obs, env_state, generator):
        steering, new = act_fn(obs, m_arr, carry)
        if carry is not None:
            carry.copy_(new)
        return {"car_control": torch.stack(
                    [torch.full_like(steering, speed), steering], dim=-1),
                "maneuver": act_m}

    # sequential: a fresh episode after every step i with i % steps == 0
    # (benchmark_tinycar_net.py:63-65), i = 0 included: segments of 1,
    # then `steps` steps, a respawn after each, and steps - 1 at the end
    segments = ([1] + [steps] * (episodes - 1) + [steps - 1]
                if sequential else [steps])
    stats = {} if stats is None else stats
    _sync(dev)
    start = time.perf_counter()
    vstate, _ = vector.reset(params, n, seed=seed, stack=stack, render=False)
    trajs = []
    for j, length in enumerate(segments):
        if length:
            vstate, traj = vector.rollout(
                params, vstate, policy, length, stack=stack,
                info_keys=("position",), keep_obs=False, graph=graph,
                stats=stats)
            trajs.append(traj)
        if j < len(segments) - 1:
            rows = torch.randint(
                params.map_data.spawns.count, (n,),
                generator=vstate.generator, device=dev,
            )
            fresh, _ = vector.reset(params, n, stack=stack, render=False,
                                    spawn_rows=rows)
            vstate = replace(fresh, generator=vstate.generator)
    traj = {k: torch.cat([t[k] for t in trajs]) for k in trajs[0]}
    traj["cte"] = torch.abs(traj["cte"])
    traj["heading_error"] = torch.abs(traj["heading_error"])
    _sync(dev)
    wall = time.perf_counter() - start

    out = {k: v.cpu().numpy() for k, v in traj.items()}
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
            out = model(pre_obs(obs), one_hot(m, model.maneuver_dim))
        return out[:, 0], carry

    return act


def temporal_policy(encoder: torch.nn.Module, actor: torch.nn.Module,
                    seq_len: int) -> Callable:
    """act_fn of an encoder + temporal actor, without autograd: the carry
    is the (B, seq_len, F) feature queue, rolled by one with the newest
    feature at slot 0 (benchmark_tinycar_net.py:38-41; pass zeros as
    `carry_init`). tinycarlo_tpu.train.evaluate.temporal_policy."""

    def act(obs, m, queue):
        with torch.no_grad():
            f = encoder(pre_obs(obs)).to(queue.dtype)
            queue = torch.cat([f[:, None], queue[:, :seq_len - 1]], dim=1)
            out = actor(queue, one_hot(m, actor.maneuver_dim, queue.dtype))
        return out[:, 0], queue

    return act
