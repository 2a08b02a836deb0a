"""Batched auto-resetting environment: the port's primary entry point.

Counterpart of tinycarlo_tpu/vector.py:44-155. A step advances every env
of the batch, applies the wrapper stack and respawns finished envs, all as
tensor ops on the device with no host round trip, so a caller can queue
steps back to back.

Auto-reset follows the gymnax/brax convention of the JAX package: when an
env finishes, the returned `obs`/`state` already belong to the NEXT
episode, while `reward`, `terminated`, `truncated` and `info` describe the
finishing step.

Respawn rows are drawn from a torch.Generator kept in the VecState (the
JAX package splits per-env PRNG keys; the two streams differ). Pass
`respawn_rows` to `step` to inject the rows instead, as the parity tests
do with the JAX package's draws.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Dict, Optional, Tuple

import torch

from tinycarlo_torch import car as car_mod
from tinycarlo_torch import env as fenv
from tinycarlo_torch.wrapper.functional import WrapperStack


@dataclass
class VecState:
    """Batched env state: every tensor has leading axis B."""

    env: fenv.EnvState
    counters: Tuple[torch.Tensor, ...]  # wrapper terminator counters, (B,)
    episode_step: torch.Tensor  # (B,) int32
    generator: Optional[torch.Generator] = None  # respawn stream


def reset(
    params: fenv.EnvParams,
    n_envs: int,
    seed: int = 0,
    stack: Optional[WrapperStack] = None,
    render: bool = True,
    spawn_rows: Optional[torch.Tensor] = None,
):
    """Spawn n_envs environments. Returns (state, obs (B, L, H, W) or None
    when render=False). The respawn generator lives on the params' device
    and is seeded with `seed`."""
    stack = stack or WrapperStack()
    dev = params.device
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)
    env_state, _, _ = fenv.reset(
        params, n_envs, spawn_row=spawn_rows, generator=generator,
        render=False,
    )
    zeros = torch.zeros(n_envs, dtype=torch.int32, device=dev)
    state = VecState(
        env=env_state,
        counters=tuple(torch.zeros_like(zeros) for _ in stack.termination_fns),
        episode_step=zeros,
        generator=generator,
    )
    obs = fenv.render_observation_batch(params, env_state) if render else None
    return state, obs


def _select(done: torch.Tensor, new, old):
    """Per-env select between two dataclasses of (B, ...) tensors."""
    return replace(
        old,
        **{
            f.name: torch.where(
                done.reshape(done.shape + (1,) * (getattr(old, f.name).ndim - 1)),
                getattr(new, f.name),
                getattr(old, f.name),
            )
            for f in fields(old)
        },
    )


def step(
    params: fenv.EnvParams,
    state: VecState,
    action: Dict[str, torch.Tensor],  # car_control (B, 2), maneuver (B,)
    stack: Optional[WrapperStack] = None,
    max_episode_steps: Optional[int] = None,
    render: bool = True,
    auto_reset: bool = True,
    respawn_rows: Optional[torch.Tensor] = None,
):
    """Vectorized step + fused shaping + in-graph auto-reset.

    Returns (state', obs, reward, terminated, truncated, info), obs None
    when render=False. With a stack carrying reward or termination fns the
    default shaping is off (reference env.py:136-138) and the stack
    supplies it. Finished envs respawn at `respawn_rows` (B,) when given,
    else at rows drawn from the state's generator.
    """
    wrapped = stack is not None and (
        len(stack.reward_fns) > 0 or len(stack.termination_fns) > 0
    )
    stack = stack or WrapperStack()
    env_state, _, reward, terminated, truncated, info = fenv.step(
        params, state.env, action, render=False, wrapped=wrapped
    )
    reward, terminated, counters = stack.apply(
        info, reward, terminated, state.counters
    )

    episode_step = state.episode_step + 1
    if max_episode_steps is not None:
        truncated = truncated | (episode_step >= max_episode_steps)

    done = terminated | truncated
    if auto_reset:
        md = params.map_data
        if respawn_rows is None:
            respawn_rows = torch.randint(
                md.spawns.count, done.shape, generator=state.generator,
                device=done.device,
            )
        fresh = car_mod.car_reset(md, params.cfg.car, respawn_rows)
        env_state = replace(env_state, car=_select(done, fresh, env_state.car))
        counters = tuple(torch.where(done, 0, c) for c in counters)
        episode_step = torch.where(done, 0, episode_step)

    state = VecState(
        env=env_state, counters=counters, episode_step=episode_step,
        generator=state.generator,
    )
    obs = fenv.render_observation_batch(params, env_state) if render else None
    return state, obs, reward, terminated, truncated, info
