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

`rollout` runs n steps of (policy -> step) (tinycarlo_tpu/vector.py:
158-209, a jitted scan there). On the CPU it is a loop; on the card its
first steps run eagerly and the rest replay one captured CUDA graph of a
step (utils/graphs.py), so the host enqueues one replay a step.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from tinycarlo_torch import car as car_mod
from tinycarlo_torch import env as fenv
from tinycarlo_torch.utils import graphs, profiling
from tinycarlo_torch.wrapper.functional import WrapperStack

# eager steps of a rollout on the card before its step is captured
ROLLOUT_WARMUP = 3


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
    when render=False; the stack's observation fns transform the rendered
    obs, drawing from the state's generator. With a stack carrying reward
    or termination fns the default shaping is off (reference
    env.py:136-138) and the stack supplies it. Finished envs respawn at
    `respawn_rows` (B,) when given, else at rows drawn from the state's
    generator.
    """
    with profiling.device_span("vector.step", state.episode_step.device):
        return _step(params, state, action, stack, max_episode_steps, render,
                     auto_reset, respawn_rows)


def _step(params, state, action, stack, max_episode_steps, render,
          auto_reset, respawn_rows):
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
    obs = None
    if render:
        with profiling.device_span("vector.render", episode_step.device):
            obs = fenv.render_observation_batch(params, env_state)
        if stack.observation_fns:  # tinycarlo_tpu/vector.py:147-150
            obs = stack.apply_observation(state.generator, obs)
    return state, obs, reward, terminated, truncated, info


def rollout(
    params: fenv.EnvParams,
    state: VecState,
    policy_fn: Callable,
    n_steps: int,
    stack: Optional[WrapperStack] = None,
    max_episode_steps: Optional[int] = None,
    render: bool = True,
    generator: Optional[torch.Generator] = None,
    info_keys: Sequence[str] = (),
    keep_obs: bool = True,
    graph: bool = True,
    stats: Optional[Dict[str, int]] = None,
):
    """`n_steps` of (policy -> step). Returns (final state, trajectory):
    reward, terminated, truncated, cte and heading_error (T, B) stacked
    along a leading time axis, "obs" (T, B, ...) when rendering (unless
    `keep_obs` is off: at 4096 rgb envs a 100-step trajectory's frames
    would take 25 GB), and the info entries named in `info_keys` (e.g.
    "position").

    `policy_fn(obs or None, env_state, generator) -> action dict`; it
    receives the EnvState, so observation-free controllers (Stanley) skip
    the render (render=False). `generator` drives the policy's draws
    (default: the state's own, which also draws the respawns). A policy
    that keeps state between steps keeps it in tensors it updates in place.

    On a CUDA state with `graph` (the default) and more than
    ROLLOUT_WARMUP steps, those first steps run eagerly on the side
    stream, then one step is captured over the state's tensors by a
    `graphs.StepGraphs` of the call (each render kernel recorded once when
    rendering; the generators registered) and replayed for the rest, its
    outputs written into (T, ...) buffers at a device-side step index.
    The returned state's tensors are the graph's static ones. `stats`, if
    given, gains the counts "replays" and "captures" (a replayed render
    passes no kernel wrapper, so launch counts read eager renders plus
    captures).

    Traced (utils/profiling.py): the call span "rollout" holds
    "rollout.warmup" (the eager steps), "rollout.capture" and one
    "rollout.replay" a replay on the host; each step, eager or replayed,
    is the device span "rollout.step". The call captures its graph anew,
    so tracing at call time decides whether the graph carries the marks.
    """
    with profiling.span("rollout", call=True):
        return _rollout(params, state, policy_fn, n_steps, stack,
                        max_episode_steps, render, generator, info_keys,
                        keep_obs, graph, stats)


def _rollout(params, state, policy_fn, n_steps, stack, max_episode_steps,
             render, generator, info_keys, keep_obs, graph, stats):
    generator = state.generator if generator is None else generator
    device = state.episode_step.device

    def body(vs):
        obs = (fenv.render_observation_batch(params, vs.env)
               if render else None)
        action = policy_fn(obs, vs.env, generator)
        vs, _, reward, term, trunc, info = step(
            params, vs, action, stack=stack,
            max_episode_steps=max_episode_steps, render=False,
        )
        out = {"reward": reward, "terminated": term, "truncated": trunc,
               "cte": info["cte"], "heading_error": info["heading_error"]}
        out.update({k: info[k] for k in info_keys})
        if obs is not None and keep_obs:
            out["obs"] = obs
        return vs, out

    use_graph = (graph and state.episode_step.device.type == "cuda"
                 and n_steps > ROLLOUT_WARMUP)
    outs = []

    def eager():
        nonlocal state
        with profiling.device_span("rollout.step", device):
            state, out = body(state)
        outs.append(out)

    if not use_graph:
        for _ in range(n_steps):
            eager()
        return state, _stack(outs)

    with profiling.span("rollout.warmup"):
        graphs.warm_up(eager, ROLLOUT_WARMUP)
    graphs.check_distinct(graphs.tensors(state), "rollout")
    n_rest = n_steps - ROLLOUT_WARMUP
    bufs = {k: torch.empty((n_rest, *v.shape), dtype=v.dtype,
                           device=v.device) for k, v in outs[-1].items()}
    t = torch.zeros(1, dtype=torch.long, device=device)

    def captured():
        with profiling.device_span("rollout.step", device):
            new, out = body(state)
            graphs.copy_into(state, new)
            for k, v in out.items():
                bufs[k].index_copy_(0, t, v[None])
            t.add_(1)

    steps = graphs.StepGraphs(device, name="rollout")
    with profiling.span("rollout.capture"):
        steps.capture(None, captured, fenv.render_kernels(params) if render
                      else (), generators=(state.generator, generator))
    for _ in range(n_rest):
        steps.replay(None)
    if stats is not None:
        stats["replays"] = stats.get("replays", 0) + steps.replays
        stats["captures"] = stats.get("captures", 0) + steps.captures
    traj = _stack(outs)
    return state, {k: torch.cat([traj[k], bufs[k]]) for k in bufs}


def _stack(outs):
    if not outs:
        return {}
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
