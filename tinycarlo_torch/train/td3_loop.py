"""The fused TD3 actor-learner: rollout, replay and updates on the device.

Counterpart of tinycarlo_tpu/train/td3_loop.py:38-280 (reference:
examples/train_td3.py:174-207). A chunk steps B parallel envs T times;
each step encodes the observations with a frozen encoder, explores with OU
noise, inserts the transitions into the replay buffer and runs the TD3
updates, all on the device. The semantics the JAX module lists (:11-19):
  * the frozen encoder's features feed a (seq_len + 1) feature queue that
    is rolled, never cleared, across episode boundaries;
  * replay rows are (queue[1:], m, a, r, queue[:-1]);
  * OU noise resets and a fresh maneuver in {0, 1, 2} is drawn when an
    episode ends, and maneuver 2 goes to the env as 3;
  * updates start once the buffer holds a full batch, after the step's
    insert; `updates_per_step` of them a step, 0 included;
  * OU sigma is constant within an episode: at an episode's end it takes
    the host-set level `sigma_target`, or with `total_episodes` the
    reference's 0.4 * (1 - e / EPISODES) from the env's own count e.

`obs_render_fn` (:128-141, :182-189) replaces the float-obs render, the
composition point of the segment-parallel renderer
(`parallel.sp.render_observation_batch_sp`). With `mesh`, the chunk is one
data-parallel rank of BASELINE config 5's DP x TP x SP chunk (JAX:
tests/_multihost_chunk_common.py): the state's envs, queue, noise,
maneuvers, sigma and episode counts are this rank's rows of the global
batch, the replay buffer and loop scalars are the same on every rank, and
a TP learner (`parallel.tp.shard_params`) does its own collectives over
the model axis. Each step all-gathers its replay rows over the data axis
in global env order, so every rank inserts the same rows at the same
draws and samples the same batch: the replicas stay equal with no
gradient all-reduce. Every random draw of a step is of the global batch's
shape, from generators seeded alike on every rank, and a rank keeps its
rows: its respawns, OU noise and maneuvers are the single-process
chunk's. The outputs are gathered to the global batch.

On the card a chunk is a sequence of replayed CUDA graphs, not one graph
of T steps (at ~2000 kernels a step that would be 400k nodes). A step's
two branches -- whether the buffer holds a batch (:229-232) and whether an
update is an actor step (td3.py:211-213) -- are functions of the step
count, which the host counts: so the loop captures one graph per kind of
step (collect only; critic-only updates; critic + actor; and once more
under tracing, whose graphs mark their stages; `utils.graphs.StepGraphs`),
the first step of each kind run eagerly before its capture, and replays
them in the order the counts give. The graphs share one memory pool and
write everything into the state's own tensors and into (T, ...) output
buffers at a device-side step index; they live on the state
(`LoopState.runtime`), so a field of the state is only ever written with
`copy_` (`sigma_target` between chunks, `utils.checkpoint.restore`).

The state changes in place (the JAX package's chunk is pure): the replay
buffer alone holds 2 GB at config 4's 100 000 slots.

Random draws come from the state's torch.Generators (the loop's and the
env's respawn stream); `draws` injects them instead, for the parity tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.models.tinycar_net import FEATURE_VEC_SIZE, one_hot
from tinycarlo_torch.parallel.mesh import (DATA_AXIS, axis_group,
                                           axis_size, data_rows)
from tinycarlo_torch.train import replay as rb
from tinycarlo_torch.train import td3
from tinycarlo_torch.utils import graphs, profiling
from tinycarlo_torch.wrapper.functional import WrapperStack

# the initial OU sigma (train_td3.py:143)
SIGMA0 = 0.4
# a step's stages, as the device spans `_step` opens around them
# (utils/profiling.py; benchmarks/profile_td3.py prices them, eager and in
# the replayed graphs); the uint8 observation's render runs inside the
# env step, in vector.step's "vector.render" span
STAGES = ("td3.policy", "td3.env_step", "td3.render", "td3.encoder",
          "td3.replay_add", "td3.update")
# the losses of one update, in the order of `update_losses`' last axis
LOSSES = ("critic1_loss", "critic2_loss", "actor_loss")


@dataclass(frozen=True)
class LoopConfig:
    """Rollout-side knobs; the defaults of tinycarlo_tpu's LoopConfig
    (train_td3.py:25-48). `obs_dtype`: None renders the uint8 observation
    contract (the encoder gets `pre_obs` of it); torch.float32 or
    torch.bfloat16 (classes only) has the masks kernel write 0/1 masks in
    that dtype straight for the encoder. Ignored when the wrapper stack
    has observation fns. `total_episodes`: planned episodes per env for
    the in-graph sigma decay; None keeps the host-set `sigma_target`."""

    speed: float = 0.4
    steering_shift: float = 0.0
    max_episode_steps: int = 1000
    replay_size: int = 500_000
    updates_per_step: int = 1
    obs_dtype: Optional[torch.dtype] = None
    total_episodes: Optional[int] = None


@dataclass
class LoopState:
    vstate: vector.VecState
    queue: torch.Tensor  # (B, seq_len + 1, F)
    noise: torch.Tensor  # (B, action_dim)
    maneuver: torch.Tensor  # (B,) int32
    buf: rb.ReplayBuffer
    td3_state: td3.TD3State
    generator: torch.Generator  # OU, eviction, sample and maneuver draws
    sigma: torch.Tensor  # (B,) per-env OU sigma
    sigma_target: torch.Tensor  # () the host-set level
    ep_count: torch.Tensor  # (B,) int32 completed episodes
    # the host's copies of buf.filled and td3_state.steps, which decide
    # each step's kind without reading the device
    filled_host: int = 0
    steps_host: int = 0
    # the captured graphs and their buffers; never saved
    runtime: Optional[Any] = field(default=None, repr=False)


def init_loop(
    params: fenv.EnvParams,
    cfg: td3.TD3Config,
    loop_cfg: LoopConfig,
    n_envs: int,
    seed: int = 0,
    stack: Optional[WrapperStack] = None,
    td3_state: Optional[td3.TD3State] = None,
) -> LoopState:
    """A fresh loop on the params' device: `n_envs` envs reset from a
    generator seeded with `seed`, zero queue and noise, maneuvers drawn
    from the loop's generator (seeded with seed + 1), an empty buffer of
    `loop_cfg.replay_size` and `td3.create(cfg, seed)` (or `td3_state`)."""
    dev = params.device
    vstate, _ = vector.reset(params, n_envs, seed=seed, stack=stack,
                             render=False)
    generator = torch.Generator(device=dev).manual_seed(seed + 1)
    f32 = torch.float32
    example = {
        "x": torch.zeros((cfg.seq_len, FEATURE_VEC_SIZE), dtype=f32),
        "m": torch.zeros((), dtype=torch.int32),
        "a": torch.zeros((cfg.action_dim,), dtype=f32),
        "r": torch.zeros((1,), dtype=f32),
        "x1": torch.zeros((cfg.seq_len, FEATURE_VEC_SIZE), dtype=f32),
    }
    return LoopState(
        vstate=vstate,
        queue=torch.zeros((n_envs, cfg.seq_len + 1, FEATURE_VEC_SIZE),
                          dtype=f32, device=dev),
        noise=torch.zeros((n_envs, cfg.action_dim), dtype=f32, device=dev),
        maneuver=torch.randint(3, (n_envs,), generator=generator,
                               device=dev, dtype=torch.int32),
        buf=rb.create(loop_cfg.replay_size, example, device=dev),
        td3_state=(td3.create(cfg, seed, device=dev) if td3_state is None
                   else td3_state),
        generator=generator,
        sigma=torch.full((n_envs,), SIGMA0, dtype=f32, device=dev),
        sigma_target=torch.tensor(SIGMA0, dtype=f32, device=dev),
        ep_count=torch.zeros(n_envs, dtype=torch.int32, device=dev),
    )


class _DataParallel:
    """A chunk's data axis: this rank's rows of the global batch of
    `n` envs, the global draws cut to them, and all-gathers in global env
    order over the data group."""

    def __init__(self, mesh, n_local: int):
        self.group = axis_group(mesh, DATA_AXIS)
        self.size = axis_size(mesh, DATA_AXIS)
        self.n = n_local * self.size
        self.rows = data_rows(self.n, mesh)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        # bool goes as its bytes (the gloo backend has no bool type)
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        parts = [torch.empty_like(wire) for _ in range(self.size)]
        torch.distributed.all_gather(parts, wire.contiguous(),
                                     group=self.group)
        out = torch.cat(parts)
        return out.bool() if x.dtype == torch.bool else out


def step_kinds(state: LoopState, cfg: td3.TD3Config, loop_cfg: LoopConfig,
               n_steps: int, b: Optional[int] = None):
    """The kind of each of the next `n_steps` steps, from the host's
    counts, and the counts after them: a kind is None (collect only) or
    the tuple of the step's updates, True for an actor update. `b`: the
    envs a step inserts (default: the state's)."""
    b = state.queue.shape[0] if b is None else b
    filled, steps = state.filled_host, state.steps_host
    kinds = []
    for _ in range(n_steps):
        filled = min(filled + b, state.buf.size)
        if loop_cfg.updates_per_step > 0 and filled >= cfg.batch_size:
            kinds.append(tuple(
                (steps + i + 1) % cfg.policy_delay == 0
                for i in range(loop_cfg.updates_per_step)))
            steps += loop_cfg.updates_per_step
        else:
            kinds.append(None)
    return kinds, filled, steps


class _Runtime:
    """A chunk's output buffers, its step index, the injected draws'
    buffers, and its captured steps, one graph a kind of step
    (`graphs.StepGraphs`). The buffers hold `steps` rows, the longest
    chunk since the capture; a shorter chunk fills their first rows."""

    def __init__(self, key, n_steps: int, outs: Dict[str, torch.Tensor],
                 dev: torch.device):
        self.key = key
        self.steps = n_steps
        self.out = {k: torch.zeros((n_steps, *v.shape), dtype=v.dtype,
                                   device=dev) for k, v in outs.items()}
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.draws: Optional[Dict[str, torch.Tensor]] = None
        self.step_graphs = graphs.StepGraphs(dev)


def _step(state: LoopState, params, cfg: td3.TD3Config,
          loop_cfg: LoopConfig, encoder_apply: Callable, stack, kind,
          rt: _Runtime, obs_render_fn: Optional[Callable] = None,
          dp: Optional[_DataParallel] = None) -> None:
    """One fused step (td3_loop.py:144-278), in place, its outputs written
    at row rt.t of rt.out; reads row rt.t of rt.draws when injected. With
    `dp` the state holds this rank's rows (module docstring)."""
    s = state
    b = s.queue.shape[0]
    dev = s.queue.device
    draw = None
    if rt.draws is not None:
        draw = {k: v.index_select(0, rt.t)[0] for k, v in rt.draws.items()}
    # per-env draws are of the global batch under dp, cut to this rank's
    # rows (eviction and sample draws are the global batch's anyway)
    n_draw, mine = (b, slice(None)) if dp is None else (dp.n, dp.rows)

    def drawn(key, make):
        return (draw[key] if draw is not None else make(n_draw))[mine]

    net_dtype = s.queue.dtype
    feat_seq = s.queue[:, :-1]
    m_onehot = one_hot(s.maneuver, cfg.maneuver_dim, net_dtype)
    eps = drawn("ou", lambda n: torch.randn(
        (n, *s.noise.shape[1:]), generator=s.generator,
        dtype=s.noise.dtype, device=dev))
    respawn = None  # vector.step draws them itself
    if draw is not None or dp is not None:
        respawn = drawn("respawn", lambda n: torch.randint(
            params.map_data.spawns.count, (n,),
            generator=s.vstate.generator, device=dev))
    with profiling.device_span("td3.policy", dev):
        noise = (s.noise + cfg.noise_theta * (cfg.noise_mean - s.noise)
                 + s.sigma[:, None] * eps)
        action = td3.select_action(s.td3_state, cfg, feat_seq, m_onehot,
                                   noise, loop_cfg.steering_shift)
    env_dtype = s.vstate.env.car.position.dtype
    env_action = {
        "car_control": torch.stack(
            [torch.full((b,), loop_cfg.speed, dtype=env_dtype, device=dev),
             action[:, 0].to(env_dtype)], dim=-1),
        "maneuver": torch.where(s.maneuver != 2, s.maneuver, 3),
    }
    float_obs = loop_cfg.obs_dtype is not None and not (
        stack is not None and stack.observation_fns)
    with profiling.device_span("td3.env_step", dev):
        vstate, obs, rew, term, trunc, info = vector.step(
            params, s.vstate, env_action, stack=stack,
            max_episode_steps=loop_cfg.max_episode_steps,
            render=not float_obs, respawn_rows=respawn,
        )
    if float_obs:
        # 0/1 masks in the encoder's dtype straight from the kernel, of
        # the post-reset states vector.step would render
        render = (fenv.render_observation_batch if obs_render_fn is None
                  else obs_render_fn)
        with profiling.device_span("td3.render", dev):
            obs = render(params, vstate.env, out_dtype=loop_cfg.obs_dtype)
    with profiling.device_span("td3.encoder", dev):
        f = encoder_apply(obs).to(s.queue.dtype)
    queue = torch.cat([f[:, None], s.queue[:, :-1]], dim=1)
    rows = {"x": queue[:, 1:], "m": s.maneuver, "a": action,
            "r": rew[:, None].to(torch.float32), "x1": queue[:, :-1]}
    if dp is not None:
        rows = {k: dp.gather(v) for k, v in rows.items()}
    with profiling.device_span("td3.replay_add", dev):
        rb.add_batch(s.buf, rows, s.generator,
                     None if draw is None else draw["evict"])
    profiling.count("td3.rows_inserted", rows["m"].shape[0])

    per_update = []
    for i, do_actor in enumerate(kind or ()):
        with profiling.device_span("td3.update", dev):
            batch = rb.sample(s.buf, cfg.batch_size, s.generator,
                              None if draw is None else draw["sample"][i])
            batch["m"] = one_hot(batch["m"], cfg.maneuver_dim, net_dtype)
            batch["m1"] = batch["m"]
            _, losses = td3.train_step(s.td3_state, cfg, batch, do_actor)
            per_update.append(torch.stack(
                [losses[k].to(torch.float32) for k in LOSSES]))
    # (U, 3): each update's losses (LOSSES), 0 on a step without updates
    update_losses = (torch.stack(per_update) if per_update else torch.zeros(
        (loop_cfg.updates_per_step, len(LOSSES)), dtype=torch.float32,
        device=dev))
    if kind:
        profiling.count("td3.updates", len(kind))
        profiling.count("td3.actor_updates", sum(kind))
    done = term | trunc
    noise = torch.where(done[:, None], 0.0, noise)
    ep_count = s.ep_count + done.to(torch.int32)
    if loop_cfg.total_episodes is not None:
        level = SIGMA0 * torch.clamp(
            1.0 - ep_count.to(torch.float32) / loop_cfg.total_episodes,
            min=0.0)
    else:
        level = s.sigma_target.expand(ep_count.shape)
    sigma = torch.where(done, level, s.sigma)
    fresh = drawn("maneuver", lambda n: torch.randint(
        3, (n,), generator=s.generator, device=dev, dtype=torch.int32))
    maneuver = torch.where(done, fresh.to(torch.int32), s.maneuver)

    per_env = {"reward": rew, "done": done, "sigma": sigma,
               "cte": info["cte"], "lines": info["laneline_distances"]}
    if dp is not None:
        per_env = {k: dp.gather(v) for k, v in per_env.items()}
    lines = per_env.pop("lines")
    out = {**per_env,
           # batch-mean per-laneline distances (vis_utils.py's logging)
           "laneline_distances": lines.mean(dim=0),
           # the last update's losses, as the JAX package's chunk gives them
           **{k: update_losses[-1, j] if len(update_losses)
              else torch.zeros((), dtype=torch.float32, device=dev)
              for j, k in enumerate(LOSSES)},
           "update_losses": update_losses}
    with torch.no_grad():
        graphs.copy_into(s.vstate, vstate)
        s.queue.copy_(queue)
        s.noise.copy_(noise)
        s.maneuver.copy_(maneuver)
        s.sigma.copy_(sigma)
        s.ep_count.copy_(ep_count)
        for k, v in out.items():
            rt.out[k].index_copy_(0, rt.t, v[None].to(rt.out[k].dtype))
        rt.t.add_(1)


def _outputs(state: LoopState, params, b: int,
             updates: int) -> Dict[str, torch.Tensor]:
    """One step's outputs of a b-env batch with `updates` updates a step,
    zeros of their shapes and dtypes."""
    dev = state.queue.device
    dtype = state.vstate.env.car.position.dtype
    n_lines = fenv._info(params, state.vstate.env)["laneline_distances"]
    return {
        "reward": torch.zeros(b, dtype=dtype, device=dev),
        "done": torch.zeros(b, dtype=torch.bool, device=dev),
        "sigma": torch.zeros(b, dtype=torch.float32, device=dev),
        "cte": torch.zeros(b, dtype=dtype, device=dev),
        "laneline_distances": torch.zeros(n_lines.shape[1:], dtype=dtype,
                                          device=dev),
        **{k: torch.zeros((), dtype=torch.float32, device=dev)
           for k in LOSSES},
        "update_losses": torch.zeros((updates, len(LOSSES)),
                                     dtype=torch.float32, device=dev),
    }


def chunk(
    state: LoopState,
    params: fenv.EnvParams,
    cfg: td3.TD3Config,
    loop_cfg: LoopConfig,
    encoder_apply: Callable,
    n_steps: int,
    stack: Optional[WrapperStack] = None,
    draws: Optional[Dict[str, torch.Tensor]] = None,
    graph: bool = True,
    obs_render_fn: Optional[Callable] = None,
    mesh=None,
) -> Tuple[LoopState, Dict[str, torch.Tensor]]:
    """Run `n_steps` fused rollout + train steps, updating `state` in
    place. `encoder_apply(obs) -> (B, F)` features (typically
    `models.tinycar_net.encoder_apply_fn` of a frozen encoder,
    train_td3.py:66-67,152-155). Returns (state, outputs), each output
    (T, ...): reward, done, sigma, cte (B per step), laneline_distances
    (the batch mean), critic1_loss, critic2_loss, actor_loss (the step's
    last update's; 0 where skipped), update_losses (U, 3): every update's
    critic1, critic2 and actor loss (LOSSES; actor 0 on a critic-only
    update, all 0 on a step without updates), U = updates_per_step.

    The graphs write into buffers of the longest chunk run since they
    were captured: a chunk of fewer steps replays the same graphs and
    returns its first rows; a longer one captures anew.

    On a CUDA state with `graph`, steps replay captured graphs (module
    docstring); otherwise each step runs eagerly. `draws` (tests only)
    injects a chunk's random numbers, each (T, ...): "ou" (B, A) normals,
    "evict" (B,) slots, "sample" (U, batch) indices, "maneuver" (B,) and
    "respawn" (B,) spawn rows, of the global batch under a mesh.

    `obs_render_fn(params, env_state, out_dtype=...) -> obs` replaces the
    float-obs render (it needs `loop_cfg.obs_dtype`). `mesh`: a
    (data, model) `parallel.mesh` DeviceMesh; the state holds this rank's
    rows of the global batch (module docstring). Under a mesh of more
    than one rank the chunk runs eagerly and `graph=True` on the card
    raises: the collectives go through the host (gloo) and cannot be
    captured in a CUDA graph, and a capture that left them out would
    silently skip them."""
    dev = state.queue.device
    if obs_render_fn is not None and loop_cfg.obs_dtype is None:
        raise ValueError("obs_render_fn replaces the float-obs render: set "
                         "loop_cfg.obs_dtype")
    dp = None
    if mesh is not None and mesh.size() > 1:
        if graph and dev.type == "cuda":
            raise ValueError("a chunk over a mesh of more than one rank "
                             "runs eagerly: pass graph=False")
        if stack is not None and stack.observation_fns:
            raise ValueError("observation wrappers draw per local env: "
                             "not defined under a mesh")
        dp = _DataParallel(mesh, state.queue.shape[0])
    n_global = state.queue.shape[0] if dp is None else dp.n
    key = (id(params), id(encoder_apply), id(stack), cfg, loop_cfg,
           draws is not None, id(obs_render_fn), id(mesh))
    rt = state.runtime
    if rt is None or rt.key != key or rt.steps < n_steps:
        rt = state.runtime = _Runtime(
            key, n_steps, _outputs(state, params, n_global,
                                   loop_cfg.updates_per_step), dev)
    if draws is not None:
        if rt.draws is None:
            rt.draws = {k: torch.zeros((rt.steps, *v.shape[1:]),
                                       dtype=v.dtype, device=dev)
                        for k, v in draws.items()}
        for k, v in draws.items():
            rt.draws[k][:n_steps].copy_(v)
    rt.t.zero_()
    kinds, filled, steps = step_kinds(state, cfg, loop_cfg, n_steps,
                                      n_global)
    kernels = fenv.render_kernels(params)
    for kind in kinds:
        rt.step_graphs.run(
            kind, partial(_step, state, params, cfg, loop_cfg, encoder_apply,
                          stack, kind, rt, obs_render_fn, dp),
            graph, kernels, (state.generator, state.vstate.generator))
    state.filled_host, state.steps_host = filled, steps
    return state, {k: v[:n_steps].clone() for k, v in rt.out.items()}


def set_sigma_target(state: LoopState, level: float) -> None:
    """The host-driven OU sigma level that envs adopt at their next
    episode boundary (examples/train_td3.py), written in place."""
    state.sigma_target.fill_(level)
