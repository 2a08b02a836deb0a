"""Stanley-expert imitation learning on the device.

Counterpart of tinycarlo_tpu/train/il.py (reference: examples/
train_stanley_il.py): per-chunk camera domain randomization (pitch in
[10, 20), fov in [90, 130)), a Stanley expert with OU noise collecting
(obs, maneuver, steering) tuples every `skip_steps` frames under the
reference's collection-time CTE cut, DAgger chunks in which the car
follows the net while the label stays the expert's, and supervised MSE
training of the TinycarCombo with BatchNorm in train mode.

Unlike the JAX package's pure functions, training changes the state in
place (parameters, BatchNorm running statistics, Adam moments and count),
so that a CUDA graph can replay a step over the state's own tensors.
Adam is `train.td3.adam_update`, optax's order of operations.

On the card (`utils.graphs.StepGraphs`):
- `train_chunk` runs its first step eagerly, captures one step (index
  draw, gather, `pre_obs`, one-hot, forward, backward, Adam)
  as a CUDA graph over static batch buffers with the index generator
  registered, and replays it for the rest of the chunk; the losses go
  into an (n_steps,) device buffer at a device-side index. The graph lives
  on the state (`ILState.runtime`) and is kept while the data tensors,
  the chunk length, the generator and the config stay the same.
- A `Collector` captures one unit of collection steps: `skip_steps` steps
  of which the last renders (the expert), or one rendering step (DAgger),
  and replays it `chunk_steps // unit` times a chunk (an expert chunk's
  remaining steps, which render nothing, run eagerly). The camera
  matrices, the env state, the noise and the outputs are static tensors
  that each chunk refills in place. A replayed render passes no kernel
  wrapper, so the collector counts eager renders, captures and replays
  (`Collector.stats`): launches = renders + captures.
Nothing in a chunk syncs with the host; a failed capture raises.

Random draws come from torch.Generators (the JAX package splits
`jax.random` keys; the streams differ). `draws` injects them instead, for
the parity tests: the batch indices of `train_chunk`, and a collection
chunk's camera (pitch, fov), reset rows, OU normals and respawn rows.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tinycarlo_torch import camera as cam
from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.models.tinycar_net import (
    TinycarCombo,
    encoder_flat_features,
    flax_init_,
    one_hot,
    pre_obs,
)
# the one reader of the flat npz, re-exported beside its writer
from tinycarlo_torch.models.tinycar_net import load_variables_npz  # noqa: F401
from tinycarlo_torch.train import td3
from tinycarlo_torch.train.stanley import stanley_steering
from tinycarlo_torch.utils import graphs
from tinycarlo_torch.utils.helper import resolve_device
from tinycarlo_torch.wrapper.functional import WrapperStack, cte_termination


@dataclass(frozen=True)
class ILConfig:
    """The JAX package's ILConfig (tinycarlo_tpu/train/il.py:31-64), whose
    defaults mirror reference train_stanley_il.py:18-36.
    `collect_max_cte`: the collection-time CTE cut (the reference collects
    under CTETerminationWrapper(max_cte=0.15), train_stanley_il.py:84): a
    car the OU noise pushed off the path auto-resets. `turn_weight`: w > 0
    weights each sample's squared error by 1 + w * min(|label|, 1),
    normalized per batch (0 is the reference's plain MSE). `camera_dr`:
    fresh pitch and fov for every chunk (train_stanley_il.py:53-57); False
    collects against the config's camera."""

    learning_rate: float = 1e-4
    batch_size: int = 32
    steps: int = 10_000
    speed: float = 0.5
    k: float = 5.0
    noise_theta: float = 0.1
    noise_sigma: float = 0.4
    skip_steps: int = 2
    maneuver_dim: int = 3
    action_dim: int = 1
    collect_max_cte: float = 0.15
    turn_weight: float = 0.0
    camera_dr: bool = True


@dataclass
class ILState:
    """The combo (parameters and BatchNorm running statistics; kept in
    eval mode between steps), its Adam state, the generator of
    `train_chunk`'s batch draws, and the captured train step (never
    saved)."""

    model: TinycarCombo
    opt: td3.AdamState
    generator: Optional[torch.Generator] = None
    runtime: Optional[Any] = field(default=None, repr=False)


def _chw(obs_shape: Sequence[int]) -> Tuple[int, int, int]:
    """(C, H, W) of an env observation shape, (C, H, W) or (H, W, C) with
    C in (1, 3) -- `pre_obs`'s rule."""
    if len(obs_shape) != 3:
        raise ValueError(f"the combo takes (C, H, W) or (H, W, C) frames, "
                         f"got observation shape {tuple(obs_shape)}")
    if obs_shape[-1] in (1, 3):
        return obs_shape[2], obs_shape[0], obs_shape[1]
    return tuple(obs_shape)


def _state(model: TinycarCombo, device: torch.device,
           dtype: torch.dtype, seed: int) -> ILState:
    model = model.to(device=device, dtype=dtype).eval()
    return ILState(
        model=model, opt=td3.adam_init(model),
        generator=torch.Generator(device=device).manual_seed(seed + 1))


def create(obs_shape: Sequence[int], cfg: ILConfig, seed: int = 0,
           device="cuda", dtype: torch.dtype = torch.float32) -> ILState:
    """A fresh learner for `obs_shape` (the env's (C, H, W) or (H, W, 3)):
    the combo with flax's initialisers (lecun-normal kernels, zero biases,
    BatchNorm 1 / 0 and running statistics 0 / 1), drawn on the CPU from a
    torch.Generator seeded with `seed` and moved to `device` (default
    "cuda"; raises without a GPU), Adam at zero, and the batch-draw
    generator seeded with seed + 1. The JAX package draws the weights from
    `jax.random.key`; the streams differ."""
    device = resolve_device(device)
    c, h, w = _chw(obs_shape)
    model = TinycarCombo(in_channels=c, maneuver_dim=cfg.maneuver_dim,
                         action_dim=cfg.action_dim,
                         flat_features=encoder_flat_features(h, w))
    flax_init_(model, torch.Generator().manual_seed(seed))
    return _state(model, device, dtype, seed)


def state_from_state_dict(sd: Dict[str, torch.Tensor], cfg: ILConfig,
                          device="cuda", seed: int = 0) -> ILState:
    """A learner whose combo holds the state dict `sd` (in its dtype), with
    Adam at zero (`convert.il_state_from_flax` then fills the moments)."""
    device = resolve_device(device)
    model = TinycarCombo(
        in_channels=sd["encoder.convs.0.conv1.weight"].shape[1],
        maneuver_dim=cfg.maneuver_dim, action_dim=cfg.action_dim,
        flat_features=sd["encoder.fc1.weight"].shape[1])
    model.to(sd["encoder.fc1.weight"].dtype).load_state_dict(sd)
    return _state(model, device, sd["encoder.fc1.weight"].dtype, seed)


def train_step(state: ILState, cfg: ILConfig,
               batch: Dict[str, torch.Tensor]) -> Tuple[ILState, torch.Tensor]:
    """MSE regression of the combo onto expert steering
    (train_stanley_il.py:117-124), in place. batch: x (B, C, H, W) float
    (`pre_obs`), m (B, M) one-hot, y (B, A). BatchNorm runs in train mode
    and updates its running statistics as flax's does; the gradients are
    taken with respect to fresh leaves over the parameters' storage
    (`td3._leaves`). Returns (state, loss)."""
    model = state.model
    leaves = td3._leaves(model, True)
    model.train()
    try:
        out = td3._call(model, leaves, batch["x"], batch["m"])
    finally:
        model.eval()
    err = (out - batch["y"]) ** 2
    if cfg.turn_weight:
        w = 1.0 + cfg.turn_weight * torch.clamp_max(batch["y"].abs(), 1.0)
        loss = torch.sum(w * err) / torch.sum(w)
    else:
        loss = torch.mean(err)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    names, params = td3._params(model)
    td3.adam_update(params, grads, state.opt, names, cfg.learning_rate)
    return state, loss.detach()


def draw_indices(cfg: ILConfig, data: Dict[str, torch.Tensor],
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One batch's (batch_size,) dataset indices: uniform, or with `pools`
    ((M, P) per-maneuver sample indices, repeat-padded) and `pool_n` ((M,)
    live pool sizes) MANEUVER-BALANCED, batch_size // M uniform draws from
    each pool, then a uniform remainder (tinycarlo_tpu/train/il.py:
    156-169). Drawn on the device, without a host sync."""
    n = data["x"].shape[0]
    dev = data["x"].device
    if "pools" not in data:
        return torch.randint(n, (cfg.batch_size,), generator=generator,
                             device=dev)
    pools, pool_n = data["pools"], data["pool_n"]
    n_m = pools.shape[0]
    per = cfg.batch_size // n_m
    parts = []
    for m in range(n_m):
        # uniform in [0, pool_n[m]) from 62 random bits (bias < 2^-31)
        r = torch.randint(2 ** 62, (per,), generator=generator, device=dev)
        parts.append(pools[m].index_select(
            0, r % pool_n[m].clamp_min(1).long()).long())
    rem = cfg.batch_size - per * n_m
    if rem:
        parts.append(torch.randint(n, (rem,), generator=generator,
                                   device=dev))
    return torch.cat(parts)


def _batch(cfg: ILConfig, data: Dict[str, torch.Tensor], idx: torch.Tensor,
           dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The gathered batch: frames through `pre_obs`, one-hot maneuvers."""
    return {
        "x": pre_obs(data["x"].index_select(0, idx)).to(dtype),
        "m": one_hot(data["m"].index_select(0, idx), cfg.maneuver_dim, dtype),
        "y": data["y"].index_select(0, idx).to(dtype),
    }


class _TrainRuntime:
    """A train chunk's loss buffer, step index, injected draws and captured
    step (`graphs.StepGraphs`)."""

    def __init__(self, key, n_steps: int, dev: torch.device,
                 dtype: torch.dtype):
        self.key = key
        self.losses = torch.zeros(n_steps, dtype=dtype, device=dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.draws: Optional[torch.Tensor] = None
        self.step_graphs = graphs.StepGraphs(dev)


def train_chunk(
    state: ILState,
    cfg: ILConfig,
    data: Dict[str, torch.Tensor],
    n_steps: int,
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
    graph: bool = True,
) -> Tuple[ILState, torch.Tensor]:
    """`n_steps` train steps over a dataset on the device, in place: x (N,
    H, W, C) or (N, C, H, W) uint8, m (N,) int, y (N, A), and optionally
    `pools` / `pool_n` for maneuver-balanced batches (`draw_indices`).
    Each step draws its indices from `generator` (default the state's),
    gathers the batch and converts it (`pre_obs`, one-hot) on the device.
    `draws` (tests) injects the (n_steps, batch_size) indices. Returns
    (state, losses (n_steps,)).

    On a CUDA state with `graph`, the steps replay one captured graph
    (module docstring); otherwise each step runs eagerly."""
    generator = state.generator if generator is None else generator
    dev = data["x"].device
    dtype = next(state.model.parameters()).dtype
    key = (cfg, n_steps, draws is not None, id(generator),
           tuple((k, v.data_ptr(), tuple(v.shape))
                 for k, v in sorted(data.items())))
    rt = state.runtime
    if rt is None or rt.key != key:
        rt = state.runtime = _TrainRuntime(key, n_steps, dev, dtype)
    if draws is not None:
        if rt.draws is None:
            rt.draws = draws.to(dev).long().clone()
        else:
            rt.draws.copy_(draws)
    rt.t.zero_()

    def run():
        idx = (rt.draws.index_select(0, rt.t)[0] if rt.draws is not None
               else draw_indices(cfg, data, generator))
        _, loss = train_step(state, cfg, _batch(cfg, data, idx, dtype))
        with torch.no_grad():
            rt.losses.index_copy_(0, rt.t, loss[None])
            rt.t.add_(1)

    for _ in range(n_steps):
        rt.step_graphs.run(None, run, graph, generators=(generator,))
    return state, rt.losses.clone()


def save_variables_npz(path: str,
                       state_or_model: Union[ILState, torch.nn.Module]
                       ) -> None:
    """Write the combo as the JAX package's flat npz: its flax variables
    ({"params", "batch_stats"}, `convert.combo_state_dict_to_flax`) keyed
    by '/'-joined paths (tinycarlo_tpu/train/il.py:183-194), so that the
    JAX package's `load_variables_npz` and flax TinycarCombo, and the
    port's `models.load_pretrained`, read it."""
    from tinycarlo_torch.convert import combo_state_dict_to_flax, flat_paths

    model = (state_or_model.model if isinstance(state_or_model, ILState)
             else state_or_model)
    np.savez(path, **flat_paths(combo_state_dict_to_flax(model)))


# ---------------------------------------------------------------------------
# Collection
# ---------------------------------------------------------------------------

def camera_draw(generator: Optional[torch.Generator] = None,
                device=None) -> Tuple[int, int]:
    """(pitch, fov) ~ (U{10..19}, U{90..129}) degrees from `generator`
    (reference train_stanley_il.py:53-57), read on the host."""
    dev = generator.device if generator is not None else (device or "cpu")
    pitch = torch.randint(10, 20, (), generator=generator, device=dev)
    fov = torch.randint(90, 130, (), generator=generator, device=dev)
    return int(pitch), int(fov)


def camera_matrices(params: fenv.EnvParams, pitch, fov) -> cam.CameraMatrices:
    """The config's camera at `pitch` and `fov` degrees, built by
    `camera.matrix_builder` in the params' dtype on their device."""
    cfg = params.cfg.camera
    orientation = [float(pitch)] + list(cfg.orientation)[1:]
    build = cam.matrix_builder(cfg.resolution, params.camera.E.dtype,
                               params.device)
    return build(orientation, cfg.position, float(fov))


def randomize_camera(params: fenv.EnvParams,
                     generator: Optional[torch.Generator] = None
                     ) -> fenv.EnvParams:
    """The params with fresh camera matrices: pitch ~ U{10..19}, fov ~
    U{90..129} (`camera_draw`), rebuilt by `camera_matrices`."""
    return replace(params, camera=camera_matrices(
        params, *camera_draw(generator, params.device)))


class Collector:
    """Collection chunks of `n_envs` envs x `chunk_steps` steps over static
    tensors, replayed as CUDA graphs on the card (module docstring). With
    a `model` (a TinycarCombo in eval mode) the chunks are DAgger's: the
    car follows the net, the label stays the expert's. `stats` counts
    eager renders, captures and unit replays."""

    def __init__(self, params: fenv.EnvParams, cfg: ILConfig, n_envs: int,
                 chunk_steps: int, model: Optional[torch.nn.Module] = None,
                 graph: bool = True):
        dev = params.device
        # the camera the graphs read; each chunk copies its matrices in
        self.params = replace(params, camera=cam.CameraMatrices(
            E=params.camera.E.clone(), K=params.camera.K.clone()))
        self.cfg, self.n, self.steps = cfg, n_envs, chunk_steps
        self.model = model
        self.unit = 1 if model is not None else cfg.skip_steps
        self.graph = graph
        # CTETerminationWrapper(max_cte=collect_max_cte, number_of_steps=1)
        # (tinycarlo_tpu/train/il.py:255-267): a diverged car auto-resets
        self.stack = WrapperStack(termination_fns=(partial(
            cte_termination, max_cte=cfg.collect_max_cte,
            number_of_steps=1),))
        dtype = params.camera.E.dtype
        z = lambda *s, d=dtype: torch.zeros(s, dtype=d, device=dev)  # noqa
        self.maneuver = z(n_envs, d=torch.int32)
        self.noise = z(n_envs, cfg.action_dim)
        self.cte, self.heading_error = z(n_envs), z(n_envs)
        obs_shape = fenv.observation_shape(params)
        self.out = {
            "obs": z(chunk_steps, n_envs, *obs_shape, d=torch.uint8),
            "steering": z(chunk_steps, n_envs),
            "position": z(chunk_steps, n_envs, 2),
            "done": z(chunk_steps, n_envs, d=torch.bool),
        }
        self.keep = torch.tensor(
            [(i + 1) % cfg.skip_steps == 0 for i in range(chunk_steps)],
            device=dev)
        self.t = torch.zeros(1, dtype=torch.long, device=dev)
        self.vstate: Optional[vector.VecState] = None
        self.draws: Optional[Dict[str, torch.Tensor]] = None
        self.kernels = fenv.render_kernels(params)
        self.step_graphs = graphs.StepGraphs(dev)

    @property
    def stats(self) -> Dict[str, int]:
        """Units run eagerly (a render each), captures and unit replays."""
        s = self.step_graphs
        return {"renders": s.eager, "captures": s.captures,
                "replays": s.replays}

    def _begin(self, maneuver, generator, draws) -> None:
        """A chunk's start, in place: the camera, reset states and infos,
        zero noise, the maneuvers and the step index."""
        p, dev = self.params, self.params.device
        if self.cfg.camera_dr:
            if draws is not None:
                pitch, fov = int(draws["pitch"]), int(draws["fov"])
            else:
                pitch, fov = camera_draw(generator, dev)
            mats = camera_matrices(p, pitch, fov)
            p.camera.E.copy_(mats.E)
            p.camera.K.copy_(mats.K)
        rows = (draws["reset"].to(dev) if draws is not None
                else torch.randint(p.map_data.spawns.count, (self.n,),
                                   generator=generator, device=dev))
        fresh, _ = vector.reset(p, self.n, stack=self.stack, render=False,
                                spawn_rows=rows)
        if self.vstate is None:
            self.vstate = replace(fresh, generator=generator)
            graphs.check_distinct(graphs.tensors(self.vstate), "collection")
        else:
            graphs.copy_into(self.vstate, fresh)
            self.vstate.generator = generator
        info = fenv._info(p, self.vstate.env)
        m = torch.as_tensor(maneuver, device=dev).to(torch.int32)
        with torch.no_grad():
            self.cte.copy_(info["cte"])
            self.heading_error.copy_(info["heading_error"])
            self.noise.zero_()
            self.maneuver.copy_(m.expand(self.n))
            self.t.zero_()
        if draws is not None:
            inject = {k: draws[k] for k in ("ou", "respawn") if k in draws}
            if self.draws is None:
                self.draws = {k: v.to(dev).clone() for k, v in inject.items()}
            else:
                for k, v in inject.items():
                    self.draws[k].copy_(v)

    def _step(self, render: bool) -> None:
        """One collection step (tinycarlo_tpu/train/il.py:275-312, or
        DAgger's :371-398), in place; writes row t of the outputs."""
        cfg, p, vs = self.cfg, self.params, self.vstate
        dev = p.device
        env_dtype = p.camera.E.dtype
        draw = None
        if self.draws is not None:
            draw = {k: v.index_select(0, self.t)[0]
                    for k, v in self.draws.items()}
        steering = stanley_steering(self.cte, self.heading_error, cfg.speed,
                                    cfg.k, p.cfg.car.max_steering_angle)
        obs = fenv.render_observation_batch(p, vs.env) if render else None
        if self.model is None:
            eps = draw["ou"] if draw is not None else torch.randn(
                self.noise.shape, generator=vs.generator, dtype=env_dtype,
                device=dev)
            noise = (self.noise + cfg.noise_theta * (0.0 - self.noise)
                     + cfg.noise_sigma * eps)
            steer = steering + noise[:, 0]
        else:
            noise = None
            dtype = next(self.model.parameters()).dtype
            with torch.no_grad():
                act = self.model(pre_obs(obs).to(dtype), one_hot(
                    self.maneuver, cfg.maneuver_dim, dtype))
            steer = torch.clamp(act[:, 0], -1.0, 1.0)
        action = {
            "car_control": torch.stack(
                [torch.full((self.n,), cfg.speed, dtype=env_dtype,
                            device=dev), steer.to(env_dtype)], dim=-1),
            "maneuver": torch.where(self.maneuver != 2, self.maneuver, 3),
        }
        new, _, _, term, trunc, info = vector.step(
            p, vs, action, stack=self.stack, render=False,
            respawn_rows=None if draw is None else draw["respawn"])
        with torch.no_grad():
            graphs.copy_into(vs, new)
            self.cte.copy_(info["cte"])
            self.heading_error.copy_(info["heading_error"])
            if noise is not None:
                self.noise.copy_(noise)
            row = {"steering": steering, "position": vs.env.car.position,
                   "done": term | trunc}
            if render:
                row["obs"] = obs
            for k, v in row.items():
                self.out[k].index_copy_(0, self.t, v[None])
            self.t.add_(1)

    def _unit(self) -> None:
        for j in range(self.unit):
            self._step(render=j == self.unit - 1)

    def chunk(self, maneuver, generator: Optional[torch.Generator] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None,
              trace: bool = False) -> Dict[str, torch.Tensor]:
        """One chunk at `maneuver` (an int or (B,) ints, MODEL space: 2 is
        left and goes to the env as 3), drawing from `generator` (on the
        params' device). Returns obs (T, B, ...) uint8 (zeros on the steps
        not sampled, except in DAgger chunks), steering (T, B) expert
        labels and keep (T,) -- plus, with `trace`, position (T, B, 2) and
        done (T, B) after each step. `draws` (tests) injects "pitch",
        "fov" (ints), "reset" (B,) spawn rows, "respawn" (T, B) rows and,
        for the expert, "ou" (T, B, A) normals."""
        self._begin(maneuver, generator, draws)
        n_units, rest = divmod(self.steps, self.unit)
        if self.model is not None:
            self.model.eval()
        for _ in range(n_units):
            self.step_graphs.run((draws is not None, id(generator)),
                                 self._unit, self.graph, self.kernels,
                                 (generator,))
        for _ in range(rest):  # steps past the last unit render nothing
            self._step(render=False)
        out = {k: self.out[k].clone() for k in ("obs", "steering")}
        out["keep"] = self.keep.clone()
        if trace:
            out.update({k: self.out[k].clone() for k in ("position", "done")})
        return out


def collect_chunk(params: fenv.EnvParams, cfg: ILConfig,
                  generator: Optional[torch.Generator], n_envs: int,
                  chunk_steps: int, maneuver,
                  draws: Optional[Dict[str, torch.Tensor]] = None,
                  graph: bool = True, trace: bool = False):
    """One expert collection chunk (tinycarlo_tpu/train/il.py:228-322):
    randomized camera, Stanley expert with OU noise, a render every
    `skip_steps` steps, the CTE auto-reset. Returns `Collector.chunk`'s
    dict. A `Collector` keeps its graphs across chunks; this builds a new
    one."""
    return Collector(params, cfg, n_envs, chunk_steps, graph=graph).chunk(
        maneuver, generator, draws, trace)


def collect_chunk_dagger(params: fenv.EnvParams, cfg: ILConfig,
                         generator: Optional[torch.Generator], n_envs: int,
                         chunk_steps: int, maneuver,
                         model: torch.nn.Module,
                         draws: Optional[Dict[str, torch.Tensor]] = None,
                         graph: bool = True, trace: bool = False):
    """One DAgger chunk (tinycarlo_tpu/train/il.py:325-404): the car follows
    `model` (eval mode, a render every step, the steering clipped to
    [-1, 1]) while the label stays the Stanley expert's; every
    `skip_steps`-th frame is kept. Returns `Collector.chunk`'s dict."""
    return Collector(params, cfg, n_envs, chunk_steps, model=model,
                     graph=graph).chunk(maneuver, generator, draws, trace)


def _generator(generator, device) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def _dataset(collector: Collector, generator, n_samples: int,
             maneuver_cycle, stats):
    """The host loop over chunks (tinycarlo_tpu/train/il.py:431-453)."""
    g = _generator(generator, collector.params.device)
    xs, ms, ys = [], [], []
    total = 0
    chunk_i = 0
    while total < n_samples:
        m_id = int(maneuver_cycle[chunk_i % len(maneuver_cycle)])
        traj = collector.chunk(m_id, g)
        keep = traj["keep"]
        obs = traj["obs"][keep]
        obs = obs.reshape(-1, *obs.shape[2:]).cpu().numpy()
        steer = traj["steering"][keep].reshape(-1).cpu().numpy()
        n = obs.shape[0]
        xs.append(obs)
        ms.append(np.full(n, m_id, np.float32))
        ys.append(steer[:, None].astype(np.float32))
        total += n
        chunk_i += 1
    if stats is not None:
        for k, v in collector.stats.items():
            stats[k] = stats.get(k, 0) + v
    X = np.concatenate(xs)[:n_samples]
    M = np.concatenate(ms)[:n_samples]
    Y = np.concatenate(ys)[:n_samples]
    return X, M, Y


def collect_dataset_dagger(params: fenv.EnvParams, cfg: ILConfig,
                           generator, n_samples: int,
                           model: torch.nn.Module, n_envs: int = 16,
                           chunk_steps: int = 128,
                           maneuver_cycle=(0, 1, 2), graph: bool = True,
                           stats: Optional[Dict[str, int]] = None):
    """`collect_dataset` over DAgger chunks: (X, M, Y) where X are states
    the current net reaches and Y the expert's steering there
    (tinycarlo_tpu/train/il.py:407-453)."""
    collector = Collector(params, cfg, n_envs, chunk_steps, model=model,
                          graph=graph)
    return _dataset(collector, generator, n_samples, maneuver_cycle, stats)


def collect_dataset(params: fenv.EnvParams, cfg: ILConfig, generator,
                    n_samples: int, n_envs: int = 16, chunk_steps: int = 128,
                    maneuver_cycle=(0, 1, 2), graph: bool = True,
                    stats: Optional[Dict[str, int]] = None):
    """(X, M, Y) numpy arrays of `n_samples` expert samples -- uint8 frames,
    float32 maneuvers (N,), float32 labels (N, 1) -- from batched chunks
    whose maneuver cycles `maneuver_cycle` per chunk (0, 1, 2 like the
    reference's per-episode cycle, train_stanley_il.py:104-107; (0, 1, 2,
    2) oversamples the rare left turns). `generator` is a torch.Generator
    on the params' device or an int seed. `stats` gains the collector's
    counts (renders, captures, replays)."""
    collector = Collector(params, cfg, n_envs, chunk_steps, graph=graph)
    return _dataset(collector, generator, n_samples, maneuver_cycle, stats)
