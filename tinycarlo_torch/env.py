"""Functional environment core, batched: reset/step over dataclasses.

Counterpart of tinycarlo_tpu/env.py (reference: tinycarlo/env.py). The
JAX package writes a single-env step and vmaps it; here every function
takes a batch of B environments with the batch axis out front:

    reset(params, n_envs)        -> (state, obs, info)
    step(params, state, action)  -> (state, obs, reward, terminated,
                                     truncated, info)

Observations follow `sim.observation_space_format` (shapes in
`observation_shape`): "classes" masks (B, L, H, W) uint8 0/255 (or float32
or bfloat16 0/1 with `out_dtype`) from the masks kernel, or the rank
kernel's (B, H, W) layer-rank map -- "rank" itself, or decoded to "rgb"
(B, H, W, 3) and "rgb_planar" (B, 3, H, W) uint8. Both kernels read the
compaction of the packed camera projection. With `camera.stroke: exact`
at line_thickness >= 2 every format renders through the exact kernel's
cv2 ThickLine masks instead, decoded for rank, rgb and rgb_planar.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple, Union

import torch

from tinycarlo_torch import camera as cam
from tinycarlo_torch import car as car_mod
from tinycarlo_torch.config import EnvConfig, load_config
from tinycarlo_torch.map_compiler import MapData, compile_map
from tinycarlo_torch.ops import car_kernel as ck
from tinycarlo_torch.ops import rasterize as ras
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.utils import profiling
from tinycarlo_torch.utils.helper import resolve_device


@dataclass
class EnvParams:
    """Compiled map + camera matrices on the device, and the static config."""

    map_data: MapData
    camera: cam.CameraMatrices
    cfg: EnvConfig = None

    @property
    def device(self) -> torch.device:
        return self.camera.E.device


@dataclass
class EnvState:
    """Batched env state. The JAX package also carries a per-env PRNG key
    here; the port draws respawns from a torch.Generator held by
    vector.VecState instead."""

    car: car_mod.CarState


def make_env_params(
    config: Union[str, Dict[str, Any], EnvConfig],
    dtype: torch.dtype = torch.float32,
    base_path: Optional[str] = None,
    device="cuda",
) -> EnvParams:
    """Compile a reference-schema config (dict / yaml path / EnvConfig) into
    EnvParams on `device` (default "cuda"; raises without a GPU). Mirrors
    tinycarlo_tpu.env.make_env_params."""
    device = resolve_device(device)
    if isinstance(config, EnvConfig):
        cfg, config_path = config, base_path
    else:
        cfg, config_path = load_config(config)
        config_path = config_path or base_path
    map_data = compile_map(cfg.map, base_path=config_path, dtype=dtype,
                           device=device)
    matrices = cam.build_camera_matrices(cfg.camera, dtype=dtype, device=device)
    return EnvParams(map_data=map_data, camera=matrices, cfg=cfg)


FORMATS = ("classes", "rgb", "rgb_planar", "rank")


def observation_shape(params: EnvParams) -> Tuple[int, ...]:
    """One env's observation shape in the configured format. Reference
    env.py:68-73 for rgb / classes; tinycarlo_tpu.env.observation_shape
    for the extensions rgb_planar (channel-planar rgb) and rank (the
    paint-order layer map, one byte per pixel)."""
    h, w = params.cfg.camera.resolution
    fmt = _check_format(params, None)
    if fmt == "rgb":
        return (h, w, 3)
    if fmt == "rgb_planar":
        return (3, h, w)
    if fmt == "rank":
        return (h, w)
    return (params.map_data.n_layers, h, w)


def _check_format(params: EnvParams, fmt: Optional[str]) -> str:
    fmt = fmt or params.cfg.sim.observation_space_format
    if fmt not in FORMATS:
        raise ValueError(
            f"observation_space_format {fmt!r} is not one of {FORMATS}"
        )
    return fmt


def _project_packed_batch_soa(params: EnvParams, states: EnvState,
                              edges: Optional[torch.Tensor] = None,
                              edge_mask: Optional[torch.Tensor] = None):
    """Project the packed edge axis for a batch of states: (B, Ep)
    u0/v0/u1/v1 pixel coords + (B, Ep) draw mask. `edges` (1, E, 2) and
    `edge_mask` (1, E) project a slice of the packed axis instead (the
    segment-parallel renderer's shard); the projection is per edge, so a
    slice's values are the full axis's."""
    cfg = params.cfg
    md = params.map_data
    if edges is None:
        edges, edge_mask = md.packed_edges, md.packed_edge_mask
    u0, v0, u1, v1, draw = cam.project_layers_batch_soa(
        md.packed_nodes, edges, edge_mask, _camera_pose(params, states),
        params.camera.K, tuple(cfg.camera.resolution), cfg.camera.max_range,
    )  # (B, 1, Ep) each
    return u0[:, 0], v0[:, 0], u1[:, 0], v1[:, 0], draw[:, 0]


def _camera_pose(params: EnvParams, states: EnvState) -> torch.Tensor:
    """(B, 3, 4) camera poses E @ world->car of a batch (camera.py:61)."""
    body = cam.car_world_to_body_matrix(
        states.car.position, states.car.rotation
    )
    return torch.matmul(params.camera.E, body)


def _project_packed_batch(params: EnvParams, states: EnvState):
    """Stacked-point view of `_project_packed_batch_soa`: (B, Ep, 2) x2
    endpoints + (B, Ep) draw mask (tinycarlo_tpu/env.py:213-221)."""
    u0, v0, u1, v1, draw = _project_packed_batch_soa(params, states)
    return torch.stack([u0, v0], dim=-1), torch.stack([u1, v1], dim=-1), draw


def check_segment_overflow(params: EnvParams, states: EnvState) -> torch.Tensor:
    """Per-env count of rasterizer slot copies dropped by the
    `CameraConfig.max_visible_segments` budget at the current states. The
    reference draws unbounded segment lists and never drops; nonzero means
    observation pixels would be lost -- raise the budget until it is 0."""
    cfg = params.cfg
    u0, v0, u1, v1, draw = _project_packed_batch_soa(params, states)
    budget = cfg.camera.max_visible_segments
    if budget is None:  # no budget: every copy gets a slot
        budget = draw.shape[-1]
    return rk.segment_overflow(
        torch.stack([u0, v0], dim=-1), torch.stack([u1, v1], dim=-1), draw,
        tuple(cfg.camera.resolution), cfg.camera.line_thickness, budget,
        stroke=cfg.camera.stroke,
    )


def render_observation_batch(
    params: EnvParams,
    states: EnvState,
    fmt: Optional[str] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Observations of a batch of states in format `fmt` (default: the
    config's): packed projection and compaction (one front kernel on the
    card, `rasterize_kernels.front_bundle`), then the masks kernel
    (classes) or the rank kernel and its decode (rank, rgb, rgb_planar).
    With the exact stroke at t >= 2 every format starts from the exact
    kernel's masks, as the JAX package's does (env.py:270-319): classes
    returns them, rank, rgb and rgb_planar decode them.
    tinycarlo_tpu.env.render_observation_batch (env.py:245-319).

    `out_dtype=None` keeps the observation contract (uint8); float32 or
    bfloat16 gives 0/1 class masks straight from the masks (or exact)
    kernel for in-graph consumers such as the TD3 trainer's encoder feed
    (tinycarlo_tpu/env.py:256-266), and is only defined for classes.
    Traced as the device span "render" (utils/profiling.py)."""
    fmt = _check_format(params, fmt)
    if out_dtype is not None and fmt != "classes":
        raise ValueError("float out_dtype is only defined for classes masks")
    with profiling.device_span("render", states.car.position.device):
        return _render(params, states, fmt, out_dtype)


def _render(params: EnvParams, states: EnvState, fmt: str,
            out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    cfg = params.cfg
    md = params.map_data
    res = tuple(cfg.camera.resolution)
    t = cfg.camera.line_thickness
    if ras._exact(t, cfg.camera.stroke):
        u0, v0, u1, v1, draw = _project_packed_batch_soa(params, states)
        masks = rk.rasterize_masks_packed_soa(
            u0, v0, u1, v1, draw, md.packed_edge_layer, md.n_layers, res, t,
            max_visible=cfg.camera.max_visible_segments,
            layer_bounds=md.packed_layer_bounds,
            out_dtype=torch.uint8 if out_dtype is None else out_dtype,
            stroke=cfg.camera.stroke,
        )
        if fmt == "classes":
            return masks
        # the rank kernel stamps the fast stroke only (env.py:274-275):
        # decode the exact masks (:308-319)
        if fmt == "rgb_planar":
            return ras.rasterize_rgb_planar(masks, md.laneline_colors)
        rank = ras.rank_from_masks(masks)
        return rank if fmt == "rank" else ras.rgb_from_rank(
            rank, md.laneline_colors)
    # the fast stroke: the front kernel's bundle (projection and
    # compaction in one launch on the card), then the masks kernel for
    # classes, or for rank / rgb / rgb_planar (env.py:270-297) the rank
    # kernel's layer map, which the palette composite reads
    bundle = rk.front_bundle(
        md.packed_nodes, md.packed_edges, md.packed_edge_mask,
        md.packed_edge_layer, _camera_pose(params, states), params.camera.K,
        md.n_layers, res, t, cfg.camera.max_range,
        max_visible=cfg.camera.max_visible_segments,
        layer_bounds=md.packed_layer_bounds,
    )
    if fmt == "classes":
        return rk.masks_kernel(
            bundle, md.n_layers, res, t,
            out_dtype=torch.uint8 if out_dtype is None else out_dtype,
        )
    rank = rk.rank_kernel(bundle, md.n_layers, res, t)
    if fmt == "rank":
        return rank
    if fmt == "rgb_planar":
        return ras.rgb_planar_from_rank(rank, md.laneline_colors)
    return ras.rgb_from_rank(rank, md.laneline_colors)


def render_kernel(params: EnvParams):
    """The kernel `render_observation_batch` launches for the config's
    format: the exact kernel under `camera.stroke: exact` at t >= 2, else
    the masks kernel for classes and the rank kernel for rank, rgb and
    rgb_planar."""
    camera = params.cfg.camera
    if ras._exact(camera.line_thickness, camera.stroke):
        return rk.exact_kernel
    if params.cfg.sim.observation_space_format == "classes":
        return rk.masks_kernel
    return rk.rank_kernel


def render_kernels(params: EnvParams):
    """The kernel wrappers a render of the config's format launches on the
    card, once each: the front kernel, then `render_kernel`'s, under the
    fast stroke; the exact kernel alone under the exact stroke."""
    kernel = render_kernel(params)
    if kernel is rk.exact_kernel:
        return (kernel,)
    return (rk.front_kernel, kernel)


def render_observation(
    params: EnvParams, state: EnvState, fmt: Optional[str] = None
) -> torch.Tensor:
    """The observation of a one-env state, without the batch axis:
    `render_observation_batch` of the (1, ...) state, squeezed.
    tinycarlo_tpu/env.py:141-186, without its CPU-only retry at a small
    slot budget (:166-183), whose frames equal the full budget's."""
    if state.car.position.shape[0] != 1:
        raise ValueError("render_observation takes a one-env state; use "
                         "render_observation_batch for a batch")
    return render_observation_batch(params, state, fmt=fmt)[0]


def _info(params: EnvParams, state: EnvState) -> Dict[str, torch.Tensor]:
    """Reference info dict (env.py:83-85), batched."""
    info = car_mod.car_info(params.map_data, params.cfg.car, state.car)
    info["position"] = state.car.position
    info["orientation"] = state.car.rotation
    return info


def default_reward(params: EnvParams, cte: torch.Tensor) -> torch.Tensor:
    """Linear shaping on the signed cte (reference env.py:87-93, whose
    negative cte yields reward > 1 -- replicated as-is)."""
    tw = params.cfg.car.track_width
    return torch.clamp_min((-1.0 / tw) * cte + 1.0, 0.0)


def default_termination(params: EnvParams, cte: torch.Tensor) -> torch.Tensor:
    """Reference env.py:95-99 (signed comparison, also as-is)."""
    return cte > params.cfg.car.track_width * 10


def shaping(params: EnvParams, cte: torch.Tensor, truncated: torch.Tensor,
            wrapped: bool = False):
    """(reward, terminated) of a step: the default shaping, or zeros when
    `wrapped` (reference env.py:136-138)."""
    if wrapped:
        return torch.zeros_like(cte), torch.zeros_like(truncated)
    return default_reward(params, cte), default_termination(params, cte)


def reset(
    params: EnvParams,
    n_envs: int,
    spawn_row: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    render: bool = True,
):
    """Spawn `n_envs` cars at uniformly drawn (or the given (B,)) spawn-table
    rows. Reference: env.py:101-113 / car.py:34-44 / map.py:51-69. Returns
    (state, obs or None when render=False, info)."""
    md = params.map_data
    if spawn_row is None:
        spawn_row = torch.randint(
            md.spawns.count, (n_envs,), generator=generator,
            device=params.device,
        )
    state = EnvState(car=car_mod.car_reset(md, params.cfg.car, spawn_row))
    obs = render_observation_batch(params, state) if render else None
    return state, obs, _info(params, state)


def step(
    params: EnvParams,
    state: EnvState,
    action: Dict[str, torch.Tensor],
    render: bool = True,
    wrapped: bool = False,
):
    """One step of every env. Reference: env.py:115-146.

    `action` = {"car_control": (B, 2) in [-1, 1], "maneuver": (B,) int}.
    `wrapped=True` disables the default reward/termination, as the
    reference's wrapper flag does (env.py:136-138). Returns (state, obs or
    None when render=False, reward, terminated, truncated, info). The
    per-car work (action clamp, car step, car_info, shaping) is one launch
    of the car kernel on the card (`_car_work`), then the render.
    """
    car_state, truncated, info, reward, terminated = _car_work(
        params, state.car, action, wrapped)
    state = replace(state, car=car_state)
    obs = render_observation_batch(params, state) if render else None
    info["position"] = car_state.position
    info["orientation"] = car_state.rotation
    return state, obs, reward, terminated, truncated, info


def _car_work(params: EnvParams, car: car_mod.CarState,
              action: Dict[str, torch.Tensor], wrapped: bool):
    """A step's per-car work: (car state, truncated, info without
    "position" and "orientation", reward, terminated). One launch of the
    car kernel (ops/csrc/car.cu) where it applies (`ck.applies`:
    CUDA float32 and no LanelineGrid), its envs counted in the host counter
    "car.kernel"; elsewhere its plain version, `_car_work_plain`."""
    md = params.map_data
    if ck.applies(md, car, action["car_control"]):
        out = ck.car_kernel(md, params.cfg.car, params.cfg.sim.T, car,
                            action["car_control"], action["maneuver"],
                            wrapped)
        profiling.count("car.kernel", car.position.shape[0])
        return out
    return _car_work_plain(params, car, action, wrapped)


def _car_work_plain(params: EnvParams, car: car_mod.CarState,
                    action: Dict[str, torch.Tensor], wrapped: bool):
    """`_car_work` as torch ops: the action clamp, `car.car_step`,
    `car.car_info` and `shaping` (reference env.py:118-138)."""
    control = torch.clamp(action["car_control"], -1.0, 1.0)  # env.py:118
    car_state, truncated = car_mod.car_step(
        params.map_data, params.cfg.car, params.cfg.sim.T, car,
        control[:, 0], control[:, 1], action["maneuver"],
    )
    info = car_mod.car_info(params.map_data, params.cfg.car, car_state)
    reward, terminated = shaping(params, info["cte"], truncated, wrapped)
    return car_state, truncated, info, reward, terminated
