"""Real-world backend contract + the glue between a tracked pose and the
port's batched state.

Counterpart of tinycarlo_tpu/real_world/base.py (reference:
tinycarlo/real_world/env.py:11-27, contract in real_world/README.md:5-9).
A hardware backend provides two things:

  * a `RealWorldCar`: send drive commands, report the tracked pose;
  * a `RealWorldCamera`: deliver observation frames (or None to fall back
    to the simulated camera rendered at the tracked pose -- the digital
    twin view).

`pose_step` puts an externally tracked pose into a one-env (B = 1)
`EnvState` and re-runs the map-relative machinery (position_front, the
local-path walk) as the simulated step would (reference
AutosysCar.step's find_local_path call, env_autosys.py:133);
`snap_to_lanepath` mirrors `Map.sample_nearest_edge` (map.py:71-84, a
90-degree margin). `pose_step` and `pose_reset` are functional: they
return a new state and leave the given one as it was, so the twin copies
their result into its own tensors and the guidance of `make_guidance`
never touches them. A pose may be numbers, numpy arrays or tensors on the
state's device (a captured step passes tensors).
"""
from __future__ import annotations

from dataclasses import fields, replace
from typing import Optional, Tuple

import numpy as np
import torch

from tinycarlo_torch import car as car_mod
from tinycarlo_torch import env as fenv
from tinycarlo_torch import geometry as geo
from tinycarlo_torch.utils.helper import numpy_dtype


class RealWorldCar:
    """Hardware car interface. Subclass and implement the three methods."""

    def connect(self) -> None:
        """Open hardware connections; called once by the env."""

    def drive(self, velocity: float, steering: float, maneuver: int) -> None:
        """Send normalized [-1,1] commands (maneuver may drive blinkers)."""
        raise NotImplementedError

    def pose(self) -> Tuple[np.ndarray, float, float]:
        """Latest tracked (position_m (2,), rotation_rad, velocity_mps)."""
        raise NotImplementedError

    def stop(self) -> None:
        """Emergency/shutdown stop."""

    def reposition(self, target_position, target_rotation, guidance=None) -> None:
        """Optional automatic recovery toward a lanepath pose (the
        reference's history-replay / Stanley drive-back,
        env_autosys.py:135-178).

        `guidance`, when provided by the env, is the digital twin's map
        feedback for the drive-back controller:
        ``guidance(position, rotation, maneuver) -> (cte, heading_error,
        truncated, target_position, target_rotation)`` -- cte/heading
        relative to the lanepath edge nearest the given pose (the
        reference's get_info stream inside its reset loop,
        env_autosys.py:161-164), `truncated` whether the local-path walk
        dead-ends for that maneuver (the maneuver-retry signal,
        env_autosys.py:156-160), and the re-snapped target pose
        (env_autosys.py:167). Backends that only replay history may
        ignore it."""


class RealWorldCamera:
    """Hardware camera interface."""

    def connect(self) -> None:
        pass

    def capture(self) -> Optional[np.ndarray]:
        """An observation frame in the env's observation layout, or None
        to use the simulated camera at the tracked pose."""
        return None


def _like(value, like: torch.Tensor) -> torch.Tensor:
    """A pose value as a tensor of `like`'s dtype, device and shape."""
    return torch.as_tensor(value, dtype=like.dtype,
                           device=like.device).reshape(like.shape)


def snap_to_lanepath(params: fenv.EnvParams, position, rotation):
    """Nearest lanepath edge within +/-90 degrees of `rotation`, or edge 0
    when none is; returns (target_position, target_rotation, edge) on the
    host. Reference: map.py:71-84; tinycarlo_tpu/real_world/base.py:
    94-106. The position enters in float64 and the rotation in the map's
    dtype, the promotions of the JAX package's float64 mode."""
    lp = params.map_data.lanepath
    dev = lp.nodes.device
    idx = geo.nearest_edge_with_orientation_idx(
        lp.nodes, lp.edges, lp.edge_mask,
        torch.as_tensor(np.asarray(position, np.float64), device=dev),
        torch.as_tensor(float(rotation), dtype=lp.nodes.dtype, device=dev),
        margin_deg=90.0,
    )
    edge = lp.edges[torch.clamp_min(idx, 0)]
    target = lp.nodes[edge[1]]
    target_rot = geo.edge_orientations(lp.nodes, edge)
    host = torch.cat([target.double(), target_rot.double()[None],
                      edge.double()]).cpu().numpy()
    return (host[:2].astype(numpy_dtype(target.dtype)), float(host[2]),
            host[3:].astype(np.int32))


def pose_step(
    params: fenv.EnvParams,
    state: fenv.EnvState,
    position,
    rotation,
    velocity,
    maneuver,
):
    """The car's pose from tracking, position_front refreshed, and the
    maneuver-conditioned local-path walk. Returns (state, truncated (1,))
    (tinycarlo_tpu/real_world/base.py:109-130)."""
    car = state.car
    car = replace(
        car,
        position=_like(position, car.position),
        rotation=_like(rotation, car.rotation),
        velocity=_like(velocity, car.velocity),
    )
    car = car_mod.update_position_front(car, params.cfg.car)
    car, truncated = car_mod.find_local_path(
        params.map_data, car, _like(maneuver, car.last_maneuver)
    )
    return replace(state, car=car), truncated


def _reset_on_edge(params: fenv.EnvParams, state: fenv.EnvState, position,
                   rotation, edge) -> fenv.EnvState:
    """The state at the tracked pose with its local path the lanepath
    `edge`, at rest (every field a tensor of its own)."""
    car = state.car
    car = car_mod.CarState(
        position=_like(position, car.position),
        position_front=torch.empty_like(car.position_front),
        rotation=_like(rotation, car.rotation),
        steering_angle=torch.zeros_like(car.steering_angle),
        radius=torch.zeros_like(car.radius),
        velocity=torch.zeros_like(car.velocity),
        local_path=torch.as_tensor(edge, dtype=torch.int32,
                                   device=car.local_path.device)
        .expand(car.local_path.shape).contiguous(),
        local_path_len=torch.ones_like(car.local_path_len),
        last_maneuver=torch.zeros_like(car.last_maneuver),
    )
    return replace(state,
                   car=car_mod.update_position_front(car, params.cfg.car))


def pose_reset(params: fenv.EnvParams, state: fenv.EnvState, position,
               rotation) -> fenv.EnvState:
    """The state reset onto the nearest lanepath edge at the tracked pose
    (reference AutosysCar.reset tail, env_autosys.py:170-178;
    tinycarlo_tpu/real_world/base.py:164-180): the edge fills the local
    path, velocity, steering and radius are zero."""
    _, _, edge = snap_to_lanepath(params, position, rotation)
    return _reset_on_edge(params, state, position, rotation, edge)


def make_guidance(params: fenv.EnvParams, state: fenv.EnvState):
    """The digital twin's map-feedback callback for
    `RealWorldCar.reposition` (see its docstring for the contract).

    Each call snaps the pose onto the nearest lanepath edge (pose_reset),
    runs the maneuver-conditioned local-path walk at rest (pose_step), and
    reads cte / heading_error from the info path the simulator uses -- the
    reference's reset-loop get_info + sample_nearest_edge stream
    (env_autosys.py:154-167; tinycarlo_tpu/real_world/base.py:133-161).
    It works on a clone of `state` taken now, so a drive-back leaves the
    caller's state as it was."""
    snapshot = replace(state, car=car_mod.CarState(**{
        f.name: getattr(state.car, f.name).clone()
        for f in fields(state.car)}))

    def guidance(position, rotation, maneuver):
        target, target_rot, edge = snap_to_lanepath(params, position,
                                                     rotation)
        st = _reset_on_edge(params, snapshot, position, rotation, edge)
        st, truncated = pose_step(params, st, position, rotation, 0.0,
                                  maneuver)
        info = fenv._info(params, st)
        host = torch.stack([info["cte"][0].double(),
                            info["heading_error"][0].double(),
                            truncated[0].double()]).cpu().numpy()
        return (float(host[0]), float(host[1]), bool(host[2]), target,
                target_rot)

    return guidance
