"""Gymnasium env bridging the port's simulation to real hardware: the
digital twin.

Counterpart of tinycarlo_tpu/real_world/env.py; registered as
`"tinycarlo-torch-realworld-v2"` by `import tinycarlo_torch` when
gymnasium imports (the JAX package holds "tinycarlo-realworld-v2";
reference: tinycarlo/__init__.py:4). Backends resolve like the
reference's (real_world/env.py:11-27): `sim.real_world_env: <name>` in
the config selects `tinycarlo_torch.real_world.environments.env_<name>`,
whose RealWorldCar / RealWorldCamera subclasses are found by reflection;
`register_backend` registers others by name.

Each step sends the commands to the hardware car, reads its tracked pose
and computes the info, reward and termination from the map exactly as
the simulator does. The observation is the hardware camera's frame, or
else the simulated camera rendered at the tracked pose (the rank kernel
on rgb configs, the masks kernel on classes ones).

Device: `device="cuda"` by default, raising without a GPU; `device="cpu"`
runs the plain PyTorch path. On the card a step's device work -- the pose
copied in from a pinned buffer, position_front, the local-path walk, the
info, the shaping and the render -- is ONE CUDA graph per (render,
wrapped) mode, captured at the mode's first step over the shim's state
tensors and replayed, with ONE copy of the outputs back, through the
shim's machinery (`TinyCarloEnv._fused_step`); eagerly on the CPU and
under DEBUG=1 / DEBUG=2. Reset, the drive-back guidance and the pose
written at reset run eagerly: they are host-bound by the hardware.
"""
from __future__ import annotations

import importlib
import inspect
import os
import time
from typing import Any, Dict, Optional, Tuple, Type, Union

import numpy as np
import torch

from tinycarlo_torch import car as car_mod
from tinycarlo_torch import env as fenv
from tinycarlo_torch.gym_env import TinyCarloEnv, _pack
from tinycarlo_torch.real_world.base import (
    RealWorldCamera,
    RealWorldCar,
    make_guidance,
    pose_reset,
    pose_step,
    snap_to_lanepath,
)
from tinycarlo_torch.utils.gym_compat import Env
from tinycarlo_torch.utils.helper import getenv

_REGISTRY: Dict[str, Tuple[Type[RealWorldCar], Type[RealWorldCamera]]] = {}


def register_backend(
    name: str, car_cls: Type[RealWorldCar], camera_cls: Type[RealWorldCamera]
) -> None:
    _REGISTRY[name.lower()] = (car_cls, camera_cls)


def _resolve(name: str):
    name = name.lower()
    if name in _REGISTRY:
        return _REGISTRY[name]
    module = importlib.import_module(
        f"tinycarlo_torch.real_world.environments.env_{name}"
    )
    classes = [c for _, c in inspect.getmembers(module, inspect.isclass)]
    cars = [c for c in classes
            if issubclass(c, RealWorldCar) and c is not RealWorldCar]
    cams = [c for c in classes
            if issubclass(c, RealWorldCamera) and c is not RealWorldCamera]
    if not cars or not cams:
        raise ValueError(
            f"backend env_{name} must define RealWorldCar and "
            f"RealWorldCamera subclasses"
        )
    return cars[0], cams[0]


class TinyCarloRealWorldEnv(TinyCarloEnv):
    """Digital-twin env: simulated map/rewards around a hardware car.
    tinycarlo_tpu/real_world/env.py:71-181."""

    def __init__(
        self,
        render_mode: Optional[str] = None,
        config: Optional[Union[str, Dict[str, Any]]] = None,
        dtype: torch.dtype = torch.float32,
        backend: Optional[Tuple[RealWorldCar, RealWorldCamera]] = None,
        device="cuda",
    ):
        self._hw_car: Optional[RealWorldCar] = None
        self._hw_camera: Optional[RealWorldCamera] = None
        self._backend_override = backend
        # the tracked pose a step reads: (x, y, rotation, velocity,
        # maneuver) in float64, staged in pinned memory on the card
        self._pose: Optional[torch.Tensor] = None
        self._pose_host: Optional[torch.Tensor] = None
        super().__init__(render_mode=render_mode, config=config, dtype=dtype,
                         device=device)

    # the base __init__ calls reset(); the hardware connects there
    def _ensure_backend(self) -> None:
        if self._hw_car is not None:
            return
        if self._backend_override is not None:
            self._hw_car, self._hw_camera = self._backend_override
        else:
            name = self.params.cfg.sim.real_world_env
            if name is None:
                raise ValueError(
                    "sim.real_world_env missing from config; use the normal "
                    "tinycarlo-torch-v2 env instead"
                )
            car_cls, cam_cls = _resolve(name)
            self._hw_car, self._hw_camera = car_cls(), cam_cls()
        self._hw_car.connect()
        self._hw_camera.connect()

    def _capture_frame(self) -> Optional[np.ndarray]:
        frame = self._hw_camera.capture() if self._hw_camera else None
        return None if frame is None else np.asarray(frame, np.uint8)

    def _get_obs(self) -> np.ndarray:
        frame = self._capture_frame()
        if frame is not None:
            return frame
        return super()._get_obs()  # digital-twin view at the tracked pose

    def _stage_pose(self, position, rotation, velocity, maneuver) -> None:
        """Write the pose into the buffer a step reads, in place."""
        if self._pose is None:
            self._pose = torch.zeros(5, dtype=torch.float64,
                                     device=self.device)
            self._pose_host = torch.zeros(
                5, dtype=torch.float64,
                pin_memory=self.device.type == "cuda")
        staged = self._pose_host.numpy()
        staged[:2] = np.asarray(position, np.float64).reshape(2)
        staged[2:] = (rotation, velocity, maneuver)
        self._pose.copy_(self._pose_host, non_blocking=True)

    def _step_body(self, want_obs: bool, wrapped: bool):
        """One twin step from the pose buffer: the new car state is
        written back into the state tensors; returns the packed outputs
        and their layout. The default shaping reads the cte in float64,
        as the JAX twin shapes the host's float (real_world/env.py:
        339-346)."""
        pose = self._pose
        state, truncated = pose_step(
            self.params, self.state, pose[None, :2], pose[None, 2],
            pose[None, 3], pose[None, 4],
        )
        self._set_state(state.car)
        info = fenv._info(self.params, self.state)
        reward, terminated = fenv.shaping(self.params, info["cte"].double(),
                                          truncated, wrapped)
        obs = (fenv.render_observation_batch(self.params, self.state)
               if want_obs else None)
        return self._outputs(obs, reward, terminated, truncated, info)

    def reset(self, seed: Optional[int] = None, options: Optional[Any] = None):
        self._ensure_backend()
        # seed the RNG without running the simulated spawn
        Env.reset(self, seed=seed)
        position, rotation, _velocity = self._hw_car.pose()
        target_pos, target_rot, _ = snap_to_lanepath(
            self.params, position, rotation
        )
        if self.state is None:
            # the first state's tensors, which the steps' graphs read
            self._set_state(car_mod.car_reset(
                self.params.map_data, self.params.cfg.car,
                torch.zeros(1, dtype=torch.int64, device=self.device)))
        # hand the backend the digital twin's map feedback so its
        # drive-back controller (reference env_autosys.py:154-167) can
        # run without the backend holding the map; backends with a 2-arg
        # reposition still work
        if "guidance" in inspect.signature(self._hw_car.reposition).parameters:
            self._hw_car.reposition(
                target_pos, target_rot,
                guidance=make_guidance(self.params, self.state),
            )
        else:
            self._hw_car.reposition(target_pos, target_rot)
        position, rotation, _velocity = self._hw_car.pose()
        self._set_state(pose_reset(self.params, self.state, position,
                                   rotation).car)
        observation = self._get_obs()
        info = self._to_host(*_pack(fenv._info(self.params, self.state)))
        if self.render_mode == "human":
            self._render_frame()
        return observation, self._convert_info(info)

    def step(self, action: Dict[str, Any]):
        st = time.perf_counter()
        control = np.clip(np.asarray(action["car_control"], np.float64), -1, 1)
        maneuver = int(action["maneuver"])
        self._hw_car.drive(float(control[0]), float(control[1]), maneuver)
        position, rotation, velocity = self._hw_car.pose()
        self._stage_pose(position, rotation, velocity, maneuver)
        frame = self._capture_frame()
        want_obs = frame is None and (
            not self.no_observation or self.render_mode is not None)
        if getenv("DEBUG") or os.environ.get("DEBUG") == "2":
            out = self._to_host(*self._step_body(want_obs, self.wrapped))
        else:
            out = self._fused_step(want_obs, self.wrapped)
        if frame is not None:
            observation = frame
        elif want_obs:
            observation = out.pop("obs")
        else:
            observation = np.zeros(self.observation_space.shape, np.uint8)
        reward, terminated, truncated = (
            out.pop("reward"), out.pop("terminated"), out.pop("truncated"))
        if self.render_mode == "human":
            self._render_frame()
        self.loop_time = time.perf_counter() - st
        return (
            observation,
            float(reward),
            bool(terminated),
            bool(truncated),
            self._convert_info(out),
        )

    def close(self) -> None:
        if self._hw_car is not None:
            self._hw_car.stop()
        super().close()
