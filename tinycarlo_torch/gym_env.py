"""The Gymnasium entry point: `TinyCarloEnv` over the port's batched core.

Counterpart of tinycarlo_tpu/gym_env.py (reference: tinycarlo/env.py):
the same config schema, action and observation spaces, info dict, render
modes and RNG stream (the spawn draws replay the reference's seeded
`np_random` rejection sampling, draw for draw). The simulation is the
port's batched `env` core at B = 1; this class holds the host state (the
RNG, the wrapper flag) and converts tensors to numpy at the boundary.

Device: `device="cuda"` by default, raising without a GPU; `device="cpu"`
runs the plain PyTorch path. On the card a step is ONE replayed CUDA
graph: the car step, the render (the masks kernel for classes, the rank
kernel for rgb, rgb_planar and rank, the exact kernel under `camera.stroke:
exact`), the info and the default or wrapped shaping, captured once per
(render, wrapped) mode at its first use, and once more with tracing on
(`utils.graphs.StepGraphs`, `step_graphs`), over static state and action
buffers. Per step the host writes the action into a pinned buffer, copies
it in, replays, and copies obs, reward, flags and info out as ONE byte
buffer into pinned memory (tinycarlo_tpu/gym_env.py:309-326 is the JAX
shim's one dispatch and one transfer). The capture raises unless it
recorded exactly one launch of each render kernel (`env.render_kernels`;
none without a render) and none of the others; its wrapper counts that
recording, and a replay, which runs the recorded launch without the
wrapper, counts nothing (`step_graphs.replays` counts the replays).
Anything that changes the state outside a step (`reset`,
`camera.update_params()`) writes into the captured tensors in place.
Traced, `step()` is the call span "gym.step": "gym.stage_in" (the action
staged and copied in), "gym.replay", "gym.wait" (the copy out and its
synchronize) and "gym.unpack" (the buffer's fields, `_convert_info`).

The eager path (`device="cpu"`, and `DEBUG=1` / `DEBUG=2`, whose staged
step prints the reference's timing lines) runs the same step body; a
replay equals it bit for bit. `render_mode="human"` shows the overview map
(`viz.render_overview`) and the camera's rgb frame in two cv2 windows,
"Map" and "Camera", after every reset and step, paced by `cv2.waitKey` to
the sim's period (tinycarlo_tpu/gym_env.py:476-512); it needs a display.

For throughput use `tinycarlo_torch.vector`, which steps thousands of
envs at once.
"""
from __future__ import annotations

import os
import time
from dataclasses import fields
from functools import partial
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from tinycarlo_torch import camera as cam
from tinycarlo_torch import car as car_mod
from tinycarlo_torch import env as fenv
from tinycarlo_torch.config import load_config
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.utils import graphs, profiling
from tinycarlo_torch.utils.gym_compat import Env, spaces
from tinycarlo_torch.utils.helper import getenv, numpy_dtype, resolve_device


class _CarView:
    """Host-side view of the car config and live state, so wrapper and
    example code written against the reference's `env.unwrapped.car`
    keeps working (e.g. `car.track_width`, reference wrapper/reward.py:22).
    tinycarlo_tpu/gym_env.py:36-78."""

    def __init__(self, shim: "TinyCarloEnv"):
        self._shim = shim
        cfg = shim.params.cfg.car
        self.track_width = cfg.track_width
        self.wheelbase = cfg.wheelbase
        self.max_velocity = cfg.max_velocity
        self.max_steering_angle = cfg.max_steering_angle

    def _get(self, name: str) -> torch.Tensor:
        return getattr(self._shim.state.car, name)[0].cpu()

    @property
    def position(self) -> np.ndarray:
        return self._get("position").numpy()

    @property
    def position_front(self) -> np.ndarray:
        return self._get("position_front").numpy()

    @property
    def rotation(self) -> float:
        return float(self._get("rotation"))

    @property
    def steering_angle(self) -> float:
        return float(self._get("steering_angle"))

    @property
    def velocity(self) -> float:
        return float(self._get("velocity"))

    @property
    def radius(self) -> float:
        return float(self._get("radius"))

    @property
    def local_path(self):
        n = int(self._get("local_path_len"))
        return [tuple(int(i) for i in e)
                for e in self._get("local_path")[:n].numpy()]


class _CameraView:
    """Mutable camera parameters and `update_params()`, the reference's
    domain-randomization hook (reference camera.py:48-50, mutated in
    examples/train_stanley_il.py:53-57). tinycarlo_tpu/gym_env.py:81-108,
    except that the new matrices are written into the env's camera
    tensors in place (a captured step reads those tensors)."""

    def __init__(self, shim: "TinyCarloEnv"):
        self._shim = shim
        cfg = shim.params.cfg.camera
        self.resolution = list(cfg.resolution)
        self.position = list(cfg.position)
        self.orientation = list(cfg.orientation)
        self.fov = cfg.fov
        self.max_range = cfg.max_range
        self.line_thickness = cfg.line_thickness

    def update_params(self) -> None:
        camera = self._shim.params.camera
        build = cam.matrix_builder(tuple(self.resolution), camera.E.dtype,
                                   camera.E.device)
        matrices = build(self.orientation, self.position, self.fov)
        camera.E.copy_(matrices.E)
        camera.K.copy_(matrices.K)


# Output names of a step, in the order they are packed: 8-byte floats
# first, so every field of the byte buffer lies at a multiple of its size.
_OUT_ORDER = ("reward", "cte", "heading_error", "laneline_distances",
              "local_path", "position", "orientation", "velocity",
              "local_path_len", "terminated", "truncated", "obs")


def _pack(outputs: Dict[str, torch.Tensor]):
    """The step's outputs as one uint8 tensor, and its layout: (name,
    numpy dtype, shape without the batch axis, byte offset) a field."""
    names = sorted(outputs, key=lambda n: (-outputs[n].element_size(),
                                           _OUT_ORDER.index(n)))
    parts, layout, offset = [], [], 0
    for name in names:
        t = outputs[name].contiguous()
        part = t.reshape(-1).view(torch.uint8)
        layout.append((name, numpy_dtype(t.dtype), tuple(t.shape[1:]),
                       offset))
        parts.append(part)
        offset += part.numel()
    return torch.cat(parts), tuple(layout)


def _unpack(buf: np.ndarray, layout) -> Dict[str, np.ndarray]:
    """The fields of a packed byte buffer, each a numpy array of its own."""
    out = {}
    for name, dtype, shape, offset in layout:
        count = int(np.prod(shape, dtype=np.int64))
        out[name] = np.frombuffer(buf, dtype=dtype, count=count,
                                  offset=offset).reshape(shape).copy()
    return out


class TinyCarloEnv(Env):
    """Gymnasium env `"tinycarlo-torch-v2"`. Reference:
    tinycarlo/env.py:15-180; tinycarlo_tpu/gym_env.py:112-512."""

    metadata: Dict[str, list] = {"render_modes": ["human", "rgb_array"]}

    def __init__(
        self,
        render_mode: Optional[str] = None,
        config: Optional[Union[str, Dict[str, Any]]] = None,
        dtype: torch.dtype = torch.float32,
        device="cuda",
    ):
        if render_mode is not None and (
                render_mode not in self.metadata["render_modes"]):
            raise ValueError(f"render_mode {render_mode!r} is not one of "
                             f"{self.metadata['render_modes']}")
        cfg, config_path = load_config(config)
        self.config_path = config_path
        self.config = config if isinstance(config, dict) else None
        if self.config is None:
            import yaml

            with open(config_path) as stream:
                self.config = yaml.safe_load(stream)

        self.device = resolve_device(device)
        self.params = fenv.make_env_params(
            cfg, dtype=dtype, base_path=config_path, device=self.device
        )
        self.fps = cfg.sim.fps
        self.T = cfg.sim.T
        self.render_realtime = cfg.sim.render_realtime
        self.observation_space_format = cfg.sim.observation_space_format
        self.overview_pixel_per_meter = cfg.sim.overview_pixel_per_meter
        self.render_node_names = cfg.sim.render_node_names

        self.render_mode = render_mode
        self.no_observation = False
        self.wrapped = False  # set True by wrappers; disables default shaping
        self.loop_time: float = 1.0
        # the human mode's cv2 windows and the overview's static map
        self._window: Optional[str] = None
        self._window_camera: Optional[str] = None
        self._overview_cache: Optional[np.ndarray] = None

        self.state: Optional[fenv.EnvState] = None
        self.car = _CarView(self)
        self.camera = _CameraView(self)

        # Host-side spawn parity: lanepath node index -> spawn-table row
        # (-1 for dead ends and nodes outside the candidates), so the
        # reference's rejection sampling (map.py:51-69) is replayed draw
        # for draw on the same seeded np_random stream.
        spawns = self.params.map_data.spawns
        self._n_lanepath_nodes = self.params.map_data.lanepath.n_nodes
        self._spawn_points = cfg.map.spawn_points
        node_to_row = np.full(self._n_lanepath_nodes, -1, dtype=np.int64)
        nodes = spawns.node_idx[: spawns.count].cpu().numpy()
        node_to_row[nodes] = np.arange(len(nodes))
        self._node_to_row = node_to_row

        # the action a step reads: (velocity, steering, maneuver) in
        # float64, clipped on the host
        self._action = torch.zeros(3, dtype=torch.float64, device=self.device)
        cuda = self.device.type == "cuda"
        self._action_host = torch.zeros(3, dtype=torch.float64,
                                        pin_memory=cuda)
        # replay each (render, wrapped) mode's captured step on the card;
        # False steps eagerly, as off the card
        self.graphs = cuda
        self.step_graphs = graphs.StepGraphs(self.device, name="gym")
        self._host_out: Dict[int, torch.Tensor] = {}  # pinned, by size

        self.action_space = spaces.Dict(
            {
                "car_control": spaces.Box(-1, 1, shape=(2,), dtype=np.float32),
                "maneuver": spaces.Discrete(4),
            }
        )
        self.observation_space = spaces.Box(
            low=0,
            high=255,
            shape=fenv.observation_shape(self.params),
            dtype=np.uint8,
        )

        self.reset()

    # -- helpers -----------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample_spawn_row(self) -> int:
        """Replay the reference RNG draw sequence (map.py:61-64)."""
        while True:
            if self._spawn_points is None:
                idx = int(
                    self.np_random.integers(
                        0, self._n_lanepath_nodes - 1, size=1, dtype=int
                    )[0]
                )
            else:
                idx = int(self.np_random.choice(
                    np.asarray(self._spawn_points)))
            row = self._node_to_row[idx]
            if row >= 0:
                return int(row)

    def _set_state(self, car: car_mod.CarState) -> None:
        """Write `car` into the env's state tensors in place (the tensors a
        captured step reads); the first state gets tensors of its own."""
        if self.state is None:
            self.state = fenv.EnvState(car=car_mod.CarState(**{
                f.name: getattr(car, f.name).clone() for f in fields(car)
            }))
            return
        for f in fields(car):
            getattr(self.state.car, f.name).copy_(getattr(car, f.name))

    def _step_action(self) -> Dict[str, torch.Tensor]:
        dtype = self.params.camera.E.dtype
        return {"car_control": self._action[None, :2].to(dtype),
                "maneuver": self._action[None, 2].to(torch.int32)}

    def _step_body(self, want_obs: bool, wrapped: bool):
        """One B = 1 step from the state and action buffers: the new car
        state is written back into the state tensors; returns the packed
        outputs and their layout."""
        state, obs, reward, terminated, truncated, info = fenv.step(
            self.params, self.state, self._step_action(), render=want_obs,
            wrapped=wrapped,
        )
        self._set_state(state.car)
        return self._outputs(obs, reward, terminated, truncated, info)

    @staticmethod
    def _outputs(obs, reward, terminated, truncated, info):
        """A step's outputs packed (`obs=None` when not rendering)."""
        outputs = dict(info, reward=reward, terminated=terminated,
                       truncated=truncated)
        if obs is not None:
            outputs["obs"] = obs
        return _pack(outputs)

    def _to_host(self, packed: torch.Tensor, layout) -> Dict[str, np.ndarray]:
        """ONE device->host copy of a packed buffer, unpacked (traced as
        "gym.wait" and "gym.unpack")."""
        if self.device.type != "cuda":
            with profiling.span("gym.unpack"):
                return _unpack(packed.numpy(), layout)
        host = self._host_out.get(packed.numel())
        if host is None:
            host = torch.empty(packed.numel(), dtype=torch.uint8,
                               pin_memory=True)
            self._host_out[packed.numel()] = host
        with profiling.span("gym.wait"):
            host.copy_(packed, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        with profiling.span("gym.unpack"):
            return _unpack(host.numpy(), layout)

    def _fused_step(self, want_obs: bool, wrapped: bool
                    ) -> Dict[str, np.ndarray]:
        """One step: on the card a replay of the (render, wrapped) mode's
        step, captured at its first step (`graphs.StepGraphs`), or eagerly
        when `graphs` is off."""
        return self._to_host(*self.step_graphs.run(
            (want_obs, wrapped), partial(self._step_body, want_obs, wrapped),
            self.graphs, fenv.render_kernels(self.params) if want_obs
            else ()))

    def _render_obs(self, fmt: Optional[str] = None) -> np.ndarray:
        obs = fenv.render_observation(self.params, self.state, fmt)
        return obs.cpu().numpy()

    def _get_obs(self) -> np.ndarray:
        if not self.no_observation or self.render_mode is not None:
            return self._render_obs()
        return np.zeros(self.observation_space.shape, dtype=np.uint8)

    def _convert_info(self, info: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Host info (one env's numpy arrays) -> the reference's dict
        (env.py:83-85): laneline_distances keyed by layer name, local_path
        as a trimmed coordinate list. tinycarlo_tpu/gym_env.py:247-267."""
        names = self.params.map_data.laneline_names
        distances = np.asarray(info["laneline_distances"]).reshape(-1)
        n = int(info["local_path_len"])
        coords = np.asarray(info["local_path"]).reshape(-1, 2)
        return {
            "cte": float(info["cte"]),
            "heading_error": float(info["heading_error"]),
            "position": np.asarray(info["position"]).reshape(2),
            "orientation": float(info["orientation"]),
            "laneline_distances": {
                name: float(d) for name, d in zip(names, distances)
            },
            "local_path": [coords[i] for i in range(n)] if n >= 2 else [],
            "velocity": float(info["velocity"]),
        }

    # -- gym API -----------------------------------------------------------

    def reset(
        self, seed: Optional[int] = None, options: Optional[Any] = None
    ) -> Tuple[np.ndarray, Dict[str, Any]]:
        super().reset(seed=seed)
        row = self._sample_spawn_row()
        self._set_state(car_mod.car_reset(
            self.params.map_data, self.params.cfg.car,
            torch.tensor([row], dtype=torch.int64, device=self.device),
        ))
        observation = self._get_obs()
        packed, layout = _pack(fenv._info(self.params, self.state))
        info = self._to_host(packed, layout)
        if self.render_mode == "human":
            self._render_frame()
        return observation, self._convert_info(info)

    def step(self, action: Dict[str, Any]):
        with profiling.span("gym.step", call=True):
            return self._step(action)

    def _step(self, action: Dict[str, Any]):
        st = time.perf_counter()
        with profiling.span("gym.stage_in"):
            control = np.clip(np.asarray(action["car_control"], np.float64),
                              -1, 1)
            staged = self._action_host.numpy()
            staged[:2] = control
            staged[2] = int(action["maneuver"])
            self._action.copy_(self._action_host, non_blocking=True)
        want_obs = not self.no_observation or self.render_mode is not None
        # DEBUG=1: staged step timings (reference env.py:144-145);
        # DEBUG=2: also per-layer camera timings (reference camera.py:99-109)
        if getenv("DEBUG") or os.environ.get("DEBUG") == "2":
            observation, reward, terminated, truncated, info = (
                self._step_debug(want_obs, st)
            )
        else:
            out = self._fused_step(want_obs, self.wrapped)
            observation = out.pop("obs") if want_obs else np.zeros(
                self.observation_space.shape, dtype=np.uint8)
            reward, terminated, truncated = (
                out.pop("reward"), out.pop("terminated"), out.pop("truncated"))
            info = out
        if self.render_mode == "human":
            self._render_frame()
        self.loop_time = time.perf_counter() - st
        with profiling.span("gym.unpack"):
            info = self._convert_info(info)
        return (observation, float(reward), bool(terminated), bool(truncated),
                info)

    def _step_debug(self, want_obs: bool, st: float):
        """DEBUG=1 staged step with the reference's per-stage timing prints
        (env.py:144-145 all / obs / info / car-step line; camera.py:99-109
        stage breakdown), tinycarlo_tpu/gym_env.py:346-466. Each stage ends
        in a synchronize, so the times are the card's; slower than the
        fused step by design. The camera line reports the packed
        projection and the render (projection and rasterize) instead of the
        reference's per-layer loop; DEBUG=2 adds one line per layer
        (project | rasterize)."""
        params = self.params
        cfg = params.cfg
        md = params.map_data
        st_step = time.perf_counter()
        action = self._step_action()
        control = torch.clamp(action["car_control"], -1.0, 1.0)
        car_state, truncated = car_mod.car_step(
            md, cfg.car, cfg.sim.T, self.state.car, control[:, 0],
            control[:, 1], action["maneuver"],
        )
        self._set_state(car_state)
        self._sync()
        td_step = time.perf_counter() - st_step

        st_obs = time.perf_counter()
        if want_obs:
            if os.environ.get("DEBUG") == "2":
                self._debug_layers()
            fenv._project_packed_batch_soa(params, self.state)
            self._sync()
            td_project = time.perf_counter() - st_obs
            observation = self._render_obs()
            td_obs = time.perf_counter() - st_obs
            print(
                f"obs projection: {td_project*1000:.4f} ms | "
                f"render (projection+rasterize fused): "
                f"{(td_obs-td_project)*1000:.4f} ms"
            )
        else:
            observation = np.zeros(self.observation_space.shape, np.uint8)
            td_obs = time.perf_counter() - st_obs

        st_info = time.perf_counter()
        info = fenv._info(params, self.state)
        reward, terminated = fenv.shaping(params, info["cte"], truncated,
                                          self.wrapped)
        info = self._to_host(*self._outputs(None, reward, terminated,
                                            truncated, info))
        td_info = time.perf_counter() - st_info
        print(
            f"all: {(time.perf_counter() - st)*1000:.2f} ms | "
            f"obs render {td_obs*1000:.2f} ms | info {td_info*1000:.2f} ms | "
            f"car step {td_step*1000:.2f} ms"
        )
        return (observation, info.pop("reward"), info.pop("terminated"),
                info.pop("truncated"), info)

    def _debug_layers(self) -> None:
        """DEBUG=2: per layer, its edges of the packed axis projected, then
        rasterized as a one-layer frame, each stage timed."""
        params = self.params
        md = params.map_data
        cam_cfg = params.cfg.camera
        bounds = md.packed_layer_bounds
        body = cam.car_world_to_body_matrix(
            self.state.car.position, self.state.car.rotation)
        pose = torch.matmul(params.camera.E, body)
        for l, name in enumerate(md.laneline_names):
            a, b = bounds[l], bounds[l + 1]
            st_l = time.perf_counter()
            u0, v0, u1, v1, draw = cam.project_layers_batch_soa(
                md.packed_nodes, md.packed_edges[:, a:b],
                md.packed_edge_mask[:, a:b], pose, params.camera.K,
                tuple(cam_cfg.resolution), cam_cfg.max_range,
            )
            self._sync()
            td_p = time.perf_counter() - st_l
            rk.rasterize_masks_packed_soa(
                u0[:, 0], v0[:, 0], u1[:, 0], v1[:, 0], draw[:, 0],
                torch.zeros(b - a, dtype=torch.int32, device=self.device), 1,
                tuple(cam_cfg.resolution), cam_cfg.line_thickness,
                max_visible=cam_cfg.max_visible_segments,
                layer_bounds=(0, b - a), stroke=cam_cfg.stroke,
            )
            self._sync()
            print(
                f"camera layer {name}: project {td_p*1000:.4f} ms"
                f" | rasterize "
                f"{(time.perf_counter()-st_l-td_p)*1000:.4f} ms"
            )

    def render(self) -> Optional[np.ndarray]:
        if self.render_mode == "rgb_array":
            return self._render_frame()
        return None

    def _camera_rgb(self) -> np.ndarray:
        return self._render_obs(fmt="rgb")

    def _render_frame(self) -> Optional[np.ndarray]:
        """The camera's rgb frame; in human mode it is shown beside the
        overview map instead, and cv2.waitKey waits out the rest of the
        sim's period (tinycarlo_tpu/gym_env.py:476-503)."""
        camera_view = self._camera_rgb()
        if self.render_mode != "human":
            return camera_view
        import cv2

        from tinycarlo_torch.viz import render_overview

        if self._window is None:
            self._window = "Map"
            cv2.namedWindow(self._window, cv2.WINDOW_NORMAL)
        if self._window_camera is None:
            self._window_camera = "Camera"
            cv2.namedWindow(self._window_camera, cv2.WINDOW_NORMAL)
        overview, self._overview_cache = render_overview(
            self.params,
            self.state,
            self.overview_pixel_per_meter,
            render_node_names=self.render_node_names,
            static_cache=self._overview_cache,
        )
        cv2.imshow(self._window, overview)
        cv2.imshow(self._window_camera, camera_view)
        waiting_time = self.T - self.loop_time
        if waiting_time < 0.001 or not self.render_realtime:
            waiting_time = 0.001
        cv2.waitKey(int(waiting_time * 1000))
        return None

    def close(self) -> None:
        if self._window is not None or self._window_camera is not None:
            import cv2

            for window in (self._window, self._window_camera):
                if window is not None:
                    cv2.destroyWindow(window)
            self._window = self._window_camera = None
        self.step_graphs.entries.clear()
