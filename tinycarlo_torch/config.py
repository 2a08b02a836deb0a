"""Config schema: YAML/dict -> frozen dataclasses.

Drop-in compatible with the reference YAML schema (documented in
reference examples/config_simple_layout.yaml:1-26 and consumed in
tinycarlo/env.py:40-45, car.py:12-18, camera.py:16-21, map.py:16-26).
All fields are static Python values.

The port's own copy of tinycarlo_tpu/config.py, field for field: importing
the JAX package's module would run tinycarlo_tpu/__init__.py, which
imports jax. In this package `MapConfig.query_grid=True` is not ported
yet and raises NotImplementedError where it is used.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple, Union

import yaml


@dataclass(frozen=True)
class SimConfig:
    # Defaults mirror reference tinycarlo/env.py:40-45.
    fps: int = 30
    render_realtime: bool = False
    observation_space_format: str = "rgb"  # "rgb", "classes", or the extensions "rgb_planar" (channel-planar rgb) / "rank" (1-byte/pixel paint-order layer map) -- see env.observation_shape
    overview_pixel_per_meter: int = 150
    render_node_names: bool = False
    real_world_env: Optional[str] = None

    @property
    def T(self) -> float:
        return 1.0 / self.fps


@dataclass(frozen=True)
class CarConfig:
    # Defaults mirror reference tinycarlo/car.py:12-18.
    track_width: float = 0.03
    wheelbase: float = 0.08
    max_velocity: float = 1.0
    max_steering_angle: float = 35.0  # degrees
    steering_speed: Optional[float] = None  # degrees/s rate limit
    max_acceleration: Optional[float] = None  # m/s^2
    max_deceleration: Optional[float] = None  # m/s^2


@dataclass(frozen=True)
class CameraConfig:
    # Defaults mirror reference tinycarlo/camera.py:16-21.
    resolution: Tuple[int, int] = (128, 160)  # (height, width) px
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # m, rel. front axle
    orientation: Tuple[float, float, float] = (0.0, 0.0, 0.0)  # pitch/roll/yaw deg
    fov: float = 90.0  # degrees
    max_range: Optional[float] = None  # meters
    line_thickness: int = 1  # px
    # Upper bound on simultaneously visible segments per layer-frame; the
    # rasterizer compacts the padded segment axis down to this many slots
    # (ops/rasterize.py:compact_visible). Not part of the reference schema
    # (its renderer draws unbounded Python lists); frames with more
    # visible segments would drop the excess, so raise it for unusually
    # dense maps. None disables compaction (exact, slower).
    max_visible_segments: Optional[int] = 128
    # Thickness >= 2 stroke semantics (extension; not part of the
    # reference YAML schema). "fast": the calibrated rectangle-body +
    # end-cap stroke (rasterize._split_radii) -- the throughput path.
    # "exact": the bit-exact cv2.polylines thick-stroke replica
    # (ops/cv2_stroke.py) for reference-checkpoint portability; renders
    # through its own compaction and kernel (ops/csrc/exact.cu on the GPU,
    # its plain PyTorch version on the CPU; its cost is in PERF.md).
    # Thickness 1 is bit-exact in BOTH modes.
    stroke: str = "fast"


@dataclass(frozen=True)
class MapConfig:
    json_path: str = ""
    pixel_per_meter: int = 1
    spawn_points: Optional[Tuple[int, ...]] = None
    # Spatial-pruning grid for car_info's per-laneline nearest-edge
    # queries (extension; the reference scans every edge per step,
    # tinycarlo/layer.py:33-44). Exact-argmin-preserving within the
    # map bbox inflated by `query_grid_margin` meters per side (None =
    # half the larger map dimension); positions beyond the inflated
    # bbox clamp to the boundary cell and may then deviate from the
    # full scan -- unreachable under any terminating config.
    # DEFAULT OFF: on reference-sized maps (packed E ~264-740) the
    # fused full scan is FASTER than the pruned query -- the dense
    # elementwise scan fuses into the step program while the grid's
    # candidate routing (one-hot matmul or row gather, both measured)
    # adds ~0.2 ms/step at 4096 envs (docs/KERNELS.md round-4).
    # Enable for maps with orders of magnitude more edges.
    # `query_grid_cells` targets the total cell count (actual count
    # rounds to the map aspect ratio).
    query_grid: bool = False
    query_grid_cells: int = 4096
    query_grid_margin: Optional[float] = None


@dataclass(frozen=True)
class EnvConfig:
    sim: SimConfig = field(default_factory=SimConfig)
    car: CarConfig = field(default_factory=CarConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    map: MapConfig = field(default_factory=MapConfig)


def _tupled(v):
    if isinstance(v, list):
        return tuple(_tupled(x) for x in v)
    return v


def _sub(d: Dict[str, Any], cls, known: Dict[str, Any]):
    fields = {f for f in cls.__dataclass_fields__}
    kwargs = {k: _tupled(v) for k, v in d.items() if k in fields}
    kwargs.update(known)
    return cls(**kwargs)


def load_config(
    config: Union[str, Dict[str, Any]], base_path: Optional[str] = None
) -> Tuple[EnvConfig, Optional[str]]:
    """Parse a config given as a dict, a yaml path, or a directory holding
    config.yaml (reference: tinycarlo/env.py:26-35). Returns the parsed
    config plus the absolute yaml path (None for dict configs), which the
    map loader uses to resolve relative map paths (reference:
    tinycarlo/map.py:15-16).
    """
    config_path: Optional[str] = None
    if isinstance(config, str):
        if config.endswith(".yaml"):
            config_path = os.path.abspath(config)
        else:
            config_path = os.path.abspath(os.path.join(config, "config.yaml"))
        with open(config_path, "r") as stream:
            config = yaml.safe_load(stream)
    if base_path is not None:
        config_path = base_path

    return (
        EnvConfig(
            sim=_sub(config.get("sim", {}), SimConfig, {}),
            car=_sub(config.get("car", {}), CarConfig, {}),
            camera=_sub(config.get("camera", {}), CameraConfig, {}),
            map=_sub(config.get("map", {}), MapConfig, {}),
        ),
        config_path,
    )
