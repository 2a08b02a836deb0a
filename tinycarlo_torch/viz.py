"""Host-side visualization: the map overview, on the port's state.

Counterpart of tinycarlo_tpu/viz.py (reference: tinycarlo/renderer.py:
19-82, the car's drawing getters tinycarlo/car.py:172-220): offline
tooling for the human render mode and `render_map`, drawn with cv2 on
host numpy exactly as the JAX package draws it, so the frames are equal
bit for bit. It takes the port's `EnvParams` and a one-env (B = 1)
`EnvState`. The map's arrays are copied to the host once, when the static
overview (the cache) is drawn; a frame copies the car's fields and its
local path's node coordinates, gathered on the device, in one transfer.
The camera observation is rendered on the device by the port's kernels;
this module never touches that path.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from tinycarlo_torch.car import PATH_LEN
from tinycarlo_torch.env import EnvParams, EnvState


def _rotation2d(center: Tuple[float, float], angle_deg: float) -> np.ndarray:
    """3x3 rotate-about-point matrix (cv2.getRotationMatrix2D equivalent,
    used by the reference at car.py:186-187)."""
    a = math.radians(angle_deg)
    c, s = math.cos(a), math.sin(a)
    cx, cy = center
    return np.array(
        [
            [c, s, (1 - c) * cx - s * cy],
            [-s, c, s * cx + (1 - c) * cy],
            [0.0, 0.0, 1.0],
        ]
    )


def _pose_matrix(position: np.ndarray, rotation: float) -> np.ndarray:
    """Car->world 3x3 pose. Reference: car.py:151-157."""
    c, s = math.cos(rotation), math.sin(rotation)
    r = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t = np.array(
        [[1.0, 0.0, position[0]], [0.0, 1.0, position[1]], [0.0, 0.0, 1.0]]
    )
    return t @ r


def _ackermann(radius: float, wheelbase: float, track_width: float):
    """Per-wheel visual steering angles. Reference: car.py:206-220."""
    if radius == 0:
        return 0.0, 0.0
    wb = wheelbase / 1000
    tw = track_width / 1000
    inner = -math.atan(wb / (radius - (tw / 2 + 1e-6)))
    outer = -math.atan(wb / (radius + (tw / 2 + 1e-6)))
    return (outer, inner) if radius > 0 else (inner, outer)


def chassis_points(
    position: np.ndarray, rotation: float, wheelbase: float, track_width: float
) -> np.ndarray:
    """World-frame chassis rectangle corners. Reference: car.py:172-181."""
    t = _pose_matrix(position, rotation)
    pts = np.array(
        [
            [0, -track_width / 2, 1],
            [0, track_width / 2, 1],
            [wheelbase, track_width / 2, 1],
            [wheelbase, -track_width / 2, 1],
        ]
    )
    return (pts @ t.T)[:, :2]


def wheel_points(
    position: np.ndarray,
    rotation: float,
    radius: float,
    wheelbase: float,
    track_width: float,
) -> List[np.ndarray]:
    """World-frame wheel segments [fl, fr, rl, rr] with Ackermann-angled
    front wheels. Reference: car.py:183-204."""
    t = _pose_matrix(position, rotation)
    wheel_length = wheelbase / 3
    fl_angle, fr_angle = _ackermann(radius, wheelbase, track_width)
    fl_r = _rotation2d(
        (wheelbase - wheel_length / 2, -track_width / 2), math.degrees(fl_angle)
    )
    fr_r = _rotation2d(
        (wheelbase - wheel_length / 2, track_width / 2), math.degrees(fr_angle)
    )
    fl = np.array(
        [
            [wheelbase - wheel_length, -track_width / 2, 1],
            [wheelbase, -track_width / 2, 1],
        ]
    )
    fr = np.array(
        [
            [wheelbase - wheel_length, track_width / 2, 1],
            [wheelbase, track_width / 2, 1],
        ]
    )
    rl = np.array([[0, -track_width / 2, 1], [wheel_length, -track_width / 2, 1]])
    rr = np.array([[0, track_width / 2, 1], [wheel_length, track_width / 2, 1]])
    return [
        (fl @ (t @ fl_r).T)[:, :2],
        (fr @ (t @ fr_r).T)[:, :2],
        (rl @ t.T)[:, :2],
        (rr @ t.T)[:, :2],
    ]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def render_static_overview(
    params: EnvParams,
    ppm: int,
    background_color: Optional[Tuple[int, int, int]] = None,
    line_thickness: int = 1,
    render_node_names: bool = False,
) -> np.ndarray:
    """Map-sized canvas with lanelines in layer colors and the lanepath in
    gray. Reference: renderer.py:53-79; tinycarlo_tpu/viz.py:115-173."""
    import cv2

    md = params.map_data
    h, w = (float(x) for x in _host(md.dimension))
    overview = np.zeros((int(h * ppm), int(w * ppm), 3), dtype=np.uint8)
    if background_color is not None:
        overview[:] = background_color

    def draw_layer(pts, edges, color):
        for src, dst in edges:
            seg = np.int32([[pts[src] * ppm, pts[dst] * ppm]])
            cv2.polylines(overview, seg, False, color, line_thickness)

    nodes = _host(md.laneline_nodes)
    edges = _host(md.laneline_edges)
    counts = _host(md.laneline_edge_mask).sum(axis=1)
    colors = _host(md.laneline_colors)
    for i in range(md.n_layers):
        draw_layer(nodes[i], edges[i][: int(counts[i])],
                   tuple(int(c) for c in colors[i]))

    path_color = (50, 50, 50)
    if background_color is not None and sorted(background_color) != sorted(
        (255, 255, 255)
    ):
        path_color = (200, 200, 200)
    lp = md.lanepath
    lp_nodes = _host(lp.nodes)
    draw_layer(lp_nodes, _host(lp.edges)[: lp.n_edges], path_color)

    if render_node_names:
        for i, node in enumerate(lp_nodes[: lp.n_nodes]):
            cv2.putText(
                overview,
                str(i),
                tuple(np.int32(node * ppm)),
                cv2.FONT_HERSHEY_SIMPLEX,
                0.4,
                (50, 50, 50),
                1,
                cv2.LINE_AA,
            )
    return overview


def _car_fields(params: EnvParams, state: EnvState):
    """(position (2,), rotation, radius, local-path node coordinates
    (n, 2, 2)) of a one-env state, in the state's dtype, from one
    device-to-host copy."""
    car = state.car
    if car.position.shape[0] != 1:
        raise ValueError("the overview draws a one-env state (B = 1), got "
                         f"B = {car.position.shape[0]}")
    dtype = car.position.dtype
    coords = params.map_data.lanepath.nodes[car.local_path[0]]
    packed = _host(torch.cat([
        car.position[0], car.rotation, car.radius,
        car.local_path_len.to(dtype), coords.reshape(-1)]))
    n = int(packed[4])
    return (packed[:2], float(packed[2]), float(packed[3]),
            packed[5:].reshape(PATH_LEN, 2, 2)[:n])


def render_overview(
    params: EnvParams,
    state: EnvState,
    ppm: int,
    background_color: Optional[Tuple[int, int, int]] = None,
    line_thickness: int = 1,
    render_node_names: bool = False,
    static_cache: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Static overview + car chassis (blue), wheels (magenta), local path.
    Returns (frame, static_cache); raises for a batch of more than one
    env. Reference: renderer.py:19-34; tinycarlo_tpu/viz.py:176-214."""
    import cv2

    if static_cache is None:
        static_cache = render_static_overview(
            params, ppm, background_color, line_thickness, render_node_names
        )
    position, rotation, radius, path = _car_fields(params, state)
    image = static_cache.copy()

    cfg = params.cfg.car
    wheel_width = (cfg.wheelbase / 3) / 6  # reference car.py:22-23

    chassis = chassis_points(position, rotation, cfg.wheelbase, cfg.track_width)
    cv2.polylines(
        image, np.int32([chassis * ppm]), True, (255, 0, 0), line_thickness
    )
    for wheel in wheel_points(
        position, rotation, radius, cfg.wheelbase, cfg.track_width
    ):
        cv2.polylines(
            image,
            np.int32([wheel * ppm]),
            False,
            (255, 0, 255),
            max(1, int(wheel_width * ppm)),
        )

    for src, dst in path:
        seg = np.int32([[src * ppm, dst * ppm]])
        cv2.polylines(image, seg, False, (255, 0, 0), line_thickness)
    return image, static_cache
