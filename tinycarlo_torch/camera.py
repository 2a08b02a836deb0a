"""Pinhole camera: matrices + batched segment projection.

Counterpart of tinycarlo_tpu/camera.py:41-269 (reference:
tinycarlo/camera.py). Axis conventions follow the reference exactly: the
extrinsic composes an axis-angle rotation of (pitch-90deg, roll, 0) with
one of (0, 0, yaw+90deg) (camera.py:145-156); in that frame the z-axis
points behind the camera, so "in front" means depth < 0 (camera.py:70).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from tinycarlo_torch.config import CameraConfig
from tinycarlo_torch.utils.helper import resolve_device

NEAR_EPS = -1e-7  # reference near-plane target z (camera.py:112)


@dataclass
class CameraMatrices:
    """Extrinsic (3, 4) and intrinsic (3, 3)."""

    E: torch.Tensor
    K: torch.Tensor


def _radians(x: torch.Tensor) -> torch.Tensor:
    # jnp.radians multiplies by the constant pi/180 in the input's dtype
    return x * (math.pi / 180)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle rotation vector (3,) -> 3x3 rotation matrix, as
    cv2.Rodrigues (reference camera.py:152-153): theta = |rvec|,
    R = cos(t) I + (1-cos(t)) a a^T + sin(t) [a]_x; identity at theta=0."""
    theta = torch.sqrt(torch.sum(rvec * rvec))
    safe_theta = torch.where(theta == 0, 1.0, theta)
    a = rvec / safe_theta
    c, s = torch.cos(theta), torch.sin(theta)
    aat = torch.outer(a, a)
    zero = torch.zeros((), dtype=rvec.dtype, device=rvec.device)
    skew = torch.stack(
        [
            torch.stack([zero, -a[2], a[1]]),
            torch.stack([a[2], zero, -a[0]]),
            torch.stack([-a[1], a[0], zero]),
        ]
    )
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    r = c * eye + (1 - c) * aat + s * skew
    return torch.where(theta == 0, eye, r)


def extrinsic_matrix(
    orientation_deg: torch.Tensor, position: torch.Tensor
) -> torch.Tensor:
    """Build the (3, 4) extrinsic. Reference: camera.py:145-156."""
    dtype, dev = orientation_deg.dtype, orientation_deg.device
    offset = torch.tensor([-90.0, 0.0, 90.0], dtype=dtype, device=dev)
    angles = _radians(orientation_deg + offset)
    r_pr = rodrigues(angles * torch.tensor([1.0, 1.0, 0.0], dtype=dtype, device=dev))
    r_y = rodrigues(angles * torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev))
    trans = torch.cat(
        [torch.eye(3, dtype=dtype, device=dev), -position.to(dtype)[:, None]],
        dim=1,
    )
    return r_pr @ r_y @ trans


def intrinsic_matrix(
    fov_deg: float, resolution: Tuple[int, int], dtype=torch.float32,
    device="cpu",
) -> torch.Tensor:
    """Build the (3, 3) intrinsic from fov. Reference: camera.py:158-178."""
    h, w = resolution
    fov = _radians(torch.tensor(fov_deg, dtype=dtype, device=device))
    fx = w / (2 * torch.tan(fov / 2))
    fy = h / (2 * torch.tan(fov / 2))
    z = torch.zeros((), dtype=dtype, device=device)
    one = torch.ones((), dtype=dtype, device=device)
    return torch.stack(
        [
            torch.stack([fx, z, torch.tensor(w / 2, dtype=dtype, device=device)]),
            torch.stack([z, fy, torch.tensor(h / 2, dtype=dtype, device=device)]),
            torch.stack([z, z, one]),
        ]
    )


def matrix_builder(
    resolution: Tuple[int, int], dtype=torch.float32, device="cuda"
):
    """A `(orientation_deg (3,), position (3,), fov) -> CameraMatrices`
    builder for one resolution: the matrices are built on the host in
    `dtype` and moved to `device` (default "cuda"; raises without a GPU).
    The config's matrices come from it, and so do the per-episode camera
    randomizations (reference update_params, camera.py:48-50).
    tinycarlo_tpu/camera.py:100-113."""
    device = resolve_device(device)
    resolution = tuple(resolution)

    def build(orientation, position, fov) -> CameraMatrices:
        orientation = torch.tensor(orientation, dtype=dtype)
        position = torch.tensor(position, dtype=dtype)
        return CameraMatrices(
            E=extrinsic_matrix(orientation, position).to(device),
            K=intrinsic_matrix(float(fov), resolution, dtype).to(device),
        )

    return build


def build_camera_matrices(
    cfg: CameraConfig, dtype=torch.float32, device="cuda"
) -> CameraMatrices:
    """The config's matrices, built on the host in `dtype` and moved to
    `device` (default "cuda"; raises without a GPU)."""
    return matrix_builder(cfg.resolution, dtype, device)(
        cfg.orientation, cfg.position, cfg.fov
    )


def car_world_to_body_matrix(
    position: torch.Tensor, rotation: torch.Tensor
) -> torch.Tensor:
    """(B, 4, 4) world->car transforms (inverse poses) for positions (B, 2)
    and yaws (B,). Reference: car.py:159-165."""
    c = torch.cos(-rotation)
    s = torch.sin(-rotation)
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    r = torch.stack(
        [
            torch.stack([c, -s, zero, zero], dim=-1),
            torch.stack([s, c, zero, zero], dim=-1),
            torch.stack([zero, zero, one, zero], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    t = torch.stack(
        [
            torch.stack([one, zero, zero, -position[:, 0]], dim=-1),
            torch.stack([zero, one, zero, -position[:, 1]], dim=-1),
            torch.stack([zero, zero, one, zero], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return r @ t


def project_layers_batch_soa(
    nodes: torch.Tensor,  # (L, N, 2) shared map nodes
    edges: torch.Tensor,  # (L, E, 2) int32
    edge_mask: torch.Tensor,  # (L, E)
    camera_pose: torch.Tensor,  # (B, 3, 4) per-env E @ world->car
    K: torch.Tensor,  # (3, 3) shared intrinsics
    resolution: Tuple[int, int],
    max_range: Optional[float],
):
    """All layers of all envs at once: ((B, L, E) u0, v0, u1, v1 pixel
    coords and a (B, L, E) draw mask), every coordinate its own tensor.

    Reference capture_frame (camera.py:52-110): lift nodes to z=0 and
    transform by the pose; clip edges straddling the near plane to
    z = -1e-7 and edges straddling the range to z = -max_range; project
    through K with a true divide; an endpoint is visible iff in front, in
    range and strictly inside the frame, and an edge is drawn iff either
    endpoint is. Same arithmetic as tinycarlo_tpu.camera's SoA version,
    including its per-edge clipping (see project_layer's docstring there).
    """
    h, w = resolution
    e0 = edges[..., 0].long()
    e1 = edges[..., 1].long()
    ex0 = torch.gather(nodes[..., 0], -1, e0)
    ey0 = torch.gather(nodes[..., 1], -1, e0)
    ex1 = torch.gather(nodes[..., 0], -1, e1)
    ey1 = torch.gather(nodes[..., 1], -1, e1)

    def coef(r, c):
        return camera_pose[:, r, c][:, None, None]  # (B, 1, 1)

    def to_cam(x, y):
        cx = coef(0, 0) * x + coef(0, 1) * y + coef(0, 3)
        cy = coef(1, 0) * x + coef(1, 1) * y + coef(1, 3)
        cz = coef(2, 0) * x + coef(2, 1) * y + coef(2, 3)
        return cx, cy, cz  # (B, L, E) each

    def clip_to(move, keep, target_z):
        """Move `move` along the segment toward `keep` to depth target_z."""
        mx, my, mz = move
        kx, ky, kz = keep
        dz = kz - mz
        t = (target_z - mz) / torch.where(dz == 0, 1.0, dz)
        return mx + t * (kx - mx), my + t * (ky - my), torch.full_like(mz, target_z)

    def select3(c, new, old):
        return tuple(torch.where(c, n, o) for n, o in zip(new, old))

    a = to_cam(ex0, ey0)
    b = to_cam(ex1, ey1)
    front0 = a[2] < 0
    front1 = b[2] < 0
    clip0 = (~front0) & front1
    clip1 = front0 & (~front1)
    a = select3(clip0, clip_to(a, b, NEAR_EPS), a)
    b = select3(clip1, clip_to(b, a, NEAR_EPS), b)
    front0 = front0 | clip0
    front1 = front1 | clip1

    if max_range is not None:
        zmax = -max_range
        in0 = a[2] > zmax
        in1 = b[2] > zmax
        rclip0 = (~in0) & in1
        rclip1 = in0 & (~in1)
        a = select3(rclip0, clip_to(a, b, zmax), a)
        b = select3(rclip1, clip_to(b, a, zmax), b)
        in0 = in0 | rclip0
        in1 = in1 | rclip1
    else:
        in0 = torch.ones_like(front0)
        in1 = torch.ones_like(front1)

    fx, fy = K[0, 0], K[1, 1]
    cx_, cy_ = K[0, 2], K[1, 2]
    skew = K[0, 1]

    def proj(p):
        # a true divide (not a reciprocal multiply), as camera.py:251-258
        x, y, z = p
        zs = torch.where(z == 0, 1.0, z)
        u = (fx * x + skew * y + cx_ * z) / zs
        v = (fy * y + cy_ * z) / zs
        return u, v

    u0, v0 = proj(a)
    u1, v1 = proj(b)

    def in_frame(u, v):
        return (u > 0) & (u < w) & (v > 0) & (v < h)

    vis0 = in_frame(u0, v0) & front0 & in0
    vis1 = in_frame(u1, v1) & front1 & in1
    draw = edge_mask & (vis0 | vis1)
    return u0, v0, u1, v1, draw


def project_layers_batch(
    nodes: torch.Tensor,
    edges: torch.Tensor,
    edge_mask: torch.Tensor,
    camera_pose: torch.Tensor,
    K: torch.Tensor,
    resolution: Tuple[int, int],
    max_range: Optional[float],
):
    """`project_layers_batch_soa` with the endpoints stacked into
    ((B, L, E, 2) p0 / p1, (B, L, E) draw) point tensors for callers that
    index points (tinycarlo_tpu/camera.py:272-290)."""
    u0, v0, u1, v1, draw = project_layers_batch_soa(
        nodes, edges, edge_mask, camera_pose, K, resolution, max_range
    )
    return torch.stack([u0, v0], dim=-1), torch.stack([u1, v1], dim=-1), draw


def _point_on_line_at_z(p_keep, p_move, target_z):
    """Move p_move along the segment (p_keep, p_move) to depth target_z
    (reference camera.py:112-122, arguments in its keep/move order)."""
    direction = p_keep - p_move
    dz = direction[..., 2]
    t = (target_z - p_move[..., 2]) / torch.where(dz == 0, 1.0, dz)
    return p_move + t[..., None] * direction


def project_layer(
    nodes: torch.Tensor,  # (..., N, 2) map nodes
    edges: torch.Tensor,  # (..., E, 2) int32
    edge_mask: torch.Tensor,  # (..., E)
    camera_pose: torch.Tensor,  # (..., 3, 4) E @ world->car
    K: torch.Tensor,  # (3, 3)
    resolution: Tuple[int, int],
    max_range: Optional[float],
):
    """Project laneline layers into image-space segments in point form, as
    tinycarlo_tpu's `project_layer` (camera.py:311-370) does one layer of
    one env; the leading axes of the arguments broadcast (nodes (L, N, 2)
    with a pose (B, 1, 3, 4) projects every layer of B envs).

    Returns (p0, p1, draw): (..., E, 2) pixel endpoints and an (..., E)
    draw mask. Same steps as `project_layers_batch_soa`, in the JAX
    function's form: nodes lifted to z = 0 and transformed by the pose as
    one matrix product, each edge's endpoints gathered from them, per-edge
    near-plane (z = -1e-7) and range (z = -max_range) clips, the
    projection through K as a matrix product and a true divide; an
    endpoint is visible iff in front, in range and strictly inside the
    frame, an edge drawn iff either endpoint is."""
    h, w = resolution
    pts = torch.cat(
        [nodes, torch.zeros_like(nodes[..., :1]),
         torch.ones_like(nodes[..., :1])], dim=-1,
    )
    cam = pts @ camera_pose.transpose(-1, -2)  # (..., N, 3)
    lead = cam.shape[:-2]
    e = edges.shape[-2]

    def endpoint(i):
        sel = edges[..., i].long().expand(*lead, e)
        return torch.gather(cam, -2, sel[..., None].expand(*lead, e, 3))

    p0, p1 = endpoint(0), endpoint(1)
    front0 = p0[..., 2] < 0
    front1 = p1[..., 2] < 0
    clip0 = (~front0) & front1
    clip1 = front0 & (~front1)
    p0 = torch.where(clip0[..., None], _point_on_line_at_z(p1, p0, NEAR_EPS),
                     p0)
    p1 = torch.where(clip1[..., None], _point_on_line_at_z(p0, p1, NEAR_EPS),
                     p1)
    front0 = front0 | clip0
    front1 = front1 | clip1

    if max_range is not None:
        zmax = -max_range
        in0 = p0[..., 2] > zmax
        in1 = p1[..., 2] > zmax
        rclip0 = (~in0) & in1
        rclip1 = in0 & (~in1)
        p0 = torch.where(rclip0[..., None], _point_on_line_at_z(p1, p0, zmax),
                         p0)
        p1 = torch.where(rclip1[..., None], _point_on_line_at_z(p0, p1, zmax),
                         p1)
        in0 = in0 | rclip0
        in1 = in1 | rclip1
    else:
        in0 = torch.ones_like(front0)
        in1 = torch.ones_like(front1)

    def proj(p):
        uvw = p @ K.T
        safe_w = torch.where(uvw[..., 2] == 0, 1.0, uvw[..., 2])
        return uvw[..., :2] / safe_w[..., None]

    uv0, uv1 = proj(p0), proj(p1)

    def in_frame(uv):
        return ((uv[..., 0] > 0) & (uv[..., 0] < w) & (uv[..., 1] > 0)
                & (uv[..., 1] < h))

    vis0 = in_frame(uv0) & front0 & in0
    vis1 = in_frame(uv1) & front1 & in1
    draw = edge_mask & (vis0 | vis1)
    return uv0, uv1, draw
