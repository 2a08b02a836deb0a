"""Kinematic bicycle-model car, batched over a leading B axis.

Counterpart of tinycarlo_tpu/car.py (reference: tinycarlo/car.py). The
state is a dataclass of (B, ...) tensors and every function steps the
whole batch at once. Data-dependent control flow -- the local-path graph
walk, the u-turn re-snap, truncation early-returns -- is masked
fixed-shape selects, so a step never waits on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple

import torch

from tinycarlo_torch import geometry as geo
from tinycarlo_torch.config import CarConfig
from tinycarlo_torch.map_compiler import MapData
from tinycarlo_torch.utils.helper import clip_angle

LOOKAHEAD = 3  # reference find_local_path default (tinycarlo/car.py:127)
PATH_LEN = LOOKAHEAD + 1


@dataclass
class CarState:
    position: torch.Tensor  # (B, 2) middle of rear axle, meters
    position_front: torch.Tensor  # (B, 2) middle of front axle
    rotation: torch.Tensor  # (B,) yaw in [-pi, pi]
    steering_angle: torch.Tensor  # (B,) degrees (post rate-limit)
    radius: torch.Tensor  # (B,) turn radius of last step
    velocity: torch.Tensor  # (B,) m/s (post rate-limit)
    local_path: torch.Tensor  # (B, PATH_LEN, 2) int32 lanepath edges
    local_path_len: torch.Tensor  # (B,) int32 valid prefix length
    last_maneuver: torch.Tensor  # (B,) int32


def _front(position, rotation, wheelbase):
    return torch.stack(
        [
            position[:, 0] + wheelbase * torch.cos(rotation),
            position[:, 1] + wheelbase * torch.sin(rotation),
        ],
        dim=-1,
    )


def car_reset(
    map_data: MapData, cfg: CarConfig, spawn_row: torch.Tensor
) -> CarState:
    """Reset each car to its spawn-table row `spawn_row` (B,) (the caller
    samples the rows). Mirrors reference Car.reset (tinycarlo/car.py:34-44):
    local_path starts as just the spawn edge, steering/velocity zeroed."""
    sp = map_data.spawns
    position = sp.position[spawn_row]
    rotation = sp.rotation[spawn_row]
    edge = sp.edge[spawn_row]
    zero = torch.zeros_like(rotation)
    ones = torch.ones(rotation.shape, dtype=torch.int32, device=rotation.device)
    return CarState(
        position=position,
        position_front=_front(position, rotation, cfg.wheelbase),
        rotation=rotation,
        steering_angle=zero,
        radius=zero,
        velocity=zero,
        local_path=edge[:, None, :].expand(-1, PATH_LEN, 2).contiguous(),
        local_path_len=ones,
        last_maneuver=torch.zeros_like(ones),
    )


def car_step(
    map_data: MapData,
    cfg: CarConfig,
    T: float,
    state: CarState,
    velocity_cmd: torch.Tensor,  # (B,)
    steering_cmd: torch.Tensor,  # (B,)
    maneuver: torch.Tensor,  # (B,) int
) -> Tuple[CarState, torch.Tensor]:
    """One dt of bicycle kinematics + local-path tracking; returns
    (new_state, truncated (B,) bool).

    Scaling, rate limits and the exact-arc pose integration mirror
    reference Car.step (tinycarlo/car.py:70-125) with its quirks: the
    rotation is wrapped with a single correction, only on the arc branch.
    """
    dt = T
    new_velocity = velocity_cmd * cfg.max_velocity
    if cfg.max_acceleration is not None:
        # Reference gates on max_acceleration alone (car.py:83) and then
        # uses max_deceleration unconditionally; configs always set both.
        new_velocity = torch.clamp(
            new_velocity,
            state.velocity - cfg.max_deceleration * dt,
            state.velocity + cfg.max_acceleration * dt,
        )
    new_steering = steering_cmd * cfg.max_steering_angle
    if cfg.steering_speed is not None:
        new_steering = torch.clamp(
            new_steering,
            state.steering_angle - cfg.steering_speed * dt,
            state.steering_angle + cfg.steering_speed * dt,
        )

    vxn = torch.cos(state.rotation)
    vyn = torch.sin(state.rotation)
    straight = torch.abs(new_steering) < 0.0001  # reference car.py:95
    px, py = state.position[:, 0], state.position[:, 1]

    # Straight branch (car.py:95-99).
    pos_straight = torch.stack(
        [px + new_velocity * vxn * dt, py + new_velocity * vyn * dt], dim=-1
    )

    # Arc branch (car.py:101-122), with a div-safe steering angle.
    steer_safe = torch.where(straight, 1.0, new_steering)
    radius = cfg.wheelbase / torch.tan(steer_safe * (math.pi / 180))
    ang_vel = new_velocity / radius
    dyaw = ang_vel * dt
    nx, ny = vyn, -vxn
    tx = nx * radius
    ty = ny * radius
    c, s = torch.cos(dyaw), torch.sin(dyaw)
    rot_x = c * tx + (-s) * ty
    rot_y = s * tx + c * ty
    pos_arc = torch.stack([px - tx + rot_x, py - ty + rot_y], dim=-1)
    rot_arc = state.rotation + dyaw
    rot_arc = torch.where(rot_arc > math.pi, rot_arc - 2 * math.pi, rot_arc)
    rot_arc = torch.where(rot_arc < -math.pi, rot_arc + 2 * math.pi, rot_arc)

    new_rotation = torch.where(straight, state.rotation, rot_arc)
    state = replace(
        state,
        position=torch.where(straight[:, None], pos_straight, pos_arc),
        rotation=new_rotation,
        steering_angle=new_steering,
        velocity=new_velocity,
        radius=torch.where(straight, 0.0, radius),
    )
    state = replace(
        state,
        position_front=_front(state.position, new_rotation, cfg.wheelbase),
    )
    return find_local_path(map_data, state, maneuver)


def find_local_path(
    map_data: MapData, state: CarState, maneuver: torch.Tensor
) -> Tuple[CarState, torch.Tensor]:
    """Masked fixed-shape reference find_local_path (tinycarlo/car.py:127-148),
    batched. maneuver: 0 straight, 1 right, 2 u-turn, 3 left.

    The desired direction is the current edge orientation plus
    maneuver * pi/2. A fresh u-turn re-snaps to the nearest
    opposite-orientation edge, otherwise the car walks to the nearest
    connected edge; the path then extends LOOKAHEAD edges. Any dead end
    truncates; a failed first hop keeps the previous path and
    last_maneuver, a failed extension keeps the partial path.

    The JAX package gates the O(E) re-snap scan behind a batch-level
    `lax.cond` (vector.py:119-123, car.py:219-224). Here the scan runs for
    every car on every step and a mask selects its result, so the step
    never waits on the host to decide.
    """
    lp = map_data.lanepath
    maneuver = maneuver.to(torch.int32)
    cur_edge = state.local_path[:, 0]
    base_dir = clip_angle(
        geo.edge_orientations(lp.nodes, cur_edge)
        + maneuver.to(lp.nodes.dtype) * (math.pi / 2)
    )
    is_uturn_entry = (maneuver == 2) & (state.last_maneuver != 2)

    # U-turn re-snap (car.py:130-133), computed unconditionally.
    ut_idx = geo.nearest_edge_with_orientation_idx(
        lp.nodes, lp.edges, lp.edge_mask, state.position_front, base_dir
    )
    ut_edge = lp.edges[torch.clamp_min(ut_idx, 0)]
    ut_valid = ut_idx >= 0

    # Connected-edge walk (car.py:135-137).
    conn_edge, conn_valid = geo.nearest_connected_edge(
        lp.nodes, state.position_front, cur_edge, base_dir,
        lp.next_table, lp.next_count, lp.prev_table, lp.prev_count,
    )

    first_edge = torch.where(is_uturn_entry[:, None], ut_edge, conn_edge)
    first_valid = torch.where(is_uturn_entry, ut_valid, conn_valid)
    # After a u-turn re-snap the target direction flips (car.py:133).
    walk_dir = torch.where(
        is_uturn_entry, clip_angle(base_dir + math.pi), base_dir
    )

    # Fixed-iteration lookahead extension (car.py:140-148).
    path = [first_edge]
    cur = first_edge
    ok = first_valid
    length = torch.ones_like(state.local_path_len)
    fwd = state.velocity > 0
    for _ in range(LOOKAHEAD):
        base = torch.where(fwd, cur[:, 1], cur[:, 0])
        nxt = geo.pick_node_given_orientation(
            lp.nodes, base, walk_dir, lp.next_table[base], lp.next_count[base]
        )
        step_ok = ok & (nxt >= 0)
        hop = torch.stack([base, nxt], dim=-1)
        cur = torch.where(step_ok[:, None], hop, cur)
        path.append(cur)
        length = length + step_ok.to(torch.int32)
        ok = step_ok

    new_path = torch.stack(path, dim=1).to(torch.int32)
    truncated = ~ok

    # A failed first hop leaves path & last_maneuver untouched (car.py:136-137).
    state = replace(
        state,
        local_path=torch.where(
            first_valid[:, None, None], new_path, state.local_path
        ),
        local_path_len=torch.where(first_valid, length, state.local_path_len),
        last_maneuver=torch.where(first_valid, maneuver, state.last_maneuver),
    )
    return state, truncated


def car_info(map_data: MapData, cfg: CarConfig, state: CarState):
    """Cross-track error, heading error and per-laneline distances, batched.

    Mirrors reference Car.get_info (tinycarlo/car.py:46-67) with its mixed
    use of rear/front positions and the all-zeros "empty info" for local
    paths shorter than 2 edges. The per-laneline nearest-edge scan runs
    once over the packed edge axis with a first-wins argmin per layer over
    the static layer slices (tinycarlo_tpu.car.car_info's packed path,
    car.py:398-479).

    Returns a dict: cte (B,), heading_error (B,), laneline_distances
    (B, L), local_path (B, PATH_LEN, 2) coords, local_path_len (B,),
    velocity (B,).
    """
    lp = map_data.lanepath
    has_path = state.local_path_len >= 2

    ref_edge = state.local_path[:, 1]
    cte = geo.signed_distance_to_edge(lp.nodes, ref_edge, state.position_front)
    heading_error = clip_angle(
        geo.edge_orientations(lp.nodes, ref_edge) - state.rotation
    )

    pn = map_data.packed_nodes[0]
    pe = map_data.packed_edges[0]
    p0, p1 = geo.edge_endpoints(pn, pe)
    pos = state.position[:, None, :]
    d = torch.abs(geo.distance(pos, p0) + geo.distance(pos, p1))  # (B, Ep)
    bounds = map_data.packed_layer_bounds
    ne_idx = torch.stack(
        [
            torch.argmin(d[:, bounds[l]: bounds[l + 1]], dim=-1) + bounds[l]
            if bounds[l + 1] > bounds[l]
            # edgeless layer: the masked-argmin fallback (first index)
            else torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)
            for l in range(map_data.n_layers)
        ],
        dim=-1,
    )  # (B, L) packed-edge indices
    ne = pe[ne_idx]  # (B, L, 2)
    inside = geo.within_edge_bounds(pn, ne, pos)
    d_perp = torch.abs(geo.signed_distance_to_edge(pn, ne, pos))
    d_node = torch.minimum(
        geo.distance(pos, pn[ne[..., 0]]),
        geo.distance(state.position_front[:, None, :], pn[ne[..., 1]]),
    )
    distances = torch.where(inside, d_perp, d_node)

    return {
        "cte": torch.where(has_path, cte, 0.0),
        "heading_error": torch.where(has_path, heading_error, 0.0),
        "laneline_distances": torch.where(has_path[:, None], distances, 0.0),
        "local_path": lp.nodes[state.local_path[:, :, 1]],
        "local_path_len": torch.where(has_path, state.local_path_len, 0),
        "velocity": torch.where(has_path, state.velocity, 0.0),
    }
