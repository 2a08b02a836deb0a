"""The traffic's controller: Stanley steering from a car's own state.

The rollout cells steer every car with it, on the card inside the
captured step; the reference computes the same action from the recorded
state. It reads the state only (the rear and front axles, the yaw and
the local path's reference edge), as upstream's Stanley expert reads the
env's cte and heading error (upstream examples/stanley_control.py:52-63).
"""
from __future__ import annotations

import math

import torch

from portbench.reference.sim import clip_angle, edge_ori, signed_dist


def stanley(nodes, front, rotation, local_path, path_len, speed: float,
            k: float, max_steering_angle: float):
    """(B,) steering command in [-1, 1]: (heading error + atan2(k cte,
    speed)) in degrees over the largest steering angle, where cte and the
    heading error are taken against the local path's second edge, and are
    0 for a path shorter than two edges."""
    ref = local_path[:, 1].long()
    has = path_len >= 2
    cte = torch.where(has, signed_dist(nodes, ref, front), 0.0)
    he = torch.where(has, clip_angle(edge_ori(nodes, ref) - rotation), 0.0)
    corr = torch.atan2(k * cte, torch.full_like(cte, speed))
    return torch.clamp((he + corr) * (180.0 / math.pi) / max_steering_angle,
                       -1.0, 1.0)


def maneuvers(kind: str, step, env_ids):
    """(B,) int32 maneuver: "straight" 0 everywhere, "cycle" (step + env) % 4
    (straight, right, u-turn, left: a u-turn entry every step)."""
    if kind == "straight":
        return torch.zeros_like(env_ids)
    if kind == "cycle":
        return torch.remainder(step + env_ids, 4).to(env_ids.dtype)
    raise ValueError(f"unknown maneuver schedule {kind!r}")
