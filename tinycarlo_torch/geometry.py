"""Batched polyline-graph geometry queries.

Counterpart of tinycarlo_tpu/geometry.py:94-298 (the reference's `Layer`
class, tinycarlo/layer.py). Every query is a masked reduction over
fixed-shape padded tensors, written with the batch axis out front:
positions, orientations and node indices carry any leading shape and
broadcast against the (N, 2) node and (E, 2) edge tables.

Conventions (as in the JAX package):
  * "first wins" tie-breaking: `torch.argmin` returns the first minimal
    index, matching the reference's `list.index(min(...))`;
  * invalid results are encoded as index -1 (the reference returns None).

The JAX package's `take_rows` routes small-table lookups through a
one-hot matrix multiply for the TPU's matrix unit; here a lookup is plain
indexing.
"""
from __future__ import annotations

import math

import torch

from tinycarlo_torch.utils.helper import clip_angle

_BIG = math.inf


def distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance between points; broadcasts over leading dims.

    Reference: tinycarlo/layer.py:187.
    """
    d = a - b
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def edge_endpoints(nodes: torch.Tensor, edges: torch.Tensor):
    """Gather (src, dst) coordinates for every edge: two (..., 2) tensors."""
    return nodes[edges[..., 0]], nodes[edges[..., 1]]


def edge_orientations(nodes: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """atan2 orientation of each edge. Reference: tinycarlo/layer.py:179-181."""
    p0, p1 = edge_endpoints(nodes, edges)
    return torch.atan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])


def _masked_argmin(d: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.argmin(torch.where(valid, d, _BIG), dim=-1)


def nearest_edge_idx(
    nodes: torch.Tensor,
    edges: torch.Tensor,
    edge_mask: torch.Tensor,
    position: torch.Tensor,  # (..., 2)
) -> torch.Tensor:
    """Index of the nearest edge: argmin of summed endpoint distances.
    Reference: tinycarlo/layer.py:33-44."""
    p0, p1 = edge_endpoints(nodes, edges)
    pos = position[..., None, :]
    d = torch.abs(distance(pos, p0) + distance(pos, p1))
    return _masked_argmin(d, edge_mask)


def nearest_node_idx(
    nodes: torch.Tensor, node_mask: torch.Tensor, position: torch.Tensor
) -> torch.Tensor:
    """Index of the nearest node. Reference: tinycarlo/layer.py:46-57."""
    return _masked_argmin(distance(position[..., None, :], nodes), node_mask)


def nearest_edge_with_orientation_idx(
    nodes: torch.Tensor,  # (N, 2)
    edges: torch.Tensor,  # (E, 2)
    edge_mask: torch.Tensor,  # (E,)
    position: torch.Tensor,  # (..., 2)
    orientation: torch.Tensor,  # (...)
    margin_deg: float = 30.0,
) -> torch.Tensor:
    """Nearest edge whose orientation is within +/- margin of `orientation`;
    -1 when no edge qualifies (reference tinycarlo/layer.py:59-74 returns
    None). Distance is the sum of endpoint distances (layer.py:33-44)."""
    ori = edge_orientations(nodes, edges)
    within = (
        torch.abs(clip_angle(ori - orientation[..., None]))
        <= math.radians(margin_deg)
    )
    valid = within & edge_mask
    p0, p1 = edge_endpoints(nodes, edges)
    pos = position[..., None, :]
    d = torch.abs(distance(pos, p0) + distance(pos, p1))
    idx = _masked_argmin(d, valid)
    return torch.where(valid.any(dim=-1), idx, -1)


def signed_distance_to_edge(
    nodes: torch.Tensor, edge: torch.Tensor, position: torch.Tensor
) -> torch.Tensor:
    """Signed perpendicular distance from `position` to the edge's line,
    positive to the right, with the reference's vertical-line special case
    (and its zero-length-edge quirk). Reference: tinycarlo/layer.py:144-164.
    """
    n1 = nodes[edge[..., 0]]
    n2 = nodes[edge[..., 1]]
    lv = n2 - n1
    pv = position - n1
    vertical = lv[..., 0] == 0
    vertical_d = torch.where(
        lv[..., 1] > 0,
        position[..., 0] - n1[..., 0],
        n1[..., 0] - position[..., 0],
    )
    denom = torch.sqrt(lv[..., 0] * lv[..., 0] + lv[..., 1] * lv[..., 1])
    safe_denom = torch.where(vertical & (lv[..., 1] == 0), 1.0, denom)
    cross = pv[..., 0] * lv[..., 1] - pv[..., 1] * lv[..., 0]
    return torch.where(vertical, vertical_d, cross / safe_denom)


def distance_to_node(
    nodes: torch.Tensor, node_idx: torch.Tensor, position: torch.Tensor
) -> torch.Tensor:
    """Distance to a node by index. Reference: tinycarlo/layer.py:166-177."""
    return distance(position, nodes[node_idx])


def within_edge_bounds(
    nodes: torch.Tensor, edge: torch.Tensor, position: torch.Tensor
) -> torch.Tensor:
    """Is `position` inside the slab spanned perpendicular to the edge?
    The reference's atan2 formulation with early-True at the endpoints
    (tinycarlo/layer.py:126-142), kept for its behaviour on degenerate
    (zero-length) edges -- see tinycarlo_tpu.geometry.within_edge_bounds.
    """
    n0 = nodes[edge[..., 0]]
    n1 = nodes[edge[..., 1]]
    ev = n1 - n0
    v0 = position - n0
    v1 = position - n1
    a0 = torch.abs(
        clip_angle(
            torch.atan2(v0[..., 1], v0[..., 0])
            - torch.atan2(ev[..., 1], ev[..., 0])
        )
    )
    a1 = torch.abs(
        clip_angle(
            torch.atan2(v1[..., 1], v1[..., 0])
            - torch.atan2(-ev[..., 1], -ev[..., 0])
        )
    )
    at_n0 = (position[..., 0] == n0[..., 0]) & (position[..., 1] == n0[..., 1])
    at_n1 = (position[..., 0] == n1[..., 0]) & (position[..., 1] == n1[..., 1])
    half_pi = math.pi / 2
    return at_n0 | at_n1 | ((a0 <= half_pi) & (a1 <= half_pi))


def pick_node_given_orientation(
    nodes: torch.Tensor,  # (N, 2)
    node_idx: torch.Tensor,  # (...)
    orientation: torch.Tensor,  # (...)
    candidates: torch.Tensor,  # (..., D) adjacency rows, -1 padded
    candidate_count: torch.Tensor,  # (...)
) -> torch.Tensor:
    """Pick from `candidates` the node whose direction from `node_idx` best
    matches `orientation`: empty -> -1, a single candidate without an
    orientation check, otherwise the first-wins argmin of the wrapped
    angle difference. Reference: tinycarlo/layer.py:105-124.
    """
    n = nodes[node_idx][..., None, :]
    cand_pos = nodes[torch.clamp_min(candidates, 0)]
    ori = torch.atan2(
        cand_pos[..., 1] - n[..., 1], cand_pos[..., 0] - n[..., 0]
    )
    diff = torch.abs(clip_angle(ori - orientation[..., None]))
    best = _masked_argmin(diff, candidates >= 0)
    picked = torch.where(
        candidate_count > 1,
        torch.gather(candidates, -1, best[..., None])[..., 0],
        candidates[..., 0],
    )
    return torch.where(candidate_count == 0, -1, picked)


def nearest_connected_edge(
    nodes: torch.Tensor,
    position: torch.Tensor,  # (..., 2)
    edge: torch.Tensor,  # (..., 2)
    orientation: torch.Tensor,  # (...)
    next_table: torch.Tensor,
    next_count: torch.Tensor,
    prev_table: torch.Tensor,
    prev_count: torch.Tensor,
):
    """One-hop graph walk toward `position` from `edge`: returns
    ((..., 2) int32 edge, valid bool). Invalid when either side has no
    neighbour (reference returns None); otherwise step forward if the
    successor is strictly nearer than both endpoints, backward if the
    predecessor is, else keep. Reference: tinycarlo/layer.py:77-103.
    """
    src = edge[..., 0]
    dst = edge[..., 1]
    next_node = pick_node_given_orientation(
        nodes, dst, orientation, next_table[dst], next_count[dst]
    )
    prev_node = pick_node_given_orientation(
        nodes, src, orientation, prev_table[src], prev_count[src]
    )
    valid = (next_node >= 0) & (prev_node >= 0)

    d0 = distance(position, nodes[src])
    d1 = distance(position, nodes[dst])
    dn = distance(position, nodes[torch.clamp_min(next_node, 0)])
    dp = distance(position, nodes[torch.clamp_min(prev_node, 0)])

    fwd = (dn < d0) & (dn < d1)
    bwd = (dp < d0) & (dp < d1) & ~fwd
    out_src = torch.where(fwd, dst, torch.where(bwd, prev_node, src))
    out_dst = torch.where(fwd, next_node, torch.where(bwd, src, dst))
    return torch.stack([out_src, out_dst], dim=-1).to(torch.int32), valid
