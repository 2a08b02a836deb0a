"""The plain reference of the simulator: map, car, info, shaping, camera
and the dense rasterizer, in plain PyTorch with no kernel, no compaction,
no padding and no graph.

It follows the upstream tinycarlo semantics as the port states them, and
is a frozen rewrite of the port's plain code at commit 6c117b9:
tinycarlo_torch/map_compiler.py (lanepath adjacency, spawn table),
car.py (car_reset, car_step, find_local_path, car_info without the
LanelineGrid), geometry.py, camera.py (matrices and the per-edge
projection), env.py (reward, termination) and ops/rasterize.py (the
calibrated split stroke at line thickness >= 2, the rank and rgb
decodes). It imports nothing of the port, so a later change to the port
cannot move it.

Every function takes a batch of K cars along a leading axis. `dtype`
sets the arithmetic: float32 is the configurations' precision; the
control computes the same in bfloat16.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

LOOKAHEAD = 3
PATH_LEN = LOOKAHEAD + 1
NEAR_EPS = -1e-7
ENDPOINT_LIMIT = 1_000_000.0


def clip_angle(a):
    for _ in range(2):
        a = torch.where(a > math.pi, a - 2 * math.pi, a)
    for _ in range(2):
        a = torch.where(a < -math.pi, a + 2 * math.pi, a)
    return a


def dist(a, b):
    d = a - b
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


@dataclass
class Map:
    """A map json scaled to meters, held in `dtype` (the program holds its
    map in the configuration's float32)."""

    nodes: torch.Tensor  # (N, 2) lanepath nodes
    edges: torch.Tensor  # (E, 2) long
    next_table: torch.Tensor  # (N, D) long, -1 padded, edge order
    next_count: torch.Tensor
    prev_table: torch.Tensor
    prev_count: torch.Tensor
    spawn_node: torch.Tensor  # (S,) long
    spawn_pos: torch.Tensor  # (S, 2)
    spawn_rot: torch.Tensor  # (S,)
    spawn_edge: torch.Tensor  # (S, 2) long
    layer_nodes: List[torch.Tensor]  # per laneline layer (Nl, 2)
    layer_edges: List[torch.Tensor]  # (El, 2) long
    colors: torch.Tensor  # (L, 3) long, rgb
    names: tuple
    spawn_points: Optional[tuple]


def load_map(path: str, pixel_per_meter: float, spawn_points=None,
             dtype=torch.float32, device="cpu") -> Map:
    with open(path) as f:
        raw = json.load(f)
    ppm = float(pixel_per_meter)

    def scaled(nodes):
        # scaled in float64, then held in `dtype`, as the program holds it
        t = torch.tensor(nodes, dtype=torch.float64).reshape(-1, 2) / ppm
        return t.to(dtype).to(device)

    lp_nodes = scaled(raw["lanepath"]["nodes"])
    lp_edges = torch.tensor(raw["lanepath"]["edges"],
                            dtype=torch.long).reshape(-1, 2)
    n = lp_nodes.shape[0]
    nxt = [[] for _ in range(n)]
    prv = [[] for _ in range(n)]
    for s, d in lp_edges.tolist():
        nxt[s].append(d)
        prv[d].append(s)
    deg = max([1] + [len(x) for x in nxt] + [len(x) for x in prv])

    def table(lists):
        t = torch.full((n, deg), -1, dtype=torch.long)
        for i, row in enumerate(lists):
            t[i, :len(row)] = torch.tensor(row, dtype=torch.long)
        return t.to(device), torch.tensor([len(r) for r in lists],
                                          device=device)

    next_table, next_count = table(nxt)
    prev_table, prev_count = table(prv)
    cands = (list(spawn_points) if spawn_points is not None
             else list(range(max(0, n - 1))))
    raw_nodes = torch.tensor(raw["lanepath"]["nodes"],
                             dtype=torch.float64).reshape(-1, 2) / ppm
    rows = []
    for idx in cands:
        if not nxt[idx]:
            continue
        p, q = raw_nodes[idx], raw_nodes[nxt[idx][0]]
        rows.append((idx, float(p[0]), float(p[1]),
                     math.atan2(float(q[1] - p[1]), float(q[0] - p[0])),
                     nxt[idx][0]))
    if not rows:
        raise ValueError("map has no spawn node with a successor")
    layers = raw["lanelines"]
    return Map(
        nodes=lp_nodes, edges=lp_edges.to(device),
        next_table=next_table, next_count=next_count,
        prev_table=prev_table, prev_count=prev_count,
        spawn_node=torch.tensor([r[0] for r in rows], device=device),
        spawn_pos=torch.tensor([[r[1], r[2]] for r in rows],
                               dtype=torch.float64).to(dtype).to(device),
        spawn_rot=torch.tensor([r[3] for r in rows],
                               dtype=torch.float64).to(dtype).to(device),
        spawn_edge=torch.tensor([[r[0], r[4]] for r in rows],
                                device=device),
        layer_nodes=[scaled(l["nodes"]) for l in layers.values()],
        layer_edges=[torch.tensor(l["edges"], dtype=torch.long)
                     .reshape(-1, 2).to(device) for l in layers.values()],
        colors=torch.tensor([l["layer_color"] for l in layers.values()],
                            device=device),
        names=tuple(layers),
        spawn_points=None if spawn_points is None else tuple(spawn_points),
    )


# -- the car ---------------------------------------------------------------

def front(pos, rot, wheelbase):
    return torch.stack([pos[:, 0] + wheelbase * torch.cos(rot),
                        pos[:, 1] + wheelbase * torch.sin(rot)], dim=-1)


def car_reset(m: Map, car: Dict, rows) -> Dict[str, torch.Tensor]:
    """Fresh cars at spawn-table rows `rows` (K,)."""
    pos, rot = m.spawn_pos[rows], m.spawn_rot[rows]
    edge = m.spawn_edge[rows]
    zero = torch.zeros_like(rot)
    return {"pos": pos, "front": front(pos, rot, car["wheelbase"]),
            "rot": rot, "steer": zero, "vel": zero.clone(),
            "path": edge[:, None, :].expand(-1, PATH_LEN, 2).clone(),
            "plen": torch.ones(rot.shape, dtype=torch.long,
                               device=rot.device),
            "lastm": torch.zeros(rot.shape, dtype=torch.long,
                                 device=rot.device)}


def edge_ori(nodes, e):
    p0, p1 = nodes[e[..., 0]], nodes[e[..., 1]]
    return torch.atan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])


def _argmin_valid(d, valid):
    return torch.argmin(torch.where(valid, d, math.inf), dim=-1)


def pick_node(nodes, node, ori, cand, count):
    n = nodes[node][..., None, :]
    cp = nodes[cand.clamp_min(0)]
    o = torch.atan2(cp[..., 1] - n[..., 1], cp[..., 0] - n[..., 0])
    diff = torch.abs(clip_angle(o - ori[..., None]))
    best = _argmin_valid(diff, cand >= 0)
    picked = torch.where(count > 1, cand.gather(-1, best[..., None])[..., 0],
                         cand[..., 0])
    return torch.where(count == 0, -1, picked)


def find_local_path(m: Map, s: Dict, maneuver):
    """The local-path walk (upstream car.py:127-148): a fresh u-turn
    re-snaps to the nearest edge within 30 degrees of the reversed
    direction, otherwise a one-hop walk; then LOOKAHEAD hops. Returns
    (state, truncated)."""
    nodes = m.nodes
    cur = s["path"][:, 0]
    base_dir = clip_angle(edge_ori(nodes, cur)
                          + maneuver.to(nodes.dtype) * (math.pi / 2))
    uturn = (maneuver == 2) & (s["lastm"] != 2)
    # u-turn re-snap: nearest edge (sum of endpoint distances) whose
    # orientation lies within 30 degrees of base_dir (only where a car
    # enters a u-turn: the result is used nowhere else)
    ut_edge, ut_valid = cur, torch.zeros_like(uturn)
    if bool(uturn.any()):
        eo = edge_ori(nodes, m.edges)
        within = (torch.abs(clip_angle(eo[None] - base_dir[:, None]))
                  <= math.radians(30.0))
        p0, p1 = nodes[m.edges[:, 0]], nodes[m.edges[:, 1]]
        fr = s["front"][:, None, :]
        d = torch.abs(dist(fr, p0) + dist(fr, p1))
        ut_idx = torch.where(within.any(-1), _argmin_valid(d, within), -1)
        ut_edge = m.edges[ut_idx.clamp_min(0)]
        ut_valid = ut_idx >= 0
    # one-hop walk (upstream layer.py:77-103)
    src, dst = cur[:, 0], cur[:, 1]
    nn = pick_node(nodes, dst, base_dir, m.next_table[dst], m.next_count[dst])
    pn = pick_node(nodes, src, base_dir, m.prev_table[src], m.prev_count[src])
    walk_valid = (nn >= 0) & (pn >= 0)
    pos = s["front"]
    d0, d1 = dist(pos, nodes[src]), dist(pos, nodes[dst])
    dn, dp = dist(pos, nodes[nn.clamp_min(0)]), dist(pos, nodes[pn.clamp_min(0)])
    fwd = (dn < d0) & (dn < d1)
    bwd = (dp < d0) & (dp < d1) & ~fwd
    walk = torch.stack([torch.where(fwd, dst, torch.where(bwd, pn, src)),
                        torch.where(fwd, nn, torch.where(bwd, src, dst))], -1)
    first = torch.where(uturn[:, None], ut_edge, walk)
    first_valid = torch.where(uturn, ut_valid, walk_valid)
    walk_dir = torch.where(uturn, clip_angle(base_dir + math.pi), base_dir)
    path, cur_e, ok = [first], first, first_valid
    length = torch.ones_like(s["plen"])
    going = s["vel"] > 0
    for _ in range(LOOKAHEAD):
        b = torch.where(going, cur_e[:, 1], cur_e[:, 0])
        nxt = pick_node(nodes, b, walk_dir, m.next_table[b], m.next_count[b])
        step_ok = ok & (nxt >= 0)
        cur_e = torch.where(step_ok[:, None], torch.stack([b, nxt], -1), cur_e)
        path.append(cur_e)
        length = length + step_ok.long()
        ok = step_ok
    new_path = torch.stack(path, 1)
    s = dict(s)
    s["path"] = torch.where(first_valid[:, None, None], new_path, s["path"])
    s["plen"] = torch.where(first_valid, length, s["plen"])
    s["lastm"] = torch.where(first_valid, maneuver, s["lastm"])
    return s, ~ok


def car_step(m: Map, car: Dict, dt: float, s: Dict, vel_cmd, steer_cmd,
             maneuver):
    """Kinematic bicycle step (upstream car.py:70-125), rate limits and the
    exact-arc integration, then the local-path walk."""
    v = vel_cmd * car["max_velocity"]
    if car.get("max_acceleration") is not None:
        v = torch.clamp(v, s["vel"] - car["max_deceleration"] * dt,
                        s["vel"] + car["max_acceleration"] * dt)
    st = steer_cmd * car["max_steering_angle"]
    if car.get("steering_speed") is not None:
        st = torch.clamp(st, s["steer"] - car["steering_speed"] * dt,
                         s["steer"] + car["steering_speed"] * dt)
    vx, vy = torch.cos(s["rot"]), torch.sin(s["rot"])
    straight = torch.abs(st) < 0.0001
    px, py = s["pos"][:, 0], s["pos"][:, 1]
    pos_s = torch.stack([px + v * vx * dt, py + v * vy * dt], -1)
    radius = car["wheelbase"] / torch.tan(
        torch.where(straight, 1.0, st) * (math.pi / 180))
    dyaw = v / radius * dt
    tx, ty = vy * radius, -vx * radius
    c, sn = torch.cos(dyaw), torch.sin(dyaw)
    pos_a = torch.stack([px - tx + (c * tx + (-sn) * ty),
                         py - ty + (sn * tx + c * ty)], -1)
    rot_a = s["rot"] + dyaw
    rot_a = torch.where(rot_a > math.pi, rot_a - 2 * math.pi, rot_a)
    rot_a = torch.where(rot_a < -math.pi, rot_a + 2 * math.pi, rot_a)
    new = dict(s)
    new["pos"] = torch.where(straight[:, None], pos_s, pos_a)
    new["rot"] = torch.where(straight, s["rot"], rot_a)
    new["steer"], new["vel"] = st, v
    new["front"] = front(new["pos"], new["rot"], car["wheelbase"])
    return find_local_path(m, new, maneuver.long())


def signed_dist(nodes, e, p):
    n1, n2 = nodes[e[..., 0]], nodes[e[..., 1]]
    lv, pv = n2 - n1, p - n1
    vertical = lv[..., 0] == 0
    vd = torch.where(lv[..., 1] > 0, p[..., 0] - n1[..., 0],
                     n1[..., 0] - p[..., 0])
    den = torch.sqrt(lv[..., 0] * lv[..., 0] + lv[..., 1] * lv[..., 1])
    den = torch.where(vertical & (lv[..., 1] == 0), 1.0, den)
    cross = pv[..., 0] * lv[..., 1] - pv[..., 1] * lv[..., 0]
    return torch.where(vertical, vd, cross / den)


def within_bounds(nodes_a, nodes_b, p):
    ev = nodes_b - nodes_a
    v0, v1 = p - nodes_a, p - nodes_b
    a0 = torch.abs(clip_angle(torch.atan2(v0[..., 1], v0[..., 0])
                              - torch.atan2(ev[..., 1], ev[..., 0])))
    a1 = torch.abs(clip_angle(torch.atan2(v1[..., 1], v1[..., 0])
                              - torch.atan2(-ev[..., 1], -ev[..., 0])))
    at0 = (p[..., 0] == nodes_a[..., 0]) & (p[..., 1] == nodes_a[..., 1])
    at1 = (p[..., 0] == nodes_b[..., 0]) & (p[..., 1] == nodes_b[..., 1])
    return at0 | at1 | ((a0 <= math.pi / 2) & (a1 <= math.pi / 2))


def car_info(m: Map, s: Dict, distances: bool = False) -> Dict:
    """cte, heading error (and per-laneline distances) of each car
    (upstream car.py:46-67): zeros when the path is shorter than 2."""
    has = s["plen"] >= 2
    ref = s["path"][:, 1]
    cte = signed_dist(m.nodes, ref, s["front"])
    he = clip_angle(edge_ori(m.nodes, ref) - s["rot"])
    out = {"cte": torch.where(has, cte, 0.0),
           "heading_error": torch.where(has, he, 0.0)}
    if distances:
        pos = s["pos"]
        cols = []
        for ln, le in zip(m.layer_nodes, m.layer_edges):
            a, b = ln[le[:, 0]], ln[le[:, 1]]
            d = torch.abs(dist(pos[:, None], a) + dist(pos[:, None], b))
            k = torch.argmin(d, dim=-1)
            na, nb = a[k], b[k]
            inside = within_bounds(na, nb, pos)
            lv, pv = nb - na, pos - na
            vertical = lv[..., 0] == 0
            vd = torch.where(lv[..., 1] > 0, pos[..., 0] - na[..., 0],
                             na[..., 0] - pos[..., 0])
            den = torch.sqrt(lv[..., 0] ** 2 + lv[..., 1] ** 2)
            den = torch.where(vertical & (lv[..., 1] == 0), 1.0, den)
            perp = torch.abs(torch.where(
                vertical, vd, (pv[..., 0] * lv[..., 1]
                               - pv[..., 1] * lv[..., 0]) / den))
            node = torch.minimum(dist(pos, na), dist(s["front"], nb))
            cols.append(torch.where(inside, perp, node))
        out["laneline_distances"] = torch.where(
            has[:, None], torch.stack(cols, -1), 0.0)
    return out


def shaping(car: Dict, cte):
    """Default reward and termination (upstream env.py:87-99)."""
    tw = car["track_width"]
    return torch.clamp_min((-1.0 / tw) * cte + 1.0, 0.0), cte > tw * 10


# -- the camera ------------------------------------------------------------

def rodrigues(r):
    theta = torch.sqrt(torch.sum(r * r))
    a = r / torch.where(theta == 0, 1.0, theta)
    c, s = torch.cos(theta), torch.sin(theta)
    z = torch.zeros((), dtype=r.dtype)
    skew = torch.stack([torch.stack([z, -a[2], a[1]]),
                        torch.stack([a[2], z, -a[0]]),
                        torch.stack([-a[1], a[0], z])])
    eye = torch.eye(3, dtype=r.dtype)
    out = c * eye + (1 - c) * torch.outer(a, a) + s * skew
    return torch.where(theta == 0, eye, out)


def camera_matrices(cam: Dict, dtype, device):
    """(E (3, 4), K (3, 3)) of upstream camera.py:145-178."""
    o = torch.tensor(cam["orientation"], dtype=dtype)
    p = torch.tensor(cam["position"], dtype=dtype)
    ang = (o + torch.tensor([-90.0, 0.0, 90.0], dtype=dtype)) * (math.pi / 180)
    r_pr = rodrigues(ang * torch.tensor([1.0, 1.0, 0.0], dtype=dtype))
    r_y = rodrigues(ang * torch.tensor([0.0, 0.0, 1.0], dtype=dtype))
    trans = torch.cat([torch.eye(3, dtype=dtype), -p[:, None]], dim=1)
    e = r_pr @ r_y @ trans
    h, w = cam["resolution"]
    fov = torch.tensor(float(cam["fov"]), dtype=dtype) * (math.pi / 180)
    fx, fy = w / (2 * torch.tan(fov / 2)), h / (2 * torch.tan(fov / 2))
    z, one = torch.zeros((), dtype=dtype), torch.ones((), dtype=dtype)
    k = torch.stack([torch.stack([fx, z, torch.tensor(w / 2, dtype=dtype)]),
                     torch.stack([z, fy, torch.tensor(h / 2, dtype=dtype)]),
                     torch.stack([z, z, one])])
    return e.to(device), k.to(device)


def camera_pose(e, pos, rot):
    """(K, 3, 4) extrinsic times each car's world-to-body transform
    (upstream car.py:159-165)."""
    c, s = torch.cos(-rot), torch.sin(-rot)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    r = torch.stack([torch.stack([c, -s, z, z], -1),
                     torch.stack([s, c, z, z], -1),
                     torch.stack([z, z, o, z], -1),
                     torch.stack([z, z, z, o], -1)], -2)
    t = torch.stack([torch.stack([o, z, z, -pos[:, 0]], -1),
                     torch.stack([z, o, z, -pos[:, 1]], -1),
                     torch.stack([z, z, o, z], -1),
                     torch.stack([z, z, z, o], -1)], -2)
    return torch.matmul(e, r @ t)


def project(nodes, edges, pose, k, resolution, max_range):
    """Pixel endpoints and draw mask of one layer's edges for one pose
    (upstream camera.py:52-122): near-plane and range clips per edge, a
    true divide, drawn iff an endpoint is in front, in range and strictly
    inside the frame."""
    h, w = resolution
    a0, a1 = nodes[edges[:, 0]], nodes[edges[:, 1]]

    def to_cam(p):
        return tuple(pose[r, 0] * p[:, 0] + pose[r, 1] * p[:, 1] + pose[r, 3]
                     for r in range(3))

    def clip_to(mv, kp, tz):
        dz = kp[2] - mv[2]
        t = (tz - mv[2]) / torch.where(dz == 0, 1.0, dz)
        return (mv[0] + t * (kp[0] - mv[0]), mv[1] + t * (kp[1] - mv[1]),
                torch.full_like(mv[2], tz))

    def sel(c, new, old):
        return tuple(torch.where(c, n, o) for n, o in zip(new, old))

    a, b = to_cam(a0), to_cam(a1)
    f0, f1 = a[2] < 0, b[2] < 0
    c0, c1 = ~f0 & f1, f0 & ~f1
    a = sel(c0, clip_to(a, b, NEAR_EPS), a)
    b = sel(c1, clip_to(b, a, NEAR_EPS), b)
    f0, f1 = f0 | c0, f1 | c1
    if max_range is not None:
        zmax = -max_range
        i0, i1 = a[2] > zmax, b[2] > zmax
        r0, r1 = ~i0 & i1, i0 & ~i1
        a = sel(r0, clip_to(a, b, zmax), a)
        b = sel(r1, clip_to(b, a, zmax), b)
        i0, i1 = i0 | r0, i1 | r1
    else:
        i0 = i1 = torch.ones_like(f0)

    def proj(p):
        x, y, zz = p
        zs = torch.where(zz == 0, 1.0, zz)
        return ((k[0, 0] * x + k[0, 1] * y + k[0, 2] * zz) / zs,
                (k[1, 1] * y + k[1, 2] * zz) / zs)

    u0, v0 = proj(a)
    u1, v1 = proj(b)

    def inside(u, v):
        return (u > 0) & (u < w) & (v > 0) & (v < h)

    draw = (inside(u0, v0) & f0 & i0) | (inside(u1, v1) & f1 & i1)
    return u0, v0, u1, v1, draw


def stroke_masks(u0, v0, u1, v1, draw, resolution, thickness):
    """(H, W) bool: the calibrated split stroke of upstream's cv2
    polylines at thickness >= 2: endpoints truncated to integers, a body
    of lateral halfwidth ceil(t/2) + 0.5 and round caps of radius
    ceil(t/2), tested in the projection's dtype with a true divide. (The
    masks kernel multiplies by the reciprocal instead: on a segment with
    an endpoint clipped to the near plane, up to 1e6 pixels out, the two
    roundings part on about 1e-4 of the lit pixels.)"""
    dtype = u0.dtype
    if thickness < 2:
        raise ValueError("the reference draws line thickness >= 2 only")
    h, w = resolution
    half = math.ceil(thickness / 2)
    lat2, cap2 = (half + 0.5) ** 2, float(half) ** 2
    out = torch.zeros((h, w), dtype=torch.bool, device=u0.device)
    idx = torch.nonzero(draw).flatten()
    if idx.numel() == 0:
        return out

    def trunc(x):
        return x.clamp(-ENDPOINT_LIMIT, ENDPOINT_LIMIT).to(torch.int32)

    ax, ay = trunc(u0[idx]).to(dtype), trunc(v0[idx]).to(dtype)
    bx, by = trunc(u1[idx]).to(dtype), trunc(v1[idx]).to(dtype)
    ys = torch.arange(h, dtype=dtype, device=u0.device)[None, :, None]
    xs = torch.arange(w, dtype=dtype, device=u0.device)[None, None, :]
    chunk = max(1, (1 << 24) // (h * w))  # segments tested at once
    for i in range(0, idx.numel(), chunk):
        sa_x, sa_y = ax[i:i + chunk, None, None], ay[i:i + chunk, None, None]
        abx = bx[i:i + chunk, None, None] - sa_x
        aby = by[i:i + chunk, None, None] - sa_y
        apx, apy = xs - sa_x, ys - sa_y
        den = abx * abx + aby * aby
        tt = (apx * abx + apy * aby) / torch.where(den == 0, 1.0, den)
        tc = torch.clamp(tt, 0, 1)
        dx, dy = apx - tc * abx, apy - tc * aby
        r2 = torch.where((tt >= 0) & (tt <= 1), lat2, cap2)
        out |= ((dx * dx + dy * dy) <= r2).any(dim=0)
    return out


def render_masks(m: Map, cam: Dict, e, k, pos, rot):
    """(L, H, W) bool masks of one car's camera frame (the projection in
    the dtype of `e`, `k`, `pos` and `rot`)."""
    pose = camera_pose(e, pos[None], rot[None])[0]
    res = tuple(cam["resolution"])
    layers = []
    for ln, le in zip(m.layer_nodes, m.layer_edges):
        u0, v0, u1, v1, draw = project(ln, le, pose, k, res,
                                       cam.get("max_range"))
        layers.append(stroke_masks(u0, v0, u1, v1, draw, res,
                                   int(cam["line_thickness"])))
    return torch.stack(layers)


def observation(m: Map, masks, fmt: str):
    """An observation in `fmt` from (L, H, W) masks: classes 0/255 uint8,
    rank (the highest painted layer + 1), rgb (H, W, 3): later layers
    paint over earlier ones (upstream renderer.py:41-43)."""
    if fmt == "classes":
        return masks.to(torch.uint8) * 255
    n = masks.shape[0]
    ranks = torch.arange(1, n + 1, device=masks.device).reshape(n, 1, 1)
    rank = torch.where(masks, ranks, 0).amax(dim=0)
    if fmt == "rank":
        return rank.to(torch.uint8)
    if fmt != "rgb":
        raise ValueError(f"the reference renders classes, rank and rgb, "
                         f"not {fmt}")
    frame = torch.zeros(rank.shape + (3,), dtype=torch.uint8,
                        device=masks.device)
    for l in range(n):
        frame = torch.where((rank == l + 1)[..., None],
                            m.colors[l].to(torch.uint8), frame)
    return frame
