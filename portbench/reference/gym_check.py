"""The comparison that decides `correct` in the single-env gym cell.

The reference runs its own env from the same `reset(seed)`: it draws the
spawn rows as the entry point's seeded `np_random` does (upstream
map.py:51-69: a uniform choice of a spawn point, redrawn until the node
has a successor; gymnasium's PCG64 seeding), steps with the window's
actions and resets where the program reset (the draws stay in step). It
follows the program's position and yaw: each step starts from the
position and orientation the program returned for the step before (the
reference's own after a reset), so rounding does not add up over an
episode; the velocity, the steering angle, the local path and the last
maneuver are the reference's own. The episodes run side by side as one
batch. The first `checked_steps_per_episode` steps of every episode are
compared (a car that wanders for thousands of steps would otherwise set
the reference's time alone); the laneline distances and the frames every
`frame_stride` steps among them.

Numbers compared, as in the rollout cells (reference/rollout_check.py):
`discrete_mismatches` (steps whose `terminated`, `truncated` or local
path, its length and nodes, differ), and over the other steps
`car_gap_m` (position, the yaw times the wheelbase and the velocity
times the step, as the info returns them) and `info_gap_m` (cte, the
heading error times the wheelbase, the reward times the track width, the
laneline distances); `frame_px_mismatch` (pixels that differ over pixels
lit in either).

`stand_in="bfloat16"` puts the reference computed in bfloat16 in the
program's place (the control).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import sim

NAMES = ("car_gap_m", "info_gap_m", "discrete_mismatches",
         "frame_px_mismatch")


def spawn_rows(seed: int, spawn_points, m: sim.Map):
    """The spawn rows of successive resets from `reset(seed)`: gymnasium's
    `np_random(seed)` and the upstream rejection sampling."""
    gen = np.random.Generator(np.random.PCG64(np.random.SeedSequence(seed)))
    row_of = {int(n): r for r, n in enumerate(m.spawn_node.tolist())}
    n_nodes = m.nodes.shape[0]
    while True:
        if spawn_points is None:
            idx = int(gen.integers(0, n_nodes - 1, size=1, dtype=int)[0])
        else:
            idx = int(gen.choice(np.asarray(spawn_points)))
        if idx in row_of:
            yield row_of[idx]


def simulate(run, records, controls, maneuvers, dtype):
    """The reference's outputs of the checked steps (None for the others),
    and its frames of the kept steps, on the host. The episodes (reset to
    reset) are independent, so they run side by side as one batch, step
    for step."""
    device = "cpu"
    cfg = run.env_config()
    car, mp, cam = cfg["car"], cfg["map"], cfg["camera"]
    m = sim.load_map(mp["json_path"], mp["pixel_per_meter"],
                     mp.get("spawn_points"), dtype=dtype, device=device)
    e, k = sim.camera_matrices(cam, dtype, device)
    fmt = run.traffic["observation_space_format"]
    dt = 1.0 / cfg["sim"]["fps"]
    prog = records["out"]
    n = len(prog)
    starts = [0] + [r for r in records["resets"] if r < n]
    cap = run.traffic["checked_steps_per_episode"]
    lengths = [min(b - a, cap) for a, b in zip(starts, starts[1:] + [n])]
    rows = spawn_rows(run.seed, mp.get("spawn_points"), m)
    spawn = torch.tensor([next(rows) for _ in starts], device=device)
    first = torch.as_tensor(starts)
    # the program's position and yaw after each step, float32 as returned
    pos_all = torch.as_tensor(np.stack([o[5] for o in prog])).float()
    rot_all = torch.tensor([o[6] for o in prog], dtype=torch.float32)
    ctl_all = torch.as_tensor(np.clip(controls[:n], -1, 1)).float()
    man_all = torch.as_tensor(maneuvers[:n].astype(np.int64))
    s = sim.car_reset(m, car, spawn)
    out, frames = [None] * n, {}
    ids = list(range(len(starts)))  # the episodes still running
    for tau in range(max(lengths)):
        keep = [p for p, j in enumerate(ids) if tau < lengths[j]]
        if len(keep) < len(ids):  # drop the episodes that ended
            sel = torch.tensor(keep)
            s = {k: v[sel] for k, v in s.items()}
            ids = [ids[p] for p in keep]
        gi = first[ids] + tau  # the step of each episode
        if tau > 0:
            pos = pos_all[gi - 1].to(dtype).to(device)
            rot = rot_all[gi - 1].to(dtype).to(device)
            s["pos"] = pos
            s["rot"] = rot
            s["front"] = sim.front(pos, rot, car["wheelbase"])
        ctl = ctl_all[gi].to(dtype).to(device)
        s, dead = sim.car_step(m, car, dt, s, ctl[:, 0], ctl[:, 1],
                               man_all[gi].to(device))
        g = gi.tolist()
        kept = [p for p, i in enumerate(g) if i in records["frames"]]
        info = sim.car_info(m, s, distances=bool(kept))
        reward, term = sim.shaping(car, info["cte"])
        has = s["plen"] >= 2
        vals = torch.stack([reward, info["cte"], info["heading_error"],
                            s["rot"], torch.where(has, s["vel"], 0.0)],
                           1).double().numpy()
        flags = torch.stack([term, dead], 1).numpy()
        pos = s["pos"].double().numpy()
        plen = torch.where(has, s["plen"], 0).tolist()
        nodes = s["path"][:, :, 1].tolist()
        dist = (info["laneline_distances"].double().numpy() if kept
                else None)
        for p, i in enumerate(g):
            out[i] = (vals[p, 0], bool(flags[p, 0]), bool(flags[p, 1]),
                      vals[p, 1], vals[p, 2], pos[p], vals[p, 3], vals[p, 4],
                      tuple(dist[p]) if p in kept else None,
                      tuple(nodes[p][:plen[p]]))
        for p in kept:
            masks = sim.render_masks(m, cam, e, k, s["pos"][p], s["rot"][p])
            frames[g[p]] = sim.observation(m, masks, fmt).cpu().numpy()
    return out, frames


def node_ids(coords, nodes) -> tuple:
    """The lanepath nodes (indices) at the info's local-path coordinates:
    the nearest node to each."""
    c = np.asarray(coords, np.float64).reshape(-1, 2)
    d = ((c[:, None, :] - nodes[None]) ** 2).sum(-1)
    return tuple(int(j) for j in d.argmin(-1))


def compare(run, prog, ref, prog_frames, ref_frames):
    car = run.env_config()["car"]
    wb, tw = car["wheelbase"], car["track_width"]
    dt = 1.0 / run.env_config()["sim"]["fps"]

    def ang(d):
        return abs((d + math.pi) % (2 * math.pi) - math.pi)

    car_gap = info_gap = 0.0
    discrete = 0
    for p, r in zip(prog, ref):
        if r is None:  # past the checked prefix of its episode
            continue
        if (p[1] != r[1]) or (p[2] != r[2]) or p[9] != r[9]:
            discrete += 1
            continue
        car_gap = max(car_gap, float(np.abs(np.asarray(p[5], np.float64)
                                            - r[5]).max()),
                      ang(p[6] - r[6]) * wb, abs(p[7] - r[7]) * dt)
        info_gap = max(info_gap, abs(p[3] - r[3]), ang(p[4] - r[4]) * wb,
                       abs(p[0] - r[0]) * tw)
        if r[8] is not None:
            info_gap = max(info_gap, float(np.abs(
                np.asarray(p[8], np.float64) - np.asarray(r[8])).max()))
    diff = lit = 0
    for i, b in ref_frames.items():
        a = prog_frames[i]
        if a.ndim == 3 and a.shape[-1] == 3:
            d, l = (a != b).any(-1), (a > 0).any(-1) | (b > 0).any(-1)
        else:
            d, l = a != b, (a > 0) | (b > 0)
        diff += int(d.sum())
        lit += int(l.sum())
    return {"car_gap_m": float(car_gap), "info_gap_m": float(info_gap),
            "discrete_mismatches": float(discrete),
            "frame_px_mismatch": diff / max(1, lit)}


def check(run, records, controls, maneuvers, stand_in=None):
    """[(name, value, limit)]: the program's steps (or, with `stand_in`,
    the reference in that dtype in its place) against the reference in
    float32, on the host (one env a step: launches would cost more than
    the arithmetic)."""
    ref, ref_frames = simulate(run, records, controls, maneuvers,
                               torch.float32)
    if stand_in is None:
        mp = run.env_config()["map"]
        nodes = sim.load_map(mp["json_path"], mp["pixel_per_meter"],
                             mp.get("spawn_points")).nodes.double().numpy()
        prog = [o[:9] + (node_ids(o[9], nodes),) for o in records["out"]]
        prog_frames = records["frames"]
    else:
        prog, prog_frames = simulate(run, records, controls, maneuvers,
                                     getattr(torch, stand_in))
    got = compare(run, prog, ref, prog_frames, ref_frames)
    return [(n, got[n], float(run.limits.get(n, 0.0))) for n in NAMES]
