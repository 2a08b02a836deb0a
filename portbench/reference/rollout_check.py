"""The comparison that decides `correct` in the rollout cells.

The reference follows the program step by step from the program's own
state: for every step of the last call and every tracked car it takes
the recorded state the policy saw (the program's), computes the Stanley
action, the car step, the local-path walk, the info, the reward and the
termination and truncation (the episode counter from the recorded count
at the call's start, then its own), and renders the sampled frames from
the recorded state. The stage this skips, the chaining of steps, is the
state the next step starts from: that state is compared as the output of
the step before.

Numbers compared (each against its limit in the workload file):
- `car_gap_m`: the widest gap of the car state after a step that did
  not end the episode, in meters of motion: position and front axle,
  the yaw times the wheelbase, the velocity times the step, the steering
  angle (radians) times the wheelbase;
- `info_gap_m`: the widest gap of the step's info in meters: cte, the
  heading error times the wheelbase, the reward times the track width;
- `discrete_mismatches`: steps whose local path, its length, the last
  maneuver, `terminated` or `truncated` differ, or whose auto-reset state
  is no fresh car at a spawn row;
- `frame_px_mismatch`: pixels that differ between the program's sampled
  frames and the reference's, over the pixels lit in either.

`stand_in="bfloat16"` puts the reference computed in bfloat16 in the
program's place (the control).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import policy as pol
from portbench.reference import sim

NAMES = ("car_gap_m", "info_gap_m", "discrete_mismatches",
         "frame_px_mismatch")


def _state(f, i):
    """The car-state dict of recorded rows: f (..., 7) floats, i (..., 10)
    int32."""
    return {"pos": f[..., 0:2], "front": f[..., 2:4], "rot": f[..., 4],
            "steer": f[..., 5], "vel": f[..., 6],
            "path": i[..., :8].reshape(i.shape[:-1] + (4, 2)).long(),
            "plen": i[..., 8].long(), "lastm": i[..., 9].long()}


def follow(run, rec, tracked, m, dtype):
    """The reference's step from every recorded state: (post state, info,
    reward, terminated, truncated), each (T, K, ...)."""
    t = run.traffic
    cfg = run.env_config()
    car = cfg["car"]
    dev = m.nodes.device
    T, K = rec["f"].shape[0] - 1, rec["f"].shape[1]
    f = rec["f"][:T].to(dev).to(dtype).reshape(T * K, 7)
    i = rec["i"][:T].to(dev).reshape(T * K, 10)
    s = _state(f, i)
    steer = pol.stanley(m.nodes, s["front"], s["rot"], s["path"], s["plen"],
                        float(t["speed"]), float(t["k"]),
                        car["max_steering_angle"])
    steps = torch.arange(T, device=dev)[:, None]
    envs = torch.as_tensor(tracked, device=dev)[None, :].to(torch.int32)
    man = pol.maneuvers(t["maneuver"], steps, envs.expand(T, K)).reshape(-1)
    new, dead = sim.car_step(m, car, 1.0 / cfg["sim"]["fps"], s,
                             torch.full_like(steer, float(t["speed"])), steer,
                             man)
    info = sim.car_info(m, new)
    reward, term = sim.shaping(car, info["cte"])
    out = {k: v.reshape((T, K) + v.shape[1:]) for k, v in new.items()}
    out.update(cte=info["cte"].reshape(T, K),
               heading_error=info["heading_error"].reshape(T, K),
               reward=reward.reshape(T, K), terminated=term.reshape(T, K))
    dead = dead.reshape(T, K).cpu()
    term_c = out["terminated"].cpu()
    ep = rec["ep0"].long().clone()
    trunc = torch.zeros((T, K), dtype=torch.bool)
    for step in range(T):
        ep = ep + 1
        trunc[step] = dead[step] | (ep >= t["max_episode_steps"])
        ep = torch.where(term_c[step] | trunc[step], 0, ep)
    out["truncated"] = trunc.to(dev)
    return out


def program_outputs(rec, dev):
    """The program's side: the state after each step (the recorded state of
    the next, or the final state) and the trajectory."""
    T = rec["f"].shape[0] - 1
    out = _state(rec["f"][1:T + 1].to(dev), rec["i"][1:T + 1].to(dev))
    out.update({k: v.to(dev) for k, v in rec["traj"].items()})
    return out


def frames(run, rec, frame_env, frame_steps, tracked, m, dtype):
    """The reference's observations of the sampled steps."""
    cfg = run.env_config()
    cam = cfg["camera"]
    e, k = sim.camera_matrices(cam, dtype, m.nodes.device)
    fmt = run.traffic["observation_space_format"]
    col = {int(env): j for j, env in enumerate(tracked)}
    out = []
    for step in frame_steps:
        j = col[int(frame_env[step])]
        f = rec["f"][step, j].to(m.nodes.device).to(dtype)
        masks = sim.render_masks(m, cam, e, k, f[0:2], f[4])
        out.append(sim.observation(m, masks, fmt))
    return torch.stack(out)


def compare(run, prog, ref, prog_frames, ref_frames, resets: bool):
    car = run.env_config()["car"]
    wb, tw = car["wheelbase"], car["track_width"]
    dt = 1.0 / run.env_config()["sim"]["fps"]
    f64 = torch.float64
    p_done = prog["terminated"] | prog["truncated"]
    r_done = ref["terminated"] | ref["truncated"]
    flags = ((prog["terminated"] != ref["terminated"])
             | (prog["truncated"] != ref["truncated"]))
    cont = ~p_done & ~r_done

    def gap(name, scale=1.0, angle=False):
        d = prog[name].to(f64) - ref[name].to(f64)
        if angle:
            d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
        d = d.abs() * scale
        return d.reshape(d.shape[:2] + (-1,)).amax(-1)

    car_gap = torch.stack([gap("pos"), gap("front"),
                           gap("rot", wb, angle=True), gap("vel", dt),
                           gap("steer", math.pi / 180 * wb)]).amax(0)
    car_gap = float(torch.where(cont, car_gap, 0.0).max())
    info_gap = float(torch.stack([gap("cte"),
                                  gap("heading_error", wb, angle=True),
                                  gap("reward", tw)]).amax(0).max())
    path = ((prog["path"] != ref["path"]).flatten(2).any(-1)
            | (prog["plen"] != ref["plen"]) | (prog["lastm"] != ref["lastm"]))
    discrete = int(flags.sum()) + int((path & cont).sum())
    if resets:
        discrete += int(bad_resets(run, prog, p_done & r_done).sum())
    fmt = run.traffic["observation_space_format"]
    a, b = prog_frames.to(ref_frames.device), ref_frames
    if fmt == "rgb":
        diff, lit = (a != b).any(-1), (a > 0).any(-1) | (b > 0).any(-1)
    else:
        diff, lit = a != b, (a > 0) | (b > 0)
    px = float(diff.sum()) / max(1.0, float(lit.sum()))
    return {"car_gap_m": car_gap, "info_gap_m": info_gap,
            "discrete_mismatches": float(discrete), "frame_px_mismatch": px}


def bad_resets(run, prog, done):
    """Steps that ended an episode whose next state is no fresh car at a
    spawn row (exact: the spawn table is the map's, in float32)."""
    cfg = run.env_config()
    m = sim.load_map(cfg["map"]["json_path"], cfg["map"]["pixel_per_meter"],
                     cfg["map"].get("spawn_points"),
                     device=prog["pos"].device)
    pos, rot = prog["pos"][done], prog["rot"][done]
    hit = ((pos[:, None, :] == m.spawn_pos[None]).all(-1)
           & (rot[:, None] == m.spawn_rot[None]))
    row = hit.float().argmax(-1)
    fresh = (hit.any(-1) & (prog["steer"][done] == 0)
             & (prog["vel"][done] == 0) & (prog["plen"][done] == 1)
             & (prog["lastm"][done] == 0)
             & (prog["path"][done] == m.spawn_edge[row][:, None, :])
             .flatten(1).all(-1))
    return ~fresh


def check(run, rec, frame_env, frame_steps, tracked, stand_in=None):
    """[(name, value, limit)]: the program's last call (or, with
    `stand_in`, the reference in that dtype in its place) against the
    reference in float32, on the run's device."""
    dev, dtype = run.device, torch.float32
    cfg = run.env_config()
    mp = cfg["map"]

    def ref_map(dt):
        return sim.load_map(mp["json_path"], mp["pixel_per_meter"],
                            mp.get("spawn_points"), dtype=dt, device=dev)

    m = ref_map(dtype)
    ref = follow(run, rec, tracked, m, dtype)
    ref_frames = frames(run, rec, frame_env, frame_steps, tracked, m, dtype)
    if stand_in is None:
        prog = program_outputs(rec, dev)
        prog_frames = rec["frames"]
    else:
        sd = getattr(torch, stand_in)
        ms = ref_map(sd)
        prog = follow(run, rec, tracked, ms, sd)
        prog_frames = frames(run, rec, frame_env, frame_steps, tracked, ms,
                             sd)
    got = compare(run, prog, ref, prog_frames, ref_frames,
                  resets=stand_in is None)
    return [(n, got[n], float(run.limits.get(n, 0.0))) for n in NAMES]
