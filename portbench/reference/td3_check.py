"""The comparison that decides `correct` in the TD3 training cell.

After the window the driver steps the timed graph `followed_steps` more
times, one step a chunk, and keeps the loop's whole state before the
first and after each (`drivers/td3.py` `snapshot`: nets, targets, Adam
moments and counts, queue, noise, sigma, maneuvers, episode counts, the
cars, the wrappers' counters, the replay and its fill, both generators),
each step's outputs and the port's render of each post-step state. The
reference (`td3_ref.step`) follows every step from the program's state
before it, for every env, and the two are compared:

- `car_gap_m`: the widest gap of the car state after a step that ended
  no episode on either side, in meters of motion (position and front
  axle, the yaw times the wheelbase, the velocity times the step, the
  steering angle times the wheelbase);
- `info_gap_m`: cte, the reward times the track width (the step's and
  the replay's), the batch-mean laneline distances, in meters;
- `discrete_mismatches`: envs whose episode end, maneuver, local path
  (length, last maneuver), wrapper counters, episode step or count, or
  sigma differ; respawned cars not at the reference's drawn spawn row;
  replay slots written on one side only (the eviction draws) and stored
  maneuvers that differ; the fill, the update and Adam counts, either
  generator's state after the step (the draws taken: OU, respawn,
  eviction, each update's sample, maneuvers), and updates that ran (or
  updated the actor) on one side only;
- `frame_px_mismatch`: pixels that differ between the port's frames of
  the post-step states and the reference's, over the pixels lit in
  either;
- `action_gap`: the stored actions and the OU noise after the step;
- `feature_rel_gap`: the encoded features of the step (the queue's head)
  and the stored rows' feature queues, over the largest feature; the
  step's new features of envs whose frames are equal on both sides (a
  pixel that differs, counted in `frame_px_mismatch`, moves its env's
  features by up to a few percent);
- `loss_rel_gap`: every update's critic and actor losses
  (`update_losses`), each over its reference value;
- `param_rel_gap`: the nets, the targets, and Adam's first and second
  moments, each group's gap over the reference's change in the step
  (the norm of the difference over the norm of the change: a state left
  unchanged reads 1).

`stand_in="bfloat16"` puts the reference computed in bfloat16 in the
program's place (the control).
"""
from __future__ import annotations

import math

import torch

from portbench.reference import sim, td3_ref

NAMES = ("car_gap_m", "info_gap_m", "discrete_mismatches",
         "frame_px_mismatch", "action_gap", "feature_rel_gap",
         "loss_rel_gap", "param_rel_gap")
# the outputs of a chunk's step that are compared
OUT_KEYS = ("reward", "done", "cte", "laneline_distances", "sigma",
            "update_losses")
GROUPS = {"nets": ("actor", "critic1", "critic2"),
          "targets": ("actor_target", "critic1_target", "critic2_target")}


def _max(x) -> float:
    return float(x.max()) if x.numel() else 0.0


def _norm(tensors) -> float:
    return math.sqrt(sum(float((t.double() ** 2).sum()) for t in tensors))


def _ratio(num: float, den: float) -> float:
    if num == 0.0:
        return 0.0
    return num / den if den > 0 else math.inf


def _group_tensors(state, group):
    if group in GROUPS:
        return [v for n in GROUPS[group] for _, v in
                sorted(state["nets"][n].items())]
    return [v for n in td3_ref.OPTS for _, v in
            sorted(state["adam"][n][group].items())]


def compare(config, prev, ref_state, ref, prog_state, prog):
    """The numbers of one step: `prev` the state before it, (`ref_state`,
    `ref`) the reference's state after it and outputs, (`prog_state`,
    `prog`) the program's (OUT_KEYS and "frames"), all on one device."""
    car = config["config"]["car"]
    wb, tw = car["wheelbase"], car["track_width"]
    dt = 1.0 / config["config"]["sim"]["fps"]
    f64 = torch.float64
    pc, rc = prog_state["car"], ref_state["car"]
    p_done, r_done = prog["done"].bool(), ref["done"]
    cont = ~p_done & ~r_done

    def gap(a, b, scale=1.0, angle=False):
        d = a.to(f64) - b.to(f64)
        if angle:
            d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
        return (d.abs() * scale).reshape(d.shape[0], -1).amax(-1)

    car_gap = torch.stack([
        gap(pc["position"], rc["position"]),
        gap(pc["position_front"], rc["position_front"]),
        gap(pc["rotation"], rc["rotation"], wb, angle=True),
        gap(pc["velocity"], rc["velocity"], dt),
        gap(pc["steering_angle"], rc["steering_angle"],
            math.pi / 180 * wb)]).amax(0)
    car_gap = _max(car_gap[cont])

    # the replay: slots written on each side, and the rows at the
    # reference's slots
    slots = ref["slots"]
    changed = torch.zeros(prev["replay"]["m"].shape[0], dtype=torch.bool,
                          device=slots.device)
    for k, v in prog_state["replay"].items():
        changed |= (v != prev["replay"][k]).reshape(v.shape[0], -1).any(-1)
    ref_written = torch.zeros_like(changed)
    ref_written[slots] = True
    rows = {k: v[slots] for k, v in prog_state["replay"].items()}

    info_gap = max(_max(gap(prog["cte"], ref["cte"])),
                   _max(gap(prog["reward"], ref["reward"], tw)),
                   _max(gap(prog["laneline_distances"][None],
                            ref["laneline_distances"][None])),
                   _max(gap(rows["r"], ref["rows"]["r"], tw)))

    path = ((pc["local_path"] != rc["local_path"]).flatten(1).any(-1)
            | (pc["local_path_len"] != rc["local_path_len"])
            | (pc["last_maneuver"] != rc["last_maneuver"]))
    both = p_done & r_done
    respawn = torch.zeros_like(both)
    for k in td3_ref.CAR:
        respawn |= (pc[k] != rc[k]).reshape(both.shape[0], -1).any(-1)
    per_env = ((p_done != r_done).long()
               + (prog_state["maneuver"] != ref_state["maneuver"]).long()
               + (path & cont).long() + (respawn & both).long()
               + (prog_state["counters"] != ref_state["counters"]).sum(0)
               + (prog_state["episode_step"]
                  != ref_state["episode_step"]).long()
               + (prog_state["ep_count"] != ref_state["ep_count"]).long()
               + (prog["sigma"] != ref["sigma"]).long())
    p_ul, r_ul = prog["update_losses"].float(), ref["update_losses"]
    scalars = [prog_state["filled"] != ref_state["filled"],
               prog_state["steps"] != ref_state["steps"],
               not torch.equal(prog_state["gen_loop"], ref_state["gen_loop"]),
               not torch.equal(prog_state["gen_env"], ref_state["gen_env"])]
    scalars += [prog_state["adam"][n]["count"] != ref_state["adam"][n]["count"]
                for n in td3_ref.OPTS]
    discrete = (int(per_env.sum()) + int((changed != ref_written).sum())
                + int((rows["m"] != ref["rows"]["m"]).sum())
                + sum(int(bool(x)) for x in scalars)
                + int(((p_ul == 0) != (r_ul == 0)).sum()))

    a, b = prog["frames"].to(ref["frames"].device), ref["frames"]
    px = _max(((a != b).any(-1)).sum().double()) / max(
        1.0, float(((a > 0).any(-1) | (b > 0).any(-1)).sum()))
    same_frame = (a == b).reshape(a.shape[0], -1).all(-1)

    action_gap = max(_max(gap(rows["a"], ref["rows"]["a"])),
                     _max(gap(prog_state["noise"], ref_state["noise"])))
    # the encoder's gap where both sides encoded the same frame (a frame
    # that differs counts in frame_px_mismatch)
    scale = max(_max(ref["features"].abs()), 1e-30)
    feature_gap = max(
        _max(gap(prog_state["queue"][:, 0], ref["features"])[same_frame]),
        _max(gap(rows["x"], ref["rows"]["x"])),
        _max(gap(rows["x1"], ref["rows"]["x1"])[same_frame[ref["src"]]])
    ) / scale
    nz = r_ul != 0
    loss_gap = _max((p_ul - r_ul).abs()[nz].double()
                    / r_ul.abs()[nz].double())
    param_gap = 0.0
    for group in ("nets", "targets", "mu", "nu"):
        new_p = _group_tensors(prog_state, group)
        new_r = _group_tensors(ref_state, group)
        old = _group_tensors(prev, group)
        num = _norm([x - y for x, y in zip(new_p, new_r)])
        den = _norm([y - z for y, z in zip(new_r, old)])
        param_gap = max(param_gap, _ratio(num, den))
    return {"car_gap_m": car_gap, "info_gap_m": info_gap,
            "discrete_mismatches": float(discrete), "frame_px_mismatch": px,
            "action_gap": action_gap, "feature_rel_gap": feature_gap,
            "loss_rel_gap": loss_gap, "param_rel_gap": param_gap}


def program_outputs(records, i):
    """The program's outputs of followed step i (its chunk's one row) and
    the port's frames of its post-step state."""
    out = {k: records["outs"][i][k][0] for k in OUT_KEYS}
    out["frames"] = records["frames"][i]
    return out


def check(run, records, stand_in=None):
    """[(name, value, limit)]: the followed steps of the program (or, with
    `stand_in`, the reference in that dtype in its place) against the
    reference in float32, on the run's device; each number the largest
    over the steps, `discrete_mismatches` their sum."""
    dev = run.device
    config = {"config": run.env_config("rgb"),
              "learner": run.config["learner"]}
    mp = config["config"]["map"]

    def ref_map(dtype):
        return sim.load_map(mp["json_path"], mp["pixel_per_meter"],
                            mp.get("spawn_points"), dtype=dtype, device=dev)

    m = ref_map(torch.float32)
    m_sd = None if stand_in is None else ref_map(getattr(torch, stand_in))
    enc = td3_ref.state_to(records["encoder"], dev)
    got = dict.fromkeys(NAMES, 0.0)
    snaps = records["snaps"]
    for i in range(len(snaps) - 1):
        prev = td3_ref.state_to(snaps[i], dev)
        ref_state, ref = td3_ref.step(prev, enc, config, m)
        if stand_in is None:
            prog_state = td3_ref.state_to(snaps[i + 1], dev)
            prog = td3_ref.state_to(program_outputs(records, i), dev)
        else:
            prog_state, prog = td3_ref.step(prev, enc, config, m_sd,
                                            getattr(torch, stand_in))
        one = compare(config, prev, ref_state, ref, prog_state, prog)
        del prev, ref_state, ref, prog_state, prog
        for k, v in one.items():
            got[k] = got[k] + v if k == "discrete_mismatches" \
                else max(got[k], v)
    return [(n, got[n], float(run.limits.get(n, 0.0))) for n in NAMES]
