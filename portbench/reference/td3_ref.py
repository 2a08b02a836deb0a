"""The plain reference of one fused TD3 step: what one step of
`tinycarlo_torch.train.td3_loop.chunk` does (the port's module docstring
states it; upstream examples/train_td3.py:140-207), in plain PyTorch:
no kernel, no graph, no module of the port.

A step, for every env of the batch:
  1. OU noise, noise + theta (mean - noise) + sigma eps, and the action
     clip(actor(queue[:, :-1], one-hot maneuver) + noise + shift, -1, 1);
  2. the env step through `sim.py` (car, local path, info) at the
     configuration's speed, maneuver 2 sent as 3, then the three wrappers:
     CTELinearReward, CTETermination and CrashTermination (their counters
     carried), truncation at `max_episode_steps` and where the local path
     ends; finished envs respawn at drawn spawn rows;
  3. the rgb frame of each post-reset car (`sim.py`'s projection and
     stroke, a batch of cars at a time);
  4. the frozen TinycarEncoder: five conv3x3 stride-2 blocks, batch norm
     on its running statistics, ReLU, then the linear layer and ReLU;
  5. the feature queue rolled, (queue[1:], m, a, r, queue[:-1]) inserted
     into the replay: appended while there is room, else at uniformly
     drawn slots, the batch's last item winning a shared slot;
  6. `updates_per_step` TD3 updates once the buffer holds a batch: a
     uniform sample of the filled prefix; the twin critics' MSE to
     min(Q1', Q2') * gamma + r of the target nets (no terminal mask); every
     `policy_delay`-th update the actor's -mean Q1(x, m, actor(x, m)),
     then the tau soft updates of all three targets; optax-ordered Adam
     (bias corrections in float64);
  7. where an episode ended: noise 0, the episode count up, sigma
     0.4 (1 - e / total_episodes) clipped at 0, a fresh maneuver in 0-2.

The state is plain tensors keyed by the port's names (the nets by
parameter name, as `named_parameters` gives them); nothing of the port is
imported. Its random numbers come from the program's generators' recorded
states: the reference sets a generator of the run's device to each state
and draws in the program's order and with its calls (the loop's: the OU
normals, the eviction slots, each update's sample, the fresh maneuvers;
the env's: the respawn rows, drawn every step), so a replayed graph, which
draws what an eager step would from the same state, is followed draw for
draw. It runs in float32 with TF32 off; `dtype` computes the same in
another precision (the control).

Departures from upstream, each the port's, kept here:
  - the envs run as one batch that auto-resets (upstream steps one env);
  - the replay stores the feature queue, not frames, and its eviction
    draws are uniform over all slots (upstream rl_utils.py:20-22 draws
    over the filled prefix, which is the whole buffer once it evicts);
  - the sample draw is a uniform 31-bit integer modulo the filled count
    (a bias below filled / 2^31);
  - sigma follows each env's own episode count in the step (upstream
    lowers it once per episode of its single env);
  - Adam is optax's order of operations, not torch.optim.Adam's.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import sim

NETS = ("actor", "actor_target", "critic1", "critic2", "critic1_target",
        "critic2_target")
OPTS = ("actor", "critic1", "critic2")
# the port's car-state fields, and sim.py's names for them
CAR = {"position": "pos", "position_front": "front", "rotation": "rot",
       "steering_angle": "steer", "velocity": "vel", "local_path": "path",
       "local_path_len": "plen", "last_maneuver": "lastm"}
# the sample draw's range (below 2^31 - 1, reduced modulo the filled count)
DRAW_HIGH = 2 ** 31 - 1
BN_EPS = 1e-5
FLOAT_KEYS = ("queue", "noise", "sigma")


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- the nets (models/tinycar_net.py of the port, upstream tinycar_net.py) --

def temporal(p: Dict, prefix: str, f):
    """Dilated Conv1d stack over (B, seq_len, F): seq_len is the channel
    axis, dilations and paddings 1, 2, 4, ReLU after each, then the mean
    over the channels."""
    for i, d in enumerate((1, 2, 4)):
        f = torch.relu(F.conv1d(f, p[f"{prefix}.convs.{i}.weight"],
                                p[f"{prefix}.convs.{i}.bias"], dilation=d,
                                padding=d))
    return f.mean(dim=1)


def linear(p: Dict, name: str, x):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def actor(p: Dict, f, m):
    """The temporal actor: (B, seq_len, F) queue, (B, M) one-hot -> (B, A)
    in [-1, 1]."""
    e = torch.relu(linear(p, "trunk.fcm1", m))
    e = torch.relu(linear(p, "trunk.fcm2", e))
    e = torch.relu(linear(p, "trunk.fcm3", e))
    x = torch.cat([temporal(p, "temporal", f), e], dim=-1)
    for name in ("head.fc1", "head.fc2", "head.fc3"):
        x = torch.relu(linear(p, name, x))
    return torch.tanh(linear(p, "head.fc4", x))


def critic(p: Dict, f, m, a):
    """The temporal critic: queue, one-hot maneuver, action -> (B, 1)."""
    x = torch.cat([temporal(p, "temporal", f),
                   torch.relu(linear(p, "fcm", m)),
                   torch.relu(linear(p, "fca", a))], dim=-1)
    return linear(p, "fc2", torch.relu(linear(p, "fc1", x)))


def encoder(p: Dict, frames, n_blocks: int):
    """The frozen TinycarEncoder on (B, H, W, 3) uint8 rgb frames: /255,
    channels first, five conv3x3 stride-2 blocks with batch norm on the
    running statistics and ReLU, flattened channels first, linear, ReLU."""
    dtype = p["fc1.weight"].dtype
    x = (frames.float() / 255.0).permute(0, 3, 1, 2).contiguous().to(dtype)
    for i in range(n_blocks):
        c = f"convs.{i}"
        x = F.conv2d(x, p[f"{c}.conv1.weight"], p[f"{c}.conv1.bias"],
                     stride=2, padding=1)
        x = torch.relu(F.batch_norm(
            x, p[f"{c}.bn1.running_mean"], p[f"{c}.bn1.running_var"],
            p[f"{c}.bn1.weight"], p[f"{c}.bn1.bias"], False, 0.0, BN_EPS))
    return torch.relu(linear(p, "fc1", x.flatten(1)))


def one_hot(m, n: int, dtype):
    return (m.long()[:, None] == torch.arange(n, device=m.device)).to(dtype)


# -- the learner ------------------------------------------------------------

def adam(params: Dict, grads: Dict, opt: Dict, lr: float, b1: float,
         b2: float, eps: float) -> None:
    """One optax.adam(lr) step in place: mu = (1 - b1) g + b1 mu, nu =
    (1 - b2) g^2 + b2 nu, t + 1, p += -lr (mu / (1 - b1^t)) /
    (sqrt(nu / (1 - b2^t)) + eps), the corrections in float64 cast to the
    parameters' dtype."""
    opt["count"] = torch.where(opt["count"] < 2 ** 31 - 1, opt["count"] + 1,
                               opt["count"])
    t = opt["count"].to(torch.float64)
    for k, g in grads.items():
        p = params[k]
        mu = opt["mu"][k] * b1 + g * (1.0 - b1)
        nu = opt["nu"][k] * b2 + (g * g) * (1.0 - b2)
        opt["mu"][k], opt["nu"][k] = mu, nu
        bc1 = (1.0 - torch.pow(b1, t)).to(p.dtype)
        bc2 = (1.0 - torch.pow(b2, t)).to(p.dtype)
        den = torch.sqrt(nu / bc2 + 0.0) + eps
        params[k] = p + (mu / bc1) / den * (-lr)


def soft(tau: float, online: Dict, target: Dict) -> None:
    """target = tau online + (1 - tau) target, in place."""
    for k in target:
        target[k] = target[k] * (1.0 - tau) + online[k] * tau


def _grads(loss, p: Dict) -> Dict:
    leaves = list(p.values())
    return dict(zip(p, torch.autograd.grad(loss, leaves)))


def _leaves(p: Dict) -> Dict:
    return {k: v.detach().requires_grad_(True) for k, v in p.items()}


def update(nets: Dict, opts: Dict, lc: Dict, batch: Dict,
           do_actor: bool) -> Tuple[torch.Tensor, ...]:
    """One TD3 update in place on `nets` and `opts` (dicts of dicts of
    tensors). Returns the (critic1, critic2, actor) losses as tensors,
    actor 0 on a critic-only update."""
    x, m, a, r, x1 = (batch[k] for k in ("x", "m", "a", "r", "x1"))
    ad = lc["adam"]
    with torch.no_grad():
        ta = actor(nets["actor_target"], x1, m)
        tq = torch.minimum(critic(nets["critic1_target"], x1, m, ta),
                           critic(nets["critic2_target"], x1, m, ta))
        target_q = tq * lc["discount_factor"] + r
    losses, grads = [], []
    for name in ("critic1", "critic2"):
        p = _leaves(nets[name])
        loss = torch.mean((target_q - critic(p, x, m, a)) ** 2)
        grads.append(_grads(loss, p))
        losses.append(loss.detach())
    for name, g in zip(("critic1", "critic2"), grads):
        with torch.no_grad():
            adam(nets[name], g, opts[name], lc["lr_critic"], ad["b1"],
                 ad["b2"], ad["eps"])
    a_loss = torch.zeros((), dtype=losses[0].dtype, device=x.device)
    if do_actor:
        p = _leaves(nets["actor"])
        loss = -torch.mean(critic(nets["critic1"], x, m, actor(p, x, m)))
        g = _grads(loss, p)
        a_loss = loss.detach()
        with torch.no_grad():
            adam(nets["actor"], g, opts["actor"], lc["lr_actor"], ad["b1"],
                 ad["b2"], ad["eps"])
            for name in ("actor", "critic1", "critic2"):
                soft(lc["tau"], nets[name], nets[name + "_target"])
    return losses[0], losses[1], a_loss


# -- the env ----------------------------------------------------------------

def car_of(state: Dict, dtype) -> Dict:
    """sim.py's car dict from the port's car fields."""
    out = {}
    for port, name in CAR.items():
        v = state["car"][port]
        out[name] = v.long() if not v.is_floating_point() else v.to(dtype)
    return out


def wrappers(w: Dict, cte, velocity, counters):
    """(reward, terminated, counters') of the standard wrapper stack: the
    CTE linear reward (the env's own shaping off), and the CTE and crash
    terminations, each firing after its number of consecutive steps."""
    lr = w["cte_linear_reward"]
    y = (-lr["max_reward"] / lr["min_cte"]) * torch.abs(cte) + lr["max_reward"]
    y = (torch.clamp_min(y, lr["min_reward"]) if lr["max_reward"] > 0
         else torch.clamp_max(y, lr["min_reward"]))
    reward = torch.zeros_like(cte) + y
    conds = ((torch.abs(cte) > w["cte_termination"]["max_cte"],
              w["cte_termination"]["number_of_steps"]),
             (torch.abs(velocity) < w["crash_termination"]
              ["velocity_threshold"],
              w["crash_termination"]["number_of_steps"]))
    term = torch.zeros(cte.shape, dtype=torch.bool, device=cte.device)
    out = []
    for (cond, n), c in zip(conds, counters):
        c = torch.where(cond, c + 1, 0)
        fired = c >= n
        term = term | fired
        out.append(torch.where(fired, 0, c))
    return reward, term, out


def strokes(u0, v0, u1, v1, draw, resolution, thickness):
    """(K, H, W) bool: `sim.stroke_masks` for K cameras at once, each
    camera's edges along the second axis (its drawn edges only count):
    the same per-pixel arithmetic, edges taken in chunks."""
    dtype = u0.dtype
    if thickness < 2:
        raise ValueError("the reference draws line thickness >= 2 only")
    h, w = resolution
    half = math.ceil(thickness / 2)
    lat2, cap2 = (half + 0.5) ** 2, float(half) ** 2
    kk, n = u0.shape
    out = torch.zeros((kk, h, w), dtype=torch.bool, device=u0.device)

    def trunc(x):
        return x.clamp(-sim.ENDPOINT_LIMIT, sim.ENDPOINT_LIMIT).to(
            torch.int32).to(dtype)

    ax, ay, bx, by = (trunc(t) for t in (u0, v0, u1, v1))
    ys = torch.arange(h, dtype=dtype, device=u0.device)[None, None, :, None]
    xs = torch.arange(w, dtype=dtype, device=u0.device)[None, None, None, :]
    step = max(1, (1 << 24) // (kk * h * w))
    for i in range(0, n, step):
        if not bool(draw[:, i:i + step].any()):
            continue
        cut = slice(i, i + step)
        sa_x, sa_y = ax[:, cut, None, None], ay[:, cut, None, None]
        abx, aby = bx[:, cut, None, None] - sa_x, by[:, cut, None, None] - sa_y
        apx, apy = xs - sa_x, ys - sa_y
        den = abx * abx + aby * aby
        tt = (apx * abx + apy * aby) / torch.where(den == 0, 1.0, den)
        tc = torch.clamp(tt, 0, 1)
        dx, dy = apx - tc * abx, apy - tc * aby
        r2 = torch.where((tt >= 0) & (tt <= 1), lat2, cap2)
        hit = ((dx * dx + dy * dy) <= r2) & draw[:, cut, None, None]
        out |= hit.any(dim=1)
    return out


def render(m: sim.Map, cam: Dict, e, k, car: Dict, chunk: int = 32):
    """(B, H, W, 3) uint8 rgb frames of the cars: `sim.render_masks` and
    `sim.observation` for `chunk` cars at once (the projection's
    arithmetic is elementwise, so a batch of poses broadcasts through
    `sim.project`); later layers paint over earlier ones."""
    res = tuple(cam["resolution"])
    poses = sim.camera_pose(e, car["pos"], car["rot"])  # (B, 3, 4)
    n_layers = len(m.layer_nodes)
    ranks = torch.arange(1, n_layers + 1, device=poses.device)
    frames = []
    for i in range(0, poses.shape[0], chunk):
        pose = poses[i:i + chunk].permute(1, 2, 0)[..., None]  # (3, 4, K, 1)
        masks = torch.stack([
            strokes(*sim.project(ln, le, pose, k, res, cam.get("max_range")),
                    res, int(cam["line_thickness"]))
            for ln, le in zip(m.layer_nodes, m.layer_edges)], dim=1)
        rank = torch.where(masks, ranks[:, None, None], 0).amax(dim=1)
        frame = torch.zeros(rank.shape + (3,), dtype=torch.uint8,
                            device=rank.device)
        for layer in range(n_layers):
            frame = torch.where((rank == layer + 1)[..., None],
                                m.colors[layer].to(torch.uint8), frame)
        frames.append(frame)
    return torch.cat(frames)


def _generator(state, device):
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


def _cast(tree, dtype):
    """Floating tensors of a nested dict cast to `dtype` (others kept)."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def step(state: Dict, enc: Dict, config: Dict, m: sim.Map,
         dtype=torch.float32):
    """One fused step from `state` (the port's state as plain tensors on
    the run's device: module docstring) with the encoder's parameters
    `enc` and the configuration file's dict. Returns (the state after it,
    in the input's dtypes and layout, and its outputs: reward, done, cte,
    laneline_distances (the batch mean), sigma, update_losses (U, 3),
    features, frames, slots (the replay slots written, ascending),
    src (the env each slot's row came from) and rows (each written slot's
    row)). `m` is the map in `dtype`."""
    with no_tf32():
        return _step(state, enc, config, m, dtype)


def _step(state, enc, config, m, dtype):
    env, lc = config["config"], config["learner"]
    dev = state["queue"].device
    gen = _generator(state["gen_loop"], dev)
    gen_env = _generator(state["gen_env"], dev)
    f32 = torch.float32
    s = _cast({k: state[k] for k in FLOAT_KEYS}, dtype)
    nets = _cast({k: dict(state["nets"][k]) for k in NETS}, dtype)
    opts = {k: {"count": state["adam"][k]["count"].clone(),
                "mu": _cast(dict(state["adam"][k]["mu"]), dtype),
                "nu": _cast(dict(state["adam"][k]["nu"]), dtype)}
            for k in OPTS}
    enc = _cast(enc, dtype)
    maneuver = state["maneuver"]
    b = maneuver.shape[0]
    mdim, adim = lc["maneuver_dim"], lc["action_dim"]

    # 1. exploration
    eps = torch.randn((b, adim), generator=gen, dtype=f32,
                      device=dev).to(dtype)
    noise = (s["noise"] + lc["noise_theta"] * (lc["noise_mean"] - s["noise"])
             + s["sigma"][:, None] * eps)
    m_onehot = one_hot(maneuver, mdim, dtype)
    with torch.no_grad():
        action = torch.clamp(actor(nets["actor"], s["queue"][:, :-1],
                                   m_onehot) + noise + lc["steering_shift"],
                             -1.0, 1.0)

    # 2. the env step, the wrappers and the auto-reset
    car_cfg = env["car"]
    car = car_of(state, dtype)
    speed = torch.full((b,), lc["speed"], dtype=dtype, device=dev)
    send = torch.where(maneuver != 2, maneuver, 3).long()
    new, dead = sim.car_step(m, car_cfg, 1.0 / env["sim"]["fps"], car,
                             torch.clamp(speed, -1.0, 1.0),
                             torch.clamp(action[:, 0], -1.0, 1.0), send)
    info = sim.car_info(m, new, distances=True)
    velocity = torch.where(new["plen"] >= 2, new["vel"], 0.0)
    reward, term, counters = wrappers(lc["wrappers"], info["cte"], velocity,
                                      state["counters"].unbind(0))
    episode_step = state["episode_step"] + 1
    trunc = dead | (episode_step >= lc["max_episode_steps"])
    done = term | trunc
    rows = torch.randint(m.spawn_pos.shape[0], (b,), generator=gen_env,
                         device=dev)
    fresh = sim.car_reset(m, car_cfg, rows)
    post = {k: torch.where(done.reshape((-1,) + (1,) * (v.ndim - 1)),
                           fresh[k].to(v.dtype), v) for k, v in new.items()}
    counters = torch.stack([torch.where(done, 0, c) for c in counters])
    episode_step = torch.where(done, 0, episode_step)

    # 3-4. the post-reset frames and their features
    cam = env["camera"]
    e, k = sim.camera_matrices(cam, dtype, dev)
    frames = render(m, cam, e, k, post)
    with torch.no_grad():
        feats = encoder(enc, frames, len(lc["encoder_filters"]))

    # 5. the queue and the replay
    queue = torch.cat([feats[:, None], s["queue"][:, :-1]], dim=1)
    item = {"x": queue[:, 1:], "m": maneuver, "a": action,
            "r": reward[:, None], "x1": queue[:, :-1]}
    replay = {k: v.to(dtype if v.is_floating_point() else v.dtype,
                      copy=True) for k, v in state["replay"].items()}
    size = replay["m"].shape[0]
    filled = int(state["filled"])
    evict = torch.randint(size, (b,), generator=gen, device=dev)
    append = filled + torch.arange(b, device=dev)
    slot = torch.where(append < size, append, evict)
    last = torch.full((size,), -1, dtype=torch.long, device=dev)
    last.scatter_reduce_(0, slot, torch.arange(b, device=dev), "amax")
    slots = torch.nonzero(last >= 0)[:, 0]
    src = last[slots]
    written = {}
    for key, store in replay.items():
        written[key] = item[key][src].to(store.dtype)
        store[slots] = written[key]
    filled = min(filled + b, size)

    # 6. the updates
    steps = int(state["steps"])
    losses = []
    n_updates = (lc["updates_per_step"] if filled >= lc["batch_size"]
                 else 0)
    for _ in range(n_updates):
        idx = torch.randint(DRAW_HIGH, (lc["batch_size"],), generator=gen,
                            device=dev) % filled
        batch = {key: v[idx] for key, v in replay.items()}
        batch["m"] = one_hot(batch["m"], mdim, dtype)
        do_actor = (steps + 1) % lc["policy_delay"] == 0
        losses.append(torch.stack(update(nets, opts, lc, batch, do_actor)))
        steps += 1
    update_losses = (torch.stack(losses).to(f32) if losses else torch.zeros(
        (lc["updates_per_step"], 3), dtype=f32, device=dev))

    # 7. episode ends
    noise = torch.where(done[:, None], 0.0, noise)
    ep_count = state["ep_count"] + done.to(state["ep_count"].dtype)
    level = lc["noise_sigma"] * torch.clamp(
        1.0 - ep_count.to(f32) / lc["total_episodes"], min=0.0)
    sigma = torch.where(done, level.to(dtype), s["sigma"])
    fresh_m = torch.randint(3, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
    maneuver = torch.where(done, fresh_m.to(maneuver.dtype), maneuver)

    def back(v, like):
        return v.to(like.dtype)

    out_state = {
        "nets": {n: {k: back(v, state["nets"][n][k])
                     for k, v in nets[n].items()} for n in NETS},
        "adam": {n: {"count": opts[n]["count"],
                     "mu": {k: back(v, state["adam"][n]["mu"][k])
                            for k, v in opts[n]["mu"].items()},
                     "nu": {k: back(v, state["adam"][n]["nu"][k])
                            for k, v in opts[n]["nu"].items()}}
                 for n in OPTS},
        "steps": torch.tensor(steps, dtype=state["steps"].dtype),
        "queue": back(queue, state["queue"]),
        "noise": back(noise, state["noise"]),
        "sigma": back(sigma, state["sigma"]),
        "maneuver": maneuver,
        "ep_count": ep_count,
        "car": {port: back(post[name], state["car"][port])
                for port, name in CAR.items()},
        "counters": back(counters, state["counters"]),
        "episode_step": back(episode_step, state["episode_step"]),
        "replay": {k: back(v, state["replay"][k]) for k, v in replay.items()},
        "filled": torch.tensor(filled, dtype=state["filled"].dtype),
        "gen_loop": gen.get_state(),
        "gen_env": gen_env.get_state(),
    }
    out = {"reward": reward.to(f32), "done": done, "cte": info["cte"].to(f32),
           "laneline_distances": info["laneline_distances"].to(f32)
           .mean(dim=0),
           "sigma": sigma.to(f32), "update_losses": update_losses,
           "features": feats.to(f32), "frames": frames, "slots": slots,
           "src": src,
           "rows": {key: v.to(f32) if v.is_floating_point() else v
                    for key, v in written.items()}}
    return out_state, out


def state_to(state, device):
    """A state's tensors moved to `device` (generator states stay on the
    host, as torch keeps them)."""
    if isinstance(state, dict):
        return {k: v if k.startswith("gen_") else state_to(v, device)
                for k, v in state.items()}
    return state.to(device) if isinstance(state, torch.Tensor) else state

