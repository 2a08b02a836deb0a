"""Carry the JAX package's params and state across to the port.

`env_params_from_numpy` and `vec_state_from_numpy` build the port's
EnvParams / VecState from the JAX package's EnvParams / VecState given as
nested dicts of numpy arrays -- each dataclass's fields by name, e.g.
{"map_data": {"lanepath": {"next_table": array, ...}, ...,
"packed_layer_bounds": (0, 192, ...)}, "camera": {"E": array, "K": array}}
-- so both packages can be fed the same state. Arrays keep their dtypes.
`combo_state_dict_from_flax` turns the flax variables of a TinycarCombo
into the state dict of the port's `models.tinycar_net.TinycarCombo`;
`td3_state_from_flax` (and its inverse `td3_state_to_flax`) carries a TD3
learner across: its nets, targets and optax Adam states.
This module never imports JAX: the caller turns the JAX objects into
dicts of numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Union

import numpy as np
import torch

from tinycarlo_torch import camera as cam
from tinycarlo_torch import car as car_mod
from tinycarlo_torch import env as fenv
from tinycarlo_torch import map_compiler as mc
from tinycarlo_torch import vector
from tinycarlo_torch.config import EnvConfig, load_config
from tinycarlo_torch.utils.helper import resolve_device

# Fields that hold a nested dataclass, by field name.
_NESTED = {
    "map_data": mc.MapData,
    "lanepath": mc.LanePathArrays,
    "spawns": mc.SpawnTable,
    "camera": cam.CameraMatrices,
    "env": fenv.EnvState,
    "car": car_mod.CarState,
}


def _build(cls, d: Dict[str, Any], device: torch.device):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NESTED:
            v = _build(_NESTED[f.name], v, device)
        elif isinstance(v, np.ndarray):
            v = torch.from_numpy(np.array(v)).to(device)
        elif isinstance(v, (list, tuple)) and v and isinstance(v[0], np.ndarray):
            v = tuple(torch.from_numpy(np.array(x)).to(device) for x in v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def env_params_from_numpy(
    arrays: Dict[str, Any],
    config: Union[str, Dict[str, Any], EnvConfig],
    device="cuda",
) -> fenv.EnvParams:
    """The port's EnvParams from the JAX package's EnvParams as a nested
    dict of numpy arrays ({"map_data": ..., "camera": ...}) and the config
    it was made from."""
    device = resolve_device(device)
    cfg = config if isinstance(config, EnvConfig) else load_config(config)[0]
    params = _build(fenv.EnvParams, arrays, device)
    return dataclasses.replace(params, cfg=cfg)


def vec_state_from_numpy(
    arrays: Dict[str, Any], device="cuda", seed: int = 0
) -> vector.VecState:
    """The port's VecState from the JAX package's VecState as a nested dict
    of numpy arrays ({"env": {"car": ..., "key": ...}, "counters": [...],
    "episode_step": ...}). The per-env PRNG keys are dropped: the port's
    respawn stream is a torch.Generator seeded with `seed`."""
    device = resolve_device(device)
    state = _build(vector.VecState, arrays, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return dataclasses.replace(state, generator=generator)


# flax encoder output (H, W) per flattened size / 64 channels, for the
# reference resolutions 128x160, 64x160 and 256x320
# (tinycarlo_tpu/models/tinycar_net.py:343-353)
_ENCODER_OUT_HW = {20: (4, 5), 10: (2, 5), 80: (8, 10)}


def combo_state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's TinycarCombo state dict from flax TinycarCombo variables
    {"params": ..., "batch_stats": ...} given as nested dicts of numpy
    arrays (e.g. `models.tinycar_net.load_variables_npz` of a bundled
    checkpoint).

    Conv kernels (kh, kw, I, O) become (O, I, kh, kw) and Dense kernels
    (in, out) Linear weights (out, in). The flax encoder flattens its last
    activation NHWC, so the rows of `encoder/Dense_0` come in (h, w, c)
    order; the port flattens NCHW and gets them permuted to (c, h, w) --
    the inverse of tinycar_net.py:311-316. BatchNorm takes `batch_stats`'
    mean and var as its running statistics."""
    params, stats = variables["params"], variables["batch_stats"]
    enc, enc_stats = params["encoder"], stats["encoder"]
    f32 = lambda x: torch.tensor(np.asarray(x, np.float32))  # noqa: E731
    sd: Dict[str, torch.Tensor] = {}
    n_blocks = len([k for k in enc if k.startswith("ConvBlock_")])
    for i in range(n_blocks):
        blk, bst = enc[f"ConvBlock_{i}"], enc_stats[f"ConvBlock_{i}"]
        pre = f"encoder.convs.{i}."
        sd[pre + "conv1.weight"] = f32(
            np.transpose(blk["Conv_0"]["kernel"], (3, 2, 0, 1)))
        sd[pre + "conv1.bias"] = f32(blk["Conv_0"]["bias"])
        sd[pre + "bn1.weight"] = f32(blk["BatchNorm_0"]["scale"])
        sd[pre + "bn1.bias"] = f32(blk["BatchNorm_0"]["bias"])
        sd[pre + "bn1.running_mean"] = f32(bst["BatchNorm_0"]["mean"])
        sd[pre + "bn1.running_var"] = f32(bst["BatchNorm_0"]["var"])
        sd[pre + "bn1.num_batches_tracked"] = torch.tensor(0)
    kernel = enc["Dense_0"]["kernel"]  # (h*w*c, 256), rows NHWC
    c = enc[f"ConvBlock_{n_blocks - 1}"]["Conv_0"]["kernel"].shape[-1]
    h, w = _ENCODER_OUT_HW[kernel.shape[0] // c]
    weight = kernel.T.reshape(-1, h, w, c).transpose(0, 3, 1, 2)
    sd["encoder.fc1.weight"] = f32(weight.reshape(kernel.shape[1], -1))
    sd["encoder.fc1.bias"] = f32(enc["Dense_0"]["bias"])
    actor = params["actor"]
    for part, names in (("trunk", ("fcm1", "fcm2", "fcm3")),
                        ("head", ("fc1", "fc2", "fc3", "fc4"))):
        group = actor["_ManeuverTrunk_0" if part == "trunk" else "_ActorHead_0"]
        for name in names:
            sd[f"actor.{part}.{name}.weight"] = f32(group[name]["kernel"].T)
            sd[f"actor.{part}.{name}.bias"] = f32(group[name]["bias"])
    return sd


# ---------------------------------------------------------------------------
# The TD3 learner: flax params and optax Adam states <-> the port's modules.
# ---------------------------------------------------------------------------

def _get(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def _adam(opt):
    """optax.adam's state -- (ScaleByAdamState, EmptyState), as the
    namedtuples themselves or as dicts -- -> its first part."""
    if isinstance(opt, (tuple, list)) and not hasattr(opt, "mu"):
        opt = opt[0]
    return opt


def td3_param_paths(net: torch.nn.Module, temporal: bool):
    """{port parameter name: (flax path, kind)} of a TD3 actor or critic
    (a critic has `fca`), kind "dense" ((in, out) -> (out, in)), "conv1d"
    ((k, in, out) -> (out, in, k)) or "bias". The temporal critic's trunk
    layers are unnamed in flax (Dense_0 = fcm, Dense_1 = fca;
    tinycar_net.py:256-257)."""
    critic = hasattr(net, "fca")
    out = {}

    def add(port, path, kind):
        out[f"{port}.weight"] = (path + ("kernel",), kind)
        out[f"{port}.bias"] = (path + ("bias",), "bias")

    if temporal:
        for i in range(3):
            add(f"temporal.convs.{i}", ("_TemporalConv_0", f"Conv_{i}"),
                "conv1d")
    if critic:
        names = ("Dense_0", "Dense_1") if temporal else ("fcm", "fca")
        add("fcm", (names[0],), "dense")
        add("fca", (names[1],), "dense")
        add("fc1", ("fc1",), "dense")
        add("fc2", ("fc2",), "dense")
    else:
        for j in range(1, 4):
            add(f"trunk.fcm{j}", ("_ManeuverTrunk_0", f"fcm{j}"), "dense")
        for j in range(1, 5):
            add(f"head.fc{j}", ("_ActorHead_0", f"fc{j}"), "dense")
    if set(out) != {k for k, _ in net.named_parameters()}:
        raise ValueError("the net's parameters do not match the flax map")
    return out


def load_td3_net_from_flax(net: torch.nn.Module, params,
                           temporal: bool) -> torch.nn.Module:
    """Write a flax TD3 net's params (nested numpy arrays) into the port's
    `net` in place; returns it."""
    p = next(net.parameters())
    _load_flax_params(net, params, td3_param_paths(net, temporal), p.device,
                      p.dtype)
    return net


def to_port_layout(x, kind: str) -> np.ndarray:
    """A flax kernel or bias of `kind` (td3_param_paths) in the port's
    layout."""
    x = np.asarray(x)
    if kind == "dense":
        return x.T
    if kind == "conv1d":
        return np.transpose(x, (2, 1, 0))
    return x


def _to_flax(x: np.ndarray, kind):
    if kind == "dense":
        return np.ascontiguousarray(x.T)
    if kind == "conv1d":
        return np.ascontiguousarray(np.transpose(x, (2, 1, 0)))
    return x


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _load_flax_params(net, params, mapping, device, dtype):
    with torch.no_grad():
        for name, p in net.named_parameters():
            path, kind = mapping[name]
            p.copy_(torch.from_numpy(np.array(
                to_port_layout(_at(params, path), kind))).to(device, dtype))


def td3_state_from_flax(state, cfg, device="cuda",
                        dtype: torch.dtype = None):
    """The port's `train.td3.TD3State` from the JAX package's TD3State
    given as nested numpy arrays (e.g. `jax.device_get(state)`, or the
    same as dicts): actor, critics and their targets, and optax Adam's
    count, mu and nu of the three optimisers. Flax Dense kernels (in, out)
    become Linear weights (out, in), Conv1d kernels (k, in, out) become
    (out, in, k). `dtype` defaults to the arrays' own."""
    from tinycarlo_torch.train import td3

    device = resolve_device(device)
    actor, critic = td3.make_nets(cfg)
    maps = {False: td3_param_paths(actor, cfg.temporal),
            True: td3_param_paths(critic, cfg.temporal)}
    if dtype is None:
        leaf = np.asarray(_get(state, "actor")["_ActorHead_0"]["fc1"][
            "kernel"])
        dtype = torch.from_numpy(leaf[:1, :1].copy()).dtype
    nets = {}
    for name in ("actor", "actor_target", "critic1", "critic2",
                 "critic1_target", "critic2_target"):
        is_critic = name.startswith("critic")
        net = td3.make_nets(cfg)[int(is_critic)].to(device, dtype)
        _load_flax_params(net, _get(state, name), maps[is_critic], device,
                          dtype)
        nets[name] = net
    for name in ("actor_target", "critic1_target", "critic2_target"):
        nets[name].requires_grad_(False)
    out = td3.TD3State(
        **nets,
        **{f"opt_{n}": td3.adam_init(nets[n])
           for n in ("actor", "critic1", "critic2")},
        steps=torch.zeros((), dtype=torch.int32, device=device),
    )
    for opt_name, net_name in (("opt_actor", "actor"),
                               ("opt_critic1", "critic1"),
                               ("opt_critic2", "critic2")):
        opt = _adam(_get(state, opt_name))
        mapping = maps[net_name != "actor"]
        port = getattr(out, opt_name)
        port.count.fill_(int(np.asarray(_get(opt, "count"))))
        for which in ("mu", "nu"):
            moments = _get(opt, which)
            for k, t in getattr(port, which).items():
                path, kind = mapping[k]
                t.copy_(torch.from_numpy(np.array(to_port_layout(
                    _at(moments, path), kind))).to(device, dtype))
    out.steps.fill_(int(np.asarray(_get(state, "steps"))))
    return out


def td3_state_to_flax(state, cfg) -> Dict[str, Any]:
    """The inverse of `td3_state_from_flax`: the port's TD3State as the JAX
    package's TD3State layout in nested dicts of numpy arrays, the Adam
    states as {"count", "mu", "nu"}."""
    maps = {False: td3_param_paths(state.actor, cfg.temporal),
            True: td3_param_paths(state.critic1, cfg.temporal)}

    def tree(named, mapping):
        out: Dict[str, Any] = {}
        for name, t in named:
            path, kind = mapping[name]
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = _to_flax(t.detach().cpu().numpy(), kind)
        return out

    out: Dict[str, Any] = {}
    for name in ("actor", "actor_target", "critic1", "critic2",
                 "critic1_target", "critic2_target"):
        out[name] = tree(getattr(state, name).named_parameters(),
                         maps[name.startswith("critic")])
    for opt_name, critic in (("opt_actor", False), ("opt_critic1", True),
                             ("opt_critic2", True)):
        opt = getattr(state, opt_name)
        out[opt_name] = {
            "count": opt.count.cpu().numpy(),
            "mu": tree(opt.mu.items(), maps[critic]),
            "nu": tree(opt.nu.items(), maps[critic]),
        }
    out["steps"] = state.steps.cpu().numpy()
    return out
