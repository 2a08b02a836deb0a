"""Carry the JAX package's params and state across to the port.

`env_params_from_numpy` and `vec_state_from_numpy` build the port's
EnvParams / VecState from the JAX package's EnvParams / VecState given as
nested dicts of numpy arrays -- each dataclass's fields by name, e.g.
{"map_data": {"lanepath": {"next_table": array, ...}, ...,
"packed_layer_bounds": (0, 192, ...)}, "camera": {"E": array, "K": array}}
-- so both packages can be fed the same state. Arrays keep their dtypes.
`combo_state_dict_from_flax` turns the flax variables of a TinycarCombo
into the state dict of the port's `models.tinycar_net.TinycarCombo`;
`combo_state_dict_to_flax` is its inverse; `td3_state_from_flax` (and its
inverse `td3_state_to_flax`) carries a TD3 learner across: its nets,
targets and optax Adam states, and `il_state_from_flax` /
`il_state_to_flax` an imitation learner: its combo and Adam state.
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
_ENCODER_OUT_C = 64  # the last conv block's channels


def _combo_path(name: str):
    """(flax path, kind) of a parameter or BatchNorm buffer of the port's
    TinycarCombo, by its state-dict name. Kinds: "conv2d" ((kh, kw, I, O)
    <-> (O, I, kh, kw)), "dense" ((in, out) <-> (out, in)), "fc1" (the
    encoder's Dense, whose rows are also permuted, NHWC <-> NCHW) and
    "vector" (as it is). A buffer's path is under `batch_stats`."""
    parts = name.split(".")
    leaf = {"weight": "kernel", "bias": "bias"}
    if parts[0] == "encoder" and parts[1] == "convs":
        block = ("encoder", f"ConvBlock_{parts[2]}")
        if parts[3] == "conv1":
            return (block + ("Conv_0", leaf[parts[4]]),
                    "conv2d" if parts[4] == "weight" else "vector")
        bn = {"weight": "scale", "bias": "bias", "running_mean": "mean",
              "running_var": "var"}[parts[4]]
        return block + ("BatchNorm_0", bn), "vector"
    if parts[0] == "encoder":
        return (("encoder", "Dense_0", leaf[parts[2]]),
                "fc1" if parts[2] == "weight" else "vector")
    group = {"trunk": "_ManeuverTrunk_0", "head": "_ActorHead_0"}[parts[1]]
    return (("actor", group, parts[2], leaf[parts[3]]),
            "dense" if parts[3] == "weight" else "vector")


def _combo_to_port(x: np.ndarray, kind: str) -> np.ndarray:
    """A flax combo array of `kind` (_combo_path) in the port's layout.
    The flax encoder flattens its last activation NHWC, so the rows of
    `encoder/Dense_0` come in (h, w, c) order; the port flattens NCHW and
    gets them permuted to (c, h, w) -- the inverse of tinycar_net.py:
    311-316."""
    x = np.asarray(x)
    if kind == "conv2d":
        return np.transpose(x, (3, 2, 0, 1))
    if kind == "dense":
        return x.T
    if kind == "fc1":
        c = _ENCODER_OUT_C
        h, w = _ENCODER_OUT_HW[x.shape[0] // c]
        return x.T.reshape(-1, h, w, c).transpose(0, 3, 1, 2).reshape(
            x.shape[1], -1)
    return x


def _combo_to_flax(x: np.ndarray, kind: str) -> np.ndarray:
    """The inverse of `_combo_to_port`."""
    if kind == "conv2d":
        x = np.transpose(x, (2, 3, 1, 0))
    elif kind == "dense":
        x = x.T
    elif kind == "fc1":
        c = _ENCODER_OUT_C
        h, w = _ENCODER_OUT_HW[x.shape[1] // c]
        x = x.reshape(-1, c, h, w).transpose(0, 2, 3, 1).reshape(
            x.shape[0], -1).T
    return np.ascontiguousarray(x)


def _combo_names(variables: Dict[str, Any]):
    """The port's state-dict names of a flax combo's variables."""
    n_blocks = len([k for k in variables["params"]["encoder"]
                    if k.startswith("ConvBlock_")])
    names = []
    for i in range(n_blocks):
        pre = f"encoder.convs.{i}."
        names += [pre + "conv1.weight", pre + "conv1.bias"] + [
            pre + "bn1." + k for k in ("weight", "bias", "running_mean",
                                       "running_var")]
    names += ["encoder.fc1.weight", "encoder.fc1.bias"]
    for part, layers in (("trunk", ("fcm1", "fcm2", "fcm3")),
                         ("head", ("fc1", "fc2", "fc3", "fc4"))):
        names += [f"actor.{part}.{n}.{w}" for n in layers
                  for w in ("weight", "bias")]
    return names


def flat_paths(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{'/'-joined path: leaf} of a nested dict, keys sorted at every level
    (the order of jax.tree_util's flattening): the flat npz layout of the
    JAX package's `save_variables_npz`."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flat_paths(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def combo_state_dict_from_flax(variables: Dict[str, Any],
                               dtype: torch.dtype = torch.float32
                               ) -> Dict[str, torch.Tensor]:
    """The port's TinycarCombo state dict, in `dtype`, from flax
    TinycarCombo variables {"params": ..., "batch_stats": ...} given as
    nested dicts of numpy arrays (e.g. `models.tinycar_net.
    load_variables_npz` of a bundled checkpoint).

    Conv kernels (kh, kw, I, O) become (O, I, kh, kw) and Dense kernels
    (in, out) Linear weights (out, in); the encoder's Dense rows are
    permuted from NHWC to NCHW flattening (`_combo_to_port`). BatchNorm
    takes `batch_stats`' mean and var as its running statistics."""
    sd: Dict[str, torch.Tensor] = {}
    for name in _combo_names(variables):
        path, kind = _combo_path(name)
        tree = variables["batch_stats" if "running" in name else "params"]
        sd[name] = torch.from_numpy(np.array(
            _combo_to_port(_at(tree, path), kind))).to(dtype)
        if name.endswith("running_var"):
            sd[name.replace("running_var", "num_batches_tracked")] = (
                torch.tensor(0))
    return sd


def combo_state_dict_to_flax(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of `combo_state_dict_from_flax`: the port's TinycarCombo
    state dict (or the module) as flax variables {"params", "batch_stats"}
    in nested dicts of numpy arrays, in the tensors' dtype."""
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()
    out: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for name, t in sd.items():
        if name.endswith("num_batches_tracked"):
            continue
        path, kind = _combo_path(name)
        node = out["batch_stats" if "running" in name else "params"]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _combo_to_flax(t.detach().cpu().numpy(), kind)
    return out


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


# ---------------------------------------------------------------------------
# The imitation learner: a flax TinycarCombo and its optax Adam state.
# ---------------------------------------------------------------------------

def il_state_from_flax(state, cfg, device="cuda",
                       dtype: torch.dtype = None):
    """The port's `train.il.ILState` from the JAX package's ILState given
    as nested numpy arrays (e.g. `jax.device_get(state)`, or the same as
    dicts {"variables", "opt_state"}): the combo's parameters and running
    statistics, and optax Adam's count, mu and nu, each in the port's
    layout (`combo_state_dict_from_flax`). `dtype` defaults to the arrays'
    own. The model comes in eval mode."""
    from tinycarlo_torch.train import il

    device = resolve_device(device)
    variables = _get(state, "variables")
    if dtype is None:
        leaf = np.asarray(variables["params"]["encoder"]["Dense_0"]["bias"])
        dtype = torch.from_numpy(leaf[:1].copy()).dtype
    sd = combo_state_dict_from_flax(variables, dtype)
    out = il.state_from_state_dict(sd, cfg, device)
    opt = _adam(_get(state, "opt_state"))
    out.opt.count.fill_(int(np.asarray(_get(opt, "count"))))
    for which in ("mu", "nu"):
        moments = _get(opt, which)
        for k, t in getattr(out.opt, which).items():
            path, kind = _combo_path(k)
            t.copy_(torch.from_numpy(np.array(_combo_to_port(
                _at(moments, path), kind))).to(device, dtype))
    return out


def il_state_to_flax(state, cfg) -> Dict[str, Any]:
    """The inverse of `il_state_from_flax`: the port's ILState as the JAX
    package's ILState layout in nested dicts of numpy arrays,
    {"variables": {"params", "batch_stats"}, "opt_state": {"count", "mu",
    "nu"}}."""
    def tree(named):
        out: Dict[str, Any] = {}
        for name, t in named:
            path, kind = _combo_path(name)
            node = out
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = _combo_to_flax(t.detach().cpu().numpy(), kind)
        return out

    opt = state.opt
    return {
        "variables": combo_state_dict_to_flax(state.model),
        "opt_state": {"count": opt.count.cpu().numpy(),
                      "mu": tree(opt.mu.items()),
                      "nu": tree(opt.nu.items())},
    }
