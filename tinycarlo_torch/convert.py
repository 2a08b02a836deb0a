"""Carry the JAX package's params and state across to the port.

`env_params_from_numpy` and `vec_state_from_numpy` build the port's
EnvParams / VecState from the JAX package's EnvParams / VecState given as
nested dicts of numpy arrays -- each dataclass's fields by name, e.g.
{"map_data": {"lanepath": {"next_table": array, ...}, ...,
"packed_layer_bounds": (0, 192, ...)}, "camera": {"E": array, "K": array}}
-- so both packages can be fed the same state. Arrays keep their dtypes.
`combo_state_dict_from_flax` turns the flax variables of a TinycarCombo
into the state dict of the port's `models.tinycar_net.TinycarCombo`.
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
