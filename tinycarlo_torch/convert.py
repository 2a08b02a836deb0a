"""Carry the JAX package's params and state across to the port.

`env_params_from_numpy` and `vec_state_from_numpy` build the port's
EnvParams / VecState from the JAX package's EnvParams / VecState given as
nested dicts of numpy arrays -- each dataclass's fields by name, e.g.
{"map_data": {"lanepath": {"next_table": array, ...}, ...,
"packed_layer_bounds": (0, 192, ...)}, "camera": {"E": array, "K": array}}
-- so both packages can be fed the same state. Arrays keep their dtypes.
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
