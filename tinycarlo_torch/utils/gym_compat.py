"""Gymnasium's base classes when it is installed, and small stand-ins
when it is not.

The Gymnasium entry point (`tinycarlo_torch.gym_env`) and the wrapper
classes (`tinycarlo_torch.wrapper`) subclass `Env` and `Wrapper` from
here. With gymnasium importable they are `gymnasium.Env`,
`gymnasium.Wrapper` and `gymnasium.spaces`; without it the stand-ins
keep what the shim and the wrappers use: `np_random` seeded as
gymnasium seeds it (`np_random` below), `reset(seed=...)`, `unwrapped`,
`close`, `render`, the forwarded spaces, `metadata` and `render_mode`,
and spaces that describe their shape, bounds and dtype (they do not
sample).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

try:
    import gymnasium as gym
except ImportError:
    gym = None


def np_random(seed: Optional[int] = None) -> Tuple[np.random.Generator, int]:
    """`gymnasium.utils.seeding.np_random`: a PCG64 Generator seeded
    through a SeedSequence of `seed` (fresh entropy when None), and the
    sequence's entropy."""
    if seed is not None and not (isinstance(seed, int) and seed >= 0):
        raise ValueError(f"seed must be a non-negative int, got {seed!r}")
    seed_seq = np.random.SeedSequence(seed)
    return np.random.Generator(np.random.PCG64(seed_seq)), seed_seq.entropy


class _Env:
    """gymnasium.Env's seeding and defaults, for a machine without it."""

    metadata: Dict[str, Any] = {"render_modes": []}
    render_mode: Optional[str] = None
    _np_random: Optional[np.random.Generator] = None
    _np_random_seed: Optional[int] = None

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Any] = None):
        if seed is not None:
            self._np_random, self._np_random_seed = np_random(seed)

    @property
    def np_random(self) -> np.random.Generator:
        if self._np_random is None:
            self._np_random, self._np_random_seed = np_random()
        return self._np_random

    @property
    def np_random_seed(self) -> Optional[int]:
        if self._np_random_seed is None:
            self._np_random, self._np_random_seed = np_random()
        return self._np_random_seed

    @property
    def unwrapped(self) -> "_Env":
        return self

    def render(self):
        return None

    def close(self) -> None:
        pass

    def get_wrapper_attr(self, name: str) -> Any:
        return getattr(self, name)


class _Wrapper(_Env):
    """gymnasium.Wrapper's forwarding, for a machine without it."""

    def __init__(self, env: _Env):
        self.env = env

    def step(self, action):
        return self.env.step(action)

    def reset(self, *, seed: Optional[int] = None,
              options: Optional[Any] = None):
        return self.env.reset(seed=seed, options=options)

    def render(self):
        return self.env.render()

    def close(self) -> None:
        return self.env.close()

    @property
    def unwrapped(self) -> _Env:
        return self.env.unwrapped

    @property
    def action_space(self):
        return self.env.action_space

    @property
    def observation_space(self):
        return self.env.observation_space

    @property
    def metadata(self) -> Dict[str, Any]:
        return self.env.metadata

    @property
    def render_mode(self) -> Optional[str]:
        return self.env.render_mode

    @property
    def np_random(self) -> np.random.Generator:
        return self.env.np_random

    @property
    def np_random_seed(self) -> Optional[int]:
        return self.env.np_random_seed

    def get_wrapper_attr(self, name: str) -> Any:
        if hasattr(self, name):
            return getattr(self, name)
        return self.env.get_wrapper_attr(name)


class _Box:
    def __init__(self, low, high, shape: Tuple[int, ...], dtype):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.low = np.full(self.shape, low, self.dtype)
        self.high = np.full(self.shape, high, self.dtype)


class _Discrete:
    def __init__(self, n: int):
        self.n = int(n)
        self.shape = ()
        self.dtype = np.dtype(np.int64)


class _Dict:
    def __init__(self, spaces: Dict[str, Any]):
        self.spaces = dict(spaces)

    def __getitem__(self, key: str):
        return self.spaces[key]


class _Spaces:
    Box = _Box
    Discrete = _Discrete
    Dict = _Dict


Env = gym.Env if gym is not None else _Env
Wrapper = gym.Wrapper if gym is not None else _Wrapper
spaces = gym.spaces if gym is not None else _Spaces
