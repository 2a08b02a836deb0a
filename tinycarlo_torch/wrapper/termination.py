"""Gymnasium termination wrappers, drop-in compatible with the reference
(reference: tinycarlo/wrapper/termination.py);
tinycarlo_tpu/wrapper/termination.py, class for class. Batched
equivalents live in `tinycarlo_torch.wrapper.functional`.
"""
from typing import List, Union

from tinycarlo_torch.utils.gym_compat import Env, Wrapper


class LanelineCrossingTerminationWrapper(Wrapper):
    """Terminate when a named laneline distance <= track_width/2.
    Reference: wrapper/termination.py:4-22."""

    def __init__(self, env, lanelines: Union[List[str], str]):
        super().__init__(env)
        self.unwrapped.wrapped = True
        self.lanelines = lanelines if isinstance(lanelines, list) else [lanelines]

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(action)
        tw = self.unwrapped.car.track_width
        for name in self.lanelines:
            if info["laneline_distances"][name] <= tw / 2:
                terminated = True
        return observation, reward, terminated, truncated, info


class _ConsecutiveTerminationWrapper(Wrapper):
    """Shared debounce counter for the two consecutive-condition
    terminations: a per-step predicate over `info` must hold for N
    consecutive steps to terminate; any miss clears the streak, and a
    firing clears it too (so back-to-back episodes re-arm). The counter
    keeps the reference's `steps_true` attribute name for drop-in
    introspection compatibility. The batched equivalents carry the streak
    as a (B,) counter in `wrapper.functional`."""

    def __init__(self, env: Env, number_of_steps: int):
        super().__init__(env)
        self.unwrapped.wrapped = True
        self.number_of_steps = number_of_steps
        self.steps_true = 0

    def _condition(self, info) -> bool:
        raise NotImplementedError

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(action)
        if not self._condition(info):
            self.steps_true = 0
        else:
            self.steps_true += 1
            if self.steps_true >= self.number_of_steps:
                self.steps_true = 0
                terminated = True
        return observation, reward, terminated, truncated, info


class CTETerminationWrapper(_ConsecutiveTerminationWrapper):
    """Terminate after N consecutive steps with |cte| > max_cte; the counter
    resets on success or on firing. Reference: wrapper/termination.py:24-48."""

    def __init__(self, env, max_cte: float, number_of_steps: int = 1):
        super().__init__(env, number_of_steps)
        self.max_cte = max_cte

    def _condition(self, info) -> bool:
        return abs(info["cte"]) > self.max_cte


class CrashTerminationWrapper(_ConsecutiveTerminationWrapper):
    """Terminate after N consecutive steps with |velocity| below threshold
    (stall detection for real-world envs). Reference:
    wrapper/termination.py:50-70 (whose kwarg spells it `velcoity_threshold`;
    both spellings are accepted here for drop-in compatibility)."""

    def __init__(
        self,
        env: Env,
        velocity_threshold: float = 0.005,
        number_of_steps: int = 10,
        **kwargs,
    ):
        super().__init__(env, number_of_steps)
        self.velocity_threshold = kwargs.pop(
            "velcoity_threshold", velocity_threshold
        )
        if kwargs:
            raise TypeError(f"unexpected kwargs: {sorted(kwargs)}")

    def _condition(self, info) -> bool:
        return abs(info["velocity"]) < self.velocity_threshold
