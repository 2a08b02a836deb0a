"""Gymnasium reward wrappers, drop-in compatible with the reference
(reference: tinycarlo/wrapper/reward.py); tinycarlo_tpu/wrapper/reward.py,
class for class. All add to the incoming reward and set
`unwrapped.wrapped = True`, which disables the env's default reward and
termination (reference: tinycarlo/env.py:136-138).

Host-side shapers of the single-env Gymnasium API, on Python floats; for
batched envs use the shapers in `tinycarlo_torch.wrapper.functional`.
"""
from typing import Dict

from tinycarlo_torch.utils.gym_compat import Wrapper
from tinycarlo_torch.wrapper.utils import linear_reward, sparse_reward


class LanelineSparseRewardWrapper(Wrapper):
    """Sparse reward on laneline touch/cross (distance < track_width/2).
    Reference: wrapper/reward.py:5-23."""

    def __init__(self, env, sparse_rewards: Dict[str, float]):
        super().__init__(env)
        self.unwrapped.wrapped = True
        self.sparse_rewards = sparse_rewards

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(action)
        tw = self.unwrapped.car.track_width
        conditions = {
            name: dist < tw / 2
            for name, dist in info["laneline_distances"].items()
        }
        reward += sparse_reward(conditions, self.sparse_rewards)
        return observation, reward, terminated, truncated, info


class LanelineLinearRewardWrapper(Wrapper):
    """Linear-in-distance laneline reward, zero at track_width.
    Reference: wrapper/reward.py:25-42."""

    def __init__(self, env, max_rewards: Dict[str, float]):
        super().__init__(env)
        self.unwrapped.wrapped = True
        self.max_rewards = max_rewards

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(action)
        tw = self.unwrapped.car.track_width
        for name, dist in info["laneline_distances"].items():
            reward += linear_reward(dist, tw, self.max_rewards[name])
        return observation, reward, terminated, truncated, info


class CTESparseRewardWrapper(Wrapper):
    """Sparse reward while |cte| <= min_cte. Reference: wrapper/reward.py:44-62."""

    def __init__(self, env, min_cte: float, sparse_reward: float = 1.0):
        super().__init__(env)
        self.unwrapped.wrapped = True
        self.min_cte = min_cte
        self.sparse_reward = sparse_reward

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(action)
        reward += sparse_reward(
            {"cte": abs(info["cte"]) <= self.min_cte},
            {"cte": self.sparse_reward},
        )
        return observation, reward, terminated, truncated, info


class CTELinearRewardWrapper(Wrapper):
    """Linear CTE reward ramp. Reference: wrapper/reward.py:64-84."""

    def __init__(
        self,
        env,
        min_cte: float,
        max_reward: float = 1.0,
        min_reward: float = 0.0,
    ):
        super().__init__(env)
        self.unwrapped.wrapped = True
        self.min_cte = min_cte
        self.max_reward = max_reward
        self.min_reward = min_reward

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(action)
        reward += linear_reward(
            info["cte"], self.min_cte, self.max_reward, self.min_reward
        )
        return observation, reward, terminated, truncated, info
