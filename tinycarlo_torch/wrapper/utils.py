"""Scalar shaping helpers for the Gymnasium wrapper classes.

Counterpart of tinycarlo_tpu/wrapper/utils.py (reference:
tinycarlo/wrapper/utils.py): host-side Python floats, so the class
wrappers shape rewards as the reference does, value for value. The
batched versions live in `tinycarlo_torch.wrapper.functional`.
"""
from typing import Dict


def sparse_reward(
    conditions: Dict[str, bool], sparse_rewards: Dict[str, float]
) -> float:
    """Sum of rewards whose condition holds. Reference: wrapper/utils.py:3-19."""
    reward = 0.0
    for name, condition in conditions.items():
        if condition and name in sparse_rewards:
            reward += sparse_rewards[name]
    return reward


def linear_reward(
    x: float, max_x: float, max_reward: float = 1.0, min_reward: float = 0.0
) -> float:
    """Linear ramp from max_reward at |x|=0 to zero at |x|=max_x, clamped
    toward min_reward. Reference: wrapper/utils.py:21-36."""
    y = (-max_reward / max_x) * abs(x) + max_reward
    if max_reward > 0:
        return max(y, min_reward)
    return min(y, min_reward)
