"""Composable pure reward/termination shaping, batched.

Counterpart of tinycarlo_tpu/wrapper/functional.py:30-158, 215-263
(reference: tinycarlo/wrapper/reward.py, termination.py, utils.py):

    reward = shaper(info)                               (stateless)
    terminated, counters' = terminator(info, counters)  (stateful)

over (B, ...) info tensors, so a whole stack runs inside vector.step.
Layer-name-keyed dicts become per-layer coefficient vectors aligned with
`MapData.laneline_names`.

Not ported yet: `add_blob_noise_classes` and the stack's observation
transforms (ROADMAP M12).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

import torch


def linear_reward(x, max_x, max_reward=1.0, min_reward=0.0):
    """Linear ramp: max_reward at |x|=0, zero at |x|=max_x, clamped, with
    the reference's sign-dependent clamp (wrapper/utils.py:21-36)."""
    y = (-max_reward / max_x) * torch.abs(x) + max_reward
    if max_reward > 0:
        return torch.clamp_min(y, min_reward)
    return torch.clamp_max(y, min_reward)


def _coeffs(
    values: Dict[str, float], layer_names: Sequence[str], like: torch.Tensor
) -> torch.Tensor:
    return torch.tensor(
        [values.get(n, 0.0) for n in layer_names],
        dtype=like.dtype, device=like.device,
    )


def laneline_sparse_reward(
    info: Dict[str, torch.Tensor],
    track_width: float,
    rewards: Dict[str, float],
    layer_names: Sequence[str],
) -> torch.Tensor:
    """Sparse reward when a laneline is touched/crossed (distance <
    track_width/2). Reference: wrapper/reward.py:5-23."""
    dist = info["laneline_distances"]
    c = _coeffs(rewards, layer_names, dist)
    hit = dist < track_width / 2
    return torch.where(hit, c, 0.0).sum(dim=-1)


def laneline_linear_reward(
    info: Dict[str, torch.Tensor],
    track_width: float,
    max_rewards: Dict[str, float],
    layer_names: Sequence[str],
) -> torch.Tensor:
    """Linear-in-distance laneline reward, zero at track_width.
    Reference: wrapper/reward.py:25-42 (requires a value for every layer)."""
    dist = info["laneline_distances"]
    total = torch.zeros(dist.shape[:-1], dtype=dist.dtype, device=dist.device)
    for i, name in enumerate(layer_names):
        total = total + linear_reward(dist[..., i], track_width, max_rewards[name])
    return total


def cte_sparse_reward(
    info: Dict[str, torch.Tensor], min_cte: float, sparse: float = 1.0
) -> torch.Tensor:
    """Reward `sparse` while |cte| <= min_cte. Reference: wrapper/reward.py:44-62."""
    cte = info["cte"]
    return torch.where(torch.abs(cte) <= min_cte, torch.full_like(cte, sparse),
                       torch.zeros_like(cte))


def cte_linear_reward(
    info: Dict[str, torch.Tensor],
    min_cte: float,
    max_reward: float = 1.0,
    min_reward: float = 0.0,
) -> torch.Tensor:
    """Linear CTE reward ramp. Reference: wrapper/reward.py:64-84."""
    return linear_reward(info["cte"], min_cte, max_reward, min_reward)


def laneline_crossing_termination(
    info: Dict[str, torch.Tensor],
    track_width: float,
    lanelines: Sequence[str],
    layer_names: Sequence[str],
) -> torch.Tensor:
    """Terminate when any named laneline distance <= track_width/2.
    Reference: wrapper/termination.py:4-22."""
    dist = info["laneline_distances"]
    sel = torch.tensor(
        [n in lanelines for n in layer_names], device=dist.device
    )
    return ((dist <= track_width / 2) & sel).any(dim=-1)


def count_consecutive(
    condition: torch.Tensor, counter: torch.Tensor, number_of_steps: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Consecutive-step trigger: the counter increments while `condition`
    holds, fires at `number_of_steps`, and resets on fire or on any
    non-condition step (reference wrapper/termination.py:39-48,63-70)."""
    counter = torch.where(condition, counter + 1, 0)
    fired = counter >= number_of_steps
    return fired, torch.where(fired, 0, counter)


def cte_termination(
    info: Dict[str, torch.Tensor],
    counter: torch.Tensor,
    max_cte: float,
    number_of_steps: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Terminate after N consecutive steps with |cte| > max_cte.
    Reference: wrapper/termination.py:24-48."""
    return count_consecutive(
        torch.abs(info["cte"]) > max_cte, counter, number_of_steps
    )


def crash_termination(
    info: Dict[str, torch.Tensor],
    counter: torch.Tensor,
    velocity_threshold: float = 0.005,
    number_of_steps: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Terminate after N consecutive steps with |velocity| below threshold.
    Reference: wrapper/termination.py:50-70."""
    return count_consecutive(
        torch.abs(info["velocity"]) < velocity_threshold, counter,
        number_of_steps,
    )


RewardFn = Callable[[Dict[str, torch.Tensor]], torch.Tensor]
TerminationFn = Callable[
    [Dict[str, torch.Tensor], torch.Tensor], Tuple[torch.Tensor, torch.Tensor]
]


@dataclass(frozen=True)
class WrapperStack:
    """A fused wrapper stack: sum of reward shapers, OR of terminators.

    When a stack carries reward or termination fns the env's default
    shaping is off, mirroring `unwrapped.wrapped = True` (reference
    wrapper/reward.py:16, env.py:136-138). Counters are (B,) int32
    tensors, one per termination fn, carried in vector.VecState.
    """

    reward_fns: Tuple[RewardFn, ...] = ()
    termination_fns: Tuple[TerminationFn, ...] = ()

    def apply(
        self,
        info: Dict[str, torch.Tensor],
        reward: torch.Tensor,
        terminated: torch.Tensor,
        counters: Tuple[torch.Tensor, ...],
    ):
        for fn in self.reward_fns:
            reward = reward + fn(info)
        new_counters = []
        for fn, counter in zip(self.termination_fns, counters):
            fired, counter = fn(info, counter)
            terminated = terminated | fired
            new_counters.append(counter)
        return reward, terminated, tuple(new_counters)
