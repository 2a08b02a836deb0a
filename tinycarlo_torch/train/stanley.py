"""Stanley lateral controller + Ornstein-Uhlenbeck noise, batched.

Counterpart of tinycarlo_tpu/train/stanley.py (reference:
examples/train_stanley_il.py:62-66, examples/stanley_control.py:52-63,
train_td3.py:105).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def stanley_steering(
    cte: torch.Tensor,
    heading_error: torch.Tensor,
    speed: float,
    k: float,
    max_steering_angle: float,
) -> torch.Tensor:
    """Normalized steering command in [-1, 1]-ish units (pre-clip):
    (heading_error + atan2(K*cte, speed)) * 180/pi / max_angle.
    Reference: train_stanley_il.py:62-65 (K=5), stanley_control.py:55-57."""
    correction = torch.atan2(k * cte, torch.full_like(cte, speed))
    return (heading_error + correction) * 180.0 / math.pi / max_steering_angle


def ou_step(
    noise: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    theta: float = 0.1,
    mean: float = 0.0,
    sigma: float = 0.4,
) -> torch.Tensor:
    """One Ornstein-Uhlenbeck step: n += theta*(mean-n) + sigma*N(0,1).
    Reference: train_td3.py:105. The normal draws come from `generator`
    (torch's stream, not jax.random's)."""
    eps = torch.randn(
        noise.shape, generator=generator, dtype=noise.dtype,
        device=noise.device,
    )
    return noise + theta * (mean - noise) + sigma * eps
