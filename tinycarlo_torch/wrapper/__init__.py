"""Reward, termination and observation shaping.

Two surfaces over the same math, as in tinycarlo_tpu/wrapper/__init__.py:
  * Gymnasium classes (the reference's names and signatures,
    tinycarlo/wrapper/__init__.py) around the single-env
    `tinycarlo_torch.gym_env.TinyCarloEnv`;
  * batched functions and `WrapperStack` in
    `tinycarlo_torch.wrapper.functional`, which `tinycarlo_torch.vector`
    applies inside its step.
"""
from tinycarlo_torch.wrapper.reward import (  # noqa: F401
    CTELinearRewardWrapper,
    CTESparseRewardWrapper,
    LanelineLinearRewardWrapper,
    LanelineSparseRewardWrapper,
)
from tinycarlo_torch.wrapper.termination import (  # noqa: F401
    CrashTerminationWrapper,
    CTETerminationWrapper,
    LanelineCrossingTerminationWrapper,
)
from tinycarlo_torch.wrapper.observation import (  # noqa: F401
    NoiseObservationWrapper,
)
from tinycarlo_torch.wrapper.functional import (  # noqa: F401
    WrapperStack,
    add_blob_noise_classes,
    apply_blob_noise,
    blob_noise_draws,
    cte_linear_reward,
    cte_sparse_reward,
    cte_termination,
    crash_termination,
    laneline_crossing_termination,
    laneline_linear_reward,
    laneline_sparse_reward,
    linear_reward,
)
