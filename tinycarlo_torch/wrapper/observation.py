"""Gymnasium observation-noise wrapper, drop-in compatible with the
reference (reference: tinycarlo/wrapper/observation.py);
tinycarlo_tpu/wrapper/observation.py. The noise runs on the env's device
through `tinycarlo_torch.wrapper.functional.add_blob_noise_classes`, the
transform a batched `WrapperStack` applies inside `vector.step`.
"""
import numpy as np
import torch

from tinycarlo_torch.utils.gym_compat import Wrapper
from tinycarlo_torch.wrapper.functional import add_blob_noise_classes


class NoiseObservationWrapper(Wrapper):
    """Random blob noise on "classes" observations: per channel, discs are
    either erased or OR-ed in from a random other channel (p=0.3).
    Reference: wrapper/observation.py:5-33. Its torch.Generator lives on
    the env's device, seeded from numpy's global stream as the JAX
    wrapper seeds its key."""

    def __init__(self, env, blob_max_radius: int = 100, n_blobs: int = 10):
        super().__init__(env)
        self.unwrapped.wrapped = True
        self.max_radius = blob_max_radius
        self.n_blobs = n_blobs
        self._generator = torch.Generator(device=self.unwrapped.device)
        self._generator.manual_seed(np.random.randint(0, 2**31 - 1))

    def add_blob_noise_classes(self, observation: np.ndarray) -> np.ndarray:
        obs = torch.from_numpy(observation).to(self.unwrapped.device)
        return add_blob_noise_classes(
            self._generator, obs, self.max_radius, self.n_blobs
        ).cpu().numpy()

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(action)
        if (
            self.env.unwrapped.observation_space_format == "classes"
            and not self.env.unwrapped.no_observation
        ):
            observation = self.add_blob_noise_classes(observation)
        return observation, reward, terminated, truncated, info
