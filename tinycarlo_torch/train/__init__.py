"""Training on the device: TD3, Stanley imitation learning, replay,
evaluation and the Stanley expert. The JAX package's export names
(tinycarlo_tpu/train/__init__.py), with one difference: `train.evaluate`
stays the module (call `train.evaluate.evaluate`), as callers of the port
import it, where the JAX package binds the name to the function."""
from tinycarlo_torch.train import evaluate, replay  # noqa: F401
from tinycarlo_torch.train.evaluate import (  # noqa: F401
    combo_policy,
    standard_stack,
    temporal_policy,
)
from tinycarlo_torch.train.il import ILConfig, ILState  # noqa: F401
from tinycarlo_torch.train.il import collect_dataset, randomize_camera  # noqa: F401
from tinycarlo_torch.train.il import create as il_create  # noqa: F401
from tinycarlo_torch.train.il import train_step as il_train_step  # noqa: F401
from tinycarlo_torch.train.stanley import ou_step, stanley_steering  # noqa: F401
from tinycarlo_torch.train.td3 import TD3Config, TD3State  # noqa: F401
from tinycarlo_torch.train.td3 import create as td3_create  # noqa: F401
from tinycarlo_torch.train.td3 import select_action  # noqa: F401
from tinycarlo_torch.train.td3 import train_step as td3_train_step  # noqa: F401
