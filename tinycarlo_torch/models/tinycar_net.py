"""The tinycar_net combo in PyTorch: encoder + maneuver-conditioned actor.

Counterpart of tinycarlo_tpu/models/tinycar_net.py:42-226 (reference:
examples/models/tinycar_net.py). The JAX package keeps activations NHWC
for the TPU's convolutions; here they are NCHW, PyTorch's layout, and
`pre_obs` moves env observations there. The encoder flattens its last
(64, 4, 5) activation in NCHW order, as the reference torch net does;
`convert.combo_state_dict_from_flax` permutes the flax encoder's dense
rows (flattened NHWC) to match.

`load_pretrained` returns the combo bundled with the JAX package
(tinycarlo_tpu/models/pretrained/*.npz, trained by examples/
train_stanley_il.py), read as data with numpy. The reference's URL
download is not ported. The temporal actor and the critics come with TD3
(ROADMAP M14).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from tinycarlo_torch.utils.helper import resolve_device

FEATURE_VEC_SIZE = 256  # reference TinycarEncoder.FEATURE_VEC_SIZE
DEFAULT_M_DIM = 3
DEFAULT_A_DIM = 1
# flax.linen.BatchNorm's defaults: epsilon, and momentum 0.99 on the
# running average (torch's momentum is the weight of the new batch)
BN_EPS = 1e-5
BN_MOMENTUM = 0.01

_PRETRAINED_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "tinycarlo_tpu", "models", "pretrained",
)


def pre_obs(obs: torch.Tensor) -> torch.Tensor:
    """A batch of env observations -> float NCHW in [0, 1].

    Takes (B, C, H, W) "classes" / "rgb_planar" or (B, H, W, C) "rgb"
    (C = 1 or 3) frames. uint8 gets the reference's obs/255 scaling
    (benchmark_tinycar_net.py:20-21); a float input (the masks kernel's
    0/1 output) is already scaled. A 3-d input is a (B, H, W) rank map (or
    an unbatched frame) and raises: decode rank maps with `pre_obs_rank`.
    (The JAX package's `pre_obs` moves a rank map's batch axis into the
    channels instead, tinycar_net.py:55.)
    """
    if obs.ndim != 4:
        raise ValueError(
            f"pre_obs takes a batch of (C, H, W) or (H, W, C) frames, got "
            f"shape {tuple(obs.shape)}; decode a (B, H, W) rank map with "
            "pre_obs_rank"
        )
    x = obs.float() / 255.0 if obs.dtype == torch.uint8 else obs
    if x.shape[-1] in (1, 3):  # (B, H, W, C) -> (B, C, H, W)
        x = x.permute(0, 3, 1, 2)
    return x.contiguous()


def pre_obs_rank(obs: torch.Tensor, n_layers: int) -> torch.Tensor:
    """(B, H, W) uint8 rank observation -> float NCHW one-hot in {0, 1}:
    channel l is 1 where layer l was painted last -- the classes feed up to
    paint order. tinycarlo_tpu.models.tinycar_net.pre_obs_rank."""
    ids = torch.arange(1, n_layers + 1, dtype=obs.dtype, device=obs.device)
    return (obs[..., None, :, :] == ids[:, None, None]).float()


class ConvBlock(nn.Module):
    """Conv3x3 stride 2 + BatchNorm + ReLU. Reference: tinycar_net.py:18-25."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride=2, padding=1)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        return torch.relu(self.bn1(self.conv1(x)))


class TinycarEncoder(nn.Module):
    """5 conv blocks [24, 36, 48, 64, 64] + FC -> 256-d feature.
    Reference: tinycar_net.py:27-50. `flat_features` is the flattened
    size of the last block's output: 64 * 4 * 5 at 128x160."""

    def __init__(self, in_channels: int = 3,
                 filters: Sequence[int] = (24, 36, 48, 64, 64),
                 flat_features: int = 64 * 4 * 5):
        super().__init__()
        chans = (in_channels,) + tuple(filters)
        self.convs = nn.ModuleList(
            ConvBlock(chans[i], chans[i + 1]) for i in range(len(filters))
        )
        self.fc1 = nn.Linear(flat_features, FEATURE_VEC_SIZE)

    def forward(self, x):
        for block in self.convs:
            x = block(x)
        return torch.relu(self.fc1(x.flatten(1)))


class _ManeuverTrunk(nn.Module):
    """maneuver one-hot -> 100 -> 200 -> in_features MLP.
    Reference: tinycar_net.py:56-58,66-68."""

    def __init__(self, maneuver_dim: int = DEFAULT_M_DIM,
                 in_features: int = FEATURE_VEC_SIZE):
        super().__init__()
        self.fcm1 = nn.Linear(maneuver_dim, 100)
        self.fcm2 = nn.Linear(100, 200)
        self.fcm3 = nn.Linear(200, in_features)

    def forward(self, m):
        m = torch.relu(self.fcm1(m))
        m = torch.relu(self.fcm2(m))
        return torch.relu(self.fcm3(m))


class _ActorHead(nn.Module):
    """concat(feature, maneuver embedding) -> 200 -> 100 -> 100 -> action,
    tanh. Reference: tinycar_net.py:59-71."""

    def __init__(self, in_features: int = FEATURE_VEC_SIZE,
                 action_dim: int = DEFAULT_A_DIM):
        super().__init__()
        self.fc1 = nn.Linear(2 * in_features, 200)
        self.fc2 = nn.Linear(200, 100)
        self.fc3 = nn.Linear(100, 100)
        self.fc4 = nn.Linear(100, action_dim)

    def forward(self, f, m):
        out = torch.cat([f, m], dim=-1)
        out = torch.relu(self.fc1(out))
        out = torch.relu(self.fc2(out))
        out = torch.relu(self.fc3(out))
        return torch.tanh(self.fc4(out))


class TinycarActor(nn.Module):
    """Reference: tinycar_net.py:52-71."""

    def __init__(self, in_features: int = FEATURE_VEC_SIZE,
                 maneuver_dim: int = DEFAULT_M_DIM,
                 action_dim: int = DEFAULT_A_DIM):
        super().__init__()
        self.maneuver_dim = maneuver_dim
        self.trunk = _ManeuverTrunk(maneuver_dim, in_features)
        self.head = _ActorHead(in_features, action_dim)

    def forward(self, f, m):
        return self.head(f, self.trunk(m))


class TinycarCombo(nn.Module):
    """Encoder + actor end to end: (B, C, H, W) float frames and (B, M)
    maneuver one-hots -> (B, A) actions in [-1, 1].
    Reference: tinycar_net.py:100-129."""

    def __init__(self, in_channels: int = 3,
                 maneuver_dim: int = DEFAULT_M_DIM,
                 action_dim: int = DEFAULT_A_DIM,
                 flat_features: int = 64 * 4 * 5):
        super().__init__()
        self.maneuver_dim = maneuver_dim
        self.encoder = TinycarEncoder(in_channels,
                                      flat_features=flat_features)
        self.actor = TinycarActor(FEATURE_VEC_SIZE, maneuver_dim, action_dim)

    def forward(self, x, m):
        return self.actor(self.encoder(x), m)


def load_variables_npz(path: str) -> Dict:
    """A flat npz keyed by '/'-joined paths -> the nested dict of numpy
    arrays it was saved from (the JAX package's checkpoint format for the
    examples; tinycarlo_tpu/train/il.py:197-207)."""
    out: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def load_pretrained(
    image_dim: Tuple[int, int, int],
    maneuver_dim: int = DEFAULT_M_DIM,
    action_dim: int = DEFAULT_A_DIM,
    device="cuda",
) -> Optional[TinycarCombo]:
    """The bundled pretrained combo for `image_dim` ((C, H, W), or the rgb
    observation shape (H, W, C)), in eval mode on `device`; None, with the
    JAX package's message, when there is none. Mirrors
    tinycarlo_tpu.models.tinycar_net.load_pretrained without its download."""
    from tinycarlo_torch.convert import combo_state_dict_from_flax

    device = resolve_device(device)
    if maneuver_dim != DEFAULT_M_DIM or action_dim != DEFAULT_A_DIM:
        print(
            f"No pretrained weights found for image_dim: {image_dim}, "
            f"maneuver_dim: {maneuver_dim}, action_dim: {action_dim}"
        )
        return None
    image_dim = tuple(image_dim)
    if len(image_dim) == 3 and image_dim[-1] in (1, 3):
        image_dim = (image_dim[2], image_dim[0], image_dim[1])
    path = os.path.join(
        _PRETRAINED_DIR,
        "tinycar_combo_flax_{}_{}_{}.npz".format(*image_dim),
    ) if len(image_dim) == 3 else None
    if path is None or not os.path.exists(path):
        print(f"No pretrained weights found for image_dim: {image_dim}")
        return None
    state = combo_state_dict_from_flax(load_variables_npz(path))
    model = TinycarCombo(
        in_channels=image_dim[0],
        flat_features=state["encoder.fc1.weight"].shape[1],
    )
    model.load_state_dict(state)
    print(f"loaded bundled pretrained combo: {path}")
    return model.to(device).eval()
