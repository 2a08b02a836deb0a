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
train_stanley_il.py), read as data with numpy; `load_torch_state_dict`
reads a reference-format torch checkpoint of the combo. The reference's
URL download is not ported.

The TD3 nets (tinycar_net.py:164-265): the maneuver-conditioned critic and
the temporal actor and critic, whose `_TemporalConv` convolves the
(B, seq_len, F) feature queue as it stands -- seq_len is the Conv1d
channel axis and the 256 features its length, as in the reference; the
flax version swaps axes to get that layout. `flax_init_` gives a module
flax's default initialisers (lecun-normal kernels, zero biases), drawn from
a torch.Generator, so that a fresh learner starts from the distribution
`td3.create` draws from (torch's defaults are kaiming-uniform).
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

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


def one_hot(m: torch.Tensor, n: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) integer maneuvers -> (B, n) one-hots of `dtype`, without the
    host sync of torch.nn.functional.one_hot's range check (so a CUDA
    graph can capture it)."""
    ids = torch.arange(n, device=m.device)
    return (m.long()[:, None] == ids).to(dtype)


def pre_obs_rank(obs: torch.Tensor, n_layers: int) -> torch.Tensor:
    """(B, H, W) uint8 rank observation -> float NCHW one-hot in {0, 1}:
    channel l is 1 where layer l was painted last -- the classes feed up to
    paint order. tinycarlo_tpu.models.tinycar_net.pre_obs_rank."""
    ids = torch.arange(1, n_layers + 1, dtype=obs.dtype, device=obs.device)
    return (obs[..., None, :, :] == ids[:, None, None]).float()


class ConvBlock(nn.Module):
    """Conv3x3 stride 2 + BatchNorm + ReLU. Reference: tinycar_net.py:18-25.

    Eval mode is torch's BatchNorm2d on the running statistics. Train mode
    is flax.linen.BatchNorm's: the batch is normalized with its mean and
    biased variance over (N, H, W), and the running statistics move by
    ra = 0.99 * ra + (1 - 0.99) * stat with the *biased* variance (torch's
    BatchNorm2d would take the unbiased one). The update is in place, with
    no host sync, so a CUDA graph can capture it; `num_batches_tracked`
    stays as it is (flax keeps no count)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, features, 3, stride=2, padding=1)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)

    def forward(self, x):
        x = self.conv1(x)
        if not self.training:
            return torch.relu(self.bn1(x))
        bn = self.bn1
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            keep = 1.0 - BN_MOMENTUM
            bn.running_mean.mul_(keep).add_(mean * (1.0 - keep))
            bn.running_var.mul_(keep).add_(var * (1.0 - keep))
        return torch.relu(F.batch_norm(x, None, None, bn.weight, bn.bias,
                                       True, 0.0, bn.eps))


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


class _TemporalConv(nn.Module):
    """Dilated Conv1d stack over a (B, seq_len, F) feature queue: seq_len
    is the channel axis and F the length, dilations (and paddings) 1, 2,
    4, a ReLU after each, then the mean over channels -> (B, F).
    Reference: tinycar_net.py:76-78,88-90,152-154,166-168."""

    def __init__(self, seq_len: int, channels: Sequence[int]):
        super().__init__()
        chans = (seq_len,) + tuple(channels)
        self.convs = nn.ModuleList(
            nn.Conv1d(chans[i], chans[i + 1], 3, dilation=d, padding=d)
            for i, d in enumerate((1, 2, 4))
        )

    def forward(self, f):
        for conv in self.convs:
            f = torch.relu(conv(f))
        return f.mean(dim=1)


class TinycarActorTemporal(nn.Module):
    """(B, seq_len, F) feature queue + maneuver one-hot -> (B, A) actions.
    Reference: tinycar_net.py:73-98."""

    def __init__(self, in_features: int = FEATURE_VEC_SIZE,
                 maneuver_dim: int = DEFAULT_M_DIM,
                 action_dim: int = DEFAULT_A_DIM, seq_len: int = 5):
        super().__init__()
        self.maneuver_dim = maneuver_dim
        self.temporal = _TemporalConv(seq_len, (32, 16, 16))
        self.trunk = _ManeuverTrunk(maneuver_dim, in_features)
        self.head = _ActorHead(in_features, action_dim)

    def forward(self, f, m):
        return self.head(self.temporal(f), self.trunk(m))


class TinycarCritic(nn.Module):
    """(feature, maneuver, action) -> Q. Reference: tinycar_net.py:132-145."""

    def __init__(self, maneuver_dim: int = DEFAULT_M_DIM,
                 action_dim: int = DEFAULT_A_DIM):
        super().__init__()
        self.fcm = nn.Linear(maneuver_dim, FEATURE_VEC_SIZE)
        self.fca = nn.Linear(action_dim, FEATURE_VEC_SIZE)
        self.fc1 = nn.Linear(3 * FEATURE_VEC_SIZE, 512)
        self.fc2 = nn.Linear(512, 1)

    def features(self, f):
        return f

    def forward(self, f, m, a):
        m = torch.relu(self.fcm(m))
        a = torch.relu(self.fca(a))
        out = torch.cat([self.features(f), m, a], dim=-1)
        return self.fc2(torch.relu(self.fc1(out)))


class TinycarCriticTemporal(TinycarCritic):
    """(feature queue, maneuver, action) -> Q.
    Reference: tinycar_net.py:147-166."""

    def __init__(self, maneuver_dim: int = DEFAULT_M_DIM,
                 action_dim: int = DEFAULT_A_DIM, seq_len: int = 5):
        super().__init__(maneuver_dim, action_dim)
        self.temporal = _TemporalConv(seq_len, (16, 16, 16))

    def features(self, f):
        return self.temporal(f)


# flax's truncated normal: a standard normal cut to [-2, 2] has this
# standard deviation (flax.linen.initializers.variance_scaling)
_TRUNC_STD = 0.87962566103423978


def flax_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Re-initialise `module` in place as flax.linen does by default:
    every Linear and Conv kernel lecun-normal (a normal truncated to two
    standard deviations, scaled to variance 1 / fan_in), every bias zero,
    BatchNorm scale 1, bias 0 and running statistics 0 / 1. Draws come
    from `generator`, in the order of `module.modules()`."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return module


def encoder_flat_features(h: int, w: int,
                          filters: Sequence[int] = (24, 36, 48, 64, 64)
                          ) -> int:
    """`TinycarEncoder`'s flat_features for (h, w) frames: each stride-2
    block takes a side n to ceil(n / 2)."""
    for _ in filters:
        h, w = (h + 1) // 2, (w + 1) // 2
    return filters[-1] * h * w


def encoder_apply_fn(encoder: nn.Module):
    """`encoder_apply(obs) -> (B, 256) features` of a frozen encoder, for
    the TD3 loop: `pre_obs`, then the frames cast to the encoder's dtype
    (0/1 masks in float32 or bfloat16 are exact in either; a float32
    Conv2d refuses a bfloat16 input, which flax would promote), and no
    autograd. The features come in the encoder's dtype."""
    dtype = next(encoder.parameters()).dtype

    def apply(obs):
        with torch.no_grad():
            return encoder(pre_obs(obs).to(dtype))

    return apply


def _encoder_out_hw(sd: Dict[str, torch.Tensor]) -> Tuple[int, int, int]:
    """The conv stack's output (C, H, W) from fc1's input size, given its
    64 channels and the reference resolutions. tinycar_net.py:343-353."""
    in_size = sd["encoder.fc1.weight"].shape[1]
    c = 64
    hw = in_size // c
    # the two reference aspect ratios: 128x160 -> 4x5, 64x160 -> 2x5
    for h, w in ((4, 5), (2, 5), (8, 10)):
        if h * w == hw:
            return c, h, w
    raise ValueError(f"unrecognized encoder output size {in_size}")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference TinycarCombo torch checkpoint (examples/models/
    tinycar_net.py:9-13,113-129) -> the state dict of the port's
    `TinycarCombo`, on the CPU. The key map of tinycarlo_tpu's
    `load_torch_state_dict` (tinycar_net.py:293-336): the encoder's keys
    as they are (both flatten NCHW, so fc1 needs no permutation), the
    actor's fcm1-3 under `actor.trunk`, fc1-4 under `actor.head`."""
    sd = torch.load(path, map_location="cpu")
    _encoder_out_hw(sd)
    out: Dict[str, torch.Tensor] = {}
    for i in range(5):
        for part in ("conv1.weight", "conv1.bias", "bn1.weight", "bn1.bias",
                     "bn1.running_mean", "bn1.running_var"):
            key = f"encoder.convs.{i}.{part}"
            out[key] = sd[key].float()
        out[f"encoder.convs.{i}.bn1.num_batches_tracked"] = torch.tensor(0)
    for part in ("weight", "bias"):
        out[f"encoder.fc1.{part}"] = sd[f"encoder.fc1.{part}"].float()
        for j in range(3):
            out[f"actor.trunk.fcm{j + 1}.{part}"] = (
                sd[f"actor.fcm{j + 1}.{part}"].float())
        for j in range(4):
            out[f"actor.head.fc{j + 1}.{part}"] = (
                sd[f"actor.fc{j + 1}.{part}"].float())
    return out


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
