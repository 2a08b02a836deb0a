"""The least work of one TD3 loop step, from the configuration's widths:
the floating-point operations (an FMA as 2) and the bytes the step has
to move, for `step_mfu.train`'s least time.

Operations: the frozen encoder's forward over the step's frames, the
policy's actor forward over the batch of envs, and each update's nets
over its sampled batch: the target actor and both target critics
forward, both critics forward and backward; on an actor update the actor
forward and backward and critic 1 forward and back to its action input.
A backward counts twice its forward (the weights' and the inputs'
gradients), less the inputs' gradient of the layers that read the batch,
which no one needs. Biases, activations, the mean over the queue, Adam
and the soft updates are left out (elementwise, and in the bytes).

Bytes: the feature queue read and written, the replay rows written and
the sampled rows read, and per update the updated nets' parameters and
Adam moments read and written, the targets read (and written on an actor
update). The frames and the activations between layers are left out: a
fused step need not store them. So both counts are lower bounds.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

FLOAT = 4  # bytes of a float32


def conv1d_flops(c_in: int, c_out: int, length: int, k: int = 3) -> int:
    return 2 * c_in * c_out * k * length


def linear_flops(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def temporal(seq_len: int, channels, length: int) -> List[Tuple[int, int]]:
    """(forward ops, parameters) per layer of a temporal conv stack."""
    chans = (seq_len,) + tuple(channels)
    return [(conv1d_flops(a, b, length), a * b * 3 + b)
            for a, b in zip(chans, chans[1:])]


def _dense(sizes) -> List[Tuple[int, int]]:
    return [(linear_flops(a, b), a * b + b) for a, b in zip(sizes, sizes[1:])]


def actor_layers(lc: Dict):
    """(ops, parameters) of each layer, and the layers that read the
    batch (the first of each branch), of the temporal actor."""
    f = lc["features"]
    t = temporal(lc["seq_len"], (32, 16, 16), f)
    trunk = _dense((lc["maneuver_dim"], 100, 200, f))
    head = _dense((2 * f, 200, 100, 100, lc["action_dim"]))
    return t + trunk + head, [t[0], trunk[0]]


def critic_layers(lc: Dict):
    f = lc["features"]
    t = temporal(lc["seq_len"], (16, 16, 16), f)
    fcm = _dense((lc["maneuver_dim"], f))
    fca = _dense((lc["action_dim"], f))
    head = _dense((3 * f, 512, 1))
    return t + fcm + fca + head, [t[0], fcm[0], fca[0]]


def _fwd(layers) -> int:
    return sum(ops for ops, _ in layers[0])


def _fwd_bwd(layers) -> int:
    """Forward and backward with the weights' and inputs' gradients,
    less the inputs' gradient of the layers reading the batch."""
    return 3 * _fwd(layers) - sum(ops for ops, _ in layers[1])


def _params(layers) -> int:
    return sum(p for _, p in layers[0])


def encoder_flops(h: int, w: int, filters, features: int,
                  channels: int = 3) -> int:
    """Five conv3x3 stride-2 blocks (padding 1) and the linear layer."""
    ops, c = 0, channels
    for f in filters:
        h, w = (h + 1) // 2, (w + 1) // 2
        ops += 2 * h * w * f * c * 9
        c = f
    return ops + linear_flops(c * h * w, features)


def step_work(config: Dict, n_envs: int) -> Dict[str, float]:
    """{"flops_per_step", "bytes_per_step"} of one loop step at the
    configuration's widths (its `learner` block and camera)."""
    lc = config["learner"]
    h, w = config["config"]["camera"]["resolution"]
    a, c = actor_layers(lc), critic_layers(lc)
    n, u = lc["batch_size"], lc["updates_per_step"]
    n_actor = u // lc["policy_delay"]
    critic_update = _fwd(a) + 2 * _fwd(c) + 2 * _fwd_bwd(c)
    # critic 1 back to its action input only: its forward once more
    actor_update = _fwd_bwd(a) + 2 * _fwd(c)
    flops = (n_envs * (encoder_flops(h, w, lc["encoder_filters"],
                                     lc["features"]) + _fwd(a))
             + n * (u * critic_update + n_actor * actor_update))
    f, q = lc["features"], lc["seq_len"]
    row = FLOAT * (2 * q * f + lc["action_dim"] + 1) + 4  # x, x1, a, r, m
    pa, pc = _params(a), _params(c)
    # per update: both critics' parameters and moments read and written,
    # the targets read; per actor update the actor's likewise, and the
    # three targets written
    per_update = FLOAT * (2 * 3 * 2 * pc + pa + 2 * pc)
    per_actor = FLOAT * (2 * 3 * pa + pa + 2 * pc)
    bytes_ = (2 * FLOAT * n_envs * (q + 1) * f + n_envs * row
              + u * n * row + u * per_update + n_actor * per_actor)
    return {"flops_per_step": float(flops), "bytes_per_step": float(bytes_)}
