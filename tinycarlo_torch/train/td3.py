"""TD3 (twin delayed DDPG): the update steps on the device.

Counterpart of tinycarlo_tpu/train/td3.py:31-234, with its math as that
module states it (reference: examples/train_td3.py:105-138): twin critics
regressed to min(Q1', Q2') * gamma + r from the target nets (the reference
applies no terminal mask, and neither does this), MSE critic losses, the
actor updated every `policy_delay` steps to maximise critic 1, and the tau
soft updates of all three targets done only inside the actor update.

Losses and gradients come from torch autograd (`torch.autograd.grad` with
respect to fresh leaves over the parameters' storage, so no `.grad` is
ever set and no earlier graph's accumulator is reused). Adam is optax's
`adam` (`scale_by_adam`, then the learning rate) with its step count on
the device:
    mu = (1 - b1) g + b1 mu,  nu = (1 - b2) g^2 + b2 nu,  t += 1,
    u = -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t) + 0) + eps),
the bias corrections computed in float64 and cast to the parameters'
dtype, as optax does with 64-bit floats on. torch.optim.Adam orders it
as sqrt(v) / sqrt(1 - b2^t) and does not agree with optax to rounding.

Unlike the JAX package's pure functions, the updates here change the state
in place (parameters, Adam moments, counts and targets): the replayed
CUDA graphs of the training loop read and write the state's own tensors.
`train_step` takes its actor branch from the host (`do_actor`), since a
graph cannot branch on a device value; without it, it reads the count.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from tinycarlo_torch.models.tinycar_net import (
    DEFAULT_A_DIM,
    DEFAULT_M_DIM,
    TinycarActor,
    TinycarActorTemporal,
    TinycarCritic,
    TinycarCriticTemporal,
    flax_init_,
)
from tinycarlo_torch.utils.helper import resolve_device

# optax.adam's defaults
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_INT32_MAX = 2 ** 31 - 1


@dataclass(frozen=True)
class TD3Config:
    """Hyperparameters; the defaults of tinycarlo_tpu's TD3Config (reference
    train_td3.py:25-34,41-46)."""

    batch_size: int = 256
    discount_factor: float = 0.99
    tau: float = 0.001
    policy_delay: int = 2
    lr_actor: float = 1e-4
    lr_critic: float = 2e-4
    noise_theta: float = 0.1
    noise_mean: float = 0.0
    noise_sigma: float = 0.4
    seq_len: int = 10
    maneuver_dim: int = DEFAULT_M_DIM
    action_dim: int = DEFAULT_A_DIM
    temporal: bool = True


@dataclass
class AdamState:
    """optax ScaleByAdamState: the step count (() int32) and the moments,
    keyed by parameter name."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclass
class TD3State:
    actor: nn.Module
    actor_target: nn.Module
    critic1: nn.Module
    critic2: nn.Module
    critic1_target: nn.Module
    critic2_target: nn.Module
    opt_actor: AdamState
    opt_critic1: AdamState
    opt_critic2: AdamState
    steps: torch.Tensor  # () int32 update counter (drives the policy delay)


def make_nets(cfg: TD3Config) -> Tuple[nn.Module, nn.Module]:
    """(actor, critic) modules of the config, torch-initialised on the
    CPU."""
    if cfg.temporal:
        return (TinycarActorTemporal(maneuver_dim=cfg.maneuver_dim,
                                     action_dim=cfg.action_dim,
                                     seq_len=cfg.seq_len),
                TinycarCriticTemporal(cfg.maneuver_dim, cfg.action_dim,
                                      cfg.seq_len))
    return (TinycarActor(maneuver_dim=cfg.maneuver_dim,
                         action_dim=cfg.action_dim),
            TinycarCritic(cfg.maneuver_dim, cfg.action_dim))


def _target(net: nn.Module) -> nn.Module:
    target = copy.deepcopy(net)
    target.requires_grad_(False)
    return target


def adam_init(net: nn.Module) -> AdamState:
    """Zero moments and count, as optax's `init_fn`."""
    params = dict(net.named_parameters())
    dev = next(iter(params.values())).device
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
    )


def create(cfg: TD3Config, seed: int = 0, device="cuda",
           dtype: torch.dtype = torch.float32) -> TD3State:
    """A fresh learner: actor and critics with flax's initialisers, drawn
    on the CPU from a torch.Generator seeded with `seed` (so the weights do
    not depend on the device), then moved to `device`; the targets start
    as copies (train_td3.py:87-92), the optimisers and the update count at
    zero. The JAX package draws the weights from `jax.random.key`; the
    streams differ."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    actor, critic1 = make_nets(cfg)
    actor, critic1, critic2 = (
        flax_init_(net, generator).to(device=device, dtype=dtype)
        for net in (actor, critic1, make_nets(cfg)[1]))
    return TD3State(
        actor=actor, actor_target=_target(actor),
        critic1=critic1, critic2=critic2,
        critic1_target=_target(critic1), critic2_target=_target(critic2),
        opt_actor=adam_init(actor), opt_critic1=adam_init(critic1),
        opt_critic2=adam_init(critic2),
        steps=torch.zeros((), dtype=torch.int32, device=device),
    )


def apply_actor(cfg: TD3Config, net: nn.Module, f, m):
    return net(f, m)


def apply_critic(cfg: TD3Config, net: nn.Module, f, m, a):
    return net(f, m, a)


def _params(net: nn.Module) -> Tuple[List[str], List[torch.Tensor]]:
    names, params = zip(*net.named_parameters())
    return list(names), list(params)


def adam_update(params: List[torch.Tensor], grads, opt: AdamState,
                names: List[str], lr: float, b1: float = ADAM_B1,
                b2: float = ADAM_B2, eps: float = ADAM_EPS) -> None:
    """One `optax.adam(lr)` step on `params`, in place: the moments and
    the count of `opt` and the parameters, in optax's order of operations
    (module docstring). Capturable in a CUDA graph: no host sync."""
    grads = list(grads)
    mu = [opt.mu[k] for k in names]
    nu = [opt.nu[k] for k in names]
    with torch.no_grad():
        g_b1 = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, g_b1)
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, g2)
        # optax's safe_increment: the count stops at int32's max
        opt.count.copy_(torch.where(opt.count < _INT32_MAX, opt.count + 1,
                                    opt.count))
        t = opt.count.to(torch.float64)
        dtype = params[0].dtype
        bc1 = (1.0 - torch.pow(b1, t)).to(dtype)
        bc2 = (1.0 - torch.pow(b2, t)).to(dtype)
        mu_hat = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_add_(den, 0.0)  # eps_root
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)


def _soft(tau: float, online: nn.Module, target: nn.Module) -> None:
    """target = tau * online + (1 - tau) * target, in place."""
    with torch.no_grad():
        on = [p for _, p in online.named_parameters()]
        tg = [p for _, p in target.named_parameters()]
        scaled = torch._foreach_mul(on, tau)
        torch._foreach_mul_(tg, 1.0 - tau)
        torch._foreach_add_(tg, scaled)


def _leaves(net: nn.Module, grad: bool) -> Dict[str, torch.Tensor]:
    """The net's parameters as fresh leaves over the same storage (with
    autograd when `grad`). Gradients are taken with respect to these, not
    to the parameters: autograd keeps one accumulator node per leaf, with
    the stream it was made on, for as long as any graph through the leaf
    lives, and a node made on another stream breaks a CUDA graph's
    capture."""
    return {n: p.detach().requires_grad_(grad)
            for n, p in net.named_parameters()}


def _call(net: nn.Module, leaves, *args):
    return torch.func.functional_call(net, leaves, args)


def critic_losses_and_grads(state: TD3State, cfg: TD3Config,
                            batch: Dict[str, torch.Tensor]):
    """((l1, l2), (g1, g2)): the twin critics' MSE losses against the
    min target (train_td3.py:105-124) and their gradients, in the order of
    `named_parameters()`, parameters unchanged. batch keys: x, m
    (one-hot), a, r, x1, m1."""
    with torch.no_grad():
        ta = state.actor_target(batch["x1"], batch["m1"])
        tq1 = state.critic1_target(batch["x1"], batch["m1"], ta)
        tq2 = state.critic2_target(batch["x1"], batch["m1"], ta)
        target_q = torch.minimum(tq1, tq2) * cfg.discount_factor + batch["r"]
    losses, grads = [], []
    for net in (state.critic1, state.critic2):
        leaves = _leaves(net, True)
        q = _call(net, leaves, batch["x"], batch["m"], batch["a"])
        loss = torch.mean((target_q - q) ** 2)
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
        losses.append(loss.detach())
    return tuple(losses), tuple(grads)


def critic_update(state: TD3State, cfg: TD3Config,
                  batch: Dict[str, torch.Tensor]):
    """The critics' Adam step, in place. Returns (state, (l1, l2))."""
    (l1, l2), (g1, g2) = critic_losses_and_grads(state, cfg, batch)
    for net, grads, opt in ((state.critic1, g1, state.opt_critic1),
                            (state.critic2, g2, state.opt_critic2)):
        names, params = _params(net)
        adam_update(params, grads, opt, names, cfg.lr_critic)
    return state, (l1, l2)


def actor_loss_and_grads(state: TD3State, cfg: TD3Config,
                         batch: Dict[str, torch.Tensor]):
    """(loss, grads): -mean critic1(x, m, actor(x, m)) and its gradient
    with respect to the actor's parameters."""
    leaves = _leaves(state.actor, True)
    a = _call(state.actor, leaves, batch["x"], batch["m"])
    q = _call(state.critic1, _leaves(state.critic1, False), batch["x"],
              batch["m"], a)
    loss = -torch.mean(q)
    return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))


def actor_update(state: TD3State, cfg: TD3Config,
                 batch: Dict[str, torch.Tensor]):
    """The deterministic policy gradient step, then the tau soft updates
    of all three targets (train_td3.py:126-138), in place. Returns
    (state, loss)."""
    loss, grads = actor_loss_and_grads(state, cfg, batch)
    names, params = _params(state.actor)
    adam_update(params, grads, state.opt_actor, names, cfg.lr_actor)
    _soft(cfg.tau, state.actor, state.actor_target)
    _soft(cfg.tau, state.critic1, state.critic1_target)
    _soft(cfg.tau, state.critic2, state.critic2_target)
    return state, loss


def train_step(state: TD3State, cfg: TD3Config,
               batch: Dict[str, torch.Tensor],
               do_actor: Optional[bool] = None):
    """One TD3 update, in place: the critics always, the actor every
    `policy_delay` steps (train_td3.py:201-207). `do_actor` is that
    branch, (steps + 1) % policy_delay == 0, as the caller counts it; None
    reads the count from the device. Returns (state, {"critic1_loss",
    "critic2_loss", "actor_loss"}), actor_loss 0 on a skipped step."""
    if do_actor is None:
        do_actor = (int(state.steps) + 1) % cfg.policy_delay == 0
    state, (l1, l2) = critic_update(state, cfg, batch)
    with torch.no_grad():
        state.steps.add_(1)
    if do_actor:
        state, a_loss = actor_update(state, cfg, batch)
        a_loss = a_loss.to(l1.dtype)
    else:
        a_loss = torch.zeros((), dtype=l1.dtype, device=l1.device)
    return state, {"critic1_loss": l1, "critic2_loss": l2,
                   "actor_loss": a_loss}


def select_action(state: TD3State, cfg: TD3Config, feat: torch.Tensor,
                  maneuver_onehot: torch.Tensor, noise: torch.Tensor,
                  steering_shift: float = 0.0) -> torch.Tensor:
    """Exploration action: the actor's output + OU noise (+ the constant
    steering shift of train_td3.py:37,146-147), clipped to [-1, 1]
    (train_td3.py:140-150). No autograd."""
    with torch.no_grad():
        action = state.actor(feat, maneuver_onehot)
        return torch.clamp(action + noise + steering_shift, -1.0, 1.0)
