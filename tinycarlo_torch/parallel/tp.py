"""Tensor parallelism for the tinycar_net family.

Counterpart of tinycarlo_tpu/parallel/tp.py: Megatron column / row
sharding of the MLP pairs over the `model` axis. The first Linear of each
wide pair keeps its shard of the output features (column-parallel; its
bias shards with it), the next keeps its shard of the input features
(row-parallel; its bias stays whole and is added once after the sum).

The JAX package places the shards and XLA inserts the psum; here the
shards are the modules' own parameters and the two conjugate collectives
are explicit autograd functions (Megatron's f and g): before a
column-parallel product, f is the identity forward and an all-reduce of
the input's gradient backward; after a row-parallel product, g is an
all-reduce forward and the identity backward. Parameters stay plain
tensors under their unsharded names, so the learner's fresh-leaf
gradients (train/td3.py `_leaves`, `_call`) and its foreach Adam work on
the shards unchanged; Adam's moments shard by the same plan
(`shard_state_dict`).

The sum over the row-parallel shards is the model group's all-reduce, so
a TP net's outputs differ from the unsharded net's in the last bits of
float32 (another order of the same sum); every rank of a model group
gets the same bits.

The plan keys on the explicit layer names of models/tinycar_net.py
(`fc1`/`fc2` of the actor head and critics, `fcm2`/`fcm3` of the
maneuver trunk). The frozen encoder's `fc1` is never sharded.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from tinycarlo_torch.models.tinycar_net import TinycarEncoder
from tinycarlo_torch.parallel.mesh import MODEL_AXIS, axis_group, axis_index, axis_size

# column-parallel layers (output features sharded, bias with them) and
# their row-parallel consumers (input features sharded, bias whole)
_COLUMN = frozenset({"fc1", "fcm2"})
_ROW = frozenset({"fc2", "fcm3"})


def _kind(names: Tuple[str, ...]) -> Optional[str]:
    """"column", "row" or None for a parameter by its dotted-name parts."""
    if len(names) < 2:
        return None
    layer, leaf = names[-2], names[-1]
    if layer in _COLUMN and leaf in ("weight", "bias"):
        return "column"
    if layer in _ROW and leaf == "weight":
        return "row"
    return None


def _encoder_prefixes(module: nn.Module) -> Tuple[str, ...]:
    return tuple(name + "." if name else "" for name, m in
                 module.named_modules() if isinstance(m, TinycarEncoder))


def tp_plan(module: nn.Module) -> Dict[Tuple[str, ...], str]:
    """{parameter name parts: "column" | "row"} of every parameter the
    plan shards. Tests hold it against the exact set each net should
    have: a renamed layer empties it instead of silently replicating."""
    skip = _encoder_prefixes(module)
    plan = {}
    for name, _ in module.named_parameters():
        if any(name.startswith(p) for p in skip):
            continue
        kind = _kind(tuple(name.split(".")))
        if kind is not None:
            plan[tuple(name.split("."))] = kind
    return plan


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient over
    the model group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: all-reduce over the model group forward, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _shard(t: torch.Tensor, kind: str, leaf: str, mesh: DeviceMesh
           ) -> torch.Tensor:
    """This rank's model shard of a planned Linear's weight or bias."""
    d, i = axis_size(mesh, MODEL_AXIS), axis_index(mesh, MODEL_AXIS)
    dim = 0 if kind == "column" else 1  # torch weights are (out, in)
    if leaf == "bias":
        dim = 0
    assert t.shape[dim] % d == 0, (
        f"{kind} {leaf} {tuple(t.shape)} not divisible by model={d}")
    per = t.shape[dim] // d
    return t.narrow(dim, i * per, per).contiguous().clone()


class ParallelLinear(nn.Module):
    """A Linear holding its model shard (`weight`, `bias` under the
    unsharded names) and the collectives of its kind."""

    def __init__(self, linear: nn.Linear, kind: str, mesh: DeviceMesh):
        super().__init__()
        self.kind = kind
        self.group = axis_group(mesh, MODEL_AXIS)
        self.weight = nn.Parameter(_shard(linear.weight.data, kind,
                                          "weight", mesh),
                                   linear.weight.requires_grad)
        bias = linear.bias.data
        if kind == "column":
            bias = _shard(bias, kind, "bias", mesh)
        self.bias = nn.Parameter(bias.clone(), linear.bias.requires_grad)

    def forward(self, x):
        if self.kind == "column":
            return F.linear(_CopyToModel.apply(x, self.group), self.weight,
                            self.bias)
        y = _ReduceFromModel.apply(F.linear(x, self.weight), self.group)
        return y + self.bias

    def extra_repr(self) -> str:
        return f"{self.kind}, weight={tuple(self.weight.shape)}"


def shard_params(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Replace every planned Linear of `module` by its ParallelLinear
    shard over `mesh`'s model axis, in place; returns the module. The
    parameters keep their names (and `requires_grad`)."""
    layers = {names[:-1] for names in tp_plan(module)}
    for names in sorted(layers):
        parent = module.get_submodule(".".join(names[:-1]))
        linear = getattr(parent, names[-1])
        kind = _kind(names + ("weight",))
        setattr(parent, names[-1], ParallelLinear(linear, kind, mesh))
    return module


def shard_state_dict(module: nn.Module, state: Dict[str, torch.Tensor],
                     mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """A {parameter name: tensor} dict shaped like the unsharded module's
    parameters (Adam's moments) cut to the shards `shard_params` keeps."""
    plan = tp_plan(module)
    out = {}
    for name, t in state.items():
        names = tuple(name.split("."))
        kind = plan.get(names)
        out[name] = (t if kind is None else
                     _shard(t, kind, names[-1], mesh))
    return out
