"""Checkpoint and resume of any nested state with `torch.save`.

Counterpart of tinycarlo_tpu/utils/checkpoint.py. The JAX package writes
Orbax checkpoints (a directory per pytree); the port writes one
`torch.save` file, so the two formats differ and neither package reads
the other's (a replay buffer crosses as an npz, train/replay.py). Any
state checkpoints the same way -- a learner (`td3.TD3State`), a replay
buffer, the batched env state (`vector.VecState`), the whole training
loop (`td3_loop.LoopState`) -- so a run resumes mid-episode.

`save` walks dataclasses, dicts, lists and tuples; a tensor is stored on
the CPU, a module as its state dict, a torch.Generator as its state, and
numbers, strings and None as they are. A dataclass's `runtime` field
(the training loop's captured graphs and their buffers) is not saved. `restore(path, example)` writes the saved values
into `example` in place -- `copy_` into its tensors, `load_state_dict`
into its modules, `set_state` on its generators -- so the tensors a
captured CUDA graph reads stay the ones it reads; without an example it
returns the saved tree. Restore only files this program wrote:
`torch.load` unpickles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

_GENERATOR = "__generator__"


def _skipped(f: dataclasses.Field) -> bool:
    return f.name == "runtime"


def _tree(obj) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().clone()
    if isinstance(obj, nn.Module):
        return {k: v.detach().cpu().clone()
                for k, v in obj.state_dict().items()}
    if isinstance(obj, torch.Generator):
        return {_GENERATOR: obj.get_state(), "device": str(obj.device)}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if not _skipped(f)}
    if isinstance(obj, dict):
        return {k: _tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_tree(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"checkpoint: cannot save a {type(obj).__name__}")


def save(path: str, tree: Any) -> None:
    """Write `tree` (any nested state) to the file `path`."""
    torch.save(_tree(tree), path)


def _load_into(example, saved, where: str):
    if isinstance(example, torch.Tensor):
        if tuple(example.shape) != tuple(saved.shape):
            raise ValueError(f"checkpoint: {where} has shape "
                             f"{tuple(saved.shape)}, not "
                             f"{tuple(example.shape)}")
        with torch.no_grad():
            example.copy_(saved)
        return example
    if isinstance(example, nn.Module):
        example.load_state_dict(saved)
        return example
    if isinstance(example, torch.Generator):
        if str(example.device) != saved["device"]:
            raise ValueError(f"checkpoint: {where} is a {saved['device']} "
                             f"generator, not {example.device}")
        example.set_state(saved[_GENERATOR])
        return example
    if dataclasses.is_dataclass(example) and not isinstance(example, type):
        for f in dataclasses.fields(example):
            if _skipped(f):
                continue
            value = _load_into(getattr(example, f.name), saved[f.name],
                               f"{where}.{f.name}")
            object.__setattr__(example, f.name, value)
        return example
    if isinstance(example, dict):
        for k in example:
            example[k] = _load_into(example[k], saved[k], f"{where}.{k}")
        return example
    if isinstance(example, (list, tuple)):
        if len(example) != len(saved):
            raise ValueError(f"checkpoint: {where} has {len(saved)} items")
        items = [_load_into(e, s, f"{where}[{i}]")
                 for i, (e, s) in enumerate(zip(example, saved))]
        return type(example)(items) if isinstance(example, tuple) else items
    return saved


def restore(path: str, example: Optional[Any] = None) -> Any:
    """Restore a checkpoint. With `example` (a state of the same structure,
    e.g. a freshly initialised one) the saved values are written into it
    in place and it is returned; its tensors keep their devices and
    dtypes. Without one, the saved tree (CPU tensors) is returned."""
    saved = torch.load(path, map_location="cpu", weights_only=False)
    if example is None:
        return saved
    return _load_into(example, saved, "state")
