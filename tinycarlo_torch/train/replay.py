"""Replay buffer on the device: ring storage, random eviction, batched
insertion.

Counterpart of tinycarlo_tpu/train/replay.py:10-101 (reference:
examples/rl_utils.py:13-57). The storage is a dict of (size, ...) device
tensors and `filled` a device int32 counting the valid prefix; a batch
appends while there is room, then each item overwrites a uniformly drawn
slot (rl_utils.py:20-22), and samples are uniform over the filled prefix
(rl_utils.py:26).

Unlike the JAX package's pure functions, `add_batch` writes the storage in
place: at 100 000 slots of (10, 256) float32 features a copy per step
would move 2 GB.

Duplicate slots. Once the buffer is full, two items of one batch draw the
same slot now and then (about 5 a step at 1024 envs over 100 000 slots).
The JAX package's `.at[idx].set` on the CPU keeps the LAST such item (its
scatter runs in order; tests/test_torch_replay.py pins it). The port does
the same deterministically on any device: each item is replaced by the
last item of the batch that targets its slot, so every write to a slot
carries the same value, and CUDA's unordered `index_put_` cannot pick
another.

Draws come from a torch.Generator (the JAX package's jax.random streams
differ), or are injected (`idx=`) for the parity tests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from tinycarlo_torch.utils.helper import resolve_device

# the sample draw's range: uniform integers below 2^31 - 1, reduced modulo
# `filled` (a device value; the bias is below filled / 2^31)
_DRAW_HIGH = 2 ** 31 - 1


@dataclass
class ReplayBuffer:
    """`storage` maps names to (size, ...) tensors; `filled` () int32."""

    storage: Dict[str, torch.Tensor]
    filled: torch.Tensor
    size: int = 0

    @property
    def capacity(self) -> int:
        return self.size


def create(size: int, example: Dict[str, torch.Tensor],
           device=None) -> ReplayBuffer:
    """A zeroed buffer of `size` items shaped and typed like `example`
    (one item, no batch axis), on `device` (default: the example's)."""
    storage = {
        k: torch.zeros((size, *v.shape), dtype=v.dtype,
                       device=v.device if device is None else device)
        for k, v in example.items()
    }
    dev = next(iter(storage.values())).device
    return ReplayBuffer(storage=storage,
                        filled=torch.zeros((), dtype=torch.int32, device=dev),
                        size=size)


def _slots(buf: ReplayBuffer, b: int, evict: torch.Tensor) -> torch.Tensor:
    """(b,) int64 slots of a batch of b items: filled + i while that is
    below size, else the item's eviction draw `evict[i]`."""
    append = buf.filled.long() + torch.arange(b, device=evict.device)
    return torch.where(append < buf.size, append, evict.long())


def last_writer(slot: torch.Tensor) -> torch.Tensor:
    """(b,) the index of the last item of the batch whose slot is item
    i's: i itself unless a later item targets the same slot."""
    b = slot.shape[0]
    order = torch.arange(b, device=slot.device)
    same = slot[:, None] == slot[None, :]
    return torch.where(same, order[None, :], -1).amax(dim=1)


def add_batch(buf: ReplayBuffer, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              idx: Optional[torch.Tensor] = None) -> ReplayBuffer:
    """Insert a batch of items (leading axis B), in place. The eviction
    draws (B,) in [0, size) come from `generator`, or are `idx`; they are
    drawn on every call, as the JAX package does, and used only by items
    past the end. Each value is cast to its storage's dtype. Returns buf."""
    b = next(iter(batch.values())).shape[0]
    dev = buf.filled.device
    if idx is None:
        idx = torch.randint(buf.size, (b,), generator=generator, device=dev)
    slot = _slots(buf, b, idx.to(dev))
    src = last_writer(slot)
    with torch.no_grad():
        for k, store in buf.storage.items():
            store[slot] = batch[k][src].to(store.dtype)
        buf.filled.copy_(torch.clamp(buf.filled + b, max=buf.size))
    return buf


def sample_indices(buf: ReplayBuffer, batch_size: int,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """(batch_size,) int64 uniform draws over the filled prefix, without
    reading `filled` on the host."""
    draw = torch.randint(_DRAW_HIGH, (batch_size,), generator=generator,
                         device=buf.filled.device)
    return draw % buf.filled.long()


def sample(buf: ReplayBuffer, batch_size: int,
           generator: Optional[torch.Generator] = None,
           idx: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """A uniform sample over the filled prefix (rl_utils.py:24-27), at the
    injected `idx` when given. The caller ensures filled >= batch_size."""
    if idx is None:
        idx = sample_indices(buf, batch_size, generator)
    idx = idx.to(buf.filled.device).long()
    return {k: v[idx] for k, v in buf.storage.items()}


def save(buf: ReplayBuffer, filename: str) -> None:
    """An npz of the JAX package's keys (`__filled` and the storage's), so
    that either package loads the other's file (rl_utils.py:48-49)."""
    np.savez_compressed(
        filename, __filled=int(buf.filled),
        **{k: v.cpu().numpy() for k, v in buf.storage.items()},
    )


def load(filename: str, device="cuda") -> ReplayBuffer:
    """A buffer from an npz of `save`'s (or the JAX package's) keys, on
    `device` (rl_utils.py:51-54)."""
    dev = resolve_device(device)
    with np.load(filename) as data:
        storage = {k: torch.from_numpy(data[k]).to(dev)
                   for k in data.files if k != "__filled"}
        filled = int(data["__filled"])
    size = next(iter(storage.values())).shape[0]
    return ReplayBuffer(
        storage=storage,
        filled=torch.tensor(filled, dtype=torch.int32, device=dev),
        size=size,
    )
