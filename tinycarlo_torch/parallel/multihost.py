"""Multi-process start-up and per-rank feeding.

Counterpart of tinycarlo_tpu/parallel/multihost.py. The JAX package
joins hosts with `jax.distributed.initialize` and feeds each host's
shard of a global array; here every rank is one process, joined by
`torch.distributed.init_process_group`, and a "global" value is what each
rank holds of it: its rows of a batch (`host_local_array`), or its slice
of a full value that every rank computed alike (`global_array`).

Backends: `backend=None` is torch's default, NCCL for CUDA tensors and
gloo for CPU tensors. NCCL takes one rank per card; ranks that share a
card ask for `backend="gloo"`, which carries CUDA tensors through the
host. Nothing switches the backend behind the caller's back.

Failure model (SURVEY.md §5): no elasticity; a failed rank aborts the
job, which restarts from the latest checkpoint.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tinycarlo_torch.parallel.mesh import axis_index, axis_size, data_rows

_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: float = 300.0) -> None:
    """Join the process group. With no arguments the group forms from the
    `env://` variables (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), and a
    single process without them stays alone (nothing happens). Explicit
    arguments, or the variables present, must form the group: a failure
    raises, as the JAX package's explicit initialize does (:45-52). Does
    nothing when the group exists."""
    if dist.is_initialized():
        return
    explicit = not (init_method is None and world_size is None
                    and rank is None)
    if not explicit and not all(k in os.environ for k in _ENV_KEYS):
        return
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
        timeout=timedelta(seconds=timeout_s),
    )


def local_batch_slice(n_global: int,
                      mesh: Optional[DeviceMesh] = None) -> slice:
    """The [start, stop) rows of an n_global batch this rank owns: its
    data index's block under `mesh`, else its rank's block of the world."""
    if mesh is not None:
        return data_rows(n_global, mesh)
    n = dist.get_world_size() if dist.is_initialized() else 1
    r = dist.get_rank() if dist.is_initialized() else 0
    per = n_global // n
    return slice(r * per, (r + 1) * per)


def global_array(value: torch.Tensor, mesh: DeviceMesh,
                 placement: Sequence[Optional[str]] = ()) -> torch.Tensor:
    """A full value, the same on every rank, as this rank's shard of it.
    `placement` names the mesh axis each leading dim is split over (None:
    kept whole; dims past it are kept whole), as a JAX PartitionSpec
    does: () replicates, (MODEL_AXIS,) splits dim 0 over model, (None,
    MODEL_AXIS) dim 1."""
    out = value
    for dim, axis in enumerate(placement):
        if axis is None:
            continue
        d = axis_size(mesh, axis)
        assert out.shape[dim] % d == 0, (
            f"dim {dim} of {tuple(value.shape)} not divisible by {axis}={d}")
        per = out.shape[dim] // d
        out = out.narrow(dim, axis_index(mesh, axis) * per, per)
    return out.contiguous().clone()


def host_local_array(global_shape: Sequence[int], mesh: DeviceMesh,
                     make_local: Callable[[slice], torch.Tensor]
                     ) -> torch.Tensor:
    """This rank's rows of a batch of `global_shape`, sharded over data:
    `make_local(rows)` makes only them (JAX :94-110)."""
    rows = local_batch_slice(global_shape[0], mesh)
    local = torch.as_tensor(make_local(rows))
    want = (rows.stop - rows.start, *global_shape[1:])
    if tuple(local.shape) != want:
        raise ValueError(f"make_local gave {tuple(local.shape)}, this "
                         f"rank's rows are {want}")
    return local
