"""Device meshes: the scale-out layer's (data, model) grid of ranks.

Counterpart of tinycarlo_tpu/parallel/mesh.py. The JAX package lays a
`Mesh` over devices and lets XLA insert the collectives; here a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of an
initialised process group (`multihost.initialize`), one rank per process,
and the port's code calls the collectives itself over the mesh's axis
groups: the `data` axis shards environments and batches (DP), the `model`
axis carries tensor-parallel layers (tp.py) and segment-sharded
rasterisation (sp.py).

`batch_sharding` is not ported: it returns a JAX `NamedSharding`, a
placement XLA reads, which has no torch meaning. `shard_batch` gives a
rank its rows instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A (data, model) mesh over the process group's ranks, in rank order.

    `data=None` uses every rank left after the model axis. The model axis
    is innermost: with model = 2, ranks r and r ^ 1 share a model group
    (the JAX package puts it innermost for the fastest links). A mesh
    smaller than the world covers its first data * model ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.initialize first")
    n = dist.get_world_size()
    if data is None:
        assert n % model == 0, f"{n} ranks not divisible by model={model}"
        data = n // model
    assert data * model <= n, f"mesh {data}x{model} exceeds {n} ranks"
    names = (DATA_AXIS, MODEL_AXIS)
    if data * model == n:
        return init_device_mesh(device_type, (data, model),
                                mesh_dim_names=names)
    return DeviceMesh(device_type,
                      torch.arange(data * model).reshape(data, model),
                      mesh_dim_names=names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that share this rank's other
    coordinate: its model group for MODEL_AXIS, its data group for
    DATA_AXIS."""
    return mesh.get_group(axis)


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """fn over every tensor of a tree of dataclasses, dicts, lists and
    tuples; every other leaf (ints, generators, None) is kept."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def data_rows(n: int, mesh: DeviceMesh) -> slice:
    """The [start, stop) rows of an n-row batch that this rank's data
    index owns: contiguous blocks in data order."""
    d = axis_size(mesh, DATA_AXIS)
    assert n % d == 0, f"batch of {n} not divisible by data={d}"
    per = n // d
    start = axis_index(mesh, DATA_AXIS) * per
    return slice(start, start + per)


def shard_batch(tree: Any, mesh: DeviceMesh) -> Any:
    """This rank's rows of every tensor's leading (batch) axis, sharded
    over `data` and the same along `model`."""
    return tree_map(lambda x: x[data_rows(x.shape[0], mesh)].clone(), tree)


def replicate(tree: Any, mesh: DeviceMesh) -> Any:
    """Every tensor broadcast from the rank at mesh coordinate (0, 0), in
    place: first along `data` from data index 0, then along `model` from
    model index 0, so every rank of the mesh holds the same bits."""
    def bcast(x):
        # bool goes as its bytes (the gloo backend has no bool type)
        wire = x.view(torch.uint8) if x.dtype == torch.bool else x
        for axis in (DATA_AXIS, MODEL_AXIS):
            group = axis_group(mesh, axis)
            if dist.get_world_size(group) > 1:
                dist.broadcast(wire, group=group, group_src=0)
        return x

    return tree_map(bcast, tree)
