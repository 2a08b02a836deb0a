"""Segment-parallel (SP) rasterisation: the map's edge axis sharded over
the `model` axis.

Counterpart of tinycarlo_tpu/parallel/sp.py. The reference has no
sequence or context parallelism; the analogous axis of this workload is
the map-segment axis of camera rasterisation, since large maps mean many
projected segments per frame. Each rank of a model group projects,
compacts and rasterises its contiguous shard of the packed edge axis
(padded with dead edges to a multiple of the group's size) into a partial
frame, and a MAX all-reduce over the group composes the frame: the OR of
0/255 masks, or paint order of rank maps (a layer's rank does not depend
on the shard). Rank, projection and stroke are per segment, so the
composed frame equals the unsharded render bit for bit whenever the
`max_visible` budget is not oversubscribed; the budget applies per shard,
as in the JAX package (:61-63), so sharding can only keep more.

Two tiers, as there:
  * `render_observation_batch_sp` / `rasterize_masks_packed_sp`: the
    production path through the kernels -- the masks kernel (K1) on each
    shard's `compact_env_idx_soa` bundle, the rank kernel (K3) for
    `fmt="rank"`, the exact kernel (K4) under `camera.stroke: exact` at
    t >= 2 -- composable with DP over the `data` axis;
  * `rasterize_masks_sp`: the dense per-layer reference
    (ops/rasterize.rasterize_masks) on a shard of the padded per-layer
    axis.

On CPU tensors the kernels' plain versions run (ops/rasterize_kernels);
on CUDA tensors the kernels, and the collective goes through the process
group's backend for that device.

`data_sharded=True` takes this rank's data rows of the batch first and
returns only them (the JAX output is sharded over `data` alike). A float
`out_dtype` with `fmt="rank"` raises: the rank map is uint8 (the JAX
function ignores the argument there).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tinycarlo_torch import env as fenv
from tinycarlo_torch.ops import rasterize as ras
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.parallel.mesh import (MODEL_AXIS, axis_group,
                                           axis_index, axis_size,
                                           data_rows, tree_map)


def _model_shard(x: torch.Tensor, dim: int, mesh: DeviceMesh,
                 value=0) -> torch.Tensor:
    """This rank's contiguous shard of `dim`, padded with `value` up to a
    multiple of the model axis size first."""
    d = axis_size(mesh, MODEL_AXIS)
    pad = (-x.shape[dim]) % d
    if pad:
        widths = [0, 0] * (x.ndim - 1 - dim) + [0, pad]
        if x.dtype == torch.bool:
            x = F.pad(x.to(torch.uint8), widths, value=int(value)).bool()
        else:
            x = F.pad(x, widths, value=value)
    per = x.shape[dim] // d
    return x.narrow(dim, axis_index(mesh, MODEL_AXIS) * per,
                    per).contiguous()


def _max_over_model(part: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The elementwise max of every model rank's `part`, in place."""
    group = axis_group(mesh, MODEL_AXIS)
    if dist.get_world_size(group) > 1:
        dist.all_reduce(part, op=dist.ReduceOp.MAX, group=group)
    return part


def rasterize_masks_sp(
    p0: torch.Tensor,  # (L, E, 2), E divisible by the model axis size
    p1: torch.Tensor,
    draw: torch.Tensor,  # (L, E)
    resolution: Tuple[int, int],
    thickness: int,
    mesh: DeviceMesh,
) -> torch.Tensor:
    """`ops.rasterize.rasterize_masks` with the segment axis sharded over
    the model axis and an OR combine: (L, H, W) 0/255, bit-equal to the
    unsharded masks (JAX sp.py:216-244)."""
    d = axis_size(mesh, MODEL_AXIS)
    assert p0.shape[1] % d == 0, (
        f"segment axis {p0.shape[1]} not divisible by model={d}")
    part = ras.rasterize_masks(
        _model_shard(p0, 1, mesh), _model_shard(p1, 1, mesh),
        _model_shard(draw, 1, mesh), resolution, thickness,
    )
    return _max_over_model(part.contiguous(), mesh)


def rasterize_masks_packed_sp(
    u0: torch.Tensor,  # (B, E) packed edge axis, SoA pixel coords
    v0: torch.Tensor,
    u1: torch.Tensor,
    v1: torch.Tensor,
    draw: torch.Tensor,  # (B, E)
    edge_layer: torch.Tensor,  # (E,) int32
    n_layers: int,
    resolution: Tuple[int, int],
    thickness: int,
    mesh: DeviceMesh,
    max_visible: Optional[int] = None,
    data_sharded: bool = False,
    stroke: str = "fast",
) -> torch.Tensor:
    """The production kernel path with the packed segment axis sharded:
    each model rank compacts its shard and launches the masks kernel
    (the exact kernel for `stroke="exact"` at t >= 2) through
    `rasterize_kernels.rasterize_masks_packed_soa`; an OR over the model
    group composes the (B, L, H, W) 0/255 masks (JAX sp.py:42-107).
    With `data_sharded` only this rank's data rows are rendered and
    returned."""
    if data_sharded:
        rows = data_rows(draw.shape[0], mesh)
        u0, v0, u1, v1, draw = (x[rows] for x in (u0, v0, u1, v1, draw))
    u0, v0, u1, v1 = (_model_shard(x, 1, mesh) for x in (u0, v0, u1, v1))
    part = rk.rasterize_masks_packed_soa(
        u0, v0, u1, v1, _model_shard(draw, 1, mesh, value=False),
        _model_shard(edge_layer, 0, mesh), n_layers, tuple(resolution),
        thickness, max_visible=max_visible, stroke=stroke,
    )
    return _max_over_model(part, mesh)


def render_observation_batch_sp(
    params: fenv.EnvParams,
    states: fenv.EnvState,
    mesh: DeviceMesh,
    data_sharded: bool = False,
    out_dtype: torch.dtype = torch.uint8,
    fmt: str = "classes",
) -> torch.Tensor:
    """`env.render_observation_batch` with the packed segment axis sharded
    over the model axis (JAX sp.py:110-213): each rank projects its edge
    shard (node table and camera whole), compacts it and launches a
    kernel; a MAX all-reduce over the model group composes the frame.
    Under the fast stroke the projection and compaction are the front
    kernel's one launch on the card (`rasterize_kernels.front_bundle`),
    as in the unsharded render.

    fmt="classes": (B, L, H, W) masks, 0/255 uint8 or 0/1 in a float
    `out_dtype` (the TD3 chunk's encoder feed, `td3_loop.chunk(
    obs_render_fn=...)`), through the masks kernel, or the exact kernel
    under `camera.stroke: exact` at t >= 2. fmt="rank": the (B, H, W)
    paint-order layer map through the rank kernel, or, under the exact
    stroke at t >= 2, `rank_from_masks` of the composed exact masks (as
    the unsharded renderer does). `data_sharded` renders and returns only
    this rank's data rows of `states`."""
    if fmt not in ("classes", "rank"):
        raise ValueError(f"unsupported SP observation format: {fmt!r}")
    if fmt == "rank" and out_dtype != torch.uint8:
        raise ValueError("fmt='rank' renders the uint8 layer-rank map; "
                         f"out_dtype {out_dtype} is only defined for classes")
    cfg = params.cfg
    md = params.map_data
    cam_cfg = cfg.camera
    res = tuple(cam_cfg.resolution)
    if data_sharded:
        rows = data_rows(states.car.position.shape[0], mesh)
        states = tree_map(lambda x: x[rows], states)
    edges = _model_shard(md.packed_edges, 1, mesh)
    emask = _model_shard(md.packed_edge_mask, 1, mesh, value=False)
    elayer = _model_shard(md.packed_edge_layer, 0, mesh)
    t = cam_cfg.line_thickness
    if ras._exact(t, cam_cfg.stroke):
        u0, v0, u1, v1, draw = fenv._project_packed_batch_soa(
            params, states, edges=edges, edge_mask=emask)
        part = rk.rasterize_masks_packed_soa(
            u0, v0, u1, v1, draw, elayer, md.n_layers, res, t,
            max_visible=cam_cfg.max_visible_segments, stroke=cam_cfg.stroke,
        )
    else:
        bundle = rk.front_bundle(
            md.packed_nodes, edges, emask, elayer,
            fenv._camera_pose(params, states), params.camera.K, md.n_layers,
            res, t, cam_cfg.max_range,
            max_visible=cam_cfg.max_visible_segments,
        )
        if fmt == "rank":
            return _max_over_model(
                rk.rank_kernel(bundle, md.n_layers, res, t), mesh)
        part = rk.masks_kernel(bundle, md.n_layers, res, t)
    masks = _max_over_model(part, mesh)
    if fmt == "rank":
        return ras.rank_from_masks(masks)
    # 0/255 uint8, or 0/1 in a float out_dtype
    return masks if out_dtype == torch.uint8 else (masks > 0).to(out_dtype)
