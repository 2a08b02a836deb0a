"""Map compiler: map JSON -> fixed-shape padded tensors on the device.

Counterpart of tinycarlo_tpu/map_compiler.py. A map is compiled once on
the host in numpy into padded arrays plus precomputed adjacency and spawn
tables, then moved to the device in one pass, so every runtime query is
a fixed-shape masked tensor op. The arrays are equal to the JAX
package's, field for field, the `LanelineGrid` of `car.car_info`'s
pruned nearest-edge query included.
"""
from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tinycarlo_torch.config import MapConfig
from tinycarlo_torch.utils.helper import numpy_dtype, resolve_device, to_device

_PAD_MULTIPLE = 8


def _round_up(n: int, m: int = _PAD_MULTIPLE) -> int:
    return max(m, ((n + m - 1) // m) * m)


@dataclass
class LayerArrays:
    """One polyline graph layer as padded arrays."""

    nodes: torch.Tensor  # (Nmax, 2) float
    node_mask: torch.Tensor  # (Nmax,) bool
    edges: torch.Tensor  # (Emax, 2) int32
    edge_mask: torch.Tensor  # (Emax,) bool
    n_nodes: int = 0
    n_edges: int = 0


@dataclass
class LanePathArrays(LayerArrays):
    """The directed lanepath layer, with adjacency tables.

    ``next_table[n]`` lists successors of node n in original edge order
    (the reference's linear scan order, tinycarlo/layer.py:183), packed
    first and padded with -1; ``next_count[n]`` is the true degree.
    """

    next_table: torch.Tensor = None  # (Nmax, D) int32
    next_count: torch.Tensor = None  # (Nmax,) int32
    prev_table: torch.Tensor = None  # (Nmax, D) int32
    prev_count: torch.Tensor = None  # (Nmax,) int32


@dataclass
class SpawnTable:
    """Valid spawn rows (tinycarlo_tpu.map_compiler.SpawnTable): the nodes
    the reference's rejection sampling can return (tinycarlo/map.py:51-69),
    so a uniform draw over the first `count` rows is its distribution."""

    node_idx: torch.Tensor  # (S,) int32
    position: torch.Tensor  # (S, 2) float
    rotation: torch.Tensor  # (S,) float
    edge: torch.Tensor  # (S, 2) int32
    count: int = 0


@dataclass
class LanelineGrid:
    """Uniform spatial grid over the packed laneline edges, pruning
    car_info's per-laneline nearest-edge scans to a per-cell candidate list
    (tinycarlo_tpu.map_compiler.LanelineGrid, map_compiler.py:77-108).

    A cell keeps every edge e of a layer with lb(e) <= min_f ub(f), where
    lb / ub bound the sum-of-endpoint-distances metric over the cell's
    rectangle, so every minimiser (and tie) of any position inside the
    cell survives; candidates keep packed-edge order, so the first-wins
    argmin picks the full scan's edge. Positions outside the grid clamp to
    the boundary cell."""

    origin: torch.Tensor  # (2,) float (x, y) of cell (0, 0)'s corner
    inv_cell: torch.Tensor  # () float, 1 / cell size
    cand_idx: torch.Tensor  # (C, K) int32 packed-edge index, -1 = pad
    cand_p0: torch.Tensor  # (C, K, 2) float src endpoint coords
    cand_p1: torch.Tensor  # (C, K, 2) float dst endpoint coords
    nx: int = 1
    ny: int = 1
    # per-layer offsets into the K axis (len L + 1): layer l's candidates
    # occupy [bounds[l], bounds[l + 1]) of every row
    layer_bounds: Tuple[int, ...] = ()


def _build_laneline_grid(
    packed_nodes: np.ndarray,  # (Np, 2) float (post-dtype cast)
    packed_edges: np.ndarray,  # (Ep, 2) int32
    n_real_edges: int,
    layer_bounds: Tuple[int, ...],
    dimension_hw: Tuple[float, float],
    target_cells: int,
    margin: Optional[float],
) -> Optional[LanelineGrid]:
    """Host-side grid construction (tinycarlo_tpu/map_compiler.py:
    111-197), as numpy arrays. None when pruning would not pay (candidate
    rows of at least 0.9 of the edge axis)."""
    if n_real_edges == 0:
        return None
    h_m, w_m = float(dimension_hw[0]), float(dimension_hw[1])
    if margin is None:
        margin = 0.5 * max(h_m, w_m)
    x0, y0 = -margin, -margin
    x1, y1 = w_m + margin, h_m + margin
    area = max((x1 - x0) * (y1 - y0), 1e-9)
    cell = math.sqrt(area / max(target_cells, 1))
    nx = max(1, int(math.ceil((x1 - x0) / cell)))
    ny = max(1, int(math.ceil((y1 - y0) / cell)))

    # cell rectangles (C, 1, 2) against edge endpoints (1, E, 2), row-major
    # cell = cy * nx + cx
    cxs = x0 + cell * np.arange(nx)
    cys = y0 + cell * np.arange(ny)
    lo = np.stack([np.tile(cxs, ny), np.repeat(cys, nx)], axis=-1)
    hi = lo + cell
    a = packed_nodes[packed_edges[:n_real_edges, 0]].astype(np.float64)
    b = packed_nodes[packed_edges[:n_real_edges, 1]].astype(np.float64)

    def rect_dists(p):  # (E, 2) -> (C, E) min & max distance to rect
        clamped = np.clip(p[None], lo[:, None], hi[:, None])
        dmin = np.linalg.norm(clamped - p[None], axis=-1)
        far = np.maximum(
            np.abs(p[None] - lo[:, None]), np.abs(p[None] - hi[:, None])
        )
        return dmin, np.linalg.norm(far, axis=-1)

    a_min, a_max = rect_dists(a)
    b_min, b_max = rect_dists(b)
    lb = a_min + b_min  # (C, E)
    ub = a_max + b_max

    n_layers = len(layer_bounds) - 1
    keep = np.zeros_like(lb, dtype=bool)
    for l in range(n_layers):
        s, e = layer_bounds[l], layer_bounds[l + 1]
        if e <= s:
            continue
        thresh = ub[:, s:e].min(axis=1, keepdims=True)
        keep[:, s:e] = lb[:, s:e] <= thresh
    per_layer_k = [
        int(keep[:, layer_bounds[l]: layer_bounds[l + 1]].sum(axis=1).max())
        if layer_bounds[l + 1] > layer_bounds[l] else 0
        for l in range(n_layers)
    ]
    k_tot = sum(per_layer_k)
    if k_tot >= 0.9 * n_real_edges:
        return None

    ncells = nx * ny
    cand_idx = np.full((ncells, k_tot), -1, dtype=np.int32)
    out_bounds = tuple(np.cumsum([0] + per_layer_k).tolist())
    for l in range(n_layers):
        s, e = layer_bounds[l], layer_bounds[l + 1]
        o = out_bounds[l]
        for c in range(ncells):
            (idx,) = np.nonzero(keep[c, s:e])
            cand_idx[c, o: o + len(idx)] = idx + s
    safe = np.maximum(cand_idx, 0)
    return LanelineGrid(
        origin=np.asarray([x0, y0], dtype=packed_nodes.dtype),
        inv_cell=np.asarray(1.0 / cell, dtype=packed_nodes.dtype),
        cand_idx=cand_idx,
        cand_p0=packed_nodes[packed_edges[safe, 0]],
        cand_p1=packed_nodes[packed_edges[safe, 1]],
        nx=nx,
        ny=ny,
        layer_bounds=out_bounds,
    )


@dataclass
class MapData:
    """A compiled map. Laneline layers are stacked along a leading axis,
    all padded to the same Nmax/Emax; the packed view concatenates every
    layer's real edges (see tinycarlo_tpu.map_compiler.MapData)."""

    laneline_nodes: torch.Tensor  # (L, Nmax, 2)
    laneline_node_mask: torch.Tensor  # (L, Nmax)
    laneline_edges: torch.Tensor  # (L, Emax, 2) int32
    laneline_edge_mask: torch.Tensor  # (L, Emax)
    laneline_colors: torch.Tensor  # (L, 3) int32 (RGB)
    lanepath: LanePathArrays
    spawns: SpawnTable
    dimension: torch.Tensor  # (2,) float: (height, width) meters
    packed_nodes: torch.Tensor  # (1, Np, 2)
    packed_edges: torch.Tensor  # (1, Ep, 2) int32 into packed nodes
    packed_edge_mask: torch.Tensor  # (1, Ep) bool
    packed_edge_layer: torch.Tensor  # (Ep,) int32 layer id per edge
    # cumulative per-layer edge offsets into the packed axis (len L + 1)
    packed_layer_bounds: Tuple[int, ...] = ()
    # car_info's spatial-pruning grid (LanelineGrid); None = full scan
    laneline_grid: Optional[LanelineGrid] = None
    laneline_names: Tuple[str, ...] = ()
    pixel_per_meter: int = 1

    @property
    def n_layers(self) -> int:
        return len(self.laneline_names)


def _compile_layer(
    layer: Dict[str, Any], n_max: int, e_max: int, dtype: np.dtype
) -> LayerArrays:
    nodes = np.asarray(layer["nodes"], dtype=np.float64).reshape(-1, 2)
    edges = np.asarray(layer["edges"], dtype=np.int32).reshape(-1, 2)
    n, e = len(nodes), len(edges)
    pad_nodes = np.zeros((n_max, 2), dtype=np.float64)
    pad_nodes[:n] = nodes
    # Padded node slots repeat node 0 so stray gathers stay in-bounds & finite.
    if n:
        pad_nodes[n:] = nodes[0]
    pad_edges = np.zeros((e_max, 2), dtype=np.int32)
    pad_edges[:e] = edges
    return LayerArrays(
        nodes=np.asarray(pad_nodes, dtype=dtype),
        node_mask=np.arange(n_max) < n,
        edges=pad_edges,
        edge_mask=np.arange(e_max) < e,
        n_nodes=n,
        n_edges=e,
    )


def _adjacency(edges: np.ndarray, n_max: int):
    """Successor/predecessor tables in original edge order."""
    next_lists = [[] for _ in range(n_max)]
    prev_lists = [[] for _ in range(n_max)]
    for src, dst in edges:
        next_lists[src].append(int(dst))
        prev_lists[dst].append(int(src))
    deg = max(
        [2]
        + [len(x) for x in next_lists]
        + [len(x) for x in prev_lists]
    )
    next_table = np.full((n_max, deg), -1, dtype=np.int32)
    prev_table = np.full((n_max, deg), -1, dtype=np.int32)
    next_count = np.zeros(n_max, dtype=np.int32)
    prev_count = np.zeros(n_max, dtype=np.int32)
    for i in range(n_max):
        next_table[i, : len(next_lists[i])] = next_lists[i]
        next_count[i] = len(next_lists[i])
        prev_table[i, : len(prev_lists[i])] = prev_lists[i]
        prev_count[i] = len(prev_lists[i])
    return next_table, next_count, prev_table, prev_count


def compile_map(
    map_config: MapConfig,
    base_path: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device="cuda",
) -> MapData:
    """Load a reference map.json, scale px -> meters (reference:
    tinycarlo/map.py:28-37), and pack it into a MapData on `device`."""
    base_dir = "./" if base_path is None else os.path.dirname(base_path)
    map_path = os.path.join(base_dir, map_config.json_path)
    with open(map_path) as f:
        raw = json.load(f)
    return compile_map_data(raw, map_config.pixel_per_meter,
                            spawn_points=map_config.spawn_points, dtype=dtype,
                            query_grid=map_config.query_grid,
                            query_grid_cells=map_config.query_grid_cells,
                            query_grid_margin=map_config.query_grid_margin,
                            device=device)


def compile_map_data(
    raw: Dict[str, Any],
    pixel_per_meter: float,
    spawn_points: Optional[Tuple[int, ...]] = None,
    dtype: torch.dtype = torch.float32,
    query_grid: bool = True,
    query_grid_cells: int = 4096,
    query_grid_margin: Optional[float] = None,
    device="cuda",
) -> MapData:
    """Host-side compilation of a parsed map JSON (numpy), moved to
    `device` once at the end. Same arrays as
    tinycarlo_tpu.map_compiler.compile_map_data, whose defaults it keeps:
    `query_grid` builds the LanelineGrid (None where it would not pay);
    `compile_map` passes MapConfig's, which defaults to False."""
    device = resolve_device(device)
    ndt = numpy_dtype(dtype)
    ppm = float(pixel_per_meter)
    height = raw["height"] / ppm
    width = raw["width"] / ppm

    lanelines = raw["lanelines"]
    names = tuple(lanelines.keys())
    scaled_layers = {
        name: {
            "nodes": np.asarray(layer["nodes"], dtype=np.float64) / ppm,
            "edges": layer["edges"],
            "layer_color": layer["layer_color"],
        }
        for name, layer in lanelines.items()
    }
    lp_nodes = np.asarray(raw["lanepath"]["nodes"], dtype=np.float64) / ppm
    lp_edges = np.asarray(raw["lanepath"]["edges"], dtype=np.int32).reshape(-1, 2)

    n_max = _round_up(max(len(l["nodes"]) for l in scaled_layers.values()))
    e_max = _round_up(max(len(l["edges"]) for l in scaled_layers.values()))
    layer_arrays = [
        _compile_layer(scaled_layers[name], n_max, e_max, ndt) for name in names
    ]
    colors = np.asarray(
        [scaled_layers[name]["layer_color"] for name in names], dtype=np.int32
    )

    # Lanepath with adjacency.
    lp_nmax = _round_up(len(lp_nodes))
    lp = _compile_layer(
        {"nodes": lp_nodes, "edges": lp_edges}, lp_nmax,
        _round_up(len(lp_edges)), ndt,
    )
    nt, nc, pt, pc = _adjacency(lp_edges, lp_nmax)
    lanepath = LanePathArrays(
        nodes=lp.nodes, node_mask=lp.node_mask, edges=lp.edges,
        edge_mask=lp.edge_mask, n_nodes=lp.n_nodes, n_edges=lp.n_edges,
        next_table=nt, next_count=nc, prev_table=pt, prev_count=pc,
    )

    # Spawn table: candidates with >= 1 successor, first successor defines
    # the spawn edge + rotation (reference: tinycarlo/map.py:61-68).
    if spawn_points is not None:
        candidates = [int(s) for s in spawn_points]
    else:
        candidates = list(range(max(0, len(lp_nodes) - 1)))
    rows = []
    for idx in candidates:
        succs = nt[idx]
        succs = succs[succs >= 0]
        if len(succs) == 0:
            continue
        nxt = int(succs[0])
        pos = lp_nodes[idx]
        npos = lp_nodes[nxt]
        rot = math.atan2(npos[1] - pos[1], npos[0] - pos[0])
        rows.append((idx, pos[0], pos[1], rot, idx, nxt))
    if not rows:
        raise ValueError("map has no valid spawn node (no node with successor)")
    s = len(rows)
    arr = np.zeros((_round_up(s), 6), dtype=np.float64)
    arr[:s] = np.asarray(rows, dtype=np.float64)
    arr[s:] = arr[0]  # pad with the first row; sampling never selects pads
    spawns = SpawnTable(
        node_idx=np.asarray(arr[:, 0], dtype=np.int32),
        position=np.asarray(arr[:, 1:3], dtype=ndt),
        rotation=np.asarray(arr[:, 3], dtype=ndt),
        edge=np.asarray(arr[:, 4:6], dtype=np.int32),
        count=s,
    )

    # Packed camera view: real (unpadded) nodes/edges of all layers
    # concatenated, edges re-indexed into the packed node table.
    pk_nodes, pk_edges, pk_lay, node_off = [], [], [], 0
    for li, l in enumerate(layer_arrays):
        pk_nodes.append(l.nodes[: l.n_nodes])
        pk_edges.append(l.edges[: l.n_edges] + node_off)
        pk_lay.append(np.full(l.n_edges, li, dtype=np.int32))
        node_off += l.n_nodes
    pk_nodes = np.concatenate(pk_nodes)
    pk_edges = np.concatenate(pk_edges)
    pk_lay = np.concatenate(pk_lay)
    np_, ep = _round_up(len(pk_nodes)), _round_up(len(pk_edges))
    packed_nodes = np.zeros((np_, 2), dtype=pk_nodes.dtype)
    packed_nodes[: len(pk_nodes)] = pk_nodes
    if len(pk_nodes):
        packed_nodes[len(pk_nodes):] = pk_nodes[0]
    packed_edges = np.zeros((ep, 2), np.int32)
    packed_edges[: len(pk_edges)] = pk_edges
    packed_edge_layer = np.zeros((ep,), np.int32)
    packed_edge_layer[: len(pk_lay)] = pk_lay
    packed_bounds = tuple(
        np.cumsum([0] + [l.n_edges for l in layer_arrays]).tolist()
    )
    grid = None
    if query_grid:
        grid = _build_laneline_grid(
            packed_nodes, packed_edges, len(pk_edges), packed_bounds,
            (height, width), query_grid_cells, query_grid_margin,
        )

    map_data = MapData(
        laneline_nodes=np.stack([l.nodes for l in layer_arrays]),
        laneline_node_mask=np.stack([l.node_mask for l in layer_arrays]),
        laneline_edges=np.stack([l.edges for l in layer_arrays]),
        laneline_edge_mask=np.stack([l.edge_mask for l in layer_arrays]),
        laneline_colors=colors,
        lanepath=lanepath,
        spawns=spawns,
        dimension=np.asarray([height, width], dtype=ndt),
        packed_nodes=packed_nodes[None].astype(ndt),
        packed_edges=packed_edges[None],
        packed_edge_mask=(np.arange(ep) < len(pk_edges))[None],
        packed_edge_layer=packed_edge_layer,
        packed_layer_bounds=packed_bounds,
        laneline_grid=grid,
        laneline_names=names,
        pixel_per_meter=int(pixel_per_meter),
    )
    # One host -> device move for the whole map.
    return to_device(map_data, device)
