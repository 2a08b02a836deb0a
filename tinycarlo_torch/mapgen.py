"""Procedural map generation in the reference map.json schema.

The port's own copy of tinycarlo_tpu/mapgen.py (json and math only), so
that the port needs nothing of the JAX package: `loop_track` and
`figure_eight` return the same dicts, and `save_map` / `generate_examples`
write the same bytes. The reference ships hand-authored maps (reference:
examples/maps/*.json, authored with the mapbuilder GUI, schema per
mapbuilder/mapbuilder.py:92-107: pixel-unit {width, height,
lanelines{name: {layer_color, nodes, edges}}, lanepath{...}}); these
generators make equivalent maps in code.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List


def _ring_nodes(
    cx: float, cy: float, rx: float, ry: float, n: int, corner: float
) -> List[List[float]]:
    """Rounded-rectangle ring sampled at n points (pixel units)."""
    pts = []
    for i in range(n):
        t = 2 * math.pi * i / n
        # superellipse-ish rounding: blend rectangle and ellipse
        c, s = math.cos(t), math.sin(t)
        ex = abs(c) ** corner * (1 if c >= 0 else -1)
        ey = abs(s) ** corner * (1 if s >= 0 else -1)
        pts.append([cx + rx * ex, cy + ry * ey])
    return pts


def _ring_edges(n: int, offset: int = 0, reverse: bool = False):
    if reverse:
        return [[offset + (i + 1) % n, offset + i] for i in range(n)]
    return [[offset + i, offset + (i + 1) % n] for i in range(n)]


def _dashed_edges(n: int, offset: int = 0, period: int = 2):
    """Every other segment, giving a dashed appearance."""
    return [
        [offset + i, offset + (i + 1) % n]
        for i in range(n)
        if i % period == 0
    ]


def loop_track(
    width: int = 1000,
    height: int = 700,
    n_points: int = 96,
    lane_width: int = 40,
    corner: float = 0.6,
) -> Dict:
    """A two-lane closed loop: outer boundary, dashed center divider,
    solid inner boundary, and a directed two-lane lanepath (one lane per
    direction), structurally equivalent to the reference's simple_layout
    (5-layer laneline map with a loop lanepath).
    """
    cx, cy = width / 2, height / 2
    rx, ry = width / 2 - 60, height / 2 - 60

    outer = _ring_nodes(cx, cy, rx, ry, n_points, corner)
    center = _ring_nodes(cx, cy, rx - lane_width, ry - lane_width, n_points, corner)
    inner = _ring_nodes(
        cx, cy, rx - 2 * lane_width, ry - 2 * lane_width, n_points, corner
    )
    # lanepath: middle of each lane; outer lane counter-clockwise, inner
    # lane clockwise (two directed loops, enabling u-turn maneuvers)
    lane_out = _ring_nodes(
        cx, cy, rx - lane_width / 2, ry - lane_width / 2, n_points, corner
    )
    lane_in = _ring_nodes(
        cx, cy, rx - 1.5 * lane_width, ry - 1.5 * lane_width, n_points, corner
    )

    lanepath_nodes = lane_out + lane_in
    lanepath_edges = _ring_edges(n_points) + _ring_edges(
        n_points, offset=n_points, reverse=True
    )

    return {
        "width": width,
        "height": height,
        "lanelines": {
            "outer": {
                "layer_color": [255, 255, 255],
                "nodes": outer,
                "edges": _ring_edges(n_points),
            },
            "dashed": {
                "layer_color": [0, 255, 255],
                "nodes": center,
                "edges": _dashed_edges(n_points),
            },
            "solid": {
                "layer_color": [255, 0, 255],
                "nodes": inner,
                "edges": _ring_edges(n_points),
            },
        },
        "lanepath": {
            "layer_color": [50, 50, 50],
            "nodes": lanepath_nodes,
            "edges": lanepath_edges,
        },
    }


def figure_eight(
    width: int = 1200, height: int = 700, n_points: int = 64
) -> Dict:
    """A one-way figure-eight lanepath with a single outer boundary --
    exercises heading reversals and self-intersection."""
    cx1, cx2, cy = width * 0.3, width * 0.7, height / 2
    r = min(width * 0.18, height * 0.38)
    left = _ring_nodes(cx1, cy, r, r, n_points, 1.0)
    right = _ring_nodes(cx2, cy, r, r, n_points, 1.0)
    nodes = left + right
    edges = _ring_edges(n_points) + _ring_edges(
        n_points, offset=n_points, reverse=True
    )
    outer = _ring_nodes(cx1, cy, r + 50, r + 50, n_points, 1.0) + _ring_nodes(
        cx2, cy, r + 50, r + 50, n_points, 1.0
    )
    outer_edges = _ring_edges(n_points) + _ring_edges(n_points, offset=n_points)
    return {
        "width": width,
        "height": height,
        "lanelines": {
            "outer": {
                "layer_color": [255, 255, 255],
                "nodes": outer,
                "edges": outer_edges,
            },
        },
        "lanepath": {
            "layer_color": [50, 50, 50],
            "nodes": nodes,
            "edges": edges,
        },
    }


def save_map(map_data: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(map_data, f)


def generate_examples(directory: str) -> List[str]:
    """Write the bundled generated maps into `directory`."""
    import os

    os.makedirs(directory, exist_ok=True)
    out = []
    for name, gen in (("loop_track", loop_track), ("figure_eight", figure_eight)):
        p = os.path.join(directory, f"{name}.json")
        save_map(gen(), p)
        out.append(p)
    return out
