"""Line-segment rasterization into class masks: the dense torch twin.

Counterpart of the parts of tinycarlo_tpu/ops/rasterize.py that the
port's main path and its tests use: cv2's integer endpoint truncation,
clipLine and closed-form 8-connected Bresenham at thickness 1, the
calibrated split stroke (rectangle body + end caps) at t >= 2, and the
dense `rasterize_masks`. The dense rasterizer evaluates every (pixel,
segment) pair and is the CPU oracle for the masks kernel
(ops/rasterize_kernels.py, ops/csrc/masks.cu). The decodes turn a layer-
rank map (the rank kernel's output) or class masks into the rgb,
rgb_planar and classes formats.

Not ported yet: the bit-exact cv2 ThickLine stroke (`stroke="exact"` at
t >= 2, ROADMAP M11).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


def _split_radii(thickness: int) -> Tuple[float, float]:
    """cv2-calibrated stroke geometry for t >= 2: lateral halfwidth
    ceil(t/2)+0.5, cap radius ceil(t/2) (see tinycarlo_tpu's docstring for
    the calibration). t=1 is not a disc at all (see _bresenham_hit)."""
    if thickness <= 1:
        return 0.5, 0.5
    half = math.ceil(thickness / 2)
    return half + 0.5, float(half)


def _check_stroke(thickness: int, stroke: str) -> None:
    if stroke == "exact" and thickness >= 2:
        raise NotImplementedError(
            'stroke="exact" at thickness >= 2 is not ported yet (ROADMAP M11)'
        )


def _stroke_radius_sq(thickness: int, stroke: str = "fast") -> float:
    """Squared band-extent radius (the largest distance at which any pixel
    can be painted) -- used for band culling and compaction extents."""
    _check_stroke(thickness, stroke)
    r = _split_radii(thickness)[0]
    return r * r


def _clip_line_cv2(w: int, h: int, x1, y1, x2, y2):
    """Bit-exact replica of cv2 clipLine (drawing.cpp) on integer-valued
    float tensors: clip pt1 then pt2 against the y range, then against
    x, intermediates truncated toward zero -- the arithmetic of
    tinycarlo_tpu.ops.rasterize._clip_line_cv2. Returns
    (x1, y1, x2, y2, accept)."""
    right = float(w - 1)
    bottom = float(h - 1)

    def code(x, y):
        return (
            (x < 0).int()
            + 2 * (x > right).int()
            + 4 * (y < 0).int()
            + 8 * (y > bottom).int()
        )

    def tdiv(num, den):
        return torch.trunc(num / torch.where(den == 0, 1.0, den))

    c1 = code(x1, y1)
    c2 = code(x2, y2)
    active = ((c1 & c2) == 0) & ((c1 | c2) != 0)

    do = active & ((c1 & 12) != 0)
    a = torch.where(c1 < 8, 0.0, bottom).to(x1.dtype)
    x1n = x1 + tdiv((a - y1) * (x2 - x1), y2 - y1)
    x1 = torch.where(do, x1n, x1)
    y1 = torch.where(do, a, y1)
    c1 = torch.where(do, (x1 < 0).int() + 2 * (x1 > right).int(), c1)

    do = active & ((c2 & 12) != 0)
    a = torch.where(c2 < 8, 0.0, bottom).to(x1.dtype)
    x2n = x2 + tdiv((a - y2) * (x2 - x1), y2 - y1)
    x2 = torch.where(do, x2n, x2)
    y2 = torch.where(do, a, y2)
    c2 = torch.where(do, (x2 < 0).int() + 2 * (x2 > right).int(), c2)

    active = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    do = active & (c1 != 0)
    a = torch.where(c1 == 1, 0.0, right).to(x1.dtype)
    y1n = y1 + tdiv((a - x1) * (y2 - y1), x2 - x1)
    y1 = torch.where(do, y1n, y1)
    x1 = torch.where(do, a, x1)
    c1 = torch.where(do, 0, c1)

    do = active & (c2 != 0)
    a = torch.where(c2 == 1, 0.0, right).to(x1.dtype)
    y2n = y2 + tdiv((a - x2) * (y2 - y1), x2 - x1)
    y2 = torch.where(do, y2n, y2)
    x2 = torch.where(do, a, x2)
    c2 = torch.where(do, 0, c2)

    return x1, y1, x2, y2, (c1 & c2) == 0


def _bresenham_hit(px, py, x1, y1, x2, y2, accept):
    """Per-pixel predicate for cv2's thickness-1 line: the 8-connected DDA
    of LineIterator in closed form, anchored at the smaller-x endpoint,
    with the residual correction that keeps the float floor division
    exact (tinycarlo_tpu.ops.rasterize._bresenham_hit)."""
    swap = x2 < x1
    ax = torch.where(swap, x2, x1)
    ay = torch.where(swap, y2, y1)
    bx = torch.where(swap, x1, x2)
    by = torch.where(swap, y1, y2)
    dx = bx - ax
    dy = by - ay
    sy = torch.where(dy >= 0, 1.0, -1.0).to(px.dtype)
    ady = torch.abs(dy)
    xmaj = dx >= ady
    maj = torch.where(xmaj, dx, ady)
    mino = torch.where(xmaj, ady, dx)
    step = torch.where(xmaj, px - ax, sy * (py - ay))
    num = 2 * mino * step + maj - 1
    den = 2 * maj
    q = torch.floor(num / torch.where(den == 0, 1.0, den))
    r = num - q * den
    q = q + (r >= den).to(px.dtype) - (r < 0).to(px.dtype)
    minor_coord = torch.where(xmaj, ay + sy * q, ax + q)
    probe = torch.where(xmaj, py, px)
    inrange = (step >= 0) & (step <= maj)
    hit = inrange & (probe == minor_coord)
    point = (dx == 0) & (ady == 0)
    hit = torch.where(point, (px == ax) & (py == ay), hit)
    return hit & accept


def _segment_dist_sq(px, py, ax, ay, bx, by):
    """Squared distance from points (px, py) to segments (a, b)."""
    abx = bx - ax
    aby = by - ay
    apx = px - ax
    apy = py - ay
    denom = abx * abx + aby * aby
    t = (apx * abx + apy * aby) / torch.where(denom == 0, 1.0, denom)
    t = torch.clamp(t, 0.0, 1.0)
    dx = apx - t * abx
    dy = apy - t * aby
    return dx * dx + dy * dy


def _int_endpoints(p0: torch.Tensor, p1: torch.Tensor, dtype):
    """cv2-style int32 truncation of endpoints, clamped to a sane window so
    near-plane-clipped points (|coord| up to ~1e9) stay finite in float32."""
    lim = 1_000_000.0
    a = torch.clamp(p0, -lim, lim).to(torch.int32).to(dtype)
    b = torch.clamp(p1, -lim, lim).to(torch.int32).to(dtype)
    return a, b


def _segment_hit(px, py, ax, ay, bx, by, thickness: int, resolution,
                 stroke: str = "fast"):
    """Per-(pixel, segment) hit predicate with cv2 stroke semantics: exact
    clipLine + 8-connected Bresenham at thickness 1; the calibrated split
    stroke at t >= 2. Pixel coords broadcast against segment coords."""
    _check_stroke(thickness, stroke)
    if thickness <= 1:
        cx1, cy1, cx2, cy2, acc = _clip_line_cv2(
            resolution[1], resolution[0], ax, ay, bx, by
        )
        return _bresenham_hit(px, py, cx1, cy1, cx2, cy2, acc)
    lat, cap = _split_radii(thickness)
    abx = bx - ax
    aby = by - ay
    apx = px - ax
    apy = py - ay
    denom = abx * abx + aby * aby
    tt = (apx * abx + apy * aby) / torch.where(denom == 0, 1.0, denom)
    tc = torch.clamp(tt, 0, 1)
    dxv = apx - tc * abx
    dyv = apy - tc * aby
    d2 = dxv * dxv + dyv * dyv
    r2 = torch.where((tt >= 0) & (tt <= 1), lat * lat, cap * cap).to(px.dtype)
    return d2 <= r2


def rasterize_masks(
    p0: torch.Tensor,  # (L, E, 2) float pixel coords (u=x, v=y)
    p1: torch.Tensor,  # (L, E, 2)
    draw: torch.Tensor,  # (L, E) bool
    resolution: Tuple[int, int],
    thickness: int = 1,
    stroke: str = "fast",
) -> torch.Tensor:
    """Rasterize per-layer segments into (L, H, W) uint8 {0,255} masks by
    the dense O(H*W*E) stroke test. Reference render_camera_frame_classes
    (renderer.py:46-51); tinycarlo_tpu.ops.rasterize.rasterize_masks."""
    h, w = resolution
    dtype = p0.dtype
    a, b = _int_endpoints(p0, p1, dtype)
    ys = torch.arange(h, dtype=dtype, device=p0.device)[:, None, None]
    xs = torch.arange(w, dtype=dtype, device=p0.device)[None, :, None]
    out = []
    for l in range(p0.shape[0]):
        hit = _segment_hit(
            xs, ys, a[l, :, 0], a[l, :, 1], b[l, :, 0], b[l, :, 1],
            thickness, resolution, stroke,
        )  # (H, W, E)
        hit = (hit & draw[l]).any(dim=-1)
        out.append(torch.where(hit, 255, 0).to(torch.uint8))
    return torch.stack(out)


def rgb_from_rank(rank: torch.Tensor, colors: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 layer-rank map (0 = background, l+1 = layer l
    painted last) -> (..., H, W, 3) uint8 rgb: cv2 paints layers in index
    order with later layers overwriting (renderer.py:41-43), which is
    "highest rank wins". tinycarlo_tpu.ops.rasterize.rgb_from_rank."""
    colors = colors.to(torch.uint8)
    frame = torch.zeros(rank.shape + (3,), dtype=torch.uint8,
                        device=rank.device)
    for l in range(colors.shape[0]):
        frame = torch.where((rank == l + 1)[..., None], colors[l], frame)
    return frame


def rank_from_masks(masks: torch.Tensor) -> torch.Tensor:
    """(..., L, H, W) class masks -> (..., H, W) uint8 layer-rank map, the
    highest set layer index + 1 at each pixel (0 = background).
    tinycarlo_tpu.ops.rasterize.rank_from_masks."""
    n = masks.shape[-3]
    ranks = torch.arange(1, n + 1, dtype=torch.uint8,
                         device=masks.device).reshape(n, 1, 1)
    return torch.where(masks > 0, ranks, 0).to(torch.uint8).amax(dim=-3)


def classes_from_rank(rank: torch.Tensor, n_layers: int,
                      out_dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """(..., H, W) rank map -> (..., L, H, W) one-hot class masks: only the
    last-painted layer's channel is set where layers overlap. uint8 gives
    0/255, float dtypes 0/1. tinycarlo_tpu.ops.rasterize.classes_from_rank."""
    ids = torch.arange(1, n_layers + 1, dtype=rank.dtype,
                       device=rank.device).reshape(n_layers, 1, 1)
    hit = rank[..., None, :, :] == ids
    one = 255 if out_dtype == torch.uint8 else 1
    return torch.where(hit, one, 0).to(out_dtype)


def rgb_planar_from_rank(rank: torch.Tensor,
                         colors: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 rank map -> (..., 3, H, W) uint8 planar rgb: the
    pixels of `rgb_from_rank`, channel first.
    tinycarlo_tpu.ops.rasterize.rgb_planar_from_rank."""
    colors = colors.to(torch.uint8)
    chans = []
    for c in range(3):
        ch = torch.zeros(rank.shape, dtype=torch.uint8, device=rank.device)
        for l in range(colors.shape[0]):
            ch = torch.where(rank == l + 1, colors[l, c], ch)
        chans.append(ch)
    return torch.stack(chans, dim=-3)


def rasterize_rgb_planar(masks: torch.Tensor,
                         colors: torch.Tensor) -> torch.Tensor:
    """(..., L, H, W) masks -> (..., 3, H, W) uint8 planar rgb, layers
    painted in index order. tinycarlo_tpu.ops.rasterize.rasterize_rgb_planar."""
    colors = colors.to(torch.uint8)
    chans = []
    for c in range(3):
        ch = torch.zeros(masks.shape[:-3] + masks.shape[-2:],
                         dtype=torch.uint8, device=masks.device)
        for l in range(colors.shape[0]):
            ch = torch.where(masks[..., l, :, :] > 0, colors[l, c], ch)
        chans.append(ch)
    return torch.stack(chans, dim=-3)
