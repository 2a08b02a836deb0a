"""Exact cv2 thick-stroke (thickness >= 2) semantics: the torch twin.

Counterpart of tinycarlo_tpu/ops/cv2_stroke.py, which documents the model
(reverse-engineered against cv2 5.0 to bit-exactness): an integer pre-clip
to the image rect inflated by `thickness` px, a quad of 16.16 fixed-point
corners, FillConvexPoly's scanline fill of it, a Line2 outline per ring
edge (scaled-rect clip, both rounded endpoint dots, a major-axis DDA) and
cv2's filled integer circle at both clipped endpoints.

Two implementations, as in the JAX package:

* `thick_stroke_mask_ref` -- the scalar host oracle in pure Python ints,
  the port's own copy (the JAX package's module imports jax). The tests
  hold it against cv2.polylines; chip_smoke.py holds the card's frames
  against it on a machine without cv2.
* `thick_params` / `thick_hit` -- the vectorized torch pair: a per-segment
  int32 scalar bundle and the per-(pixel, segment) predicate. The dense
  rasterizer (`rasterize._segment_hit`) evaluates them directly, and the
  exact compaction (`rasterize_kernels.compact_env_exact_soa`) ships the
  bundle to the exact kernel.

`thick_params` repeats the JAX package's operations one for one, in the
input's float dtype where JAX uses it (the two clips and the quad's dp)
and in int32 elsewhere. Under float64 every intermediate is exact and the
output equals cv2's. Under float32 the scaled outline clip multiplies
16.16 fixed-point values past 2^24 and rounds -- as the JAX package does;
the port keeps that order of operations rather than computing more
exactly than its reference.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
HALF = XY_ONE >> 1
_EPS64 = float(np.finfo(np.float64).eps)


# ---------------------------------------------------------------------------
# Host oracle (scalar, python ints / f64)
# ---------------------------------------------------------------------------


def _tdiv_host(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _clip_host(right, bottom, x1, y1, x2, y2):
    """cv2 clipLine on [0, right] x [0, bottom] (int64 semantics)."""

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1 = code(x1, y1)
    c2 = code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _tdiv_host((a - y1) * (x2 - x1), (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _tdiv_host((a - y2) * (x2 - x1), (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _tdiv_host((a - x1) * (y2 - y1), (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _tdiv_host((a - x2) * (y2 - y1), (x2 - x1))
                x2 = a
                c2 = 0
    return x1, y1, x2, y2, (c1 | c2) == 0


def _line2_host(mask, p1, p2):
    h, w = mask.shape
    x1, y1, x2, y2, ok = _clip_host(
        (w << XY_SHIFT) - 1, (h << XY_SHIFT) - 1, p1[0], p1[1], p2[0], p2[1]
    )
    if not ok:
        return
    for ex, ey in ((x1, y1), (x2, y2)):
        dx_, dy_ = (ex + HALF) >> XY_SHIFT, (ey + HALF) >> XY_SHIFT
        if 0 <= dx_ < w and 0 <= dy_ < h:
            mask[dy_, dx_] = True
    dx = x2 - x1
    dy = y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dy = -dy
        st = _tdiv_host(dy * XY_ONE, (ax | 1))
        m = (x1 + HALF) >> XY_SHIFT
        n = (x2 - x1 + XY_ONE - 1) >> XY_SHIFT
        v = y1 + HALF
        for _ in range(max(n, 0)):
            yy = v >> XY_SHIFT
            if 0 <= m < w and 0 <= yy < h:
                mask[yy, m] = True
            m += 1
            v += st
    else:
        if dy < 0:
            x1, y1, x2, y2 = x2, y2, x1, y1
            dx = -dx
        st = _tdiv_host(dx * XY_ONE, (ay | 1))
        m = (y1 + HALF) >> XY_SHIFT
        n = (y2 - y1 + XY_ONE - 1) >> XY_SHIFT
        v = x1 + HALF
        for _ in range(max(n, 0)):
            xx = v >> XY_SHIFT
            if 0 <= xx < w and 0 <= m < h:
                mask[m, xx] = True
            m += 1
            v += st


def _fill_host(mask, v):
    """FillConvexPoly scanfill + Line2 outlines, shift = XY_SHIFT."""
    h, w = mask.shape
    npts = len(v)
    p0 = v[-1]
    for p in v:
        _line2_host(mask, p0, p)
        p0 = p

    ys = [p[1] for p in v]
    imin = 0
    ymin_f = ys[0]
    for i, yy in enumerate(ys):
        if yy < ymin_f:
            ymin_f = yy
            imin = i
    ymin = (ymin_f + HALF) >> XY_SHIFT
    ymax = (max(ys) + HALF) >> XY_SHIFT
    xmin = (min(p[0] for p in v) + HALF) >> XY_SHIFT
    xmax = (max(p[0] for p in v) + HALF) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax_c = min(ymax, h - 1)
    edge = [
        dict(idx=imin, di=1, x=-XY_ONE, dx=0, ye=ymin),
        dict(idx=imin, di=npts - 1, x=-XY_ONE, dx=0, ye=ymin),
    ]
    edges = npts
    y = ymin
    while True:
        for i in range(2):
            if y >= edge[i]["ye"]:
                idx0 = edge[i]["idx"]
                di = edge[i]["di"]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while edges > 0:
                    edges -= 1
                    ty = (v[idx][1] + HALF) >> XY_SHIFT
                    if ty > y:
                        xs, xe = v[idx0][0], v[idx][0]
                        edge[i]["ye"] = ty
                        edge[i]["dx"] = _tdiv_host(
                            (xe - xs) * 2 + (ty - y), 2 * (ty - y)
                        )
                        edge[i]["x"] = xs
                        edge[i]["idx"] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
                else:
                    edges -= 1  # C's for(; edges-- > 0;) exit decrement
        if edges < 0:
            break
        if y >= 0:
            xa, xb = edge[0]["x"], edge[1]["x"]
            if xa > xb:
                xa, xb = xb, xa
            xx1 = (xa + HALF) >> XY_SHIFT
            xx2 = (xb + HALF) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                mask[y, max(xx1, 0): min(xx2, w - 1) + 1] = True
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax_c:
            break


def cap_table(radius: int) -> Tuple[int, ...]:
    """Half-width per |row offset| of cv2's filled integer circle."""
    W = {}
    err, dx, dy = 0, radius, 0
    plus, minus = 1, (radius << 1) - 1
    while dx >= dy:
        W[dy] = max(W.get(dy, -1), dx)
        W[dx] = max(W.get(dx, -1), dy)
        dy += 1
        err += plus
        plus += 2
        m = 0 if err <= 0 else -1
        err -= minus & m
        dx += m
        minus -= m & 2
    return tuple(W[m] for m in sorted(W))


def cap_radius(thickness: int) -> int:
    return ((thickness << (XY_SHIFT - 1)) + HALF) >> XY_SHIFT


def _circle_host(mask, cx, cy, radius):
    h, w = mask.shape
    tab = cap_table(radius)
    for m, hw in enumerate(tab):
        for yy in (cy - m, cy + m):
            if 0 <= yy < h:
                xa, xb = max(cx - hw, 0), min(cx + hw, w - 1)
                if xb >= xa:
                    mask[yy, xa: xb + 1] = True


def thick_stroke_mask_ref(
    p0, p1, thickness: int, resolution: Tuple[int, int]
) -> np.ndarray:
    """(H, W) bool mask of cv2.polylines([p0, p1], thickness, LINE_8)
    for thickness >= 2 -- the validated scalar oracle."""
    h, w = resolution
    mask = np.zeros((h, w), bool)
    pad = thickness
    x1, y1, x2, y2, ok = _clip_host(
        w - 1 + 2 * pad, h - 1 + 2 * pad,
        int(p0[0]) + pad, int(p0[1]) + pad,
        int(p1[0]) + pad, int(p1[1]) + pad,
    )
    if not ok:
        return mask
    P0 = ((x1 - pad) * XY_ONE, (y1 - pad) * XY_ONE)
    P1 = ((x2 - pad) * XY_ONE, (y2 - pad) * XY_ONE)
    dx = (P0[0] - P1[0]) / float(XY_ONE)
    dy = (P1[1] - P0[1]) / float(XY_ONE)
    r = dx * dx + dy * dy
    odd = thickness & 1
    th = thickness << (XY_SHIFT - 1)
    if abs(r) > _EPS64:
        r = (th + odd * XY_ONE * 0.5) / np.sqrt(r)
        dpx = int(np.rint(dy * r))
        dpy = int(np.rint(dx * r))
        _fill_host(
            mask,
            [
                (P0[0] + dpx, P0[1] + dpy),
                (P0[0] - dpx, P0[1] - dpy),
                (P1[0] - dpx, P1[1] - dpy),
                (P1[0] + dpx, P1[1] + dpy),
            ],
        )
    rad = cap_radius(thickness)
    for p in (P0, P1):
        _circle_host(mask, (p[0] + HALF) >> XY_SHIFT, (p[1] + HALF) >> XY_SHIFT, rad)
    return mask


# ---------------------------------------------------------------------------
# Vectorized torch params + predicate
# ---------------------------------------------------------------------------


def _tdiv_i32(a, b):
    """C-truncating int32 division (b != 0): the JAX package's floor
    quotient plus its sign correction is the same function."""
    return torch.div(a, b, rounding_mode="trunc")


def _clip_f(right, bottom, x1, y1, x2, y2):
    """Vectorized cv2 clipLine against [0, right] x [0, bottom] in the
    float dtype of the inputs (trunc division), operation for operation as
    tinycarlo_tpu's `_clip_f`; the bounds are rounded to that dtype first,
    as JAX's `dtype.type(right)` does. (Filled on the device: a
    torch.tensor from a Python number would be a blocking host copy.)"""
    dtype, dev = x1.dtype, x1.device

    def scalar(v):
        return torch.full((), v, dtype=dtype, device=dev)

    right, bottom, zero, one = scalar(right), scalar(bottom), scalar(0), scalar(1)

    def code(x, y):
        return (
            (x < 0).int()
            + 2 * (x > right).int()
            + 4 * (y < 0).int()
            + 8 * (y > bottom).int()
        )

    def tdiv(num, den):
        return torch.trunc(num / torch.where(den == 0, one, den))

    def xcode(x):
        return (x < 0).int() + 2 * (x > right).int()

    c1 = code(x1, y1)
    c2 = code(x2, y2)
    active = ((c1 & c2) == 0) & ((c1 | c2) != 0)

    do = active & ((c1 & 12) != 0)
    a = torch.where(c1 < 8, zero, bottom)
    x1 = torch.where(do, x1 + tdiv((a - y1) * (x2 - x1), y2 - y1), x1)
    y1 = torch.where(do, a, y1)
    c1 = torch.where(do, xcode(x1), c1)

    do = active & ((c2 & 12) != 0)
    a = torch.where(c2 < 8, zero, bottom)
    x2 = torch.where(do, x2 + tdiv((a - y2) * (x2 - x1), y2 - y1), x2)
    y2 = torch.where(do, a, y2)
    c2 = torch.where(do, xcode(x2), c2)

    active = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    do = active & (c1 != 0)
    a = torch.where(c1 == 1, zero, right)
    y1 = torch.where(do, y1 + tdiv((a - x1) * (y2 - y1), x2 - x1), y1)
    x1 = torch.where(do, a, x1)
    c1 = torch.where(do, 0, c1)

    do = active & (c2 != 0)
    a = torch.where(c2 == 1, zero, right)
    y2 = torch.where(do, y2 + tdiv((a - x2) * (y2 - y1), x2 - x1), y2)
    x2 = torch.where(do, a, x2)
    c2 = torch.where(do, 0, c2)

    return x1, y1, x2, y2, (c1 | c2) == 0


def _pick4(vals, idx):
    """vals: list of 4 tensors; idx in 0..3 (tensor). 4-way select."""
    out = vals[0]
    for i in (1, 2, 3):
        out = torch.where(idx == i, vals[i], out)
    return out


def _edge_outline_params(x1i, y1i, x2i, y2i, live, h: int, w: int, fdtype):
    """Line2 params for one ring edge given int32 fixed-point endpoints
    (tinycarlo_tpu's `_edge_outline_params`): the rounded endpoint dots,
    the major axis, the DDA's m0, n, v0 and slope st, the normalized-far
    dot, and `acc`. The scaled clip runs in the float dtype."""
    xc1, yc1, xc2, yc2, ok = _clip_f(
        (w << XY_SHIFT) - 1, (h << XY_SHIFT) - 1,
        x1i.to(fdtype), y1i.to(fdtype), x2i.to(fdtype), y2i.to(fdtype),
    )
    acc = ok & live
    x1 = xc1.to(torch.int32)
    y1 = yc1.to(torch.int32)
    x2 = xc2.to(torch.int32)
    y2 = yc2.to(torch.int32)
    d0x = (x1 + HALF) >> XY_SHIFT
    d0y = (y1 + HALF) >> XY_SHIFT
    d1x = (x2 + HALF) >> XY_SHIFT
    d1y = (y2 + HALF) >> XY_SHIFT
    dx = x2 - x1
    dy = y2 - y1
    ax = torch.abs(dx)
    ay = torch.abs(dy)
    xmaj = ax > ay
    # normalize major increasing
    swap = torch.where(xmaj, dx < 0, dy < 0)
    nx1 = torch.where(swap, x2, x1)
    ny1 = torch.where(swap, y2, y1)
    nx2 = torch.where(swap, x1, x2)
    ny2 = torch.where(swap, y1, y2)
    maj1 = torch.where(xmaj, nx1, ny1)
    maj2 = torch.where(xmaj, nx2, ny2)
    mino1 = torch.where(xmaj, ny1, nx1)
    mino2 = torch.where(xmaj, ny2, nx2)
    amaj = torch.maximum(ax, ay) | 1
    dmin = mino2 - mino1
    # st = tdiv(dmin << 16, amaj) without overflowing int32: with dmin =
    # q*amaj + r (trunc pair), trunc(dmin*c / amaj) = q*c + trunc(r*c /
    # amaj); applied with c = 16 four times, |r * 16| < 16 * amaj stays in
    # int32 (tinycarlo_tpu/ops/cv2_stroke.py:414-425)
    st = _tdiv_i32(dmin, amaj)
    r = dmin - st * amaj
    for _ in range(4):
        q = _tdiv_i32(r * 16, amaj)
        r = r * 16 - q * amaj
        st = (st << 4) + q
    m0 = (maj1 + HALF) >> XY_SHIFT
    n = (maj2 - maj1 + XY_ONE - 1) >> XY_SHIFT
    v0 = mino1 + HALF
    # The normalized-far dot: the DDA's k=0 pixel is the rounded
    # normalized-near endpoint, so one extra dot at the far end covers
    # both of cv2's endpoint dots; for direction-swapped edges that far
    # dot is (d0x, d0y), not (d1x, d1y)
    fdx = torch.where(swap, d0x, d1x)
    fdy = torch.where(swap, d0y, d1y)
    return dict(
        acc=acc, d0x=d0x, d0y=d0y, d1x=d1x, d1y=d1y, fdx=fdx, fdy=fdy,
        xmaj=xmaj, m0=m0, n=n, v0=v0, st=st,
    )


def _first_min_index(vals):
    """Index of the first strict minimum of 4 int32 tensors (what
    jnp.argmin returns on ties), by explicit comparisons so that ties
    resolve the same way on every device."""
    best = vals[0]
    idx = torch.zeros_like(best)
    for i in (1, 2, 3):
        less = vals[i] < best
        idx = torch.where(less, i, idx)
        best = torch.where(less, vals[i], best)
    return idx


def thick_params(ax, ay, bx, by, thickness: int, resolution: Tuple[int, int]):
    """Per-segment exact-stroke scalar bundle (tinycarlo_tpu's
    `thick_params`).

    ax..by: integer-valued float tensors (any shape) -- the segment
    endpoints in pixels, already int-truncated (`rasterize._int_endpoints`
    semantics). Returns a dict of tensors with the same leading shape:
    int32 fields, bool flags and a list of 4 per-edge dicts.
    """
    h, w = resolution
    fdtype = ax.dtype
    t = int(thickness)
    pad = t

    # 1. integer pre-clip on the inflated rect (shift coords by +pad)
    x1, y1, x2, y2, ok = _clip_f(
        w - 1 + 2 * pad, h - 1 + 2 * pad, ax + pad, ay + pad, bx + pad, by + pad
    )
    p0x = (x1 - pad).to(torch.int32)
    p0y = (y1 - pad).to(torch.int32)
    p1x = (x2 - pad).to(torch.int32)
    p1y = (y2 - pad).to(torch.int32)
    accept = ok

    # 2. quad corners: dp in the float dtype (cv2 uses double)
    dxf = (p0x - p1x).to(fdtype)
    dyf = (p1y - p0y).to(fdtype)
    r2 = dxf * dxf + dyf * dyf
    has_quad = torch.abs(r2) > _EPS64
    th = t << (XY_SHIFT - 1)
    odd = t & 1
    rr = (float(th) + odd * XY_ONE * 0.5) / torch.sqrt(
        torch.where(has_quad, r2, torch.ones((), dtype=fdtype, device=r2.device))
    )
    dpx = torch.round(dyf * rr).to(torch.int32)  # round half to even
    dpy = torch.round(dxf * rr).to(torch.int32)
    X = [
        (p0x << XY_SHIFT) + dpx,
        (p0x << XY_SHIFT) - dpx,
        (p1x << XY_SHIFT) - dpx,
        (p1x << XY_SHIFT) + dpx,
    ]
    Y = [
        (p0y << XY_SHIFT) + dpy,
        (p0y << XY_SHIFT) - dpy,
        (p1y << XY_SHIFT) - dpy,
        (p1y << XY_SHIFT) + dpy,
    ]

    # 3. fill chains. imin = first strict min of the true fixed-point ys.
    imin = _first_min_index(Y)
    rows = [(yy + HALF) >> XY_SHIFT for yy in Y]

    def chain(di):
        i0 = imin
        i1 = (imin + di) % 4
        i2 = (imin + 2) % 4
        q0 = _pick4(rows, i0)
        q1 = _pick4(rows, i1)
        q2 = _pick4(rows, i2)
        xs1 = _pick4(X, i0)
        xm = _pick4(X, i1)
        xs2 = xm
        d1 = torch.clamp_min(q1 - q0, 1)
        d2 = torch.clamp_min(q2 - q1, 1)
        dx1 = torch.where(
            q1 > q0, _tdiv_i32((xm - xs1) * 2 + (q1 - q0), 2 * d1), 0
        )
        xe2 = _pick4(X, i2)
        dx2 = torch.where(
            q2 > q1, _tdiv_i32((xe2 - xs2) * 2 + (q2 - q1), 2 * d2), 0
        )
        return q1, xs1, dx1, xs2, dx2

    brk_a, xs1_a, dx1_a, xs2_a, dx2_a = chain(1)
    brk_b, xs1_b, dx1_b, xs2_b, dx2_b = chain(3)
    ymin_row = _pick4(rows, imin)
    ymax_row = _pick4(rows, (imin + 2) % 4)
    stop_row = torch.clamp_max(ymax_row - 1, h - 1)
    # FillConvexPoly's pre-fill reject (all-rounded extents off-frame)
    xr = [(xx + HALF) >> XY_SHIFT for xx in X]
    xmin_r = torch.minimum(torch.minimum(xr[0], xr[1]),
                           torch.minimum(xr[2], xr[3]))
    xmax_r = torch.maximum(torch.maximum(xr[0], xr[1]),
                           torch.maximum(xr[2], xr[3]))
    fill_ok = (
        accept & has_quad
        & (ymax_row >= 0) & (ymin_row < h) & (xmax_r >= 0) & (xmin_r < w)
    )

    # 4. outline params per ring edge (3->0, 0->1, 1->2, 2->3), the four
    # edges stacked on a leading axis: one elementwise pass instead of
    # four (the same operations on each element)
    live = accept & has_quad
    ring = ((3, 0), (0, 1), (1, 2), (2, 3))
    stacked = _edge_outline_params(
        *(torch.stack([V[e[k]] for e in ring]) for k, V in
          ((0, X), (0, Y), (1, X), (1, Y))),
        live, h, w, fdtype,
    )
    edges = [{k: v[i] for k, v in stacked.items()} for i in range(4)]

    return dict(
        accept=accept,
        fill_ok=fill_ok,
        ymin_row=ymin_row,
        stop_row=stop_row,
        brk_a=brk_a, xs1_a=xs1_a, dx1_a=dx1_a, xs2_a=xs2_a, dx2_a=dx2_a,
        brk_b=brk_b, xs1_b=xs1_b, dx1_b=dx1_b, xs2_b=xs2_b, dx2_b=dx2_b,
        edges=edges,
        cap0x=p0x, cap0y=p0y, cap1x=p1x, cap1y=p1y,
    )


def cap_half_widths(thickness: int, m: torch.Tensor) -> torch.Tensor:
    """The cap circle's half-width at |row offset| m (-1 beyond the
    circle), from the static table of `cap_table(cap_radius(t))`."""
    hw = torch.full_like(m, -1)
    for off, half_w in enumerate(cap_table(cap_radius(thickness))):
        hw = torch.where(m == off, half_w, hw)
    return hw


def thick_hit(px, py, params, thickness: int):
    """Per-(pixel, segment) exact-stroke predicate (tinycarlo_tpu's
    `thick_hit`).

    px, py: integer-valued tensors broadcastable against the param
    tensors (the dense path passes (H, W, 1) pixels against (E,) params).
    Returns bool."""
    p = params
    pxi = px.to(torch.int32)
    pyi = py.to(torch.int32)

    # fill span
    ya = pyi - p["ymin_row"]
    x_a = torch.where(
        pyi < p["brk_a"],
        p["xs1_a"] + p["dx1_a"] * ya,
        p["xs2_a"] + p["dx2_a"] * (pyi - p["brk_a"]),
    )
    x_b = torch.where(
        pyi < p["brk_b"],
        p["xs1_b"] + p["dx1_b"] * ya,
        p["xs2_b"] + p["dx2_b"] * (pyi - p["brk_b"]),
    )
    lo = (torch.minimum(x_a, x_b) + HALF) >> XY_SHIFT
    hi = (torch.maximum(x_a, x_b) + HALF) >> XY_SHIFT
    hit = (
        p["fill_ok"]
        & (pyi >= p["ymin_row"]) & (pyi <= p["stop_row"])
        & (pxi >= lo) & (pxi <= hi)
    )

    # outline edges + dots
    for e in p["edges"]:
        k = torch.where(e["xmaj"], pxi, pyi) - e["m0"]
        mino = torch.where(e["xmaj"], pyi, pxi)
        val = (e["v0"] + k * e["st"]) >> XY_SHIFT
        hit = hit | (e["acc"] & (k >= 0) & (k < e["n"]) & (mino == val))
        hit = hit | (e["acc"] & (pxi == e["d0x"]) & (pyi == e["d0y"]))
        hit = hit | (e["acc"] & (pxi == e["d1x"]) & (pyi == e["d1y"]))

    # caps
    for cx, cy in ((p["cap0x"], p["cap0y"]), (p["cap1x"], p["cap1y"])):
        hw = cap_half_widths(thickness, torch.abs(pyi - cy))
        hit = hit | (p["accept"] & (torch.abs(pxi - cx) <= hw))
    return hit


def stroke_y_extent(thickness: int) -> float:
    """Band-culling superset radius for the exact stroke: quad halfwidth
    <= (t + 1) / 2 + rounding (1 px) and cap radius (t + 1) // 2; the
    integer pre-clip only moves endpoints along the segment by < 1 px.
    """
    return thickness / 2.0 + 2.0
