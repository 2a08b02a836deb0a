"""Segment compaction and the masks, rank and exact kernels: the port's
render path.

Counterpart of the production paths of tinycarlo_tpu/ops/rasterize_pallas.py.
Projection output (per-env packed edge coordinates) is compacted by torch
ops into the same bundles as the JAX package: per copy (one per segment
and touched 128-lane block) a payload and a packed band word, plus a
(B, k) slot->copy index from `torch.topk` over a short-first key.

- `compact_env_idx_soa(pre=False)`: the fast stroke's payload (integer
  endpoint, direction, the stamp's reciprocal). Two kernels stamp it:
  the masks kernel (ops/csrc/masks.cu) into (B, L, H, W) class masks,
  replacing the Pallas kernels `_kernel_env_idx` and `_kernel_env_dma`;
  the rank kernel (ops/csrc/rank.cu) into a (B, H, W) layer-rank map, the
  rgb / rgb_planar / rank formats' render, replacing `_kernel_env_rank`.
- `compact_env_exact_soa`: the cv2 ThickLine stroke's 30 int32 fields
  (`stroke="exact"` at t >= 2). The exact kernel (ops/csrc/exact.cu)
  stamps it into (B, L, H, W) class masks, replacing `_kernel_env_exact`.

Three older layouts that production replaced, which the rasterizer
benchmarks (tinycarlo_torch.benchmarks.rasterize_bench) still time, each
at a band granularity `gran` of 8 or 16 rows:
- `compact_soa`: slots routed per (env, layer) frame, stamped by the
  frame kernel (ops/csrc/frame_soa.cu) in place of `_kernel`;
- `compact_env_soa`: slots routed per env, layer and lane block folded
  into the rows, stamped by the env kernel (ops/csrc/env_soa.cu) in place
  of `_kernel_env`;
- `compact_env_seg`: one slot per segment, its touched lane blocks packed
  into the band word, stamped by the segment kernel (ops/csrc/env_seg.cu)
  in place of `_kernel_env_seg`.

Each wrapper's `__call__` dispatches on the bundle's device: CUDA tensors
launch the kernel (or raise), CPU tensors take the plain PyTorch version
(`rasterize_masks_env_plain`, `rasterize_rank_env_plain`,
`rasterize_masks_exact_env_plain`, `rasterize_compact_soa_plain`,
`rasterize_compact_env_soa_plain`, `rasterize_env_seg_plain`), which
computes the same function and is the kernel's reference on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tinycarlo_torch.ops._build import libraries
from tinycarlo_torch.ops.cv2_stroke import (
    cap_half_widths,
    cap_radius,
    cap_table,
    stroke_y_extent,
    thick_params,
)
from tinycarlo_torch.ops.rasterize import (
    _clip_line_cv2,
    _exact,
    _int_endpoints,
    _split_radii,
    _stroke_radius_sq,
)

# Packed band word: bw = (frame * n_bands + b0) * _NB_PACK + nb.
_NB_PACK = 512
_NB_SHIFT = 9  # log2(_NB_PACK)
# X-block width of the lane split: frames wider than this are cut into
# ceil(w / 128) blocks, each its own stamped strip.
_XB = 128
# Band granularity of the production path: a slot's window spans two
# 16-row bands (kGran in ops/csrc/stamp.cuh).
_GRAN = 16


def _n_xblocks(w: int) -> int:
    """Lane blocks for a frame width: split only when w exceeds one block."""
    return -(-w // _XB) if w > _XB else 1


def _window_rows(h: int, gran: int = _GRAN) -> Tuple[int, int, int]:
    """(n_bands, padded height, window rows) of a frame cut into `gran`-row
    bands: the window spans two bands (clamped to the padded frame)."""
    n_bands = -(-h // gran)
    hp = n_bands * gran
    return n_bands, hp, min(2 * gran, hp)


def _bands(ylo, yhi, draw, h: int, gran: int = _GRAN):
    """(nb, b0c) of segments whose stroke spans the rows [ylo, yhi]: nb,
    the count of `gran`-row bands from the first through the last it
    touches (0 unless drawn and meeting the frame's rows), and b0c, the
    first band clamped so that a window starting there stays in the padded
    frame. The clamp moves b0 only when nb fits the window, so a window at
    b0c still covers every band through the last."""
    n_bands, hp, win = _window_rows(h, gran)
    b0 = torch.clamp(torch.floor(ylo / gran), 0.0, n_bands - 1.0).to(torch.int32)
    b1 = torch.clamp(torch.floor(yhi / gran), 0.0, n_bands - 1.0).to(torch.int32)
    valid = (yhi >= 0.0) & (ylo <= h - 1.0) & draw
    nb = torch.where(valid, b1 + 1 - b0, 0)
    return nb, torch.clamp_max(b0, (hp - win) // gran)


def _stroke_params(thickness: int):
    """Stamp descriptor: ("bres",) at thickness 1 (exact cv2 Bresenham on
    clipped anchors) or ("split", lat2, cap2) at t >= 2 (calibrated
    rectangle-body + end-cap stroke)."""
    if thickness <= 1:
        return ("bres",)
    lat, cap = _split_radii(thickness)
    return ("split", float(lat * lat), float(cap * cap))


def _clip_normalize_t1(w, h, ax0, ay0, bx0, by0, draw):
    """Thickness-1 endpoint preparation: cv2-exact clipLine (rejected lines
    stop drawing) + anchor normalization to the smaller-x endpoint, so the
    Bresenham stamp needs no swap."""
    ax0, ay0, bx0, by0, acc = _clip_line_cv2(w, h, ax0, ay0, bx0, by0)
    draw = draw & acc
    swap = bx0 < ax0
    nax = torch.where(swap, bx0, ax0)
    nbx = torch.where(swap, ax0, bx0)
    nay = torch.where(swap, by0, ay0)
    nby = torch.where(swap, ay0, by0)
    return nax, nay, nbx, nby, draw


def _inv_for(abx, aby, thickness):
    """Per-copy `inv` scalar: 1/len^2 for the distance stroke, 1/(2*maj)
    for the t=1 Bresenham stamp."""
    if thickness <= 1:
        maj = torch.maximum(torch.abs(abx), torch.abs(aby))
        return 1.0 / torch.where(maj == 0.0, 1.0, 2.0 * maj)
    denom = abx * abx + aby * aby
    return 1.0 / torch.where(denom == 0.0, 1.0, denom)


def compact_env_idx_soa(
    u0: torch.Tensor,  # (B, E) float pixel coords on the packed edge axis
    v0: torch.Tensor,
    u1: torch.Tensor,
    v1: torch.Tensor,
    draw: torch.Tensor,  # (B, E) bool
    k: int,
    h: int,
    thickness: int,
    edge_layer: torch.Tensor,  # (E,) int32 layer id per packed edge
    n_layers: int,
    w: int,
    layer_bounds: Optional[Tuple[int, ...]] = None,
):
    """Compaction bundle of tinycarlo_tpu's `compact_env_idx_soa` with
    `pre=False, one_tier=False` (rasterize_pallas.py:886-1108) at gran 16,
    on the packed edge axis, equal to it element for element.

    Per copy on the dense (B, LE) copy axis (LE = E*nxb): the int32-
    truncated endpoint (ax, ay) shifted into its stacked frame strip, the
    direction (abx, aby), the stamp reciprocal `inv` and the band word
    bw = (frame*n_bands + b0c) * 512 + nb; then the slot routing of
    `_route_slots`.

    Returns (idx, ax, ay, abx, aby, inv, bw, counts), idx and counts as
    `_route_slots` gives them.
    """
    lim = 1_000_000.0

    def icast(x):
        return torch.clamp(x, -lim, lim).to(torch.int32).to(torch.float32)

    ax0, ay0, bx0, by0 = icast(u0), icast(v0), icast(u1), icast(v1)
    if thickness <= 1:
        ax0, ay0, bx0, by0, draw = _clip_normalize_t1(
            w, h, ax0, ay0, bx0, by0, draw
        )
    bsz, e = ax0.shape
    dev = ax0.device

    rf = float(_stroke_radius_sq(thickness)) ** 0.5
    n_bands, hp, win = _window_rows(h)
    nxb = _n_xblocks(w)
    assert n_bands < _NB_PACK, "frame too tall for the packed band word"
    assert n_layers * nxb * n_bands < (1 << 24) // _NB_PACK, (
        "stacked frames too tall for band word"
    )
    nb, b0c = _bands(torch.minimum(ay0, by0) - rf,
                     torch.maximum(ay0, by0) + rf, draw, h)
    lay = edge_layer.to(torch.int32)[None, :].expand(bsz, e)

    if nxb > 1:
        xlo = torch.minimum(ax0, bx0) - rf
        xhi = torch.maximum(ax0, bx0) + rf
        bidx = torch.arange(nxb, dtype=torch.int32, device=dev)
        xoff = (bidx * _XB).to(torch.float32)
        touch = (xlo[..., None] <= xoff + (_XB - 1)) & (xhi[..., None] >= xoff)

        def expand(x):
            return x[..., None].expand(*x.shape, nxb)

        ax0 = ax0[..., None] - xoff
        bx0 = bx0[..., None] - xoff
        ay0, by0, b0c = expand(ay0), expand(by0), expand(b0c)
        nb = torch.where(touch, nb[..., None], 0)
        frame = expand(lay) * nxb + bidx
    else:
        frame = lay

    roff = (frame * hp).to(torch.float32)
    ay0 = ay0 + roff
    by0 = by0 + roff
    bw = (frame * n_bands + b0c) * _NB_PACK + nb

    le = e * nxb

    def flat(x):
        return x.reshape(bsz, le)

    ax0, ay0, bx0, by0, bw, nb = map(flat, (ax0, ay0, bx0, by0, bw, nb))
    bw = bw.to(torch.int32)

    abx, aby = bx0 - ax0, by0 - ay0
    inv = _inv_for(abx, aby, thickness)
    idx, counts = _route_slots(nb, k, win, lay, nxb, n_layers, layer_bounds)
    return idx, ax0, ay0, abx, aby, inv, bw, counts


def _slot_order(nb, k, win, gran):
    """The slot order of every compaction (rasterize_pallas.py:300-335,
    :636-672, :1058-1070, :1217-1240) from the (..., E) band counts `nb`:
    a sorted `torch.topk` (k < E) or a stable argsort (k >= E, all E) over
    a key that puts eligible short copies (0 < nb <= win/gran) first, then
    the talls, then the rest, each in index order. The keys are distinct
    integers, so the selection and order are `lax.top_k`'s.

    Returns (order, n_all, n_short, n_drop): the copies of the slots, and
    per row the live slots, the short ones among them and the eligible
    copies that found no slot, int32."""
    le = nb.shape[-1]
    draw2 = nb > 0
    tall = nb > win // gran
    iota = torch.arange(le, dtype=torch.int32, device=nb.device)
    key = torch.where(
        draw2, torch.where(tall, le - iota, 2 * le - iota), -iota
    )
    n_elig = draw2.sum(dim=-1, dtype=torch.int32)
    n_all = torch.clamp_max(n_elig, k)
    n_short = torch.clamp_max((draw2 & ~tall).sum(dim=-1, dtype=torch.int32), k)
    if k < le:
        order = torch.topk(key, k, dim=-1, sorted=True).indices
    else:
        order = torch.argsort(-key, dim=-1, stable=True)
    return order, n_all, n_short, n_elig - n_all


def _route_slots(nb, k, win, lay, nxb, n_layers, layer_bounds,
                 gran: int = _GRAN):
    """The slot routing of the index-indirect compactions
    (rasterize_pallas.py:1058-1108, :1217-1272, :2744-2793) from the
    (B, LE) band counts `nb` of the copies: `_slot_order`'s (B, k)
    slot->copy index, padded with 7 copies of its last column.

    Returns (idx, counts): counts is (4 + n_layers, B) int32, rows [live,
    one-band (0: the one-band tier is off), short, dropped, per-layer
    eligible copies...]. The per-layer counts sum static slices when
    `layer_bounds` (the edges' cumulative per-layer offsets) is given,
    else a one-hot of the (B, E) copy layers `lay`."""
    bsz, le = nb.shape
    dev = nb.device
    draw2 = nb > 0
    idx, n_all, n_short, n_drop = _slot_order(nb, k, win, gran)
    n_one = torch.zeros_like(n_all)
    idx = idx.to(torch.int32)
    # 7 pad slots (duplicates of the last), as the TPU bundle carries for
    # its unrolled loops' over-run
    idx = torch.cat([idx] + [idx[:, -1:]] * 7, dim=-1)
    if layer_bounds is not None:
        # layer-contiguous copy axis: per-layer counts over static slices
        assert len(layer_bounds) == n_layers + 1, "one bound per layer edge"
        per_layer = torch.stack(
            [
                draw2[:, layer_bounds[l] * nxb: layer_bounds[l + 1] * nxb].sum(
                    dim=-1, dtype=torch.int32
                )
                for l in range(n_layers)
            ],
            dim=-1,
        )
    else:
        lay_flat = lay[..., None].expand(*lay.shape, nxb).reshape(bsz, le)
        onehot_l = lay_flat[:, None, :] == torch.arange(
            n_layers, dtype=torch.int32, device=dev
        )[None, :, None]
        per_layer = (draw2[:, None, :] & onehot_l).sum(
            dim=-1, dtype=torch.int32
        )
    counts = torch.cat(
        [torch.stack([n_all, n_one, n_short, n_drop]), per_layer.T], dim=0
    ).contiguous()
    return idx, counts


# Bias that keeps the possibly negative row / lane fields of `_pack16`
# non-negative (rasterize_pallas._XBIAS).
_XBIAS = 4096
# Fields of an exact bundle copy, in `compact_env_exact_soa`'s order.
EXACT_FIELDS = 30


def _pack16(lo, hi):
    """(lo + bias, hi + bias) -> one non-negative int32 (both fields
    16-bit)."""
    return (lo + _XBIAS) | ((hi + _XBIAS) << 16)


def _unpack16(p):
    return (p & 0xFFFF) - _XBIAS, (p >> 16) - _XBIAS


def compact_env_exact_soa(
    u0: torch.Tensor,  # (B, E) float pixel coords on the packed edge axis
    v0: torch.Tensor,
    u1: torch.Tensor,
    v1: torch.Tensor,
    draw: torch.Tensor,  # (B, E) bool
    k: int,
    h: int,
    thickness: int,
    edge_layer: torch.Tensor,  # (E,) int32 layer id per packed edge
    n_layers: int,
    w: int,
    layer_bounds: Optional[Tuple[int, ...]] = None,
):
    """Compaction bundle of tinycarlo_tpu's `compact_env_exact_soa`
    (rasterize_pallas.py:2569-2793) at gran 16 on the packed edge axis,
    equal to it element for element: the eligibility, banding, lane split
    and slot routing of `compact_env_idx_soa`, with the cv2 ThickLine
    scalar bundle (`cv2_stroke.thick_params`, computed in the input's float
    dtype) as each copy's payload, shifted into block-local lanes and
    stacked strip rows.

    Returns (idx, fields, counts): idx and counts as `_route_slots` gives
    them (row 1, the one-band tier, always 0), `fields` a 30-tuple of
    (B, LE) int32 in the JAX package's order:
      0  rowsP = pack16(ymin_row', stop_row')
      1  brkP  = pack16(brk_a', brk_b')
      2-9   xs1a, dx1a, xs2a, dx2a, xs1b, dx1b, xs2b, dx2b (fixed point)
      10-13 per edge pack16(m0', n)
      14-17 per edge v0 (fixed point, strip / block shifted)
      18-21 per edge st
      22, 23 pack16(cx', cy') of the two caps
      24-27 per edge pack16(fdx', fdy'): the normalized-far endpoint dot
      28 flags = fill_ok | acc_e << 1.. | xmaj_e << 5..
      29 bw, the band word of `compact_env_idx_soa`
    (primes: shifted by the copy's lane block or stacked row offset).
    """
    lim = 1_000_000.0

    def icast(x):
        return torch.clamp(x, -lim, lim).to(torch.int32).to(u0.dtype)

    ax0, ay0, bx0, by0 = icast(u0), icast(v0), icast(u1), icast(v1)
    bsz, e = ax0.shape
    dev = ax0.device

    P = thick_params(ax0, ay0, bx0, by0, thickness, (h, w))
    p0x, p0y = P["cap0x"], P["cap0y"]  # clipped integer endpoints
    p1x, p1y = P["cap1x"], P["cap1y"]

    rf = float(stroke_y_extent(thickness))
    n_bands, hp, win = _window_rows(h)
    nxb = _n_xblocks(w)
    assert n_bands < _NB_PACK, "frame too tall for the packed band word"
    assert n_layers * nxb * n_bands < (1 << 24) // _NB_PACK, (
        "stacked frames too tall for band word"
    )
    # _pack16's row fields carry value + row offset + _XBIAS and an x-major
    # v0 carries (row offset + y) << 16 in int32: both must not wrap
    assert n_layers * nxb * hp + h + _XBIAS < (1 << 15), (
        "stacked strip rows overflow the packed fields / v0 shift "
        f"(n_layers={n_layers}, nxb={nxb}, hp={hp}, h={h})"
    )
    assert w + _XBIAS < (1 << 16), (
        f"frame width {w} overflows the packed 16-bit fields"
    )
    nb, b0c = _bands(torch.minimum(p0y, p1y).to(torch.float32) - rf,
                     torch.maximum(p0y, p1y).to(torch.float32) + rf,
                     draw & P["accept"], h)
    lay = edge_layer.to(torch.int32)[None, :].expand(bsz, e)

    if nxb > 1:
        xloi = torch.minimum(p0x, p1x).to(torch.float32) - rf
        xhii = torch.maximum(p0x, p1x).to(torch.float32) + rf
        bidx = torch.arange(nxb, dtype=torch.int32, device=dev)
        xs = bidx * _XB  # the copy's lane shift
        xsf = xs.to(torch.float32)
        touch = (xloi[..., None] <= xsf + (_XB - 1)) & (xhii[..., None] >= xsf)

        def ex(x):
            return x[..., None].expand(*x.shape, nxb)

        nb = torch.where(touch, nb[..., None], 0)
        b0c = ex(b0c)
        frame = ex(lay) * nxb + bidx
    else:
        def ex(x):
            return x

        xs = torch.zeros((), dtype=torch.int32, device=dev)
        frame = lay

    roff = frame * hp  # stacked strip row offset
    bw = (frame * n_bands + b0c) * _NB_PACK + nb
    xshift16 = xs << 16
    chains = [
        ex(P["xs1_a"]) - xshift16, ex(P["dx1_a"]),
        ex(P["xs2_a"]) - xshift16, ex(P["dx2_a"]),
        ex(P["xs1_b"]) - xshift16, ex(P["dx1_b"]),
        ex(P["xs2_b"]) - xshift16, ex(P["dx2_b"]),
    ]
    m0n, v0s, sts, fds = [], [], [], []
    for ed in P["edges"]:
        xm = ex(ed["xmaj"])
        m0p = torch.where(xm, ex(ed["m0"]) - xs, ex(ed["m0"]) + roff)
        v0p = torch.where(xm, ex(ed["v0"]) + (roff << 16),
                          ex(ed["v0"]) - xshift16)
        # n >= 1: the k=0 DDA pixel is the rounded normalized-near dot,
        # so one pixel realizes it even for major-degenerate clipped edges
        nn = torch.clamp(ed["n"], 1, 32767 - _XBIAS)
        m0n.append(_pack16(m0p, ex(nn)))
        v0s.append(v0p)
        sts.append(ex(ed["st"]))
        fds.append(_pack16(ex(ed["fdx"]) - xs, ex(ed["fdy"]) + roff))
    flags = P["fill_ok"].to(torch.int32)
    for i, ed in enumerate(P["edges"]):
        flags = flags | (ed["acc"].to(torch.int32) << (1 + i))
    for i, ed in enumerate(P["edges"]):
        flags = flags | (ed["xmaj"].to(torch.int32) << (5 + i))
    fields = [
        _pack16(ex(P["ymin_row"]) + roff, ex(P["stop_row"]) + roff),
        _pack16(ex(P["brk_a"]) + roff, ex(P["brk_b"]) + roff),
        *chains, *m0n, *v0s, *sts,
        _pack16(ex(p0x) - xs, ex(p0y) + roff),
        _pack16(ex(p1x) - xs, ex(p1y) + roff),
        *fds, ex(flags), bw,
    ]
    le = e * nxb
    assert len(fields) == EXACT_FIELDS
    # one (30, B, LE) block: each field a contiguous (B, LE) view of it
    fields = tuple(torch.stack(
        [x.to(torch.int32).expand(nb.shape) for x in fields]
    ).reshape(EXACT_FIELDS, bsz, le).unbind(0))
    idx, counts = _route_slots(nb.reshape(bsz, le), k, win, lay, nxb,
                               n_layers, layer_bounds)
    return idx, fields, counts


def _route_soa(nb, k, win, gran, ax0, ay0, bx0, by0, bw, thickness):
    """Direct slot routing of `compact_soa` and `compact_env_soa`: the
    endpoints and band words of `_slot_order`'s slots (the JAX package
    routes them by a one-hot matmul, which turns -0.0 into +0.0: compare
    with `==`), then each slot's direction and stamp reciprocal, the slot
    axis padded to even with dead slots (nb = 0).

    Returns (ax, ay, abx, aby, inv, bw, n_all, n_short, n_drop)."""
    order, n_all, n_short, n_drop = _slot_order(nb, k, win, gran)
    ax, ay, bx, by, bw = (torch.gather(x, -1, order)
                          for x in (ax0, ay0, bx0, by0, bw))
    abx, aby = bx - ax, by - ay
    inv = _inv_for(abx, aby, thickness)
    slots = [ax, ay, abx, aby, inv, bw.to(torch.int32)]
    if ax.shape[-1] % 2:
        # the TPU loops stamp short slots in pairs, so they may run one
        # slot past an odd count; the pad slot draws nothing
        slots = [torch.nn.functional.pad(x, (0, 1)) for x in slots]
    return (*slots, n_all, n_short, n_drop)


def compact_soa(
    p0: torch.Tensor,  # (B, L, E, 2) float pixel coords
    p1: torch.Tensor,
    draw: torch.Tensor,  # (B, L, E) bool
    k: int,
    gran: int,
    h: int,
    thickness: int,
    w: Optional[int] = None,
):
    """The per-frame bundle of tinycarlo_tpu's `compact_soa`
    (rasterize_pallas.py:231-354), equal to it element for element: the
    drawn segments of each (env, layer) frame routed into k slots (all E
    when k >= E), short ones first. `w` is required at thickness 1 (the
    cv2 clip).

    Returns (ax, ay, abx, aby, inv, bw, counts): per slot (B, L, k')
    float32 integer endpoint, direction and stamp reciprocal and an int32
    band word bw = b0c*512 + nb (k' = min(k, E) rounded up to even), and
    counts (3, B*L) int32, rows [live, short, dropped]."""
    a, b = _int_endpoints(p0, p1, torch.float32)
    ax0, ay0, bx0, by0 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    if thickness <= 1:
        assert w is not None, "thickness-1 compaction needs the frame width"
        ax0, ay0, bx0, by0, draw = _clip_normalize_t1(
            w, h, ax0, ay0, bx0, by0, draw
        )
    rf = float(_stroke_radius_sq(thickness)) ** 0.5
    n_bands, hp, win = _window_rows(h, gran)
    assert n_bands < _NB_PACK, "frame too tall for the packed band word"
    nb, b0c = _bands(torch.minimum(ay0, by0) - rf,
                     torch.maximum(ay0, by0) + rf, draw, h, gran)
    *slots, n_all, n_short, n_drop = _route_soa(
        nb, k, win, gran, ax0, ay0, bx0, by0, b0c * _NB_PACK + nb, thickness
    )
    counts = torch.stack([n_all.reshape(-1), n_short.reshape(-1),
                          n_drop.reshape(-1)])
    return (*slots, counts)


def compact_env_soa(
    p0: torch.Tensor,  # (B, L, E, 2) float pixel coords
    p1: torch.Tensor,
    draw: torch.Tensor,  # (B, L, E) bool
    k: int,
    gran: int,
    h: int,
    thickness: int,
    edge_layer: Optional[torch.Tensor] = None,  # (E,) int32
    n_layers: Optional[int] = None,
    w: Optional[int] = None,
):
    """The env-merged bundle of tinycarlo_tpu's `compact_env_soa`
    (rasterize_pallas.py:518-686), equal to it element for element: the
    drawn segments of all layers of an env routed into k slots.

    With `edge_layer`/`n_layers` the input is a packed edge axis
    (B, 1, E, 2) whose edges' layers `edge_layer` gives; otherwise a
    segment's layer is its axis-1 position. Without `w` each layer is one
    frame strip of the frame's width; with `w` wider than 128, frames are
    cut into 128-lane blocks, and a segment gets one slot copy per block
    its stroke touches, its x shifted into block-local lanes. The stacked
    frame (l, or l*nxb + xb) is folded into ay (+ frame*hp) and the band
    word, bw = (frame*n_bands + b0c)*512 + nb.

    Returns (ax, ay, abx, aby, inv, bw, counts): per slot (B, k') arrays
    as `compact_soa`'s, counts (3, B) int32, rows [live, short, dropped]."""
    a, b = _int_endpoints(p0, p1, torch.float32)
    bsz, nl, e, _ = a.shape
    ax0, ay0, bx0, by0 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    if thickness <= 1:
        assert w is not None, "thickness-1 compaction needs the frame width"
        ax0, ay0, bx0, by0, draw = _clip_normalize_t1(
            w, h, ax0, ay0, bx0, by0, draw
        )
    dev = ax0.device
    rf = float(_stroke_radius_sq(thickness)) ** 0.5
    n_bands, hp, win = _window_rows(h, gran)
    n_frames = nl if edge_layer is None else n_layers
    nxb = _n_xblocks(w) if w is not None else 1
    assert n_bands < _NB_PACK, "frame too tall for the packed band word"
    assert n_frames * nxb * n_bands < (1 << 24) // _NB_PACK, (
        "stacked frames too tall for band word"
    )
    nb, b0c = _bands(torch.minimum(ay0, by0) - rf,
                     torch.maximum(ay0, by0) + rf, draw, h, gran)
    if edge_layer is None:
        lay = torch.arange(nl, dtype=torch.int32, device=dev)[None, :, None]
    else:
        lay = edge_layer.to(torch.int32)[None, None, :]
    lay = lay.expand(bsz, nl, e)

    if nxb > 1:
        xlo = torch.minimum(ax0, bx0) - rf
        xhi = torch.maximum(ax0, bx0) + rf
        bidx = torch.arange(nxb, dtype=torch.int32, device=dev)
        xoff = (bidx * _XB).to(torch.float32)
        touch = (xlo[..., None] <= xoff + (_XB - 1)) & (xhi[..., None] >= xoff)

        def expand(x):
            return x[..., None].expand(*x.shape, nxb)

        ax0 = ax0[..., None] - xoff
        bx0 = bx0[..., None] - xoff
        ay0, by0, b0c = expand(ay0), expand(by0), expand(b0c)
        nb = torch.where(touch, nb[..., None], 0)
        frame = expand(lay) * nxb + bidx
    else:
        frame = lay

    roff = (frame * hp).to(torch.float32)
    bw = (frame * n_bands + b0c) * _NB_PACK + nb
    le = nl * e * nxb
    *slots, n_all, n_short, n_drop = _route_soa(
        nb.reshape(bsz, le), k, win, gran,
        *(x.reshape(bsz, le) for x in (ax0, ay0 + roff, bx0, by0 + roff, bw)),
        thickness,
    )
    return (*slots, torch.stack([n_all, n_short, n_drop]))


def compact_env_seg(
    u0: torch.Tensor,  # (B, L, E) float pixel coords, SoA
    v0: torch.Tensor,
    u1: torch.Tensor,
    v1: torch.Tensor,
    draw: torch.Tensor,  # (B, L, E) bool
    k: int,
    gran: int,
    h: int,
    thickness: int,
    edge_layer: Optional[torch.Tensor] = None,  # (E,) int32
    n_layers: Optional[int] = None,
    w: Optional[int] = None,
):
    """The segment-axis bundle of tinycarlo_tpu's `compact_env_seg`
    (rasterize_pallas.py:1111-1272), equal to it element for element: one
    slot per segment (not per lane-block copy), the 128-lane blocks its
    stroke touches as nxb low bits of the band word,

        bw = ((lay*nxb*n_bands + b0c) * 512 + nb) << nxb | touch_bits,

    and ay pre-shifted by its layer's strip base lay*nxb*hp. Segments that
    touch no block (x-clipped) are culled like y-clipped ones (nb = 0).
    Layers come from `edge_layer` (packed axis, (B, 1, E)) or the axis-1
    position, as in `compact_env_soa`; the per-layer counts from a one-hot
    of `edge_layer` or static slices of the layer axis.

    Returns (idx, ax, ay, abx, aby, inv, bw, counts): the per-segment SoA
    on the (B, L*E) axis, and idx and counts as `_route_slots` gives them
    (row 1, the one-band tier, always 0)."""
    lim = 1_000_000.0

    def icast(x):
        return torch.clamp(x, -lim, lim).to(torch.int32).to(torch.float32)

    ax0, ay0, bx0, by0 = icast(u0), icast(v0), icast(u1), icast(v1)
    if thickness <= 1:
        assert w is not None, "thickness-1 compaction needs the frame width"
        ax0, ay0, bx0, by0, draw = _clip_normalize_t1(
            w, h, ax0, ay0, bx0, by0, draw
        )
    bsz, nl, e = ax0.shape
    dev = ax0.device
    rf = float(_stroke_radius_sq(thickness)) ** 0.5
    n_bands, hp, win = _window_rows(h, gran)
    n_frames = nl if edge_layer is None else n_layers
    nxb = _n_xblocks(w) if w is not None else 1
    assert n_bands < _NB_PACK, "frame too tall for the packed band word"
    assert (n_frames * nxb * n_bands * _NB_PACK) << nxb < 2**31, (
        "band word with block bits exceeds int32"
    )
    nb, b0c = _bands(torch.minimum(ay0, by0) - rf,
                     torch.maximum(ay0, by0) + rf, draw, h, gran)
    if edge_layer is None:
        lay = torch.arange(nl, dtype=torch.int32, device=dev)[None, :, None]
        bounds = tuple(range(0, (nl + 1) * e, e))
    else:
        lay = edge_layer.to(torch.int32)[None, None, :]
        bounds = None
    lay = lay.expand(bsz, nl, e)

    xlo = torch.minimum(ax0, bx0) - rf
    xhi = torch.maximum(ax0, bx0) + rf
    if nxb > 1:
        bits = sum(
            ((xlo <= j * _XB + (_XB - 1)) & (xhi >= j * _XB)).to(torch.int32)
            << j
            for j in range(nxb)
        )
    else:
        bits = ((xhi >= 0.0) & (xlo <= (w if w else _XB) - 1.0)).to(
            torch.int32)
    nb = torch.where(bits > 0, nb, 0)  # touches no block: culled

    abx, aby = bx0 - ax0, by0 - ay0
    inv = _inv_for(abx, aby, thickness)
    ay0 = ay0 + (lay * (nxb * hp)).to(torch.float32)
    bw = (((lay * (nxb * n_bands) + b0c) * _NB_PACK + nb) << nxb) | bits
    le = nl * e
    ax0, ay0, abx, aby, inv, bw, nb, lay = (
        x.reshape(bsz, le) for x in (ax0, ay0, abx, aby, inv, bw, nb, lay)
    )
    idx, counts = _route_slots(nb, k, win, lay, 1, n_frames, bounds, gran)
    return idx, ax0, ay0, abx, aby, inv, bw.to(torch.int32), counts


def segment_overflow(
    p0: torch.Tensor,  # (B, E, 2) pixel coords on the packed edge axis
    p1: torch.Tensor,
    draw: torch.Tensor,  # (B, E)
    resolution: Tuple[int, int],
    thickness: int,
    max_visible: int,
    stroke: str = "fast",
) -> torch.Tensor:
    """Per-env count of eligible slot copies dropped by the compaction
    budget (max_visible * ceil(w/128) copies): zero means no observation
    pixel was lost. Same eligibility as the compaction, without running
    it (tinycarlo_tpu.ops.rasterize_pallas.segment_overflow, :2308-2360).
    """
    h, w = resolution
    nxb = _n_xblocks(w)
    a, b = _int_endpoints(p0, p1, torch.float32)
    ax0, ay0, bx0, by0 = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    if thickness <= 1:
        # the compaction clips at t=1 (cv2 semantics), shrinking extents
        ax0, ay0, bx0, by0, draw = _clip_normalize_t1(
            w, h, ax0, ay0, bx0, by0, draw
        )
    rf = float(_stroke_radius_sq(thickness, stroke)) ** 0.5
    ylo = torch.minimum(ay0, by0) - rf
    yhi = torch.maximum(ay0, by0) + rf
    elig = (yhi >= 0.0) & (ylo <= h - 1.0) & draw
    if nxb > 1:
        xlo = torch.minimum(ax0, bx0) - rf
        xhi = torch.maximum(ax0, bx0) + rf
        xoff = (torch.arange(nxb, device=p0.device) * _XB).to(torch.float32)
        touch = (xlo[..., None] <= xoff + (_XB - 1)) & (xhi[..., None] >= xoff)
        n_copies = (elig[..., None] & touch).sum(dim=(1, 2))
    else:
        n_copies = elig.sum(dim=1)
    return torch.clamp_min(n_copies - max_visible * nxb, 0).to(torch.int32)


def _frame_geometry(resolution, gran: int = _GRAN, split: bool = True):
    """(n_bands, hp, win, nxb, wb) of a frame: bands, padded rows, window
    rows, lane blocks (1 unless `split`) and the stamped strip's width."""
    h, w = resolution
    n_bands, hp, win = _window_rows(h, gran)
    nxb = _n_xblocks(w) if split else 1
    wb = _XB if nxb > 1 else w
    return n_bands, hp, win, nxb, wb


# Plain version: how many (slot, band) stamps of 128 lanes are evaluated
# per chunk.
_PLAIN_CHUNK = 1 << 15


def _slot_bands(word, n, n_bands: int, win: int, gran: int, wb: int):
    """The (slot, band) pairs that the kernels stamp, chunk by chunk.

    `word` (N, k) holds band words rowband << 9 | nb, rowband = frame *
    n_bands + b0. Every live slot (s < n[env], nb > 0) stamps its window's
    bands and, for a tall slot, its tail bands: the rows [rowband*gran,
    rowband*gran + max(nb, win/gran)*gran) of its stacked strip. Each
    (slot, band) pair is one gran-row x wb-lane evaluation; the pairs come
    in chunks so that the temporaries stay bounded. Yields (env, s, rb, j,
    frame, rr, row), each over the n pairs of a chunk: the env, the slot,
    its row band, the band j of its window, its stacked frame (l*nxb +
    xb), and (n, gran) rows from the window start and in the frame's
    strip."""
    dev = word.device
    nb = word & (_NB_PACK - 1)
    rowband = word >> _NB_SHIFT
    live = (torch.arange(word.shape[1], device=dev)[None, :] < n[:, None]) & (
        nb > 0)
    ext = torch.clamp_min(nb, win // gran)
    band = torch.arange(n_bands, device=dev)
    items = torch.nonzero(live[..., None] & (band < ext[..., None]))  # (n, 3)

    rr_in_band = torch.arange(gran, device=dev)
    chunk = _PLAIN_CHUNK * _XB // max(wb, _XB)
    for c in range(0, items.shape[0], chunk):
        env, s, j = items[c: c + chunk].unbind(-1)
        rb = rowband[env, s]
        frame = rb // n_bands
        b0 = rb - frame * n_bands
        rr = j[:, None] * gran + rr_in_band[None, :]  # (n, gran)
        row = b0[:, None] * gran + rr  # (n, gran) local row in the strip
        yield env, s, rb, j, frame, rr, row


def _live_bands(idx, bw, counts, n_bands: int, win: int):
    """`_slot_bands` of an index-indirect bundle at gran 16, each pair's
    slot replaced by its copy e = idx[env, s]."""
    k = idx.shape[1] - 7
    sidx = idx[:, :k].long()
    word = torch.gather(bw, 1, sidx)
    for env, s, rb, j, frame, rr, row in _slot_bands(
            word, counts[0], n_bands, win, _GRAN, _XB):
        yield env, sidx[env, s], rb, j, frame, rr, row


def _window_hits(bands, payload, wb: int, gran: int, win: int, stroke,
                 absolute: bool, device):
    """The fast stroke's stamps of `bands` (a `_slot_bands`-style
    generator), chunk by chunk: yields (env, frame, row, hit) with env,
    frame (n,) and row (n, gran) the env, stacked frame and strip rows of
    n bands, and hit (n, gran, wb) their lit pixels. `payload(env, c)`
    gives the (ax, ay, abx, aby, inv) of the bands' slots. Same float
    arithmetic as the kernels' `window_hit` (ops/csrc/stamp.cuh), with the
    pixel row taken as the Pallas kernel does:
    - `absolute` (`_kernel`, `_kernel_env`): apy = (y0 + rr) - ay, the
      pixel's stacked strip row minus ay;
    - otherwise (`_tier_loops`, `_tier_loops_seg`): apy = ys - (ay - y0)
      from the window's start row y0, a tail band in its own gran-row
      window.
    All values are integer-valued floats below 2^24, so the two agree."""
    xs = torch.arange(wb, device=device, dtype=torch.float32)
    rr_in_band = torch.arange(gran, device=device)
    for env, c, rb, j, frame, rr, row in bands:
        sax, say, sabx, saby, sinv = payload(env, c)
        if absolute:
            ys = (rb[:, None] * gran + rr).to(torch.float32)
            apy = ys[:, :, None] - say[:, None, None]
        else:
            # the window origin: the 2-band window at rb, or a tail band's
            tail = j >= win // gran
            y0 = torch.where(tail, rb + j, rb) * gran
            ys = torch.where(tail[:, None], rr_in_band[None, :], rr)
            ayw = say - y0.to(torch.float32)
            apy = ys.to(torch.float32)[:, :, None] - ayw[:, None, None]
        apx = xs[None, None, :] - sax[:, None, None]
        hit = _window_hit_plain(
            apx, apy, sabx[:, None, None], saby[:, None, None],
            sinv[:, None, None], stroke,
        )  # (n, gran, wb)
        yield env, frame, row, hit


def _plain_hits(bundle, resolution: Tuple[int, int], thickness: int):
    """The stamps of the masks and rank kernels, as `_window_hits` yields
    them, from a `compact_env_idx_soa` bundle."""
    idx, ax, ay, abx, aby, inv, bw, counts = bundle
    n_bands, hp, win, nxb, wb = _frame_geometry(resolution)

    def payload(env, e):
        return ax[env, e], ay[env, e], abx[env, e], aby[env, e], inv[env, e]

    return _window_hits(_live_bands(idx, bw, counts, n_bands, win), payload,
                        wb, _GRAN, win, _stroke_params(thickness),
                        absolute=False, device=ax.device)


def _exact_plain_hits(bundle, resolution: Tuple[int, int], thickness: int):
    """The stamps of the exact kernel, chunk by chunk, as `_plain_hits`
    yields them: `_exact_hit_plain` at the stacked strip rows rb*16 + rr of
    each of `_live_bands`' bands (the exact stamp's fields are absolute
    strip rows, so a tail band needs no window of its own)."""
    idx, fields, counts = bundle
    n_bands, hp, win, nxb, wb = _frame_geometry(resolution)
    xi = torch.arange(wb, device=idx.device, dtype=torch.int32)[None, None]
    table = torch.stack(fields, dim=-1)  # (B, LE, 30)
    for env, e, rb, j, frame, rr, row in _live_bands(idx, fields[-1], counts,
                                                     n_bands, win):
        yi = (rb[:, None] * _GRAN + rr).to(torch.int32)[:, :, None]
        hit = _exact_hit_plain(xi, yi, table[env, e][:, None, None, :],
                               thickness)  # (n, 16, wb)
        yield env, frame, row, hit


def _exact_hit_plain(xi, yi, f, thickness: int):
    """The exact kernel's stamp (`_tier_loops_exact`'s predicate,
    rasterize_pallas.py:2818-2861) in int32 for live slots: pixel (yi, xi)
    -- stacked strip row, block-local lane -- against the 30 fields `f`
    (..., 30) of `compact_env_exact_soa`. The fill span between the two
    chains' x at row yi, each ring edge's Line2 DDA pixel and far dot, and
    the two cap circles."""
    g = lambda i: f[..., i]  # noqa: E731
    ymin, ystop = _unpack16(g(0))
    brka, brkb = _unpack16(g(1))
    xs1a, dx1a, xs2a, dx2a, xs1b, dx1b, xs2b, dx2b = map(g, range(2, 10))
    flags = g(28)
    ya = yi - ymin
    x_a = torch.where(yi < brka, xs1a + dx1a * ya, xs2a + dx2a * (yi - brka))
    x_b = torch.where(yi < brkb, xs1b + dx1b * ya, xs2b + dx2b * (yi - brkb))
    lo = (torch.minimum(x_a, x_b) + (1 << 15)) >> 16
    hi = (torch.maximum(x_a, x_b) + (1 << 15)) >> 16
    hit = (
        ((flags & 1) > 0)
        & (yi >= ymin) & (yi <= ystop) & (xi >= lo) & (xi <= hi)
    )
    for i in range(4):
        acc = ((flags >> (1 + i)) & 1) > 0
        xmaj = ((flags >> (5 + i)) & 1) > 0
        m0, n = _unpack16(g(10 + i))
        kk = torch.where(xmaj, xi, yi) - m0
        mino = torch.where(xmaj, yi, xi)
        val = (g(14 + i) + kk * g(18 + i)) >> 16
        hit = hit | (acc & (kk >= 0) & (kk < n) & (mino == val))
        fdx, fdy = _unpack16(g(24 + i))
        hit = hit | (acc & (xi == fdx) & (yi == fdy))
    for c in (22, 23):
        cx, cy = _unpack16(g(c))
        hw = cap_half_widths(thickness, torch.abs(yi - cy))
        hit = hit | (torch.abs(xi - cx) <= hw)
    return hit


def _strip_offsets(strip_id, row, hp, wb):
    """Flat offsets into a (..., hp, wb) strip tensor of the pixels of
    `_plain_hits`' bands: (n, 16, wb)."""
    return (
        (strip_id[:, None] * hp + row)[:, :, None] * wb
        + torch.arange(wb, device=row.device)[None, None, :]
    )


def _frames_from_strips(strip, h, w, nxb, wb):
    """(..., nxb, hp, wb) strips -> (..., h, w) frames: lane blocks side by
    side, padding rows and lanes cut."""
    lead = strip.shape[:-3]
    frames = strip[..., :h, :].movedim(-3, -2).reshape(*lead, h, nxb * wb)
    return frames[..., :w]


def _masks_from_hits(hits, bsz, n_layers, resolution, out_dtype, device,
                     geometry=None):
    """(B, L, H, W) masks, uint8 0/255 or float32 0/1, with the hits of a
    `_window_hits`-style generator set in a (B, L*nxb, hp, wb) strip, of
    the production `_frame_geometry` unless `geometry` gives another."""
    h, w = resolution
    _, hp, _, nxb, wb = geometry or _frame_geometry(resolution)
    n_frames = n_layers * nxb
    strip = torch.zeros(bsz * n_frames * hp * wb, dtype=torch.bool,
                        device=device)
    for env, frame, row, hit in hits:
        flat = _strip_offsets(env * n_frames + frame, row, hp, wb)
        strip[flat[hit]] = True
    frames = _frames_from_strips(
        strip.view(bsz, n_layers, nxb, hp, wb), h, w, nxb, wb
    )
    one = 255 if out_dtype == torch.uint8 else 1
    return (frames.to(out_dtype) * one).contiguous()


def rasterize_masks_env_plain(
    bundle,
    n_layers: int,
    resolution: Tuple[int, int],
    thickness: int,
    out_dtype: torch.dtype = torch.uint8,
) -> torch.Tensor:
    """Plain PyTorch version of the masks kernel: (B, L, H, W) masks from a
    `compact_env_idx_soa` bundle, `out_dtype` uint8 (0/255) or float32
    (0/1). Same function and same float arithmetic as ops/csrc/masks.cu:
    the hits of `_plain_hits` set in the frames' strips."""
    return _masks_from_hits(
        _plain_hits(bundle, resolution, thickness), bundle[-1].shape[1],
        n_layers, resolution, out_dtype, bundle[1].device,
    )


def rasterize_masks_exact_env_plain(
    bundle,
    n_layers: int,
    resolution: Tuple[int, int],
    thickness: int,
    out_dtype: torch.dtype = torch.uint8,
) -> torch.Tensor:
    """Plain PyTorch version of the exact kernel: (B, L, H, W) cv2
    ThickLine masks from a `compact_env_exact_soa` bundle, the function of
    tinycarlo_tpu's `_kernel_env_exact` (rasterize_pallas.py:2904-2970):
    each live slot stamps its 2*16-row window, then a tall copy's 16-row
    tail bands, with the int32 predicate of `_tier_loops_exact`; dead
    layers and envs with no live slot are zeros. Same arithmetic as
    ops/csrc/exact.cu.

    uint8 output is 0/255. float32 output is 0/1, the documented contract
    of a float `out_dtype` (tinycarlo_tpu/env.py:256-260) and what the
    masks kernels emit; the Pallas kernel's float output is 0/255
    (ROADMAP F0), which this version does not copy."""
    idx, fields, counts = bundle
    return _masks_from_hits(
        _exact_plain_hits(bundle, resolution, thickness), counts.shape[1],
        n_layers, resolution, out_dtype, idx.device,
    )


def rasterize_rank_env_plain(
    bundle,
    n_layers: int,
    resolution: Tuple[int, int],
    thickness: int,
) -> torch.Tensor:
    """Plain PyTorch version of the rank kernel: (B, H, W) uint8 layer-rank
    map from a `compact_env_idx_soa` bundle (0 = background, l+1 = layer l
    painted last), the function of tinycarlo_tpu's `_kernel_env_rank`
    (rasterize_pallas.py:1493-1558, `_tier_loops` rank_decode :1776-1791).

    The layer is peeled off the band word's stacked frame index (frame =
    l*nxb + xb) and each hit writes max(strip, l+1) into one (nxb, hp, wb)
    strip per env. Same stamps as ops/csrc/rank.cu; envs with no live slot
    give zeros. The ranks are read off the band words: `n_layers` is the
    layer count they come from.
    """
    h, w = resolution
    _, hp, _, nxb, wb = _frame_geometry(resolution)
    bsz = bundle[-1].shape[1]
    strip = torch.zeros(bsz * nxb * hp * wb, dtype=torch.int32,
                        device=bundle[1].device)
    for env, frame, row, hit in _plain_hits(bundle, resolution, thickness):
        lay = frame // nxb
        flat = _strip_offsets(env * nxb + frame - lay * nxb, row, hp, wb)
        rank = (lay + 1).to(torch.int32)[:, None, None].expand(hit.shape)
        strip.scatter_reduce_(0, flat[hit], rank[hit], reduce="amax")
    frames = _frames_from_strips(strip.view(bsz, nxb, hp, wb), h, w, nxb, wb)
    return frames.to(torch.uint8).contiguous()


def _soa_payload(ax, ay, abx, aby, inv):
    def payload(env, s):
        return ax[env, s], ay[env, s], abx[env, s], aby[env, s], inv[env, s]

    return payload


def rasterize_compact_soa_plain(
    soa,
    resolution: Tuple[int, int],
    thickness: int,
    gran: int = 8,
) -> torch.Tensor:
    """Plain PyTorch version of the frame kernel: (B, L, H, W) uint8 0/255
    masks from a `compact_soa` bundle of granularity `gran`, the function
    of tinycarlo_tpu's `_kernel` (rasterize_pallas.py:357-473). Every slot
    s < counts[0, frame] with nb > 0 stamps its window of two bands at b0c
    and, when tall, its tail bands through b0c + nb, into its (env, layer)
    frame; frames with no live slot are zeros. Same arithmetic as
    ops/csrc/frame_soa.cu, with `_kernel`'s absolute pixel rows."""
    ax, ay, abx, aby, inv, bw, counts = soa
    bsz, nl, k = ax.shape
    geometry = _frame_geometry(resolution, gran, split=False)
    n_bands, _, win, _, wb = geometry
    flat = [x.reshape(bsz * nl, k) for x in (ax, ay, abx, aby, inv, bw)]
    hits = _window_hits(
        _slot_bands(flat[-1], counts[0], n_bands, win, gran, wb),
        _soa_payload(*flat[:-1]), wb, gran, win, _stroke_params(thickness),
        absolute=True, device=ax.device,
    )
    masks = _masks_from_hits(hits, bsz * nl, 1, resolution, torch.uint8,
                             ax.device, geometry)
    return masks.view(bsz, nl, *resolution)


def rasterize_compact_env_soa_plain(
    soa,
    n_layers: int,
    resolution: Tuple[int, int],
    thickness: int,
    gran: int = 8,
    split: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the env kernel: (B, L, H, W) uint8 0/255
    masks from a `compact_env_soa` bundle of granularity `gran`, the
    function of tinycarlo_tpu's `_kernel_env` (rasterize_pallas.py:
    689-795). `split` must be True iff the compaction was given `w` (the
    lane-split layout). Every slot s < counts[0, env] with nb > 0 stamps
    its window and tail bands into the stacked frame its band word names;
    the frames are the strips' rows [0, h), lane blocks side by side. Same
    arithmetic as ops/csrc/env_soa.cu, with `_kernel_env`'s absolute pixel
    rows."""
    ax, ay, abx, aby, inv, bw, counts = soa
    geometry = _frame_geometry(resolution, gran, split)
    n_bands, _, win, _, wb = geometry
    hits = _window_hits(
        _slot_bands(bw, counts[0], n_bands, win, gran, wb),
        _soa_payload(ax, ay, abx, aby, inv), wb, gran, win,
        _stroke_params(thickness), absolute=True, device=ax.device,
    )
    return _masks_from_hits(hits, ax.shape[0], n_layers, resolution,
                            torch.uint8, ax.device, geometry)


def rasterize_env_seg_plain(
    soa,
    n_layers: int,
    resolution: Tuple[int, int],
    thickness: int,
    gran: int = 16,
    split: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of the segment kernel: (B, L, H, W) uint8
    0/255 masks from a `compact_env_seg` bundle of granularity `gran`, the
    function of tinycarlo_tpu's `_kernel_env_seg` (rasterize_pallas.py:
    1345-1424, `_tier_loops_seg` :1275-1342). `split` must be True iff the
    compaction was given a `w` above 128.

    A slot s < counts[0, env] reads segment e = idx[env, s] and decodes
    its word: touch bits = bw & (2^nxb - 1), nb = (bw >> nxb) & 511, enc =
    bw >> nxb >> 9. For each set bit xb it stamps, in stacked frame
    lay*nxb + xb, the window at band enc + xb*n_bands and the tall tail
    bands [win/gran, nb) after it, with ax - xb*128 and ay + xb*hp. Same
    arithmetic as ops/csrc/env_seg.cu, with `_tier_loops_seg`'s window-
    relative pixel rows. A layer with no eligible segment (counts[4+l] ==
    0) has no live slot, so its frame is zeros as the Pallas kernel
    writes it."""
    idx, ax, ay, abx, aby, inv, bw, counts = soa
    geometry = _frame_geometry(resolution, gran, split)
    n_bands, hp, win, nxb, wb = geometry
    bsz = ax.shape[0]
    k = idx.shape[1] - 7
    seg = idx[:, :k].long()
    word = torch.gather(bw, 1, seg)
    bits = word & ((1 << nxb) - 1)
    nb = (word >> nxb) & (_NB_PACK - 1)
    enc = (word >> nxb) >> _NB_SHIFT
    # one copy per (slot, touched block): slot s, block xb at s*nxb + xb
    xb = torch.arange(nxb, device=ax.device)
    touched = ((bits[..., None] >> xb) & 1) == 1
    copies = (((enc[..., None] + xb * n_bands) << _NB_SHIFT)
              | torch.where(touched, nb[..., None], 0)).reshape(bsz, k * nxb)

    def payload(env, c):
        s, x = c // nxb, c % nxb
        e = seg[env, s]
        return (ax[env, e] - (x * _XB).to(torch.float32),
                ay[env, e] + (x * hp).to(torch.float32),
                abx[env, e], aby[env, e], inv[env, e])

    hits = _window_hits(
        _slot_bands(copies, counts[0] * nxb, n_bands, win, gran, wb),
        payload, wb, gran, win, _stroke_params(thickness), absolute=False,
        device=ax.device,
    )
    return _masks_from_hits(hits, bsz, n_layers, resolution, torch.uint8,
                            ax.device, geometry)


def _window_hit_plain(apx, apy, abx, aby, inv, stroke):
    """`_window_hit` (rasterize_pallas.py:134-202) for live slots, in
    float32 with every operation separately rounded (as the kernel)."""
    if stroke[0] == "bres":
        ady = torch.abs(aby)
        sy = torch.where(aby >= 0.0, 1.0, -1.0).to(aby.dtype)
        xmaj = abx >= ady
        maj = torch.maximum(abx, ady)
        mino = torch.minimum(abx, ady)
        step = torch.where(xmaj, apx, sy * apy)
        num = 2.0 * mino * step + (maj - 1.0)
        q = torch.floor(num * inv)
        r = num - q * (2.0 * maj)
        q = q + (r >= 2.0 * maj).float() - (r < 0.0).float()
        probe = torch.where(xmaj, apy, apx)
        target = torch.where(xmaj, sy * q, q)
        hit = (step >= 0.0) & (step <= maj) & (probe == target)
        return torch.where(maj == 0.0, (apx == 0.0) & (apy == 0.0), hit)
    _, lat2, cap2 = stroke
    tu = (apx * abx + apy * aby) * inv
    t = torch.clamp(tu, 0.0, 1.0)
    dx = apx - t * abx
    dy = apy - t * aby
    d2 = dx * dx + dy * dy
    r2v = torch.where((tu >= 0.0) & (tu <= 1.0), lat2, cap2).to(d2.dtype)
    return d2 <= r2v


class _Kernel:
    """A CUDA kernel of ops/csrc bound with ctypes: its launcher, the input
    checks and the launch counter.

    `launches` counts kernel launches (and nothing else), so a run can show
    that its renders went through the kernel. A CUDA input either launches
    the kernel or raises; nothing falls back to the plain path.
    """

    NAME = ""  # kernel name in messages; its source is ops/csrc/<NAME>.cu
    SYMBOL = ""  # the C launch function
    ARGTYPES = ()

    def __init__(self):
        self.launches = 0
        self._fn = None

    def _launcher(self):
        if self._fn is None:
            fn = getattr(libraries.get(self.NAME), self.SYMBOL)
            fn.argtypes = self.ARGTYPES
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def _check_tensors(self, want, dev) -> None:
        """Raise unless every tensor of `want` ({name: (tensor, dtype,
        shape)}) lies on the CUDA device `dev` with that dtype and shape,
        contiguous."""
        if dev.type != "cuda":
            raise ValueError(f"{self.NAME} kernel: unsupported device {dev}")
        for name, (t, dtype, shape) in want.items():
            if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
                raise ValueError(
                    f"{self.NAME} kernel: {name} must be {dtype} {shape} on "
                    f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                )
            if not t.is_contiguous():
                raise ValueError(
                    f"{self.NAME} kernel: {name} must be contiguous"
                )

    def _run(self, out: torch.Tensor, *args) -> torch.Tensor:
        """Launch on out's device's current stream with the C arguments
        `args` and the stream; raise if the launch failed."""
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            err = self._launcher()(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.NAME} kernel launch failed: CUDA error {err}"
            )
        self.launches += 1
        return out


def _check_out_dtype(name: str, out_dtype: torch.dtype) -> None:
    if out_dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"{name} kernel: out_dtype {out_dtype} not in "
                         "(uint8, float32)")


class _BundleKernel(_Kernel):
    """A kernel over a `compact_env_idx_soa` bundle."""

    def _check(self, bundle, n_layers: int, w: int) -> None:
        """Raise unless the bundle is what the kernel reads: CUDA, int32 /
        float32, the shapes of one compaction, contiguous."""
        idx, ax, ay, abx, aby, inv, bw, counts = bundle
        bsz, le = ax.shape
        self._check_tensors({
            "idx": (idx, torch.int32, (bsz, idx.shape[1])),
            "ax": (ax, torch.float32, (bsz, le)),
            "ay": (ay, torch.float32, (bsz, le)),
            "abx": (abx, torch.float32, (bsz, le)),
            "aby": (aby, torch.float32, (bsz, le)),
            "inv": (inv, torch.float32, (bsz, le)),
            "bw": (bw, torch.int32, (bsz, le)),
            "counts": (counts, torch.int32, (4 + n_layers, bsz)),
        }, ax.device)
        if le % _n_xblocks(w):
            raise ValueError(
                f"{self.NAME} kernel: bundle does not match the width"
            )

    def _launch(self, bundle, out, ints, thickness: int) -> torch.Tensor:
        """Launch with the C arguments: the bundle's and out's pointers,
        `ints`, the stroke's (bres, lat2, cap2) and the stream."""
        stroke = _stroke_params(thickness)
        lat2, cap2 = (0.0, 0.0) if stroke[0] == "bres" else stroke[1:]
        idx, ax, ay, abx, aby, inv, bw, counts = bundle
        return self._run(
            out, counts.data_ptr(), idx.data_ptr(), ax.data_ptr(),
            ay.data_ptr(), abx.data_ptr(), aby.data_ptr(), inv.data_ptr(),
            bw.data_ptr(), out.data_ptr(), *ints, int(stroke[0] == "bres"),
            lat2, cap2,
        )


class MasksKernel(_BundleKernel):
    """The masks kernel's wrapper: `ops/csrc/masks.cu` on CUDA tensors,
    `rasterize_masks_env_plain` on CPU tensors."""

    NAME = "masks"
    SYMBOL = "tc_masks_launch"
    # tc_masks_launch's C signature: 9 pointers (the bundle, out), 8 ints
    # (out_float, B, L, h, w, kp, le, bres), lat2, cap2 and the stream
    ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])

    def __call__(
        self,
        bundle,
        n_layers: int,
        resolution: Tuple[int, int],
        thickness: int,
        out_dtype: torch.dtype = torch.uint8,
    ) -> torch.Tensor:
        if bundle[0].device.type == "cpu":
            return rasterize_masks_env_plain(
                bundle, n_layers, resolution, thickness, out_dtype
            )
        _check_out_dtype(self.NAME, out_dtype)
        h, w = resolution
        self._check(bundle, n_layers, w)
        bsz, le = bundle[1].shape
        out = torch.empty((bsz, n_layers, h, w), dtype=out_dtype,
                          device=bundle[1].device)
        return self._launch(bundle, out, (
            int(out_dtype == torch.float32), bsz, n_layers, h, w,
            bundle[0].shape[1], le,
        ), thickness)


class RankKernel(_BundleKernel):
    """The rank kernel's wrapper: `ops/csrc/rank.cu` on CUDA tensors,
    `rasterize_rank_env_plain` on CPU tensors. Output (B, H, W) uint8."""

    NAME = "rank"
    SYMBOL = "tc_rank_launch"
    # tc_rank_launch's C signature: 9 pointers (the bundle, out), 7 ints
    # (B, L, h, w, kp, le, bres), lat2, cap2 and the stream
    ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])

    def __call__(
        self,
        bundle,
        n_layers: int,
        resolution: Tuple[int, int],
        thickness: int,
    ) -> torch.Tensor:
        if not 0 < n_layers < 256:
            raise ValueError(f"rank kernel: {n_layers} layers do not fit "
                             "uint8 ranks")
        if bundle[0].device.type == "cpu":
            return rasterize_rank_env_plain(
                bundle, n_layers, resolution, thickness
            )
        h, w = resolution
        self._check(bundle, n_layers, w)
        bsz, le = bundle[1].shape
        out = torch.empty((bsz, h, w), dtype=torch.uint8,
                          device=bundle[1].device)
        return self._launch(bundle, out, (
            bsz, n_layers, h, w, bundle[0].shape[1], le,
        ), thickness)


# The longest cap table exact.cu takes (kMaxCap): radius (t + 1) // 2 < 64.
_MAX_CAP = 64


class ExactKernel(_Kernel):
    """The exact kernel's wrapper: `ops/csrc/exact.cu` on CUDA tensors,
    `rasterize_masks_exact_env_plain` on CPU tensors. Takes a
    `compact_env_exact_soa` bundle; output (B, L, H, W) uint8 0/255 or
    float32 0/1."""

    NAME = "exact"
    SYMBOL = "tc_exact_launch"
    # tc_exact_launch's C signature: 3 pointers (counts, idx, the host
    # array of the 30 field pointers), out, 7 ints (out_float, B, L, h, w,
    # kp, le), the host cap table, its length and the stream
    ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])

    def __call__(
        self,
        bundle,
        n_layers: int,
        resolution: Tuple[int, int],
        thickness: int,
        out_dtype: torch.dtype = torch.uint8,
    ) -> torch.Tensor:
        idx, fields, counts = bundle
        if idx.device.type == "cpu":
            return rasterize_masks_exact_env_plain(
                bundle, n_layers, resolution, thickness, out_dtype
            )
        _check_out_dtype(self.NAME, out_dtype)
        h, w = resolution
        bsz, le = fields[0].shape
        if len(fields) != EXACT_FIELDS:
            raise ValueError(f"exact kernel: {len(fields)} fields, not "
                             f"{EXACT_FIELDS}")
        want = {
            "idx": (idx, torch.int32, (bsz, idx.shape[1])),
            "counts": (counts, torch.int32, (4 + n_layers, bsz)),
        }
        for i, f in enumerate(fields):
            want[f"field {i}"] = (f, torch.int32, (bsz, le))
        self._check_tensors(want, idx.device)
        if le % _n_xblocks(w):
            raise ValueError("exact kernel: bundle does not match the width")
        table = cap_table(cap_radius(thickness))
        if len(table) > _MAX_CAP:
            raise ValueError(f"exact kernel: thickness {thickness} is too "
                             "wide for its cap table")
        out = torch.empty((bsz, n_layers, h, w), dtype=out_dtype,
                          device=idx.device)
        # host arrays, read by the C launcher before it returns
        ptrs = (ctypes.c_void_p * EXACT_FIELDS)(*(f.data_ptr() for f in fields))
        caps = (ctypes.c_int * len(table))(*table)
        return self._run(
            out, counts.data_ptr(), idx.data_ptr(), ctypes.addressof(ptrs),
            out.data_ptr(), int(out_dtype == torch.float32), bsz, n_layers,
            h, w, idx.shape[1], le, ctypes.addressof(caps), len(table),
        )


class _SoaKernel(_Kernel):
    """A kernel over one of the older SoA bundles (`compact_soa`,
    `compact_env_soa`, `compact_env_seg`): (B, L, H, W) uint8 0/255 masks
    at band granularity 8 or 16 (the kernels are compiled for those two)."""

    def _launch(self, soa, counts_shape, idx, out_shape, ints, thickness,
                gran):
        """Check the bundle (CUDA; float32 SoA and int32 bw of one shape,
        counts of `counts_shape`, `idx` if not None) and launch with the C
        arguments: counts, idx if given, the SoA and bw pointers, out's,
        the ints `ints`, the stroke's (bres, lat2, cap2) and the stream."""
        if gran not in (8, 16):
            raise ValueError(f"{self.NAME} kernel: gran {gran} not in (8, 16)")
        ax, ay, abx, aby, inv, bw, counts = soa
        dev = ax.device
        want = {"counts": (counts, torch.int32, counts_shape)}
        if idx is not None:
            want["idx"] = (idx, torch.int32, (ax.shape[0], idx.shape[1]))
        for name, t in zip(("ax", "ay", "abx", "aby", "inv"),
                           (ax, ay, abx, aby, inv)):
            want[name] = (t, torch.float32, tuple(ax.shape))
        want["bw"] = (bw, torch.int32, tuple(ax.shape))
        self._check_tensors(want, dev)
        stroke = _stroke_params(thickness)
        lat2, cap2 = (0.0, 0.0) if stroke[0] == "bres" else stroke[1:]
        out = torch.empty(out_shape, dtype=torch.uint8, device=dev)
        ptrs = [counts.data_ptr()] + ([] if idx is None else [idx.data_ptr()])
        return self._run(
            out, *ptrs, *(t.data_ptr() for t in (ax, ay, abx, aby, inv, bw)),
            out.data_ptr(), *ints, gran, int(stroke[0] == "bres"), lat2, cap2,
        )


class FrameSoaKernel(_SoaKernel):
    """The frame kernel's wrapper: `ops/csrc/frame_soa.cu` on CUDA tensors,
    `rasterize_compact_soa_plain` on CPU tensors. Takes a `compact_soa`
    bundle (the counterpart of `rasterize_compact_soa`)."""

    NAME = "frame_soa"
    SYMBOL = "tc_frame_soa_launch"
    # tc_frame_soa_launch's C signature: 8 pointers (counts, the SoA, bw,
    # out), 7 ints (B, L, h, w, k, gran, bres), lat2, cap2 and the stream
    ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])

    def __call__(self, soa, resolution: Tuple[int, int], thickness: int,
                 gran: int = 8) -> torch.Tensor:
        if soa[0].device.type == "cpu":
            return rasterize_compact_soa_plain(soa, resolution, thickness,
                                               gran)
        h, w = resolution
        bsz, nl, k = soa[0].shape
        return self._launch(soa, (3, bsz * nl), None, (bsz, nl, h, w),
                            (bsz, nl, h, w, k), thickness, gran)


class EnvSoaKernel(_SoaKernel):
    """The env kernel's wrapper: `ops/csrc/env_soa.cu` on CUDA tensors,
    `rasterize_compact_env_soa_plain` on CPU tensors. Takes a
    `compact_env_soa` bundle; `split` must be True iff the compaction was
    given `w` (the counterpart of `rasterize_compact_env_soa`)."""

    NAME = "env_soa"
    SYMBOL = "tc_env_soa_launch"
    # tc_env_soa_launch's C signature: 8 pointers (counts, the SoA, bw,
    # out), 8 ints (B, L, h, w, k, split, gran, bres), lat2, cap2 and the
    # stream
    ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])

    def __call__(self, soa, n_layers: int, resolution: Tuple[int, int],
                 thickness: int, gran: int = 8,
                 split: bool = False) -> torch.Tensor:
        if soa[0].device.type == "cpu":
            return rasterize_compact_env_soa_plain(
                soa, n_layers, resolution, thickness, gran, split)
        h, w = resolution
        bsz, k = soa[0].shape
        return self._launch(soa, (3, bsz), None, (bsz, n_layers, h, w),
                            (bsz, n_layers, h, w, k, int(split)), thickness,
                            gran)


class EnvSegKernel(_SoaKernel):
    """The segment kernel's wrapper: `ops/csrc/env_seg.cu` on CUDA
    tensors, `rasterize_env_seg_plain` on CPU tensors. Takes a
    `compact_env_seg` bundle; `split` must be True iff the compaction was
    given a `w` above 128 (the counterpart of `rasterize_env_seg`)."""

    NAME = "env_seg"
    SYMBOL = "tc_env_seg_launch"
    # tc_env_seg_launch's C signature: 9 pointers (counts, idx, the SoA,
    # bw, out), 9 ints (B, L, h, w, kp, le, split, gran, bres), lat2, cap2
    # and the stream
    ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                + [ctypes.c_float] * 2 + [ctypes.c_void_p])

    def __call__(self, soa, n_layers: int, resolution: Tuple[int, int],
                 thickness: int, gran: int = 16,
                 split: bool = True) -> torch.Tensor:
        idx, *rest = soa
        if idx.device.type == "cpu":
            return rasterize_env_seg_plain(soa, n_layers, resolution,
                                           thickness, gran, split)
        h, w = resolution
        bsz, le = rest[0].shape
        return self._launch(rest, (4 + n_layers, bsz), idx,
                            (bsz, n_layers, h, w),
                            (bsz, n_layers, h, w, idx.shape[1], le,
                             int(split)), thickness, gran)


masks_kernel = MasksKernel()
rank_kernel = RankKernel()
exact_kernel = ExactKernel()
frame_soa_kernel = FrameSoaKernel()
env_soa_kernel = EnvSoaKernel()
env_seg_kernel = EnvSegKernel()


def _packed_bundle(compact, u0, v0, u1, v1, draw, edge_layer, n_layers,
                   resolution, thickness, max_visible, layer_bounds):
    """The production compaction `compact` of a packed edge axis with any
    leading shape: budget max_visible * ceil(w/128) copies (all copies when
    None; rasterize_pallas.py:2423). Returns (leading shape, bundle)."""
    lead = draw.shape[:-1]
    e = draw.shape[-1]
    h, w = resolution
    nxb = _n_xblocks(w)
    k = e * nxb if max_visible is None else min(max_visible * nxb, e * nxb)
    u0, v0, u1, v1, draw = (x.reshape(-1, e) for x in (u0, v0, u1, v1, draw))
    return lead, compact(
        u0, v0, u1, v1, draw, k, h, thickness, edge_layer=edge_layer,
        n_layers=n_layers, w=w, layer_bounds=layer_bounds,
    )


def rasterize_masks_packed_soa(
    u0: torch.Tensor,  # (..., E) packed edge axis, SoA pixel coords
    v0: torch.Tensor,
    u1: torch.Tensor,
    v1: torch.Tensor,
    draw: torch.Tensor,  # (..., E)
    edge_layer: torch.Tensor,  # (E,) int32 layer id per packed edge
    n_layers: int,
    resolution: Tuple[int, int],
    thickness: int = 1,
    max_visible: Optional[int] = None,
    layer_bounds: Optional[Tuple[int, ...]] = None,
    out_dtype: torch.dtype = torch.uint8,
    stroke: str = "fast",
) -> torch.Tensor:
    """(..., n_layers, H, W) masks from the packed edge axis: compaction at
    the production budget (max_visible * ceil(w/128) copies, gran 16), then
    a kernel -- the counterpart of `rasterize_masks_packed_pallas_soa`
    (rasterize_pallas.py:2388-2503). The fast stroke (and t = 1) goes
    through `compact_env_idx_soa` and the masks kernel, `stroke="exact"`
    at t >= 2 through `compact_env_exact_soa` and the exact kernel
    (:2427-2444). uint8 gives 0/255 masks, float32 0/1 masks."""
    if _exact(thickness, stroke):
        compact, kernel = compact_env_exact_soa, exact_kernel
    else:
        compact, kernel = compact_env_idx_soa, masks_kernel
    lead, bundle = _packed_bundle(
        compact, u0, v0, u1, v1, draw, edge_layer, n_layers, resolution,
        thickness, max_visible, layer_bounds,
    )
    masks = kernel(
        bundle, n_layers, tuple(resolution), thickness, out_dtype=out_dtype
    )
    return masks.reshape(*lead, n_layers, *resolution)


def rasterize_rank_packed_soa(
    u0: torch.Tensor,  # (..., E) packed edge axis, SoA pixel coords
    v0: torch.Tensor,
    u1: torch.Tensor,
    v1: torch.Tensor,
    draw: torch.Tensor,  # (..., E)
    edge_layer: torch.Tensor,  # (E,) int32 layer id per packed edge
    n_layers: int,
    resolution: Tuple[int, int],
    thickness: int = 1,
    max_visible: Optional[int] = None,
    layer_bounds: Optional[Tuple[int, ...]] = None,
    stroke: str = "fast",
) -> torch.Tensor:
    """(..., H, W) uint8 layer-rank map from the packed edge axis: the
    compaction of `rasterize_masks_packed_soa`, then the rank kernel --
    the counterpart of `rasterize_rank_packed_soa`
    (rasterize_pallas.py:1626-1661). `rasterize.rgb_from_rank` composites
    it into the rgb frame of the masks' paint-order composite.

    The rank kernel stamps the fast stroke only: `stroke="exact"` at t >= 2
    raises, and its rank map is `rasterize.rank_from_masks` of the exact
    masks (tinycarlo_tpu/env.py:274-275, :308-312)."""
    if _exact(thickness, stroke):
        raise ValueError(
            'rank kernel: stroke="exact" at thickness >= 2 renders through '
            "the masks route, rank_from_masks(rasterize_masks_packed_soa("
            '..., stroke="exact"))'
        )
    lead, bundle = _packed_bundle(
        compact_env_idx_soa, u0, v0, u1, v1, draw, edge_layer, n_layers,
        resolution, thickness, max_visible, layer_bounds,
    )
    rank = rank_kernel(bundle, n_layers, tuple(resolution), thickness)
    return rank.reshape(*lead, *resolution)
