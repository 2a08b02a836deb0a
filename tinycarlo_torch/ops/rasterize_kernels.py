"""Segment compaction and the masks and rank kernels: the port's render path.

Counterpart of the main path of tinycarlo_tpu/ops/rasterize_pallas.py.
Projection output (per-env packed edge coordinates) is compacted by torch
ops into the same bundle as `compact_env_idx_soa(pre=False)`: per copy
(one per segment and touched 128-lane block) the integer endpoint, the
direction, the stamp's reciprocal and a packed band word, plus a (B, k)
slot->copy index from `torch.topk` over a short-first key. Two kernels
stamp the live slots of that bundle:

- the masks kernel (ops/csrc/masks.cu) into (B, L, H, W) class masks; it
  replaces the Pallas kernels `_kernel_env_idx` and `_kernel_env_dma`;
- the rank kernel (ops/csrc/rank.cu) into a (B, H, W) layer-rank map, the
  rgb / rgb_planar / rank formats' render; it replaces `_kernel_env_rank`.

Each wrapper's `__call__` dispatches on the bundle's device: CUDA tensors
launch the kernel (or raise), CPU tensors take the plain PyTorch version
(`rasterize_masks_env_plain`, `rasterize_rank_env_plain`), which computes
the same function and is the kernel's reference on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tinycarlo_torch.ops._build import libraries
from tinycarlo_torch.ops.rasterize import (
    _check_stroke,
    _clip_line_cv2,
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


def _window_rows(h: int) -> Tuple[int, int, int]:
    """(n_bands, padded height, window rows) of a frame: the window spans
    two bands (clamped to the padded frame)."""
    n_bands = -(-h // _GRAN)
    hp = n_bands * _GRAN
    return n_bands, hp, min(2 * _GRAN, hp)


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
    bw = (frame*n_bands + b0c) * 512 + nb; then `torch.topk` (sorted) over a
    key that puts eligible short copies first, then talls, each in index
    order, yields the (B, k) slot->copy index, padded with 7 copies of
    its last column. The keys are distinct integers, so topk selects and
    orders the same slots as `lax.top_k`.

    Returns (idx, ax, ay, abx, aby, inv, bw, counts): counts is (4 +
    n_layers, B) int32, rows [live, one-band (0: the one-band tier is
    off), short, dropped, per-layer eligible copies...]. The per-layer
    counts sum static slices when `layer_bounds` (the edges' cumulative
    per-layer offsets) is given, else a one-hot of `edge_layer`.
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
    ylo = torch.minimum(ay0, by0) - rf
    yhi = torch.maximum(ay0, by0) + rf
    b0 = torch.clamp(torch.floor(ylo / _GRAN), 0.0, n_bands - 1.0).to(torch.int32)
    b1 = torch.clamp(torch.floor(yhi / _GRAN), 0.0, n_bands - 1.0).to(torch.int32)
    valid = (yhi >= 0.0) & (ylo <= h - 1.0) & draw
    nb = torch.where(valid, b1 + 1 - b0, 0)
    b0c = torch.clamp_max(b0, (hp - win) // _GRAN)
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
    draw2 = nb > 0
    tall = nb > win // _GRAN

    abx, aby = bx0 - ax0, by0 - ay0
    inv = _inv_for(abx, aby, thickness)

    iota = torch.arange(le, dtype=torch.int32, device=dev).expand(bsz, le)
    key = torch.where(
        draw2, torch.where(tall, le - iota, 2 * le - iota), -iota
    )
    n_elig = draw2.sum(dim=-1, dtype=torch.int32)
    n_all = torch.clamp_max(n_elig, k)
    n_one = torch.zeros_like(n_all)
    n_short = torch.clamp_max((draw2 & ~tall).sum(dim=-1, dtype=torch.int32), k)
    n_drop = n_elig - n_all

    if k < le:
        idx = torch.topk(key, k, dim=-1, sorted=True).indices
    else:
        idx = torch.argsort(-key, dim=-1, stable=True)
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
        lay_flat = flat(lay[..., None].expand(bsz, e, nxb))
        onehot_l = lay_flat[:, None, :] == torch.arange(
            n_layers, dtype=torch.int32, device=dev
        )[None, :, None]
        per_layer = (draw2[:, None, :] & onehot_l).sum(
            dim=-1, dtype=torch.int32
        )
    counts = torch.cat(
        [torch.stack([n_all, n_one, n_short, n_drop]), per_layer.T], dim=0
    ).contiguous()
    return idx, ax0, ay0, abx, aby, inv, bw, counts


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


def _frame_geometry(resolution):
    """(n_bands, hp, win, nxb, wb) of a frame: bands, padded rows, window
    rows, lane blocks and the stamped strip's width."""
    h, w = resolution
    n_bands, hp, win = _window_rows(h)
    nxb = _n_xblocks(w)
    wb = _XB if nxb > 1 else w
    return n_bands, hp, win, nxb, wb


# Plain version: how many (slot, band) stamps are evaluated per chunk.
_PLAIN_CHUNK = 1 << 15


def _plain_hits(bundle, resolution: Tuple[int, int], thickness: int):
    """The stamps of the masks and rank kernels, chunk by chunk: yields
    (env, frame, row, hit) with env, frame (n,) and row (n, 16) the env,
    stacked frame (l*nxb + xb) and strip rows of n 16-row bands, and hit
    (n, 16, wb) their lit pixels. Same float arithmetic as the kernels'
    `window_hit` (ops/csrc/stamp.cuh).

    Every live slot (s < counts[0, env], nb > 0) stamps its window's bands
    and, for a tall copy, its tail bands; each (slot, band) pair is one
    16-row x wb-lane evaluation of the `_window_hit` stamp. The pairs are
    evaluated in chunks so the float temporaries stay bounded.
    """
    idx, ax, ay, abx, aby, inv, bw, counts = bundle
    n_bands, hp, win, nxb, wb = _frame_geometry(resolution)
    dev = ax.device
    stroke = _stroke_params(thickness)

    k = idx.shape[1] - 7
    sidx = idx[:, :k].long()
    word = torch.gather(bw, 1, sidx)
    nb = word & (_NB_PACK - 1)
    rowband = word >> _NB_SHIFT
    live = (torch.arange(k, device=dev)[None, :] < counts[0][:, None]) & (nb > 0)
    ext = torch.clamp_min(nb, win // _GRAN)
    band = torch.arange(n_bands, device=dev)
    items = torch.nonzero(live[..., None] & (band < ext[..., None]))  # (n, 3)

    rr_in_band = torch.arange(_GRAN, device=dev)
    xs = torch.arange(wb, device=dev, dtype=torch.float32)
    for c in range(0, items.shape[0], _PLAIN_CHUNK):
        env, s, j = items[c: c + _PLAIN_CHUNK].unbind(-1)
        e = sidx[env, s]
        g = lambda t: t[env, e]  # noqa: E731
        sax, say, sabx, saby, sinv = g(ax), g(ay), g(abx), g(aby), g(inv)
        rb = rowband[env, s]
        frame = rb // n_bands
        b0 = rb - frame * n_bands
        # rows of this band relative to the window start, and the window
        # origin: the 2-band window at rb, or a tail band's own window
        rr = j[:, None] * _GRAN + rr_in_band[None, :]  # (n, 16)
        tail = j >= win // _GRAN
        y0 = torch.where(tail, rb + j, rb) * _GRAN
        ys = torch.where(tail[:, None], rr_in_band[None, :], rr)
        ayw = say - y0.to(torch.float32)
        apx = xs[None, None, :] - sax[:, None, None]
        apy = ys.to(torch.float32)[:, :, None] - ayw[:, None, None]
        hit = _window_hit_plain(
            apx, apy, sabx[:, None, None], saby[:, None, None],
            sinv[:, None, None], stroke,
        )  # (n, 16, wb)
        row = b0[:, None] * _GRAN + rr  # (n, 16) local row in the strip
        yield env, frame, row, hit


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
    the hits of `_plain_hits` are set in a (B, L*nxb, hp, wb) strip."""
    h, w = resolution
    _, hp, _, nxb, wb = _frame_geometry(resolution)
    bsz = bundle[-1].shape[1]
    n_frames = n_layers * nxb
    strip = torch.zeros(bsz * n_frames * hp * wb, dtype=torch.bool,
                        device=bundle[1].device)
    for env, frame, row, hit in _plain_hits(bundle, resolution, thickness):
        flat = _strip_offsets(env * n_frames + frame, row, hp, wb)
        strip[flat[hit]] = True
    frames = _frames_from_strips(
        strip.view(bsz, n_layers, nxb, hp, wb), h, w, nxb, wb
    )
    one = 255 if out_dtype == torch.uint8 else 1
    return (frames.to(out_dtype) * one).contiguous()


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


class _BundleKernel:
    """A CUDA kernel over a `compact_env_idx_soa` bundle, bound with ctypes:
    its launcher, the bundle checks and the launch counter.

    `launches` counts kernel launches (and nothing else), so a run can show
    that its renders went through the kernel. A CUDA bundle either
    launches the kernel or raises; nothing falls back to the plain path.
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

    def _check(self, bundle, n_layers: int, w: int) -> None:
        """Raise unless the bundle is what the kernel reads: CUDA, int32 /
        float32, the shapes of one compaction, contiguous."""
        idx, ax, ay, abx, aby, inv, bw, counts = bundle
        dev = ax.device
        if dev.type != "cuda":
            raise ValueError(f"{self.NAME} kernel: unsupported device {dev}")
        bsz, le = ax.shape
        kp = idx.shape[1]
        want = {
            "idx": (idx, torch.int32, (bsz, kp)),
            "ax": (ax, torch.float32, (bsz, le)),
            "ay": (ay, torch.float32, (bsz, le)),
            "abx": (abx, torch.float32, (bsz, le)),
            "aby": (aby, torch.float32, (bsz, le)),
            "inv": (inv, torch.float32, (bsz, le)),
            "bw": (bw, torch.int32, (bsz, le)),
            "counts": (counts, torch.int32, (4 + n_layers, bsz)),
        }
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
        if le % _n_xblocks(w):
            raise ValueError(
                f"{self.NAME} kernel: bundle does not match the width"
            )

    def _launch(self, bundle, out, ints, thickness: int) -> torch.Tensor:
        """Launch on the current stream with the C arguments: the bundle's
        and out's pointers, `ints`, the stroke's (bres, lat2, cap2) and the
        stream."""
        stroke = _stroke_params(thickness)
        lat2, cap2 = (0.0, 0.0) if stroke[0] == "bres" else stroke[1:]
        idx, ax, ay, abx, aby, inv, bw, counts = bundle
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            err = self._launcher()(
                counts.data_ptr(), idx.data_ptr(), ax.data_ptr(),
                ay.data_ptr(), abx.data_ptr(), aby.data_ptr(), inv.data_ptr(),
                bw.data_ptr(), out.data_ptr(), *ints, int(stroke[0] == "bres"),
                lat2, cap2, stream,
            )
        if err != 0:
            raise RuntimeError(
                f"{self.NAME} kernel launch failed: CUDA error {err}"
            )
        self.launches += 1
        return out


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
        if out_dtype not in (torch.uint8, torch.float32):
            raise ValueError(f"masks kernel: out_dtype {out_dtype} not in "
                             "(uint8, float32)")
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


masks_kernel = MasksKernel()
rank_kernel = RankKernel()


def _packed_bundle(u0, v0, u1, v1, draw, edge_layer, n_layers, resolution,
                   thickness, max_visible, layer_bounds):
    """The production compaction of a packed edge axis with any leading
    shape: budget max_visible * ceil(w/128) copies (all copies when None).
    Returns (leading shape, bundle)."""
    lead = draw.shape[:-1]
    e = draw.shape[-1]
    h, w = resolution
    nxb = _n_xblocks(w)
    k = e * nxb if max_visible is None else min(max_visible * nxb, e * nxb)
    u0, v0, u1, v1, draw = (x.reshape(-1, e) for x in (u0, v0, u1, v1, draw))
    return lead, compact_env_idx_soa(
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
    the masks kernel -- the counterpart of
    `rasterize_masks_packed_pallas_soa` (rasterize_pallas.py:2388-2503) for
    the fast stroke. uint8 gives 0/255 masks, float32 0/1 masks."""
    _check_stroke(thickness, stroke)
    lead, bundle = _packed_bundle(
        u0, v0, u1, v1, draw, edge_layer, n_layers, resolution, thickness,
        max_visible, layer_bounds,
    )
    masks = masks_kernel(
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
    it into the rgb frame of the masks' paint-order composite."""
    _check_stroke(thickness, stroke)
    lead, bundle = _packed_bundle(
        u0, v0, u1, v1, draw, edge_layer, n_layers, resolution, thickness,
        max_visible, layer_bounds,
    )
    rank = rank_kernel(bundle, n_layers, tuple(resolution), thickness)
    return rank.reshape(*lead, *resolution)
