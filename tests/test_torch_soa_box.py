"""The env, segment and frame kernels' box clipping loses no pixel.

The env, segment and frame kernels (ops/csrc/env_soa.cu, env_seg.cu,
frame_soa.cu) test only the pixels of each live copy's box -- its
segment's bounding box padded by the stroke's reach and a one-pixel
margin, clipped to the copy's stamped bands of the bundle's own height
(gran 8 or 16) and to its lane block's output lanes
(`rasterize_kernels.copy_box` at `box_pad(t)`, the rule of stamp.cuh's
`copy_box`) -- where the plain versions
(`rasterize_compact_env_soa_plain`, `rasterize_env_seg_plain`,
`rasterize_compact_soa_plain`) evaluate the copy's whole window. They
agree only if every output pixel that a copy lights in the plain version
lies inside that copy's box. A copy of the env bundle (`compact_env_soa`)
is a slot; one of the segment bundle (`compact_env_seg`) is a slot's
segment in one lane block its touch bits name, moved into that block's
lanes (`rasterize_kernels._seg_copies`); one of the frame bundle
(`compact_soa`) is a slot of one (env, layer) frame, which the kernel
takes as a one-layer env: frame 0 of its band word, never lane-split,
at t = 1 too (its compaction clips with w but keeps frame lanes).

This checks it on the CPU, with the bundle's own gran and split: random
bundles at gran 8 and 16, split and unsplit, t = 1, 2, 3 and three frame
shapes (the lane split at 128x160, one lane block at 48x96, a width that
is not a multiple of 4), one 480x640 unsplit bundle, vertical, horizontal
and single-pixel segments, near-plane clipped segments thousands of
pixels long (some past the compaction's 1e6 px clamp), segment slots
touching one, two and all three lane blocks of a 300-wide frame, and
8-env bundles of the rasterizer benchmark's `env`, `cur`, `seg` and
`full` modes, and unsplit t = 1 frame bundles at w = 300 and 640; and
that the boxes hold far fewer pixels than the windows. The segments
come from tests/test_torch_masks_box.py's numpy-seeded generators.
"""
import pytest
import torch

from tests.test_torch_masks_box import L, _segments, _special
from tinycarlo_torch.ops import rasterize_kernels as rk


def _bundle(kind, segs, h, w, t, gran, split, k):
    """The env (`kind` "env"), segment ("seg") or frame ("frame") bundle
    of the packed segments `segs` at band height `gran`, lane-split iff
    `split`, k slots per env (per lane block for the env bundle, per
    (env, layer) frame for the frame bundle, which is never split: each
    layer's frame gets the edges of its layer)."""
    u0, v0, u1, v1, draw, lay = segs
    f = lambda x: torch.tensor(x, dtype=torch.float32)[:, None]  # noqa: E731
    if kind == "frame":
        assert not split
        p0 = torch.stack([f(u0), f(v0)], -1).expand(-1, L, -1, -1)
        p1 = torch.stack([f(u1), f(v1)], -1).expand(-1, L, -1, -1)
        mine = torch.tensor(lay)[None, None, :] == torch.arange(L)[:, None]
        return rk.compact_soa(p0, p1, torch.tensor(draw)[:, None] & mine, k,
                              gran, h, t, w=w)
    packed = dict(edge_layer=torch.tensor(lay), n_layers=L,
                  w=w if split else None)
    draw = torch.tensor(draw)[:, None]
    if kind == "env":
        p0 = torch.stack([f(u0), f(v0)], -1)
        p1 = torch.stack([f(u1), f(v1)], -1)
        nxb = rk._n_xblocks(w) if split else 1
        return rk.compact_env_soa(p0, p1, draw, k * nxb, gran, h, t,
                                  **packed)
    return rk.compact_env_seg(f(u0), f(v0), f(u1), f(v1), draw, k, gran, h,
                              t, **packed)


def _copies(kind, bundle, geometry):
    """(words (B, n) band words, live copies per env, payload(env, c)) of
    the bundle's copies, as the plain version stamps them."""
    if kind == "env":
        ax, ay, abx, aby, inv, bw, counts = bundle
        return bw, counts[0], rk._soa_payload(ax, ay, abx, aby, inv)
    if kind == "frame":  # (B, L, k) slots: B*L one-layer envs
        *arrays, counts = bundle
        ax, ay, abx, aby, inv, bw = (x.reshape(-1, x.shape[-1])
                                     for x in arrays)
        return bw, counts[0], rk._soa_payload(ax, ay, abx, aby, inv)
    return rk._seg_copies(bundle, geometry)


def _boxes_hold_every_lit_pixel(kind, bundle, res, t, gran, split):
    """Every output pixel the plain version's stamps light lies in the box
    of the copy that lights it, and no stamped row leaves its frame's
    strip. Returns (lit pixels, box pixels, window pixels) over the live
    copies."""
    h, w = res
    geometry = rk._frame_geometry(res, gran, split)
    n_bands, hp, win, nxb, wb = geometry
    words, n, payload = _copies(kind, bundle, geometry)
    pad = rk.box_pad(t)
    # `_kernel_env`'s and `_kernel`'s rows; the segments' relative
    absolute = kind in ("env", "frame")
    current = []

    def bands():
        for item in rk._slot_bands(words, n, n_bands, win, gran, wb):
            current[:] = item
            yield item

    def box(env, c, rb, frame):
        ax, ay, abx, aby, _ = payload(env, c)
        word = words[env, c]
        y0 = ay - (frame * hp).float()
        return rk.copy_box(ax, y0, ax + abx, y0 + aby, pad, word & 511,
                           rb - frame * n_bands, frame % nxb, res, gran,
                           split)

    lit = 0
    lanes = torch.arange(wb)
    for env, frame, row, hit in rk._window_hits(
            bands(), payload, wb, gran, win, rk._stroke_params(t),
            absolute=absolute, device=words.device):
        _, c, rb, _, _, _, _ = current
        assert bool((row < hp).all()), "a stamp leaves its frame's strip"
        xlo, xhi, ylo, yhi = box(env, c, rb, frame)
        x = lanes[None, None, :]
        y = row[:, :, None]
        # only output pixels: rows [0, h), lanes of the frame
        out = (y < h) & ((frame % nxb)[:, None, None] * rk._XB + x < w)
        inside = ((x >= xlo[:, None, None]) & (x < xhi[:, None, None])
                  & (y >= ylo[:, None, None]) & (y < yhi[:, None, None]))
        lost = hit & out & ~inside
        assert not lost.any(), (
            f"{int(lost.sum())} lit pixels outside their copy's box, e.g. "
            f"env {int(env[lost.nonzero()[0, 0]])}")
        lit += int((hit & out).sum())

    # every live copy's box against its window
    live = ((torch.arange(words.shape[1])[None] < n[:, None])
            & ((words & 511) > 0))
    env, c = torch.nonzero(live, as_tuple=True)
    rb = words[env, c] >> 9
    xlo, xhi, ylo, yhi = box(env, c, rb, rb // n_bands)
    nb = words[env, c] & 511
    boxes = int(((xhi - xlo) * (yhi - ylo)).sum())
    windows = int((torch.clamp_min(nb, win // gran) * gran * wb).sum())
    return lit, boxes, windows


def _check(kind, segs, res, t, gran, split, k, box_share):
    bundle = _bundle(kind, segs, *res, t, gran, split, k)
    lit, boxes, windows = _boxes_hold_every_lit_pixel(kind, bundle, res, t,
                                                      gran, split)
    assert lit > 0
    assert boxes < box_share * windows
    return bundle


# (h, w): the lane split at 128x160, one lane block at 48x96 (w <= 128),
# a width that is not a multiple of 4 (150, two blocks)
SHAPES = [(128, 160), (48, 96), (64, 150)]


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("gran", [8, 16])
@pytest.mark.parametrize("kind", ["env", "seg", "frame"])
def test_box_holds_every_lit_pixel_random(kind, gran, t, h, w):
    """Random bundles, lane-split and (t >= 2: the t = 1 clip needs w,
    which splits the env and segment bundles' lanes) unsplit, the frame
    bundle unsplit at every t; the boxes hold under a third of the
    windows' pixels (the gran-8 windows are 16 rows)."""
    segs = _segments(100 * t + h + gran, 12, 100, h, w)
    splits = (True, False) if t > 1 else (True,)
    for split in (False,) if kind == "frame" else splits:
        _check(kind, segs, (h, w), t, gran, split, 100, 1 / 3)


@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("kind", ["env", "seg", "frame"])
def test_box_holds_every_lit_pixel_special(kind, t):
    """Vertical, horizontal and single-pixel segments, and near-plane
    clipped segments ~1e4 px long and beyond the 1e6 px clamp (at t = 1
    the compaction clips every segment to the frame, as cv2 does), at
    both band heights; the frame bundle unsplit. The long segments' boxes
    span their frames, so the boxes hold 38-65% of the windows' pixels
    here: fewer is all that is asked."""
    h, w = 128, 160
    for gran in (8, 16):
        _check(kind, _special(7 + t + gran, 8, 90, h, w), (h, w), t, gran,
               kind != "frame", 90, 1.0)


@pytest.mark.parametrize("kind", ["env", "seg", "frame"])
def test_box_holds_every_lit_pixel_480x640_unsplit(kind):
    """A 480x640 unsplit gran-8 bundle: a frame is one 640-lane strip, the
    kernels drain it in 48-row chunks."""
    h, w = 480, 640
    _check(kind, _segments(11, 4, 80, h, w), (h, w), 2, 8, False, 80, 0.1)


@pytest.mark.parametrize("gran", [8, 16])
@pytest.mark.parametrize("h,w", [(100, 300), (480, 640)])
def test_frame_box_holds_every_lit_pixel_t1_wide_unsplit(h, w, gran):
    """The frame bundle at t = 1 on frames wider than one lane block:
    unsplit, so the Bresenham stamp runs with absolute rows over a 300-
    and a 640-lane strip, its box padded by the margin alone."""
    _check("frame", _segments(31 + w + gran, 8, 100, h, w), (h, w), 1, gran,
           False, 100, 1 / 3)


def test_seg_slots_touching_one_two_and_all_blocks():
    """Segment slots of a 300-wide frame (three lane blocks) whose touch
    bits name one, two and all three blocks: each block's copy keeps its
    lit pixels in its box."""
    h, w = 100, 300
    u0, v0, u1, v1, draw, lay = _segments(23, 8, 90, h, w)
    # every third segment across the frame, -50 to w + 50
    u0[:, ::3], u1[:, ::3] = -50.0, w + 50.0
    v1[:, ::3] = v0[:, ::3] + 5.0
    segs = (u0, v0, u1, v1, draw, lay)
    for gran in (8, 16):
        bundle = _check("seg", segs, (h, w), 2, gran, True, 90, 0.5)
        idx, bw, counts = bundle[0], bundle[-2], bundle[-1]
        live = torch.arange(idx.shape[1] - 7)[None] < counts[0][:, None]
        word = torch.gather(bw, 1, idx[:, :-7].long())[live]
        blocks = sum((word >> j) & 1 for j in range(3))
        assert set(blocks.tolist()) == {1, 2, 3}


@pytest.mark.parametrize("mode", ["env", "cur", "seg", "full"])
def test_box_holds_every_lit_pixel_bench(mode):
    """8-env bundles of the rasterizer benchmark's modes (bench.py's
    config, t = 2): `env` and `full` unsplit at gran 8, `cur` lane-split
    and `seg` at gran 16; the boxes hold under a fifth of the windows'
    pixels."""
    from tinycarlo_torch.benchmarks import rasterize_bench as rb

    inputs = rb.Inputs("cpu", 8)
    per_layer = mode in ("env", "full")
    start = inputs.layer[0] if per_layer else inputs.packed[0]
    bundle, _ = rb.bundle(mode, inputs, start, 0)
    gran = rb.GRAN if per_layer else rb.GRAN_PACKED
    kind = {"seg": "seg", "full": "frame"}.get(mode, "env")
    lit, boxes, windows = _boxes_hold_every_lit_pixel(
        kind, bundle, (rb.H, rb.W), rb.THICK, gran, not per_layer)
    assert lit > 0
    assert boxes < 0.2 * windows
