"""The masks kernel's box clipping loses no pixel.

The masks and rank kernels (ops/csrc/masks.cu, rank.cu) test only the
pixels of each live copy's box -- its segment's bounding box padded by the
stroke's reach and a one-pixel margin, clipped to the copy's stamped bands
and to its lane block's output lanes (`rasterize_kernels.copy_box` at
`box_pad(t)`, the rule of stamp.cuh's `copy_box`) -- where the plain
versions (`rasterize_masks_env_plain`, `rasterize_rank_env_plain`)
evaluate the copy's whole window. They agree only if every output pixel
that a copy lights in the plain version lies inside that copy's box. This
checks it on the port's compaction
bundles (equal to the JAX package's, tests/test_torch_compaction.py), on
the CPU: random bundles at t = 1, 2, 3 and three frame shapes (the lane
split at 128x160, one lane block at 48x96, a width that is not a
multiple of 4), tall copies, near-plane clipped segments thousands of
pixels long (some past the compaction's 1e6 px clamp), vertical,
horizontal and single-pixel segments, and a real bench bundle; and that
the boxes hold far fewer pixels than the windows.
"""
import numpy as np
import pytest
import torch

from tinycarlo_torch.ops import rasterize_kernels as rk

L = 5


def _segments(seed, b, e, h, w):
    """Numpy-seeded segments on the packed (B, E) axis: short, long, tall,
    off-frame and block-crossing; env 0 draws nothing."""
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(-40, w + 40, (b, e))
    v0 = rng.uniform(-40, h + 40, (b, e))
    u1 = u0 + rng.uniform(-90, 90, (b, e))
    v1 = v0 + rng.uniform(-60, 60, (b, e))
    draw = rng.random((b, e)) < 0.7
    draw[0] = False
    lay = rng.integers(0, L, e).astype(np.int32)
    return u0, v0, u1, v1, draw, lay


def _special(seed, b, e, h, w):
    """`_segments` with, in every env, vertical, horizontal and
    single-pixel segments, and near-plane clipped ones: thousands of
    pixels long across the frame, and far past the compaction's clamp."""
    u0, v0, u1, v1, draw, lay = _segments(seed, b, e, h, w)
    rng = np.random.default_rng(seed + 1)
    n = e // 6
    cx = rng.uniform(0, w, (b, n))
    cy = rng.uniform(0, h, (b, n))
    s = slice(0, n)  # vertical
    u0[:, s], u1[:, s] = cx, cx
    v0[:, s], v1[:, s] = cy - 40, cy + 40
    s = slice(n, 2 * n)  # horizontal
    u0[:, s], u1[:, s] = cx - 60, cx + 60
    v0[:, s], v1[:, s] = cy, cy
    s = slice(2 * n, 3 * n)  # single pixel
    u0[:, s], u1[:, s] = cx, cx
    v0[:, s], v1[:, s] = cy, cy
    s = slice(3 * n, 4 * n)  # clipped at the near plane: ~1e4 px
    u0[:, s], v0[:, s] = cx - 5e3, cy + rng.uniform(-3e3, 3e3, (b, n))
    u1[:, s], v1[:, s] = cx + 7e3, cy + rng.uniform(-3e3, 3e3, (b, n))
    s = slice(4 * n, 5 * n)  # beyond the 1e6 px clamp
    u0[:, s], v0[:, s] = cx - 3e7, cy - 2e6
    u1[:, s], v1[:, s] = cx + 4e6, cy + 5e7
    draw[1:, :5 * n] = True
    return u0, v0, u1, v1, draw, lay


def _bundle(segs, h, w, t, k_per_block):
    u0, v0, u1, v1, draw, lay = segs
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return rk.compact_env_idx_soa(
        f(u0), f(v0), f(u1), f(v1), torch.tensor(draw),
        k_per_block * rk._n_xblocks(w), h, t, edge_layer=torch.tensor(lay),
        n_layers=L, w=w,
    )


def _boxes_hold_every_lit_pixel(bundle, res, t):
    """Every output pixel the plain version's stamps light lies in the
    box of the copy that lights it. Returns (lit pixels, box pixels,
    window pixels, the largest nb) over the live copies."""
    idx, ax, ay, abx, aby, inv, bw, counts = bundle
    h, w = res
    n_bands, hp, win, nxb, wb = rk._frame_geometry(res)
    pad = rk.box_pad(t)
    current = []

    def bands():
        for item in rk._live_bands(idx, bw, counts, n_bands, win):
            current[:] = item
            yield item

    def payload(env, e):
        return ax[env, e], ay[env, e], abx[env, e], aby[env, e], inv[env, e]

    lit = 0
    lanes = torch.arange(wb)
    for env, frame, row, hit in rk._window_hits(
            bands(), payload, wb, rk._GRAN, win, rk._stroke_params(t),
            absolute=False, device=ax.device):
        _, e, rb, _, _, _, _ = current
        word = bw[env, e]
        nb = word & 511
        b0 = rb - frame * n_bands
        xb = frame % nxb
        x0 = ax[env, e]
        y0 = ay[env, e] - (frame * hp).float()
        xlo, xhi, ylo, yhi = rk.copy_box(x0, y0, x0 + abx[env, e],
                                         y0 + aby[env, e], pad, nb, b0, xb,
                                         res)
        x = lanes[None, None, :]
        y = row[:, :, None]
        # only output pixels: rows [0, h), lanes of the frame
        out = (y < h) & (xb[:, None, None] * rk._XB + x < w)
        inside = ((x >= xlo[:, None, None]) & (x < xhi[:, None, None])
                  & (y >= ylo[:, None, None]) & (y < yhi[:, None, None]))
        lost = hit & out & ~inside
        assert not lost.any(), (
            f"{int(lost.sum())} lit pixels outside their copy's box, e.g. "
            f"env {int(env[lost.nonzero()[0, 0]])}")
        lit += int((hit & out).sum())

    env, e, nb, frame, b0, xb = _live(bundle, res)
    x0 = ax[env, e]
    y0 = ay[env, e] - (frame * hp).float()
    xlo, xhi, ylo, yhi = rk.copy_box(x0, y0, x0 + abx[env, e],
                                     y0 + aby[env, e], pad, nb, b0, xb, res)
    box = int(((xhi - xlo) * (yhi - ylo)).sum())
    window = int((torch.clamp_min(nb, win // rk._GRAN) * rk._GRAN * wb).sum())
    return lit, box, window, int(nb.max()) if nb.numel() else 0


def _live(bundle, res):
    """(env, copy, nb, frame, b0, xb) of the bundle's live slots."""
    idx, _, _, _, _, _, bw, counts = bundle
    n_bands, _, _, nxb, _ = rk._frame_geometry(res)
    k = idx.shape[1] - 7
    env, slot = torch.nonzero(torch.arange(k)[None] < counts[0][:, None],
                              as_tuple=True)
    e = idx[env, slot].long()
    word = bw[env, e]
    frame = (word >> 9) // n_bands
    return (env, e, word & 511, frame, (word >> 9) - frame * n_bands,
            frame % nxb)


# (h, w): the lane split at 128x160, one lane block at 48x96 (w <= 128),
# a width that is not a multiple of 4 (150, two blocks)
SHAPES = [(128, 160), (48, 96), (64, 150)]


@pytest.mark.parametrize("t", [1, 2, 3])
@pytest.mark.parametrize("h,w", SHAPES)
def test_box_holds_every_lit_pixel_random(t, h, w):
    bundle = _bundle(_segments(100 * t + h, 16, 120, h, w), h, w, t, 120)
    lit, box, window, max_nb = _boxes_hold_every_lit_pixel(bundle, (h, w), t)
    assert lit > 0
    assert max_nb > 2  # tall copies, with tail bands
    assert box < 0.25 * window


@pytest.mark.parametrize("t", [1, 2, 3])
def test_box_holds_every_lit_pixel_special(t):
    """Vertical, horizontal and single-pixel segments, and near-plane
    clipped segments ~1e4 px long and beyond the 1e6 px clamp (at t = 1
    the compaction clips every segment to the frame, as cv2 does)."""
    h, w = 128, 160
    bundle = _bundle(_special(7 + t, 8, 90, h, w), h, w, t, 90)
    idx, ax, ay, abx, aby, inv, bw, counts = bundle
    env, e, nb, _, _, _ = _live(bundle, (h, w))
    longest = float((abx[env, e].abs() + aby[env, e].abs()).max())
    assert longest > 4096 if t > 1 else longest <= h + w
    lit, box, window, _ = _boxes_hold_every_lit_pixel(bundle, (h, w), t)
    assert lit > 0 and box < window


def test_box_holds_every_lit_pixel_bench():
    """A real 8-env bundle of bench.py's workload (its CONFIG, t = 2), where
    the boxes hold under a fifth of the windows' pixels."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.benchmarks import bench as pbench

    params = fenv.make_env_params(pbench.CONFIG, device="cpu")
    vstate, _ = vector.reset(params, 8, seed=3, render=False)
    md = params.map_data
    h, w = res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    nxb = rk._n_xblocks(w)
    u0, v0, u1, v1, draw = fenv._project_packed_batch_soa(params, vstate.env)
    bundle = rk.compact_env_idx_soa(
        u0, v0, u1, v1, draw, params.cfg.camera.max_visible_segments * nxb,
        h, t, edge_layer=md.packed_edge_layer, n_layers=md.n_layers, w=w,
        layer_bounds=md.packed_layer_bounds,
    )
    lit, box, window, _ = _boxes_hold_every_lit_pixel(bundle, res, t)
    assert lit > 0
    assert box < 0.2 * window
