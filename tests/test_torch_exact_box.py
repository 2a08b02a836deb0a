"""The exact kernel's box clipping loses no pixel.

The exact kernel (ops/csrc/exact.cu) paints only the pixels of each live
copy's box -- the bounding box of its two cap centres padded by the
stroke's extent and a one-pixel margin, clipped to the copy's stamped
bands and to its lane block's output lanes
(`rasterize_kernels.exact_copy_box` at `exact_box_pad(t)`, the rule of
exact.cu's `ExactCopies::box`) -- where the plain version
(`rasterize_masks_exact_env_plain`) evaluates the copy's whole window. The
two agree only if every output pixel that a copy lights in the plain
version lies inside that copy's box. This checks it on the port's exact
compaction bundles (equal to the JAX package's, tests/test_torch_exact.py),
on the CPU: random bundles at t = 2, 3, 5 and four frame shapes (one lane
block at 48x96, the lane split at 128x160, a width that is not a multiple
of 4, 480x640), with tall copies, deep-clipped and near-plane clipped
segments thousands of pixels long (some past the compaction's 1e6 px
clamp), vertical, horizontal and single-pixel segments, an oversubscribed
budget, and a real bench bundle; and that the boxes hold far fewer pixels
than the windows.
"""
import numpy as np
import pytest
import torch

from tinycarlo_torch.ops import rasterize_kernels as rk

L = 5


def _segments(seed, b, e, h, w, special=False):
    """Numpy-seeded segments on the packed (B, E) axis: short, long, tall,
    off-frame, deep-clipped (~400 px off frame) and block-crossing; env 0
    draws nothing. With `special`, every env also has vertical,
    horizontal and single-pixel segments and near-plane clipped ones,
    thousands of pixels long across the frame and far past the
    compaction's clamp."""
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(-40, w + 40, (b, e))
    v0 = rng.uniform(-40, h + 40, (b, e))
    u1 = u0 + rng.uniform(-90, 90, (b, e))
    v1 = v0 + rng.uniform(-60, 60, (b, e))
    far = rng.random((b, e)) < 0.3
    u0, v0, u1, v1 = (np.where(far, rng.uniform(-400, s + 400, (b, e)), x)
                      for s, x in zip((w, h, w, h), (u0, v0, u1, v1)))
    v1[:, -4:] = v0[:, -4:] + 3.0 * h  # tall copies, with tail bands
    draw = rng.random((b, e)) < 0.7
    if special:
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
        draw[:, :5 * n] = True
    draw[0] = False
    lay = rng.integers(0, L, e).astype(np.int32)
    return u0, v0, u1, v1, draw, lay


def _bundle(segs, h, w, t, k_per_block):
    u0, v0, u1, v1, draw, lay = segs
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return rk.compact_env_exact_soa(
        f(u0), f(v0), f(u1), f(v1), torch.tensor(draw),
        k_per_block * rk._n_xblocks(w), h, t, edge_layer=torch.tensor(lay),
        n_layers=L, w=w,
    )


def _boxes_hold_every_lit_pixel(bundle, res, t):
    """Every output pixel the plain version's stamps light lies in the
    box of the copy that lights it. Returns (lit pixels, box pixels,
    window pixels) over the live copies."""
    idx, fields, counts = bundle
    h, w = res
    n_bands, hp, win, nxb, wb = rk._frame_geometry(res)
    pad = rk.exact_box_pad(t)
    table = torch.stack(fields, dim=-1)  # (B, LE, 30)
    xi = torch.arange(wb, dtype=torch.int32)[None, None]
    lit = 0
    for env, e, rb, _, frame, rr, row in rk._live_bands(
            idx, fields[-1], counts, n_bands, win):
        f = table[env, e]
        yi = (rb[:, None] * rk._GRAN + rr).to(torch.int32)[:, :, None]
        hit = rk._exact_hit_plain(xi, yi, f[:, None, None, :], t)
        xlo, xhi, ylo, yhi = rk.exact_copy_box(f[:, 22], f[:, 23], f[:, 29],
                                               pad, res)
        xb = frame % nxb
        x = xi.long()
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

    k = idx.shape[1] - 7
    env, slot = torch.nonzero(torch.arange(k)[None] < counts[0][:, None],
                              as_tuple=True)
    f = table[env, idx[env, slot].long()]
    xlo, xhi, ylo, yhi = rk.exact_copy_box(f[:, 22], f[:, 23], f[:, 29], pad,
                                           res)
    nb = f[:, 29] & 511
    box = int(((xhi - xlo) * (yhi - ylo) * (nb > 0)).sum())
    window = int((torch.clamp_min(nb, win // rk._GRAN) * rk._GRAN * wb
                  * (nb > 0)).sum())
    return lit, box, window


# (h, w): one lane block at 48x96, the lane split at 128x160, a width that
# is not a multiple of 4 (150, two blocks)
SHAPES = [(48, 96), (128, 160), (100, 150)]


@pytest.mark.parametrize("t", [2, 3, 5])
@pytest.mark.parametrize("h,w", SHAPES)
def test_exact_box_holds_every_lit_pixel_random(t, h, w):
    bundle = _bundle(_segments(100 * t + h, 8, 60, h, w), h, w, t, 60)
    lit, box, window = _boxes_hold_every_lit_pixel(bundle, (h, w), t)
    assert lit > 0
    assert box < 0.3 * window


@pytest.mark.parametrize("t", [2, 5])
def test_exact_box_holds_every_lit_pixel_480x640(t):
    """480x640, five lane blocks and 30 bands. Its tall copies cross the
    whole frame diagonally, up to 90 px wide, so their boxes take most of
    their lane block's rows."""
    h, w = 480, 640
    bundle = _bundle(_segments(17 + t, 3, 30, h, w), h, w, t, 30)
    lit, box, window = _boxes_hold_every_lit_pixel(bundle, (h, w), t)
    assert lit > 0
    assert box < 0.5 * window


@pytest.mark.parametrize("t", [2, 3, 5])
def test_exact_box_holds_every_lit_pixel_special(t):
    """Vertical, horizontal and single-pixel segments and near-plane
    clipped segments ~1e4 px long and beyond the 1e6 px clamp, with an
    oversubscribed budget (8 slots a lane block for up to 60 copies)."""
    h, w = 128, 160
    bundle = _bundle(_segments(7 + t, 6, 60, h, w, special=True), h, w, t, 8)
    assert int(bundle[-1][3].sum()) > 0  # copies dropped
    lit, box, window = _boxes_hold_every_lit_pixel(bundle, (h, w), t)
    assert lit > 0 and box < window


def test_exact_box_holds_every_lit_pixel_bench():
    """A real 8-env exact bundle of bench.py's workload (its CONFIG with
    `stroke: exact`, t = 2), where the boxes hold under a fifth of the
    windows' pixels."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.benchmarks import bench as pbench

    cfg = dict(pbench.CONFIG, camera=dict(pbench.CONFIG["camera"],
                                          stroke="exact"))
    params = fenv.make_env_params(cfg, device="cpu")
    vstate, _ = vector.reset(params, 8, seed=3, render=False)
    md = params.map_data
    h, w = res = tuple(params.cfg.camera.resolution)
    t = params.cfg.camera.line_thickness
    u0, v0, u1, v1, draw = fenv._project_packed_batch_soa(params, vstate.env)
    bundle = rk.compact_env_exact_soa(
        u0, v0, u1, v1, draw,
        params.cfg.camera.max_visible_segments * rk._n_xblocks(w), h, t,
        edge_layer=md.packed_edge_layer, n_layers=md.n_layers, w=w,
        layer_bounds=md.packed_layer_bounds,
    )
    lit, box, window = _boxes_hold_every_lit_pixel(bundle, res, t)
    assert lit > 0
    assert box < 0.2 * window
