"""The exact cv2 stroke (`stroke="exact"` at t >= 2) of tinycarlo_torch
against the JAX package: ops/cv2_stroke.py's params and predicate, the host
oracle and the dense rasterizer against cv2, `compact_env_exact_soa`, the
exact kernel's plain version against the Pallas `_kernel_env_exact` in
interpret mode (tests/test_torch_exact_kernel.py; the whole route and an
env rollout in tests/test_torch_exact_env.py), and `segment_overflow`
under exact.

Tolerances:
- float64: equal, element for element and bit for bit (every intermediate
  of the stroke is exact in float64, and both packages are cv2's).
- float32: equal except in segments that XLA's compiled float32 arithmetic
  rounds differently from torch, which rounds every operation to nearest
  even (`f32_exceptions`):
  (a) XLA's CPU backend compiles the quad's `th / sqrt(r2)`
      (cv2_stroke.py:474-476) as `th * rsqrt(r2)` with its own rsqrt, up
      to 2 ulp from the correctly rounded quotient; dp = rint(d * rr) then
      moves by one in 0.13% / 0.21% / 0.49% of the segments at t = 2 / 3 /
      5 (measured on 40000 segments of `int_endpoints`);
  (b) in frames wider or taller than ~250 px (480x640), 16.16 fixed-point
      corners pass 2^24, and XLA's fused int32 -> float32 conversions of
      them (before the outline clip) do not always round to nearest even:
      seen as one float32 ulp (2/65536 px) in an outline's v0 inside the
      jitted compaction, and not in a standalone jit of the same segment
      set -- XLA's result depends on how it fuses and vectorizes.
  In such a segment every field derived from the quad may differ; all
  other segments are equal in every field. At 128x160 (the bench shape)
  only (a) can occur.
- The plain version fed JAX's own bundle: equal bit for bit in uint8;
  float32 is exactly (uint8 > 0) as 0/1 (the Pallas kernel's float output
  is 0/255, ROADMAP F0).

The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinycarlo_torch.ops import cv2_stroke as pcs
from tinycarlo_torch.ops import rasterize as pras
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_tpu.ops import cv2_stroke as jcs
from tinycarlo_tpu.ops import rasterize_pallas as rp

# the pinned segment whose direction-swapped clipped outline edge needs
# its normalized-far dot (tests/test_rasterize_pallas.py:666-670)
PINNED = (150.0, -151.0, -378.0, 406.0)


def int_endpoints(seed, n, dtype):
    """Integer endpoints (n, 4) over four coordinate domains, with
    horizontal, vertical and zero-length segments (ties of the quad's top
    vertex) and the pinned segment first."""
    rng = np.random.default_rng(seed)
    dom = np.repeat([60, 300, 100_000, 1_000_000], -(-n // 4))[:n, None]
    seg = np.floor(rng.uniform(-1, 1, (n, 4)) * dom)
    q = n // 8
    seg[:q, 3] = seg[:q, 1]  # horizontal
    seg[q:2 * q, 2] = seg[q:2 * q, 0]  # vertical
    seg[2 * q:3 * q, 2:] = seg[2 * q:3 * q, :2]  # a point
    seg[0] = PINNED
    return seg.astype(dtype)


def exact_segments(seed, b, e, h, w, n_layers, dtype=np.float64):
    """(B, 1, E) segments in the two regimes of
    tests/test_rasterize_pallas.py:653-678 -- near-frame correlated
    endpoints and deep-clipped independent ones (~400 px off frame) -- with
    the pinned segment at env 1, edge 0 and env 0 drawing nothing."""
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(-40, w + 60, (b, 1, e))
    v0 = rng.uniform(-40, h + 40, (b, 1, e))
    u1 = u0 + rng.uniform(-80, 80, (b, 1, e))
    v1 = v0 + rng.uniform(-40, 40, (b, 1, e))
    deep = rng.random((b, 1, e)) < 0.5
    u0 = np.where(deep, rng.uniform(-400, w + 400, (b, 1, e)), u0)
    v0 = np.where(deep, rng.uniform(-400, h + 400, (b, 1, e)), v0)
    u1 = np.where(deep, rng.uniform(-400, w + 400, (b, 1, e)), u1)
    v1 = np.where(deep, rng.uniform(-400, h + 400, (b, 1, e)), v1)
    u0[1, 0, 0], v0[1, 0, 0], u1[1, 0, 0], v1[1, 0, 0] = PINNED
    draw = rng.random((b, 1, e)) < 0.8
    draw[1, 0, 0] = True
    draw[0] = False
    lay = rng.integers(0, n_layers, e).astype(np.int32)
    f = lambda x: x.astype(dtype)  # noqa: E731
    return f(u0), f(v0), f(u1), f(v1), draw, lay


def _flat_params(p):
    """thick_params' dict as {name: numpy array}, the edges' fields as
    e0.acc, e0.m0, ..."""
    out = {}
    for k, v in p.items():
        if k == "edges":
            for i, ed in enumerate(v):
                out.update({f"e{i}.{n}": x for n, x in _flat_params(ed).items()})
        else:
            out[k] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


@partial(jax.jit, static_argnums=(4, 5))
def _jax_quad_dp(ax, ay, bx, by, t, res):
    """The JAX package's quad offsets (dpx, dpy) as its jitted
    thick_params computes them (cv2_stroke.py:455-478)."""
    h, w = res
    x1, y1, x2, y2, _ = jcs._clip_f(w - 1 + 2 * t, h - 1 + 2 * t, ax + t,
                                    ay + t, bx + t, by + t)
    dxf = ((x1 - t).astype(jnp.int32) - (x2 - t).astype(jnp.int32)).astype(
        ax.dtype)
    dyf = ((y2 - t).astype(jnp.int32) - (y1 - t).astype(jnp.int32)).astype(
        ax.dtype)
    r2 = dxf * dxf + dyf * dyf
    num = ax.dtype.type(t << 15) + ax.dtype.type((t & 1) * 32768.0)
    rr = num / jnp.sqrt(jnp.where(r2 > 0, r2, ax.dtype.type(1)))
    return jnp.rint(dyf * rr).astype(jnp.int32), jnp.rint(dxf * rr).astype(
        jnp.int32)


def _torch_quad_dp(ax, ay, bx, by, t, res):
    """The port's quad offsets (dpx, dpy), as its thick_params computes
    them."""
    h, w = res
    x1, y1, x2, y2, _ = pcs._clip_f(w - 1 + 2 * t, h - 1 + 2 * t, ax + t,
                                    ay + t, bx + t, by + t)
    dxf = ((x1 - t).to(torch.int32) - (x2 - t).to(torch.int32)).to(ax.dtype)
    dyf = ((y2 - t).to(torch.int32) - (y1 - t).to(torch.int32)).to(ax.dtype)
    r2 = dxf * dxf + dyf * dyf
    rr = (float(t << 15) + (t & 1) * 32768.0) / torch.sqrt(
        torch.where(r2 > 0, r2, torch.ones((), dtype=ax.dtype)))
    return (torch.round(dyf * rr).to(torch.int32).numpy(),
            torch.round(dxf * rr).to(torch.int32).numpy())


def f32_exceptions(ends, t, res):
    """(n,) bool: the float32 segments that may differ (module docstring):
    (a) those whose quad offset dp the JAX package (XLA's rsqrt) and the
    port (sqrt, then divide) round to different integers -- asserted to
    differ by one at most, in under 3% of the segments -- and (b) those
    with a fixed-point quad corner past 2^24. None in float64."""
    if ends.dtype == np.float64:
        return np.zeros(ends.shape[:-1], bool)
    cols = [ends[..., i] for i in range(4)]
    jx, jy = (np.asarray(x) for x in _jax_quad_dp(
        *(jnp.asarray(c) for c in cols), t, res))
    px, py = _torch_quad_dp(*(torch.from_numpy(np.ascontiguousarray(c))
                              for c in cols), t, res)
    assert np.abs(jx - px).max() <= 1 and np.abs(jy - py).max() <= 1
    moved = (jx != px) | (jy != py)
    assert moved.mean() < 0.03, moved.mean()
    p = pcs.thick_params(*(torch.from_numpy(np.ascontiguousarray(c))
                           for c in cols), t, res)
    big = np.zeros_like(moved)
    for c, d in (("x", px), ("y", py)):
        for end in ("cap0", "cap1"):
            fixed = p[end + c].numpy().astype(np.int64) << 16
            big |= np.abs(fixed) + np.abs(d) >= 1 << 24
    # the integer pre-clip keeps the accepted corners of frames under
    # ~250 px in range (a rejected segment keeps its endpoints and draws
    # nothing)
    assert max(res) >= 250 or not (big & p["accept"].numpy()).any()
    return moved | big


def _assert_params_equal(got, want, moved):
    """Every field equal (values and dtype), except in the `moved`
    segments (see f32_exceptions)."""
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g[~moved], w[~moved], err_msg=name)


def jax_call(fn, dtype, static, *args, **kwargs):
    """fn(*args, **kwargs, **static) of the JAX package: op by op in
    float64, where every intermediate is exact, so the bits are the
    compiled function's and the per-operation compiles are shared by the
    cases of this file (a compile per case would dominate its time);
    compiled in float32, where XLA's fusion is what the float32 rules
    above describe."""
    fn = partial(fn, **static)
    if dtype == np.float64:
        with jax.disable_jit():
            return fn(*args, **kwargs)
    return jax.jit(fn)(*args, **kwargs)


# float32 once at the bench's 128x160 (rule (a)); rule (b) at 480x640 is
# held by the float32 480x640 case of test_exact_bundle_equal
@pytest.mark.parametrize("dtype,t,res", [
    (np.float64, 2, (128, 160)), (np.float64, 3, (48, 96)),
    (np.float64, 5, (480, 640)), (np.float32, 2, (128, 160)),
])
def test_thick_params_and_hit_match_jax(dtype, t, res):
    """thick_params field for field, and in float64 thick_hit pixel for
    pixel on a 48x64 corner of the frame."""
    ends = int_endpoints(t, 2048, dtype)
    cols = [ends[:, i] for i in range(4)]
    want = jax_call(jcs.thick_params, dtype,
                    dict(thickness=t, resolution=res),
                    *(jnp.asarray(c) for c in cols))
    got = pcs.thick_params(*(torch.from_numpy(c.copy()) for c in cols), t,
                           res)
    moved = f32_exceptions(ends, t, res)
    _assert_params_equal(_flat_params(got), _flat_params(want), moved)
    if dtype == np.float32:
        return
    ys = np.arange(48, dtype=dtype)[:, None, None]
    xs = np.arange(64, dtype=dtype)[None, :, None]
    n = 256
    sub = lambda p: jax.tree.map(lambda x: x[:n], p)  # noqa: E731
    jhit = np.asarray(jax.jit(partial(jcs.thick_hit, thickness=t))(
        jnp.asarray(xs), jnp.asarray(ys), sub(want)))
    phit = pcs.thick_hit(torch.from_numpy(xs), torch.from_numpy(ys),
                         {k: (v[:n] if torch.is_tensor(v) else
                              [{a: b[:n] for a, b in e.items()} for e in v])
                          for k, v in got.items()}, t).numpy()
    np.testing.assert_array_equal(phit, jhit)
    assert jhit.any()


def test_first_strict_minimum_on_ties():
    """The quad's top vertex is the first strict minimum of the four
    fixed-point ys, as jnp.argmin picks it: ties pick the lowest index."""
    ys = torch.tensor([[5, 5, 5, 5], [3, 1, 1, 2], [2, 3, 2, 0],
                       [-7, -7, 0, -7]], dtype=torch.int32)
    got = pcs._first_min_index(list(ys.T))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.argmin(jnp.asarray(ys.numpy()), -1)))


@pytest.mark.parametrize("t", [2, 3, 5])
def test_host_oracle_and_dense_match_cv2(t):
    """The port's copy of the host oracle, and its dense exact rasterizer
    on multi-segment layers (off-frame and far-off-frame endpoints), equal
    cv2.polylines bit for bit (tests/test_cv2_stroke.py:22-93)."""
    cv2 = pytest.importorskip("cv2")
    h, w = 48, 64

    def cv2_mask(segs):
        img = np.zeros((h, w), np.uint8)
        for p0, p1 in segs:
            cv2.polylines(img, [np.array([p0, p1], np.int32)], False, 255, t)
        return img > 0

    ends = int_endpoints(10 + t, 48, np.float64).astype(np.int64)
    ends[3::4] = ends[3::4] % 300 - 60
    for a in ends:
        got = pcs.thick_stroke_mask_ref(a[:2], a[2:], t, (h, w))
        np.testing.assert_array_equal(got, cv2_mask([(a[:2], a[2:])]),
                                      err_msg=str(a))
    rng = np.random.default_rng(t + 20)
    for _ in range(6):
        p0 = rng.integers(-60, 240, (1, 8, 2)).astype(np.float64)
        p1 = rng.integers(-60, 240, (1, 8, 2)).astype(np.float64)
        draw = rng.random((1, 8)) < 0.8
        dense = pras.rasterize_masks(
            torch.from_numpy(p0), torch.from_numpy(p1),
            torch.from_numpy(draw), (h, w), t, stroke="exact",
        )
        want = cv2_mask([(p0[0, i], p1[0, i]) for i in range(8)
                         if draw[0, i]])
        np.testing.assert_array_equal(dense[0].numpy() > 0, want)


def bundles(segs, k_per_block, h, w, t, n_layers, layer_bounds=None):
    """(JAX bundle, port bundle) of compact_env_exact_soa as numpy: (idx,
    30 fields, counts). The inputs carry JAX's (B, 1, E) packed layout."""
    u0, v0, u1, v1, draw, lay = segs
    k = k_per_block * rk._n_xblocks(w)
    jidx, jfields, jcounts = jax_call(
        rp.compact_env_exact_soa, u0.dtype.type,
        dict(k=k, gran=16, h=h, thickness=t, n_layers=n_layers, w=w,
             layer_bounds=layer_bounds),
        *(jnp.asarray(x) for x in (u0, v0, u1, v1, draw)),
        edge_layer=jnp.asarray(lay),
    )
    pidx, pfields, pcounts = rk.compact_env_exact_soa(
        *(torch.from_numpy(np.ascontiguousarray(x[:, 0]))
          for x in (u0, v0, u1, v1, draw)),
        k, h, t, edge_layer=torch.from_numpy(lay), n_layers=n_layers, w=w,
        layer_bounds=layer_bounds,
    )
    want = (np.asarray(jidx), [np.asarray(f) for f in jfields],
            np.asarray(jcounts))
    got = (pidx.numpy(), [f.numpy() for f in pfields], pcounts.numpy())
    return want, got


def assert_exact_bundles_equal(got, want, segs, t, res):
    """idx and counts equal; the 30 fields equal at every copy, except the
    copies of `f32_exceptions`' segments."""
    u0, v0, u1, v1 = (x[:, 0] for x in segs[:4])
    ends = np.stack([u0, v0, u1, v1], -1)
    ends = np.trunc(np.clip(ends, -1e6, 1e6)).astype(ends.dtype)
    moved = f32_exceptions(ends.reshape(-1, 4), t, res).reshape(u0.shape)
    nxb = rk._n_xblocks(res[1])
    moved = np.repeat(moved, nxb, axis=-1)  # (B, E*nxb) copies
    for name, g, w in (("idx", got[0], want[0]), ("counts", got[2], want[2])):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert len(got[1]) == len(want[1]) == rk.EXACT_FIELDS
    for i, (g, w) in enumerate(zip(got[1], want[1])):
        assert g.dtype == w.dtype == np.int32, i
        np.testing.assert_array_equal(g[~moved], w[~moved], err_msg=str(i))


# (dtype, t, h, w, k per block): the lane split off (w = 96) and on (160,
# 640), 480x640 (the largest frame the packed fields must hold), and an
# oversubscribed budget; float32 once, at 480x640 (both float32 rules)
BUNDLE_CASES = [
    (np.float64, 2, 48, 160, 40), (np.float64, 3, 48, 96, 40),
    (np.float64, 5, 480, 640, 40), (np.float64, 2, 32, 160, 6),
    (np.float32, 5, 480, 640, 6),
]


@pytest.mark.parametrize("dtype,t,h,w,kb", BUNDLE_CASES)
def test_exact_bundle_equal(dtype, t, h, w, kb):
    segs = exact_segments(100 + t + w, 6, 40, h, w, 5, dtype)
    want, got = bundles(segs, kb, h, w, t, 5)
    assert_exact_bundles_equal(got, want, segs, t, (h, w))
    assert want[2][0].max() > 0 and want[2][0, 0] == 0  # env 0 is empty
    assert (want[2][3].sum() > 0) == (kb < 40)  # dropped copies


def test_segment_overflow_exact_equal():
    """segment_overflow with the exact stroke's wider extent equals the
    JAX package's, on segments where that extent is what drops copies."""
    h, w, t = 48, 160, 3
    u0, v0, u1, v1, draw, _ = exact_segments(9, 6, 40, h, w, 5, np.float32)
    p0 = np.stack([u0[:, 0], v0[:, 0]], -1)
    p1 = np.stack([u1[:, 0], v1[:, 0]], -1)
    for budget, stroke in ((6, "exact"), (6, "fast"), (40, "exact")):
        want = np.asarray(rp.segment_overflow(
            jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(draw[:, 0]),
            (h, w), t, budget, stroke=stroke,
        ))
        got = rk.segment_overflow(
            torch.from_numpy(p0), torch.from_numpy(p1),
            torch.from_numpy(draw[:, 0]), (h, w), t, budget, stroke=stroke,
        ).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want.sum() > 0) == (budget == 6)


def test_exact_wrapper_dispatch_and_binding():
    """On CPU tensors the exact wrapper takes the plain version and counts
    no launch; ExactKernel.ARGTYPES follows tc_exact_launch's parameter
    list in exact.cu one for one; the rank route refuses the exact stroke
    and names the masks route."""
    from tests.test_torch_masks import c_argtypes

    assert c_argtypes("exact.cu", "tc_exact_launch") == rk.ExactKernel.ARGTYPES
    h, w, t, L = 32, 160, 2, 3
    u0, v0, u1, v1, draw, lay = exact_segments(3, 3, 12, h, w, L)
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x[:, 0]))  # noqa
    bundle = rk.compact_env_exact_soa(
        f(u0), f(v0), f(u1), f(v1), f(draw), 24, h, t,
        edge_layer=torch.from_numpy(lay), n_layers=L, w=w,
    )
    before = rk.exact_kernel.launches
    out = rk.exact_kernel(bundle, L, (h, w), t)
    assert rk.exact_kernel.launches == before
    assert torch.equal(out, rk.rasterize_masks_exact_env_plain(
        bundle, L, (h, w), t))
    with pytest.raises(ValueError, match="masks route"):
        rk.rasterize_rank_packed_soa(f(u0), f(v0), f(u1), f(v1), f(draw),
                                     torch.from_numpy(lay), L, (h, w), t,
                                     stroke="exact")
