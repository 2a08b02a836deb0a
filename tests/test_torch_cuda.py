"""The port's CUDA kernels against their plain PyTorch versions on the
card, and the headline bench's CUDA graph against eager steps. These
tests need an NVIDIA GPU and nvcc and skip without them: a
CUDA kernel has no CPU mode (the CPU tests hold the plain versions against
the JAX package instead).

This file imports neither JAX nor anything of tests/, so on a GPU machine
without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Each test carries the `cuda` marker (registered in pytest.ini), which
that command selects.
"""
import numpy as np
import pytest
import torch

from tinycarlo_torch.ops import probe_kernels as pk
from tinycarlo_torch.ops import rasterize as ras
from tinycarlo_torch.ops import rasterize_kernels as rk

pytestmark = pytest.mark.cuda


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels are CUDA-only")


def _segments(seed, b, e, h, w, n_layers, dev):
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(-40, w + 40, (b, e))
    v0 = rng.uniform(-40, h + 40, (b, e))
    u1 = u0 + rng.uniform(-90, 90, (b, e))
    v1 = v0 + rng.uniform(-60, 60, (b, e))
    draw = rng.random((b, e)) < 0.7
    draw[0] = False  # an env with nothing to draw
    lay = np.sort(rng.integers(0, n_layers, e)).astype(np.int32)
    f = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa
    return (f(u0), f(v0), f(u1), f(v1), torch.tensor(draw, device=dev),
            torch.tensor(lay, device=dev))


# (t, h, w, k per block): t=1 exact Bresenham, the split stroke at t=2/3,
# the lane split at w=160, h=30 (not a multiple of the 16-row band), an
# oversubscribed budget, and 480x640, whose strip needs more than the
# default 48 KB of shared memory.
CASES = [(1, 128, 160, 100), (2, 30, 48, 100), (3, 64, 160, 6),
         (2, 128, 160, 100), (2, 480, 640, 100)]


@pytest.mark.parametrize("t,h,w,kb", CASES)
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
def test_masks_kernel_matches_plain(t, h, w, kb, out_dtype):
    """Bit-equal (the kernel is built with -fmad=false)."""
    _require_cuda()
    L, E = 5, 100
    u0, v0, u1, v1, draw, lay = _segments(t * 7 + h, 48, E, h, w, L, "cuda")
    bundle = rk.compact_env_idx_soa(
        u0, v0, u1, v1, draw, kb * rk._n_xblocks(w), h, t, edge_layer=lay,
        n_layers=L, w=w,
    )
    before = rk.masks_kernel.launches
    got = rk.masks_kernel(bundle, L, (h, w), t, out_dtype=out_dtype)
    assert rk.masks_kernel.launches == before + 1
    want = rk.rasterize_masks_env_plain(bundle, L, (h, w), t,
                                        out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (48, L, h, w)
    assert torch.equal(got, want)
    assert want.sum() > 0 and not want[0].any()


def test_packed_entry_launches_kernel():
    """rasterize_masks_packed_soa on CUDA tensors goes through the kernel,
    which checks its inputs and raises instead of falling back."""
    _require_cuda()
    L, E, h, w = 5, 100, 64, 160
    u0, v0, u1, v1, draw, lay = _segments(3, 16, E, h, w, L, "cuda")
    before = rk.masks_kernel.launches
    out = rk.rasterize_masks_packed_soa(u0, v0, u1, v1, draw, lay, L, (h, w),
                                        2, max_visible=128)
    torch.cuda.synchronize()
    assert rk.masks_kernel.launches == before + 1
    assert out.shape == (16, L, h, w) and out.dtype == torch.uint8
    bundle = rk.compact_env_idx_soa(
        u0, v0, u1, v1, draw, 256, h, 2, edge_layer=lay, n_layers=L, w=w,
    )
    with pytest.raises(ValueError, match="int32"):
        rk.masks_kernel((bundle[0].long(),) + bundle[1:], L, (h, w), 2)


def _bundle(t, h, w, kb, seed, b=48, L=5, E=100, plant=False):
    u0, v0, u1, v1, draw, lay = _segments(seed, b, E, h, w, L, "cuda")
    if plant:
        # edges 0 and E-1 draw one segment across the frame, in layers 0
        # and L-1, in every env but env 0
        for e, l in ((0, 0), (E - 1, L - 1)):
            u0[:, e], v0[:, e] = 2.0, float(h // 2)
            u1[:, e], v1[:, e] = w - 3.0, float(h // 2 + 3)
            draw[1:, e] = True
            lay[e] = l
    return rk.compact_env_idx_soa(
        u0, v0, u1, v1, draw, kb * rk._n_xblocks(w), h, t, edge_layer=lay,
        n_layers=L, w=w,
    )


@pytest.mark.parametrize("t,h,w,kb", CASES)
def test_rank_kernel_matches_plain_and_masks(t, h, w, kb):
    """Bit-equal to its plain version and to rank_from_masks of the masks
    kernel on the same bundle (both kernels are built with -fmad=false).
    A segment planted in layers 0 and L-1 shows that the last layer is
    painted over the first where they overlap."""
    _require_cuda()
    L, E = 5, 100
    bundle = _bundle(t, h, w, kb, t * 7 + h, L=L, E=E, plant=True)
    before = rk.rank_kernel.launches
    got = rk.rank_kernel(bundle, L, (h, w), t)
    assert rk.rank_kernel.launches == before + 1
    want = rk.rasterize_rank_env_plain(bundle, L, (h, w), t)
    masks = rk.masks_kernel(bundle, L, (h, w), t)
    via_masks = ras.rank_from_masks(masks)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == (48, h, w)
    assert torch.equal(got, want)
    assert torch.equal(got, via_masks)
    assert 0 < int(want.max()) <= L and not want[0].any()
    overlap = (masks[:, 0] > 0) & (masks[:, L - 1] > 0)
    assert bool((got[overlap] == L).all())
    if kb >= E:  # no copy dropped: the planted pair overlaps in every env
        assert bool(overlap[1:].flatten(1).any(-1).all())


def test_rank_packed_entry_launches_kernel():
    """rasterize_rank_packed_soa on CUDA tensors goes through the rank
    kernel, which checks its inputs and raises instead of falling back."""
    _require_cuda()
    L, E, h, w = 5, 100, 64, 160
    u0, v0, u1, v1, draw, lay = _segments(5, 16, E, h, w, L, "cuda")
    before = rk.rank_kernel.launches
    out = rk.rasterize_rank_packed_soa(u0, v0, u1, v1, draw, lay, L, (h, w),
                                       2, max_visible=128)
    torch.cuda.synchronize()
    assert rk.rank_kernel.launches == before + 1
    assert out.shape == (16, h, w) and out.dtype == torch.uint8
    bundle = _bundle(2, h, w, 128, 5, b=16, L=L)
    with pytest.raises(ValueError, match="float32"):
        rk.rank_kernel(bundle[:1] + (bundle[1].double(),) + bundle[2:], L,
                       (h, w), 2)


def _exact_bundle(t, h, w, kb, seed, b=48, L=5, E=100):
    """An exact-stroke bundle on the card: random segments, half of them
    deep-clipped (~400 px off frame), the pinned segment (150, -151) ->
    (-378, 406) whose swapped clipped outline edge needs its far dot, and
    horizontal and vertical segments (ties of the quad's top vertex)."""
    u0, v0, u1, v1, draw, lay = _segments(seed, b, E, h, w, L, "cuda")
    rng = np.random.default_rng(seed + 1)
    deep = torch.tensor(rng.random((b, E)) < 0.5, device="cuda")
    far = [torch.tensor(rng.uniform(-400, s + 400, (b, E)),
                        dtype=torch.float32, device="cuda")
           for s in (w, h, w, h)]
    u0, v0, u1, v1 = (torch.where(deep, f, x)
                      for f, x in zip(far, (u0, v0, u1, v1)))
    v1[:, 1:4] = v0[:, 1:4]  # horizontal
    u1[:, 4:7] = u0[:, 4:7]  # vertical
    u0[:, 0], v0[:, 0], u1[:, 0], v1[:, 0] = 150.0, -151.0, -378.0, 406.0
    draw[1:, :7] = True
    return rk.compact_env_exact_soa(
        u0, v0, u1, v1, draw, kb * rk._n_xblocks(w), h, t, edge_layer=lay,
        n_layers=L, w=w,
    )


# (t, h, w, k per block): the lane split off (w = 48) and on, odd h,
# an oversubscribed budget, and 480x640 (a 61 KB strip)
EXACT_CASES = [(2, 128, 160, 100), (3, 30, 48, 100), (5, 64, 160, 6),
               (2, 480, 640, 100)]


@pytest.mark.parametrize("t,h,w,kb", EXACT_CASES)
@pytest.mark.parametrize("out_dtype", [torch.uint8, torch.float32])
def test_exact_kernel_matches_plain(t, h, w, kb, out_dtype):
    """Bit-equal to its plain version (int32 arithmetic in both); float32
    output is 0/1."""
    _require_cuda()
    L = 5
    bundle = _exact_bundle(t, h, w, kb, t * 11 + h, L=L)
    before = rk.exact_kernel.launches
    got = rk.exact_kernel(bundle, L, (h, w), t, out_dtype=out_dtype)
    assert rk.exact_kernel.launches == before + 1
    want = rk.rasterize_masks_exact_env_plain(bundle, L, (h, w), t,
                                              out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (48, L, h, w)
    assert torch.equal(got, want)
    one = 255 if out_dtype == torch.uint8 else 1
    assert bool(((want == 0) | (want == one)).all())
    assert want.sum() > 0 and not want[0].any()


def test_exact_packed_entry_launches_kernel():
    """rasterize_masks_packed_soa with the exact stroke at t >= 2 on CUDA
    tensors goes through the exact kernel (not the masks kernel), which
    checks its inputs and raises instead of falling back."""
    _require_cuda()
    L, E, h, w = 5, 100, 64, 160
    u0, v0, u1, v1, draw, lay = _segments(7, 16, E, h, w, L, "cuda")
    before = (rk.exact_kernel.launches, rk.masks_kernel.launches)
    out = rk.rasterize_masks_packed_soa(u0, v0, u1, v1, draw, lay, L, (h, w),
                                        2, max_visible=128, stroke="exact")
    torch.cuda.synchronize()
    assert (rk.exact_kernel.launches, rk.masks_kernel.launches) == (
        before[0] + 1, before[1])
    assert out.shape == (16, L, h, w) and out.dtype == torch.uint8
    idx, fields, counts = _exact_bundle(2, h, w, 128, 7, b=16, L=L)
    with pytest.raises(ValueError, match="int32"):
        rk.exact_kernel((idx, fields[:5] + (fields[5].long(),) + fields[6:],
                         counts), L, (h, w), 2)
    with pytest.raises(ValueError, match="30"):
        rk.exact_kernel((idx, fields[:-1], counts), L, (h, w), 2)


def _soa_segments(seed, b, nl, e, h, w):
    """Per-layer segments on the card: p0, p1 (b, nl, e, 2), draw
    (b, nl, e); env 0 draws nothing."""
    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(-40, w + 40, (b, nl, e)),
                   rng.uniform(-40, h + 40, (b, nl, e))], -1)
    p1 = p0 + np.stack([rng.uniform(-90, 90, (b, nl, e)),
                        rng.uniform(-70, 70, (b, nl, e))], -1)
    draw = rng.random((b, nl, e)) < 0.7
    draw[0] = False
    f = lambda x: torch.tensor(x, dtype=torch.float32, device="cuda")  # noqa
    return f(p0), f(p1), torch.tensor(draw, device="cuda")


# (t, h, w, gran, k per layer): the three strokes, both band heights, one
# to five lane blocks, h not a multiple of the band, an oversubscribed odd
# budget, and 480x640, whose unsplit frames the kernels tile by 128 lanes
SOA_CASES = [(1, 64, 48, 8, 40), (2, 30, 200, 16, 7), (3, 100, 300, 8, 40),
             (2, 480, 640, 16, 40), (2, 128, 160, 8, 128)]


def _launched(kernel, soa, args, plain):
    before = kernel.launches
    got = kernel(soa, *args)
    assert kernel.launches == before + 1
    want = plain(soa, *args)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)
    assert want.sum() > 0 and not want[0].any()


@pytest.mark.parametrize("t,h,w,gran,kl", SOA_CASES)
def test_frame_soa_kernel_matches_plain(t, h, w, gran, kl):
    """The frame kernel (compact_soa's bundle) bit-equal to its plain
    version."""
    _require_cuda()
    p0, p1, draw = _soa_segments(t * 13 + h, 32, 3, 40, h, w)
    soa = rk.compact_soa(p0, p1, draw, kl, gran, h, t, w=w)
    _launched(rk.frame_soa_kernel, soa, ((h, w), t, gran),
              rk.rasterize_compact_soa_plain)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("t,h,w,gran,kl", SOA_CASES)
def test_env_soa_kernel_matches_plain(t, h, w, gran, kl, split):
    """The env kernel (compact_env_soa's bundle, lane-split or, without w,
    unsplit) bit-equal to its plain version."""
    _require_cuda()
    split = split or t <= 1  # the t=1 clip needs w, which splits the lanes
    p0, p1, draw = _soa_segments(t * 17 + h, 32, 3, 40, h, w)
    soa = rk.compact_env_soa(p0, p1, draw, kl * 3 * rk._n_xblocks(w), gran,
                             h, t, w=w if split else None)
    _launched(rk.env_soa_kernel, soa, (3, (h, w), t, gran, split),
              rk.rasterize_compact_env_soa_plain)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("t,h,w,gran,kl", SOA_CASES)
def test_env_seg_kernel_matches_plain(t, h, w, gran, kl, split):
    """The segment kernel (compact_env_seg's bundle) bit-equal to its plain
    version."""
    _require_cuda()
    split = split or t <= 1
    p0, p1, draw = _soa_segments(t * 19 + h, 32, 3, 40, h, w)
    soa = rk.compact_env_seg(p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1],
                             draw, kl * 3, gran, h, t, w=w if split else None)
    _launched(rk.env_seg_kernel, soa,
              (3, (h, w), t, gran, split and w > 128),
              rk.rasterize_env_seg_plain)


def test_soa_kernels_check_their_inputs():
    """The wrappers raise on what the kernels do not take, before
    launching: a band height the kernels are not compiled for, a wrong
    dtype."""
    _require_cuda()
    p0, p1, draw = _soa_segments(3, 8, 3, 40, 64, 160)
    soa = rk.compact_soa(p0, p1, draw, 40, 8, 64, 2)
    before = rk.frame_soa_kernel.launches
    with pytest.raises(ValueError, match="gran"):
        rk.frame_soa_kernel(soa, (64, 160), 2, 4)
    with pytest.raises(ValueError, match="float32"):
        rk.frame_soa_kernel((soa[0].double(),) + soa[1:], (64, 160), 2, 8)
    assert rk.frame_soa_kernel.launches == before


def test_soa_kernels_keep_a_mismatched_gran_in_the_frame():
    """A bundle compacted at gran 8 and rendered at gran 16 (the bundle
    does not carry its band height) has windows that reach past the
    strip: each kernel writes no row outside it, so the launch succeeds,
    the masks stay 0/255, and the next correct render still equals its
    plain version."""
    _require_cuda()
    h, w, t = 100, 160, 2
    p0, p1, draw = _soa_segments(5, 16, 3, 40, h, w)
    u0, v0, u1, v1 = p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1]
    cases = [
        (rk.frame_soa_kernel, rk.rasterize_compact_soa_plain,
         lambda g: rk.compact_soa(p0, p1, draw, 40, g, h, t),
         lambda g: ((h, w), t, g)),
        (rk.env_soa_kernel, rk.rasterize_compact_env_soa_plain,
         lambda g: rk.compact_env_soa(p0, p1, draw, 120, g, h, t),
         lambda g: (3, (h, w), t, g, False)),
        (rk.env_seg_kernel, rk.rasterize_env_seg_plain,
         lambda g: rk.compact_env_seg(u0, v0, u1, v1, draw, 120, g, h, t,
                                      w=w),
         lambda g: (3, (h, w), t, g, True)),
    ]
    for kernel, plain, compact, args in cases:
        out = kernel(compact(8), *args(16))
        torch.cuda.synchronize()
        assert out.shape == (16, 3, h, w)
        assert bool(((out == 0) | (out == 255)).all())
        _launched(kernel, compact(16), args(16), plain)



def _probe_case(kernel, plain, shape, dtype, args, offset=False):
    """The probe kernel and its plain version on outputs pre-filled with a
    sentinel (the kernel's one env past its allocation's start with
    `offset`): equal, one launch."""
    sentinel = 171 if dtype == torch.uint8 else -7.0
    full = torch.full((shape[0] + 1,) + shape[1:], sentinel, dtype=dtype,
                      device="cuda")
    got = full[1:] if offset else full[:-1]
    want = torch.full(shape, sentinel, dtype=dtype, device="cuda")
    before = kernel.launches
    kernel(got, *args)
    assert kernel.launches == before + 1
    plain(want, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_probe_kernels_match_plain(n):
    """K8-K10 bit-equal to their plain versions: KK 0, 1, 64 and 512 --
    values that wrap in the int32 -> uint8 cast, values the chain carries
    past an integer (0.9999 in one round, 254.99 in 29 of 64, 99.93 in
    367 of 512), and 16.9998836517334, which a fused multiply-add would
    carry to 17 and the unfused chain leaves at 16.999998 --, uint8 and
    float32 fills at g = 1, 4, 16 on the bench shape and on an odd-sized,
    misaligned one, and live masks with an empty, a full and ragged
    layers."""
    _require_cuda()
    frame = (5, 128, 160)
    for kk, v in ((0, 29.0), (1, 300.5), (64, -3.7), (1, 0.9999),
                  (1, 16.9998836517334), (64, 254.99), (512, 99.93)):
        _probe_case(pk.ovl_kernel, pk.ovl_plain, (n,) + frame, torch.uint8,
                    (v, kk))
    for shape, dtype, value in (((n, 800, 128), torch.uint8, 200),
                                ((n,) + frame, torch.float32, -1.5),
                                ((n, 3, 7, 5), torch.uint8, 77),
                                ((n, 3, 7, 5), torch.float32, 3.25)):
        for g in (1, 4, 16):
            _probe_case(pk.fill_kernel, lambda o, x, _: pk.fill_plain(o, x),
                        shape, dtype, (value, g), offset=shape[1] == 3)
    live = (torch.rand((5, n), generator=torch.Generator().manual_seed(n))
            < 0.5).to(torch.int32)
    live[0], live[1] = 0, 1
    for shape in ((n * 5, 128, 256), (n * 5, 3, 37)):
        _probe_case(pk.skip_kernel, pk.skip_plain, shape, torch.uint8,
                    (live.cuda(), 99), offset=shape[1] == 3)


def test_bench_graph_matches_eager():
    """Six replays of the bench's captured step equal six eager steps bit
    for bit from one state and generator seed, with every env respawning
    every two steps (and any that leaves the road): the replays draw the
    eager steps' respawn rows and advance the generator as far."""
    _require_cuda()
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.benchmarks import bench as pbench

    params = fenv.make_env_params(pbench.CONFIG)
    r = pbench.graph_matches_eager(params, 256, steps=6, max_episode_steps=2)
    assert r["equal"]
    assert r["respawns"] >= 3 * 256
    assert r["offsets"][0] == r["offsets"][1] > 0
