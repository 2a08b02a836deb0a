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
import os

import numpy as np
import pytest
import torch

from tinycarlo_torch.ops import probe_kernels as pk
from tinycarlo_torch.ops import rasterize as ras
from tinycarlo_torch.ops import rasterize_kernels as rk

pytestmark = pytest.mark.cuda

# bit-repeatable cuBLAS products across streams, for the TD3 tests'
# replayed graphs against eager steps (read at cuBLAS's first call)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

# the masks and exact kernels' outputs: uint8 0/255, float32 and bfloat16
# 0/1 (the TD3 trainer's encoder feed)
OUT_DTYPES = [torch.uint8, torch.float32, torch.bfloat16]


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
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
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


# (t, h, w): 480x640 frames cut into row chunks (uint8 48 rows, float32 12),
# 128x160 float32 in three chunks, and widths that are not multiples of 4
# or 16 (150 with two lane blocks, 77 with one)
CHUNK_CASES = [(2, 480, 640), (3, 480, 640), (1, 128, 160), (2, 100, 150),
               (3, 37, 77)]


@pytest.mark.parametrize("t,h,w", CHUNK_CASES)
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_masks_kernel_chunks_and_empty_layers(t, h, w, out_dtype):
    """Bit-equal to the plain version where the kernel cuts frames into
    row chunks and on odd widths, with an env that has no live slot (env
    0) and a layer no edge belongs to (counts[4+2] == 0 in every env), in
    the bench's tall-copy and near-plane shapes."""
    _require_cuda()
    L, E = 5, 100
    u0, v0, u1, v1, draw, lay = _segments(t * 11 + w, 24, E, h, w, L, "cuda")
    lay[lay == 2] = 3
    u1[:, :5] = u0[:, :5] + 4000.0  # near-plane clipped: thousands of px
    v1[:, 5:10] = v0[:, 5:10] + 3.0 * h  # tall copies through the frame
    bundle = rk.compact_env_idx_soa(
        u0, v0, u1, v1, draw, E * rk._n_xblocks(w), h, t, edge_layer=lay,
        n_layers=L, w=w,
    )
    counts = bundle[-1]
    assert int(counts[0, 0]) == 0 and int(counts[4 + 2].abs().sum()) == 0
    got = rk.masks_kernel(bundle, L, (h, w), t, out_dtype=out_dtype)
    want = rk.rasterize_masks_env_plain(bundle, L, (h, w), t,
                                        out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (24, L, h, w)
    assert torch.equal(got, want)
    assert want.sum() > 0 and not want[0].any() and not want[:, 2].any()


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
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
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


def _env_block_segments(seed, b, E, h, w, L, exact):
    """Segments for the one-block-per-env designs of the exact and rank
    kernels: env 0 draws nothing, env 1 draws only its layer L-1 edges (an
    env with one live layer), and every env has tall copies through the
    frame and near-plane clipped ones thousands of pixels long; under
    `exact` also `_exact_bundle`'s deep-clipped, horizontal and vertical
    segments."""
    u0, v0, u1, v1, draw, lay = _segments(seed, b, E, h, w, L, "cuda")
    if exact:
        rng = np.random.default_rng(seed + 1)
        deep = torch.tensor(rng.random((b, E)) < 0.3, device="cuda")
        far = [torch.tensor(rng.uniform(-400, s + 400, (b, E)),
                            dtype=torch.float32, device="cuda")
               for s in (w, h, w, h)]
        u0, v0, u1, v1 = (torch.where(deep, f, x)
                          for f, x in zip(far, (u0, v0, u1, v1)))
        v1[:, 1:4] = v0[:, 1:4]  # horizontal
        u1[:, 4:7] = u0[:, 4:7]  # vertical
    u1[:, 10:13] = u0[:, 10:13] + 4000.0  # near-plane clipped
    v1[:, 13:16] = v0[:, 13:16] + 3.0 * h  # tall copies through the frame
    draw[1:, :16] = True
    draw[1] &= lay == L - 1
    return u0, v0, u1, v1, draw, lay


def _one_live_layer(counts, L):
    """Env 0 has no live slot and env 1 live copies in layer L-1 only."""
    assert int(counts[0, 0]) == 0 and int(counts[0, 1]) > 0
    assert [int(counts[4 + l, 1]) > 0 for l in range(L)] == (
        [False] * (L - 1) + [True])


# (t, h, w, k per block) where the one-block-per-env designs branch: the
# whole 128x160 frame in one chunk, 48-row chunks at 480x640 (and for
# float32), a width with a ragged 16-byte phase (100x150), and an
# oversubscribed budget
ENV_BLOCK_CASES = [(2, 128, 160, 100), (3, 480, 640, 100),
                   (2, 100, 150, 100), (5, 128, 160, 6)]


@pytest.mark.parametrize("t,h,w,kb", ENV_BLOCK_CASES)
@pytest.mark.parametrize("out_dtype", OUT_DTYPES)
def test_exact_kernel_env_blocks(t, h, w, kb, out_dtype):
    """The exact kernel bit-equal to its plain version where its chunks,
    boxes and units branch, with an empty env and a one-layer env."""
    _require_cuda()
    L, E, b = 5, 100, 24
    segs = _env_block_segments(t * 13 + w, b, E, h, w, L, exact=True)
    bundle = rk.compact_env_exact_soa(
        *segs[:5], kb * rk._n_xblocks(w), h, t, edge_layer=segs[5],
        n_layers=L, w=w,
    )
    counts = bundle[-1]
    _one_live_layer(counts, L)
    if kb < E:
        assert int(counts[3].sum()) > 0  # copies dropped
    before = rk.exact_kernel.launches
    got = rk.exact_kernel(bundle, L, (h, w), t, out_dtype=out_dtype)
    assert rk.exact_kernel.launches == before + 1
    want = rk.rasterize_masks_exact_env_plain(bundle, L, (h, w), t,
                                              out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and got.shape == (b, L, h, w)
    assert torch.equal(got, want)
    assert want[1, L - 1].any() and not want[1, :L - 1].any()
    assert not want[0].any()


@pytest.mark.parametrize("t,h,w,kb", ENV_BLOCK_CASES)
def test_rank_kernel_env_blocks(t, h, w, kb):
    """The rank kernel bit-equal to its plain version and to
    rank_from_masks of the masks kernel where its chunks and layer
    barriers branch, with an empty env and a one-layer env."""
    _require_cuda()
    L, E, b = 5, 100, 24
    segs = _env_block_segments(t * 17 + w, b, E, h, w, L, exact=False)
    bundle = rk.compact_env_idx_soa(
        *segs[:5], kb * rk._n_xblocks(w), h, t, edge_layer=segs[5],
        n_layers=L, w=w,
    )
    _one_live_layer(bundle[-1], L)
    before = rk.rank_kernel.launches
    got = rk.rank_kernel(bundle, L, (h, w), t)
    assert rk.rank_kernel.launches == before + 1
    want = rk.rasterize_rank_env_plain(bundle, L, (h, w), t)
    via_masks = ras.rank_from_masks(rk.masks_kernel(bundle, L, (h, w), t))
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == (b, h, w)
    assert torch.equal(got, want)
    assert torch.equal(got, via_masks)
    assert not want[0].any()
    assert set(want[1].unique().tolist()) == {0, L}


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
# budget, and 480x640, whose unsplit frames the frame kernel tiles by 128
# lanes and the env and segment kernels drain in 48-row chunks
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
    return got


@pytest.mark.parametrize("t,h,w,gran,kl", SOA_CASES)
def test_frame_soa_kernel_matches_plain(t, h, w, gran, kl):
    """The frame kernel (compact_soa's bundle) bit-equal to its plain
    version."""
    _require_cuda()
    p0, p1, draw = _soa_segments(t * 13 + h, 32, 3, 40, h, w)
    soa = rk.compact_soa(p0, p1, draw, kl, gran, h, t, w=w)
    _launched(rk.frame_soa_kernel, soa, ((h, w), t, gran),
              rk.rasterize_compact_soa_plain)


def _frame_case(p0, p1, draw, k, gran, h, w, t=2):
    """The frame kernel on compact_soa's bundle of per-layer segments, k
    slots a frame, bit-equal to its plain version; returns (bundle,
    output)."""
    soa = rk.compact_soa(p0, p1, draw, k, gran, h, t, w=w)
    return soa, _launched(rk.frame_soa_kernel, soa, ((h, w), t, gran),
                          rk.rasterize_compact_soa_plain)


def test_frame_soa_kernel_one_live_layer():
    """Env 0 draws nothing and every other env only in layer 1: the
    frames of env 0 and of layers 0 and 2 have no live slot (register
    fills of zeros)."""
    _require_cuda()
    p0, p1, draw = _soa_segments(71, 16, 3, 40, 128, 160)
    draw[:, [0, 2]] = False
    soa, out = _frame_case(p0, p1, draw, 40, 8, 128, 160)
    live = soa[-1][0].view(16, 3)
    assert int(live[:, [0, 2]].abs().sum()) == 0 and int(live[1:, 1].min()) > 0
    assert out[:, 1].any() and not out[:, [0, 2]].any()


@pytest.mark.parametrize("gran", [8, 16])
def test_frame_soa_kernel_budget_reached(gran):
    """A budget of 10 slots that counts[0] reaches in every frame of every
    env that draws, slots dropped."""
    _require_cuda()
    p0, p1, draw = _soa_segments(72, 16, 3, 40, 128, 160)
    soa, _ = _frame_case(p0, p1, draw, 10, gran, 128, 160)
    live = soa[-1][0].view(16, 3)[1:]
    assert int(live.min()) == int(live.max()) == 10
    assert int(soa[-1][2].sum()) > 0


@pytest.mark.parametrize("gran", [8, 16])
def test_frame_soa_kernel_480x640(gran):
    """480x640 frames: each frame a 640-lane strip drained in 48-row
    chunks, at both band heights."""
    _require_cuda()
    p0, p1, draw = _soa_segments(73 + gran, 8, 5, 80, 480, 640)
    _frame_case(p0, p1, draw, 80, gran, 480, 640)


@pytest.mark.parametrize("w", [300, 640])
def test_frame_soa_kernel_t1_wide_unsplit(w):
    """t = 1 (the Bresenham stamp, the compaction's clip at w) on frames
    wider than one lane block: the bundle is never lane-split."""
    _require_cuda()
    h = 100 if w == 300 else 480
    p0, p1, draw = _soa_segments(74 + w, 8, 3, 60, h, w)
    for gran in (8, 16):
        _frame_case(p0, p1, draw, 60, gran, h, w, t=1)


def test_frame_soa_kernel_odd_slot_count():
    """41 edges a frame and a budget above it: k' = 41 slots padded to 42
    with a slot that draws nothing, and frames whose live count is odd."""
    _require_cuda()
    p0, p1, draw = _soa_segments(75, 16, 3, 41, 128, 160)
    soa, _ = _frame_case(p0, p1, draw, 64, 8, 128, 160)
    assert soa[0].shape[-1] == 42
    assert int((soa[-1][0] % 2).sum()) > 0


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


def _env_kernel_case(name, p0, p1, draw, k, gran, h, w, split):
    """The env (`name` "env_soa", k slots per lane block) or segment
    ("env_seg", k slots) kernel on the bundle of per-layer segments,
    bit-equal to its plain version; returns (bundle, output)."""
    nl = draw.shape[1]
    if name == "env_soa":
        nxb = rk._n_xblocks(w) if split else 1
        soa = rk.compact_env_soa(p0, p1, draw, k * nxb, gran, h, 2,
                                 w=w if split else None)
        return soa, _launched(rk.env_soa_kernel, soa,
                              (nl, (h, w), 2, gran, split),
                              rk.rasterize_compact_env_soa_plain)
    soa = rk.compact_env_seg(p0[..., 0], p0[..., 1], p1[..., 0], p1[..., 1],
                             draw, k, gran, h, 2, w=w if split else None)
    return soa, _launched(rk.env_seg_kernel, soa,
                          (nl, (h, w), 2, gran, split and w > 128),
                          rk.rasterize_env_seg_plain)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("name", ["env_soa", "env_seg"])
def test_env_kernels_one_layer_env(name, split):
    """Every live slot of every env in layer 1: layers 0 and 2 are zeros
    (the env bundle has no per-layer counts; its empty buckets skip
    them)."""
    _require_cuda()
    p0, p1, draw = _soa_segments(61, 16, 3, 40, 128, 160)
    draw[:, [0, 2]] = False
    _, out = _env_kernel_case(name, p0, p1, draw, 120, 16, 128, 160, split)
    assert out[:, 1].any() and not out[:, [0, 2]].any()


@pytest.mark.parametrize("gran", [8, 16])
@pytest.mark.parametrize("name", ["env_soa", "env_seg"])
def test_env_kernels_budget_reached(name, gran):
    """A budget that counts[0] reaches in every env that draws, slots
    dropped."""
    _require_cuda()
    p0, p1, draw = _soa_segments(62, 16, 3, 40, 128, 160)
    k = 10
    soa, _ = _env_kernel_case(name, p0, p1, draw, k, gran, 128, 160, True)
    counts = soa[-1]
    live = counts[0][1:]
    want = k * rk._n_xblocks(160) if name == "env_soa" else k
    assert int(live.min()) == int(live.max()) == want
    assert int(counts[2 if name == "env_soa" else 3].sum()) > 0


@pytest.mark.parametrize("name", ["env_soa", "env_seg"])
def test_env_kernels_480x640_unsplit_gran8(name):
    """A 480x640 unsplit gran-8 bundle: one 640-lane strip a frame, drained
    in 48-row chunks."""
    _require_cuda()
    p0, p1, draw = _soa_segments(63, 8, 5, 80, 480, 640)
    _env_kernel_case(name, p0, p1, draw, 200, 8, 480, 640, False)


@pytest.mark.parametrize("w", [300, 640])
def test_env_seg_kernel_wide_segments(w):
    """Segment slots whose touch bits name three or more lane blocks: every
    third segment crosses the frame, -50 to w + 50."""
    _require_cuda()
    h = 100
    p0, p1, draw = _soa_segments(64 + w, 16, 3, 40, h, w)
    rng = np.random.default_rng(w)
    n = p0[:, :, ::3].shape[2]
    y = torch.tensor(rng.uniform(0, h, (16, 3, n)), dtype=torch.float32,
                     device="cuda")
    p0[:, :, ::3, 0], p0[:, :, ::3, 1] = -50.0, y
    p1[:, :, ::3, 0], p1[:, :, ::3, 1] = w + 50.0, y + 6.0
    for gran in (8, 16):
        soa, _ = _env_kernel_case("env_seg", p0, p1, draw, 120, gran, h, w,
                                  True)
        idx, bw, counts = soa[0], soa[-2], soa[-1]
        word = torch.gather(bw, 1, idx[:, :-7].long())
        live = (torch.arange(idx.shape[1] - 7, device="cuda")[None]
                < counts[0][:, None])
        blocks = sum((word >> j) & 1 for j in range(rk._n_xblocks(w)))
        assert int(blocks[live].max()) >= 3


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


@pytest.mark.parametrize("n", [1, 7, 64, 4096])
def test_probe_kernels_match_plain(n):
    """K8-K10 bit-equal to their plain versions: KK 0, 1, 64 and 512 --
    values that wrap in the int32 -> uint8 cast, values the chain carries
    past an integer (0.9999 in one round, 254.99 in 29 of 64, 99.93 in
    367 of 512), and 16.9998836517334, which a fused multiply-add would
    carry to 17 and the unfused chain leaves at 16.999998 --, uint8 and
    float32 fills at g = 1, 4, 16 (which change nothing) on the flat and
    the bench shapes and on an odd-sized, misaligned one, and live masks
    with an empty, a full and ragged layers; every kernel leaves the
    bytes around its output alone."""
    _require_cuda()
    frame = (5, 128, 160)
    for kk, v in ((0, 29.0), (1, 300.5), (64, -3.7), (1, 0.9999),
                  (1, 16.9998836517334), (64, 254.99), (512, 99.93)):
        _probe_case(pk.ovl_kernel, pk.ovl_plain, (n,) + frame, torch.uint8,
                    (v, kk))
    for shape, dtype, value in (((n, 800, 128), torch.uint8, 200),
                                ((n,) + frame, torch.uint8, 29),
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


def test_gym_graph_matches_eager():
    """The Gymnasium shim on the card: 20 replayed steps of each
    gym_bench config, and of config 1 under the exact stroke, return what
    20 eager steps return, bit for bit."""
    _require_cuda()
    from tinycarlo_torch.benchmarks import gym_bench as gb

    exact = dict(gb.CONFIG1, camera=dict(gb.CONFIG1["camera"],
                                         stroke="exact"))
    for config in (*gb.CONFIGS.values(), exact):
        assert gb.graph_matches_eager(config, steps=20) == 20


@pytest.mark.parametrize("name", ["config1", "simple_layout"])
def test_gym_launches_equal_renders(name):
    """The masks (classes) or rank (rgb) kernel's wrapper, and the front
    kernel's in front of it, count one launch a render that ran eagerly
    (the resets and the first step) and one for the capture, which
    records the launch every replay runs; replays pass no wrapper, and
    each step after the first is one."""
    _require_cuda()
    from tinycarlo_torch.benchmarks import gym_bench as gb

    r = gb.measure(name, "graph", steps=30)
    kernel = "masks" if r["format"] == "classes" else "rank"
    want = {"front": 0, "masks": 0, "rank": 0, "exact": 0}
    want[kernel] = want["front"] = r["renders"] - r["replays"] + 1
    assert r["replays"] == 30 and r["captures"] == 1
    assert r["launches"] == r["want_launches"] == want


@pytest.mark.parametrize("name", ["simple_layout", "classes"])
def test_twin_graph_matches_eager(name):
    """The digital twin on the card (loopback backend): 20 replayed steps
    of each twin_bench config return what 20 eager steps return, bit for
    bit."""
    _require_cuda()
    from tinycarlo_torch.benchmarks import twin_bench as tb

    assert tb.graph_matches_eager(tb.CONFIGS[name], steps=20) == 20


def test_twin_launches_equal_renders():
    """The twin's rank-kernel launches: one a render that ran eagerly (the
    reset and the first step) and one for the capture; replays pass no
    wrapper."""
    _require_cuda()
    from tinycarlo_torch.benchmarks import twin_bench as tb

    r = tb.measure("simple_layout", "graph", steps=30)
    assert r["replays"] == 30 and r["captures"] == 1
    assert r["launches"] == r["want_launches"]
    assert r["launches"]["rank"] == r["launches"]["front"] == (
        r["renders"] - 30 + 1)


def test_gym_update_params_reaches_the_graph():
    """New camera parameters, written into the captured tensors, change
    the replayed step's frame as they change the eager step's."""
    _require_cuda()
    from tinycarlo_torch.benchmarks import gym_bench as gb

    envs = [gb.make_env(gb.CONFIG1, mode) for mode in ("graph", "eager")]
    for env in envs:
        env.reset(seed=1)
    action = {"car_control": [0.3, 0.05], "maneuver": 0}
    for _ in range(3):
        before = [env.step(action)[0] for env in envs]
    for env in envs:
        env.camera.orientation[0] = 10.0
        env.camera.fov = 110.0
        env.camera.update_params()
    after = [env.step(action)[0] for env in envs]
    assert np.array_equal(before[0], before[1])
    assert np.array_equal(after[0], after[1])
    assert not np.array_equal(after[0], before[0])


def test_gym_debug_step_on_the_card(monkeypatch, capsys):
    """DEBUG=1's staged step on the card returns the fused step's frame,
    reward, flags and info, and replays continue from its state."""
    _require_cuda()
    from tinycarlo_torch.benchmarks import gym_bench as gb

    envs = [gb.make_env(gb.CONFIG1, mode) for mode in ("graph", "eager")]
    for env in envs:
        env.reset(seed=2)
    acts = gb.actions(4, seed=5)
    for i, action in enumerate(acts):
        if i == 2:
            monkeypatch.setenv("DEBUG", "1")
        staged = envs[0].step(action)
        monkeypatch.delenv("DEBUG", raising=False)
        fused = envs[1].step(action)
        assert np.array_equal(staged[0], fused[0])
        assert staged[1] == fused[1]
        assert staged[2:4] == fused[2:4]
        assert staged[4]["cte"] == fused[4]["cte"]
        assert len(staged[4]["local_path"]) == len(fused[4]["local_path"])
    assert "car step" in capsys.readouterr().out


def _td3_loop(n_envs, seed, replay_size=10_000, resolution=(64, 80)):
    """A BASELINE config 4 loop (classes frames at `resolution`, bfloat16
    render and encoder) on the card, and its chunk arguments."""
    from tinycarlo_torch.benchmarks import td3_bench
    from tinycarlo_torch.models.tinycar_net import encoder_apply_fn
    from tinycarlo_torch.train import td3
    from tinycarlo_torch.train.evaluate import standard_stack
    from tinycarlo_torch.train.td3_loop import LoopConfig, init_loop

    params = td3_bench.make_params("cuda", resolution)
    cfg = td3.TD3Config()
    loop_cfg = LoopConfig(speed=0.4, replay_size=replay_size,
                          obs_dtype=torch.bfloat16)
    stack = standard_stack()
    enc = encoder_apply_fn(td3_bench.make_encoder(params, torch.bfloat16))
    state = init_loop(params, cfg, loop_cfg, n_envs, seed=seed, stack=stack)
    return state, (params, cfg, loop_cfg, enc), stack


def _equal_states(a, b):
    from tinycarlo_torch.utils import graphs

    ta, tb = graphs.tensors(a), graphs.tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y)
                                      for x, y in zip(ta, tb))


def test_td3_chunk_graphs_match_eager():
    """9 steps of a 64-env loop through its replayed graphs (3 collect-only
    steps, then critic-only and critic + actor updates; 6 replays) equal 9
    eager steps from the same seed bit for bit, with torch's deterministic
    algorithms on; the masks kernel launched once per eager step and
    capture."""
    _require_cuda()
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train.td3_loop import chunk
    from tinycarlo_torch.utils import graphs

    graphs.deterministic(True)
    try:
        a, args, stack = _td3_loop(64, seed=3)
        b, _, _ = _td3_loop(64, seed=3)
        before = rk.masks_kernel.launches
        a, out_a = chunk(a, *args, 9, stack=stack)
        launches = rk.masks_kernel.launches - before
        b, out_b = chunk(b, *args, 9, stack=stack, graph=False)
    finally:
        graphs.deterministic(False)
    rt = a.runtime.step_graphs
    assert rt.replays == 6 and rt.captures == 3 and rt.eager == 3
    assert launches == rt.eager + rt.captures
    assert _equal_states(a, b)
    assert all(torch.equal(out_a[k], out_b[k]) for k in out_a)
    assert bool((out_a["critic1_loss"][3:] != 0).all())
    assert bool((out_a["actor_loss"][4::2] != 0).all())


def test_td3_shorter_chunk_replays_the_captured_graphs():
    """A 1-step chunk after a 20-step one replays the captured graph (no
    capture, no eager step) and gives the row a 20-step chunk from the
    same state gives first, bit for bit, every update's losses included;
    a longer chunk captures anew."""
    _require_cuda()
    from tinycarlo_torch.train.td3_loop import chunk
    from tinycarlo_torch.utils import graphs

    graphs.deterministic(True)
    try:
        a, args, stack = _td3_loop(64, seed=5)
        b, _, _ = _td3_loop(64, seed=5)
        for s in (a, b):
            chunk(s, *args, 20, stack=stack)
        rt = a.runtime
        graphs_before = dict(rt.step_graphs.entries)
        eager, replays = rt.step_graphs.eager, rt.step_graphs.replays
        a, one = chunk(a, *args, 1, stack=stack)
        b, whole = chunk(b, *args, 20, stack=stack)
        assert a.runtime is rt and rt.step_graphs.entries == graphs_before
        assert (rt.step_graphs.eager == eager
                and rt.step_graphs.replays == replays + 1)
        assert all(torch.equal(one[k][0], whole[k][0]) for k in one)
        assert one["update_losses"].shape == (1, 1, 3)
        a, _ = chunk(a, *args, 21, stack=stack)
        # one eager step and capture a kind: critic-only, critic + actor
        assert a.runtime is not rt and a.runtime.step_graphs.eager == 2
    finally:
        graphs.deterministic(False)


def test_td3_checkpoint_restores_into_a_captured_loop(tmp_path):
    """A checkpoint restored into the loop whose graphs are captured
    (copy_ into their static tensors) replays the same next chunk."""
    _require_cuda()
    from tinycarlo_torch.train.td3_loop import chunk
    from tinycarlo_torch.utils import checkpoint, graphs

    graphs.deterministic(True)
    try:
        a, args, stack = _td3_loop(64, seed=4)
        a, _ = chunk(a, *args, 8, stack=stack)
        path = str(tmp_path / "loop.pt")
        checkpoint.save(path, a)
        a, first = chunk(a, *args, 8, stack=stack)
        graphs_before = dict(a.runtime.step_graphs.entries)
        checkpoint.restore(path, a)
        a, again = chunk(a, *args, 8, stack=stack)
    finally:
        graphs.deterministic(False)
    assert a.runtime.step_graphs.entries == graphs_before  # no new capture
    assert all(torch.equal(first[k], again[k]) for k in first)


def test_rollout_graph_matches_eager():
    """vector.rollout on the card: 12 steps of a rendering Stanley rollout
    through its replayed graph (3 eager, 9 replays) equal the eager
    rollout bit for bit, respawns included."""
    _require_cuda()
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.benchmarks import bench as pbench
    from tinycarlo_torch.train.stanley import stanley_steering

    params = fenv.make_env_params(pbench.CONFIG)
    n = 128

    def policy(obs, env_state, generator):
        info = fenv._info(params, env_state)
        steer = torch.clamp(stanley_steering(
            info["cte"], info["heading_error"], 0.5, 5.0, 30.0), -1.0, 1.0)
        return {"car_control": torch.stack(
            [torch.full_like(steer, 0.5), steer], -1),
            "maneuver": torch.zeros(n, dtype=torch.int32, device="cuda")}

    outs = []
    for graph in (True, False):
        vstate, _ = vector.reset(params, n, seed=6, render=False)
        stats = {}
        final, traj = vector.rollout(params, vstate, policy, 12,
                                     max_episode_steps=5, graph=graph,
                                     info_keys=("position",), stats=stats)
        outs.append((final, traj, stats))
    (fa, ta, sa), (fb, tb, sb) = outs
    assert sa == {"replays": 9, "captures": 1} and sb == {}
    assert bool(ta["truncated"].any())
    assert set(ta) == set(tb)
    assert all(torch.equal(ta[k], tb[k]) for k in ta)
    assert torch.equal(fa.env.car.position, fb.env.car.position)



# ---- the step-graph cache (utils/graphs.py StepGraphs) ---------------------

def test_step_graphs_replay_a_key():
    """A key's first call runs the step eagerly and captures it; each later
    call replays the graph and returns the step's static result."""
    _require_cuda()
    from tinycarlo_torch.utils import graphs

    x = torch.zeros(4, device="cuda")
    steps = graphs.StepGraphs("cuda")

    def step():
        x.add_(1)
        return x * 2

    first = steps.run("k", step)
    outs = [steps.run("k", step).clone() for _ in range(3)]
    torch.cuda.synchronize()
    assert float(first[0]) == 2.0 and float(x[0]) == 4.0
    assert [float(o[0]) for o in outs] == [4.0, 6.0, 8.0]
    assert (steps.eager, steps.captures, steps.replays) == (1, 1, 3)
    assert steps.replays_by_key == {"k": 3}


def test_step_graphs_tracing_keys_and_held_counts():
    """Tracing off and on capture two graphs of one key; the traced one
    writes its device span's marks at every replay, and the host count its
    capture held is added once a replay."""
    _require_cuda()
    from tinycarlo_torch.utils import graphs, profiling

    x = torch.zeros(1, device="cuda")
    steps = graphs.StepGraphs("cuda")

    def step():
        with profiling.device_span("s"):
            x.add_(1)
        profiling.count("n", 3)

    for _ in range(2):
        steps.run("k", step)
    with profiling.tracing() as tr:
        for _ in range(4):
            steps.run("k", step)
    assert set(steps.entries) == {("k", False), ("k", True)}
    assert (steps.eager, steps.captures, steps.replays) == (2, 2, 4)
    assert float(x) == 6.0
    # the traced warm-up counts as it runs; 3 replays add the held count
    assert tr.counters["n"] == 3 * 4
    spans = [sp for sp in tr.device_spans() if sp.name == "s"]
    assert [sp.replayed for sp in spans] == [False, True, True, True]


@pytest.mark.parametrize("launches,named", [(0, True), (2, True),
                                            (1, False)])
def test_step_graphs_check_render_launches(launches, named):
    """A capture raises unless each render kernel the step names was
    recorded once and every other render kernel never: a step that
    recorded the masks kernel 0 or 2 times, or once unnamed."""
    _require_cuda()
    from tinycarlo_torch.utils import graphs

    L, h, w, t = 5, 32, 48, 2
    u0, v0, u1, v1, draw, lay = _segments(7, 8, 100, h, w, L, "cuda")
    bundle = rk.compact_env_idx_soa(
        u0, v0, u1, v1, draw, 100 * rk._n_xblocks(w), h, t,
        edge_layer=lay, n_layers=L, w=w)
    steps = graphs.StepGraphs("cuda")

    def step():
        for _ in range(launches):
            rk.masks_kernel(bundle, L, (h, w), t)

    with pytest.raises(RuntimeError, match="recorded the launches"):
        steps.run("k", step, kernels=(rk.masks_kernel,) if named else ())
    assert steps.captures == 0 and not steps.entries


def test_step_graphs_warm_up_and_capture_on_one_stream():
    """Every warm-up and capture -- of two caches, of a rollout call and of
    the primitives -- runs on the one side stream of the card, which is
    not the default stream."""
    _require_cuda()
    from tinycarlo_torch.utils import graphs

    seen = []
    x = torch.zeros(1, device="cuda")

    def step():
        seen.append(torch.cuda.current_stream())
        x.add_(1)

    graphs.StepGraphs("cuda").run("a", step)
    graphs.StepGraphs("cuda").run("b", step)
    graphs.warm_up(step)
    graphs.capture(step)
    assert len(seen) == 6
    assert all(s == graphs.side_stream() for s in seen)
    assert graphs.side_stream() != torch.cuda.default_stream()


def test_gym_interleaved_modes_match_eager():
    """Steps that switch between the gym's (render, wrapped) modes, with
    tracing off and on, every step -- eight graphs in one memory pool --
    return what eager steps return, bit for bit."""
    _require_cuda()
    from contextlib import nullcontext

    from tinycarlo_torch.benchmarks import gym_bench as gb
    from tinycarlo_torch.utils import profiling

    envs = [gb.make_env(gb.CONFIG1, mode) for mode in ("graph", "eager")]
    for env in envs:
        env.reset(seed=3)
    modes = [(False, False), (True, False), (False, True), (True, True)]
    for i, action in enumerate(gb.actions(48, seed=7)):
        no_obs, wrapped = modes[i % 4]
        traced = (i // 4) % 3 == 2
        outs = []
        for env in envs:
            env.no_observation, env.wrapped = no_obs, wrapped
            with profiling.tracing() if traced else nullcontext():
                outs.append(env.step(action))
        assert gb._same(outs[0], outs[1]), i
        if outs[0][2] or outs[0][3]:
            for env in envs:
                env.reset()
    steps = envs[0].step_graphs
    assert steps.captures == 8 and steps.replays == 48 - 8


# ---- imitation learning (train/il.py) ----------------------------------------

def _il_params(classes=False):
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.benchmarks import bench as pbench

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return fenv.make_env_params(
        pbench.CONFIG if classes
        else os.path.join(repo, "examples", "config_simple_layout.yaml"))


def _il_data(n, shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    m = torch.randint(3, (n,), generator=g, device="cuda")
    pools = torch.stack([torch.nonzero(m == i)[:, 0][:4] for i in range(3)])
    return {"x": torch.randint(256, (n, *shape), generator=g, device="cuda",
                               dtype=torch.uint8),
            "m": m,
            "y": torch.rand((n, 1), generator=g, device="cuda") * 2 - 1,
            "pools": pools.to(torch.int32),
            "pool_n": torch.full((3,), 4, dtype=torch.int32, device="cuda")}


def test_il_train_graph_matches_eager():
    """train_chunk through its replayed graph (1 eager step, then replays)
    equals the eager steps bit for bit -- losses, parameters, BatchNorm
    running statistics and Adam state -- from the same seeds, with the
    generator's balanced draws, deterministic algorithms on."""
    _require_cuda()
    from tinycarlo_torch.train import il
    from tinycarlo_torch.utils import graphs

    cfg = il.ILConfig(batch_size=16, learning_rate=1e-3)
    shape = (128, 160, 3)
    data = _il_data(64, shape, 1)
    graphs.deterministic(True)
    try:
        runs = []
        for graph in (True, False):
            s = il.create(shape, cfg, seed=2)
            g = torch.Generator(device="cuda").manual_seed(3)
            s, l1 = il.train_chunk(s, cfg, data, 5, generator=g, graph=graph)
            s, l2 = il.train_chunk(s, cfg, data, 5, generator=g, graph=graph)
            runs.append((s, torch.cat([l1, l2])))
    finally:
        graphs.deterministic(False)
    (a, la), (b, lb) = runs
    assert (a.runtime.step_graphs.replays == 9
            and a.runtime.step_graphs.eager == 1)
    assert torch.equal(la, lb) and bool(torch.isfinite(la).all())
    assert _equal_states((a.model, a.opt), (b.model, b.opt))
    assert not torch.equal(a.model.encoder.convs[0].bn1.running_var,
                           torch.ones_like(a.model.encoder.convs[0].bn1.
                                           running_var))


def test_il_collect_graph_matches_eager():
    """Two expert chunks through the collector's replayed graph (the first
    captures) equal two eager chunks from the same generator seed bit for
    bit, auto-resets and camera draws included; the rank kernel launched
    once per eager render and capture (the replays pass no wrapper)."""
    _require_cuda()
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train import il

    params = _il_params()
    cfg = il.ILConfig(collect_max_cte=0.02)
    outs = []
    for graph in (True, False):
        coll = il.Collector(params, cfg, 8, 32, graph=graph)
        g = torch.Generator(device="cuda").manual_seed(4)
        before = rk.rank_kernel.launches
        trajs = [coll.chunk(m, g, trace=True) for m in (0, 2)]
        outs.append((coll, trajs, rk.rank_kernel.launches - before))
    (ca, ta, na), (cb, tb, nb) = outs
    assert ca.stats == {"renders": 1, "captures": 1, "replays": 31}
    assert cb.stats == {"renders": 32, "captures": 0, "replays": 0}
    assert na == ca.stats["renders"] + ca.stats["captures"] and nb == 32
    for x, y in zip(ta, tb):
        assert set(x) == set(y)
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert bool(ta[0]["obs"].any()) and bool(
        torch.cat([t["done"] for t in ta]).any())


def test_il_dagger_graph_matches_eager():
    """A DAgger chunk (a render and the combo every step) through its
    graph equals the eager chunk bit for bit; launches = renders +
    captures."""
    _require_cuda()
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train import il
    from tinycarlo_torch.utils import graphs

    params = _il_params()
    cfg = il.ILConfig()
    model = il.create(fenv.observation_shape(params), cfg, seed=6).model
    outs = []
    graphs.deterministic(True)
    try:
        for graph in (True, False):
            before = rk.rank_kernel.launches
            coll = il.Collector(params, cfg, 8, 12, model=model, graph=graph)
            traj = coll.chunk(1, torch.Generator(device="cuda").manual_seed(5))
            outs.append((coll.stats, traj, rk.rank_kernel.launches - before))
    finally:
        graphs.deterministic(False)
    (sa, ta, na), (sb, tb, nb) = outs
    assert sa == {"renders": 1, "captures": 1, "replays": 11}
    assert na == 2 and nb == 12
    assert all(torch.equal(ta[k], tb[k]) for k in ta)


def test_il_classes_collection_launches_masks_kernel():
    """On a classes config the collector's graph records the masks
    kernel once; launches = eager renders + captures."""
    _require_cuda()
    from tinycarlo_torch.ops import rasterize_kernels as rk
    from tinycarlo_torch.train import il

    before = rk.masks_kernel.launches
    coll = il.Collector(_il_params(classes=True), il.ILConfig(), 8, 16)
    traj = coll.chunk(0, torch.Generator(device="cuda").manual_seed(1))
    assert rk.masks_kernel.launches - before == 2
    assert coll.stats == {"renders": 1, "captures": 1, "replays": 7}
    assert bool(traj["obs"][traj["keep"]].any())


def test_bn_train_update_is_capturable():
    """ConvBlock's train-mode forward (flax's running-statistics update,
    in place) captured as a CUDA graph: 3 replays move the running
    statistics as 3 eager calls do, bit for bit."""
    _require_cuda()
    from tinycarlo_torch.models.tinycar_net import ConvBlock

    torch.manual_seed(0)
    a = ConvBlock(3, 8).cuda().train()
    b = ConvBlock(3, 8).cuda().train()
    b.load_state_dict(a.state_dict())
    x = torch.randn(16, 3, 32, 40, device="cuda")
    out = torch.empty(16, 8, 16, 20, device="cuda")
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), torch.no_grad():
        out.copy_(a(x))  # warm-up: one real update
    torch.cuda.current_stream().wait_stream(stream)
    with torch.no_grad():
        b(x)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g), torch.no_grad():
        out.copy_(a(x))
    for _ in range(3):
        g.replay()
        with torch.no_grad():
            want = b(x)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(a.bn1.running_mean, b.bn1.running_mean)
    assert torch.equal(a.bn1.running_var, b.bn1.running_var)
    assert not torch.equal(a.bn1.running_var, torch.ones_like(
        a.bn1.running_var))


@pytest.mark.parametrize("name", ["knuffingen", "simple_layout"])
def test_grid_car_info_matches_full_scan(name):
    """car_info through the LanelineGrid equals the full scan bit for bit
    on the card, float32, at 1024 positions fuzzed over the grid's domain
    (an eighth of them on cell corners)."""
    _require_cuda()
    from tinycarlo_torch import car as car_mod
    from tinycarlo_torch.config import CarConfig, MapConfig
    from tinycarlo_torch.map_compiler import compile_map

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path, ppm = {"knuffingen": ("knuffingen.json", 150),
                 "simple_layout": ("simple_layout.json", 450)}[name]
    kw = dict(json_path=os.path.join(repo, "examples", "maps", path),
              pixel_per_meter=ppm)
    md_g = compile_map(MapConfig(query_grid=True, **kw))
    md_f = compile_map(MapConfig(**kw))
    g = md_g.laneline_grid
    assert g is not None and g.cand_idx.is_cuda
    rng = np.random.default_rng(4)
    o = g.origin.double().cpu().numpy()
    cell = 1.0 / float(g.inv_cell)
    pos = rng.uniform(o, o + np.asarray([g.nx * cell, g.ny * cell]),
                      size=(1024, 2))
    pos[:128] = o + np.round((pos[:128] - o) / cell) * cell
    n = len(pos)
    position = torch.tensor(pos, dtype=torch.float32, device="cuda")
    rot = torch.linspace(-3.0, 3.0, n, device="cuda")
    zeros = torch.zeros(n, device="cuda")
    st = car_mod.CarState(
        position=position,
        position_front=position + 0.0487 * torch.stack(
            [torch.cos(rot), torch.sin(rot)], dim=-1),
        rotation=rot, steering_angle=zeros, radius=zeros,
        velocity=torch.full((n,), 0.1, device="cuda"),
        local_path=md_g.lanepath.edges[0].expand(
            n, car_mod.PATH_LEN, 2).contiguous(),
        local_path_len=torch.full((n,), 2, dtype=torch.int32,
                                  device="cuda"),
        last_maneuver=torch.zeros(n, dtype=torch.int32, device="cuda"))
    got = car_mod.car_info(md_g, CarConfig(), st)
    want = car_mod.car_info(md_f, CarConfig(), st)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# the SP test's config: bench.py's (simple_layout classes, t = 2) at 64x80
SP_CONFIG = {
    "sim": {"fps": 30, "observation_space_format": "classes"},
    "car": {"wheelbase": 0.0487, "track_width": 0.027, "max_velocity": 0.15,
            "max_steering_angle": 30, "steering_speed": 30,
            "max_acceleration": 0.1, "max_deceleration": 1.0},
    "camera": {"position": [0.0, -0.005, 0.04], "orientation": [22, 0, 0],
               "resolution": [64, 80], "fov": 80, "max_range": 0.5,
               "line_thickness": 2},
    "map": {"json_path": os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "examples", "maps", "simple_layout.json"), "pixel_per_meter": 450},
}


def _sp_rank(rank, init_file, out_dir):
    """One of two gloo ranks on the one card: the SP classes and rank
    renders of 64 envs against the unsharded renders."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.parallel import make_mesh, multihost
    from tinycarlo_torch.parallel.sp import render_observation_batch_sp

    torch.cuda.set_device(0)  # both ranks on the one card
    multihost.initialize(init_method="file://" + init_file, world_size=2,
                         rank=rank, backend="gloo")
    mesh = make_mesh(model=2, device_type="cuda")
    out = {}
    for fmt in ("classes", "rank"):
        cfg = dict(SP_CONFIG, sim=dict(SP_CONFIG["sim"],
                                       observation_space_format=fmt))
        params = fenv.make_env_params(cfg)
        states = vector.reset(params, 64, seed=3, render=False)[0].env
        want = fenv.render_observation_batch(params, states)
        kernel = fenv.render_kernel(params)
        before = kernel.launches, rk.front_kernel.launches
        got = render_observation_batch_sp(params, states, mesh, fmt=fmt)
        out[fmt] = (bool(torch.equal(got, want)),
                    (kernel.launches - before[0],
                     rk.front_kernel.launches - before[1]),
                    int((want > 0).sum()))
    torch.save(out, os.path.join(out_dir, f"sp_{rank}.pt"))
    torch.distributed.destroy_process_group()


def test_sp_render_two_ranks(tmp_path):
    """Two gloo ranks share the one card (model = 2): each launches the
    front kernel and the masks or rank kernel once on its edge shard, and
    the composed frame equals the unsharded render bit for bit."""
    _require_cuda()
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    init_file = str(tmp_path / "store")
    procs = [ctx.Process(target=_sp_rank, args=(r, init_file, str(tmp_path)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0]
    for r in range(2):
        out = torch.load(tmp_path / f"sp_{r}.pt", weights_only=False)
        for fmt, (equal, launches, lit) in out.items():
            assert equal and launches == (1, 1) and lit > 0, (r, fmt)


def test_config3_graph_matches_eager():
    """BASELINE config 3 (knuffingen, 480x640) at 16 envs: 6 replays of
    the captured step equal 6 eager steps bit for bit from one state,
    index and generator seed, respawning every 3 steps; the carried step
    index advances the maneuvers (u-turn entries in the run)."""
    _require_cuda()
    from tinycarlo_torch.benchmarks import baseline_configs as bc

    for fmt in ("classes", "rank"):
        r = bc.graph_matches_eager3(bc.make_params3("cuda", fmt), 16,
                                    steps=6, max_episode_steps=3)
        assert r["equal"], fmt
        assert r["uturn_entries"] > 0 and r["respawns"] >= 16
        assert r["offsets"][0] == r["offsets"][1] > 0


def test_config3_measure_on_the_card():
    """measure3 at 16 envs and 4-step chunks: the graph, one render launch
    a warm-up step and one at capture, a checksum, the index back at the
    chunk's length."""
    _require_cuda()
    from tinycarlo_torch.benchmarks import baseline_configs as bc

    before = rk.masks_kernel.launches
    r = bc.measure3(n_envs=16, chunk=4, fmt="classes")
    assert r["graph"] is not None and r["checksum"] > 0
    assert rk.masks_kernel.launches - before == bc.WARMUP + 1
    assert int(r["state"][2]) == 4


@pytest.mark.parametrize("mode", ["kin", "kininfo", "car", "proj", "comp",
                                  "full", "bench"])
def test_step_decomp_mode_captures(mode):
    """Each step_decomp mode captures: the masks kernel launched once at
    capture (and once a warm-up step) in the rendering modes, never in
    the others; the replays give a checksum."""
    _require_cuda()
    from tinycarlo_torch.benchmarks import step_decomp as sd

    before = rk.masks_kernel.launches
    r = sd.run(modes=(mode,), n_envs=64, iters=2, repeats=1)
    launched = rk.masks_kernel.launches - before
    assert launched == (3 if mode in sd.RENDERING else 0)
    assert r["modes"][0]["mode"] == mode and r["modes"][0]["ms"] > 0


# ---- the tracer (utils/profiling.py, ops/csrc/trace_mark.cu) ---------------

def _kineto(prof):
    """(name, start ns) of a finished profile's device activity."""
    return [(e.name(), e.start_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def test_tracer_device_spans_survive_replay():
    """Device spans and a device counter captured into a graph: every
    replay writes marks of its own, nested under the step's span; on the
    host clock each replay's marks fall between the host's reads before
    its launch and after its synchronize, and the intervals between marks
    equal those between the mark kernels' profiler starts within 1 us (the
    profiler's own device timestamps drift from the host clock by tens of
    microseconds over seconds: PERF.md section 6); the counter adds once a
    replay; a graph captured with tracing off holds no mark kernel."""
    _require_cuda()
    import time

    from torch.profiler import ProfilerActivity, profile

    from tinycarlo_torch.utils import profiling

    x = torch.ones(1 << 16, device="cuda")

    def body():
        with profiling.device_span("step"):
            with profiling.device_span("inner"):
                x.mul_(1.0001)
            profiling.device_count("ones", x[:8] > 0)

    host = []
    with profiling.tracing() as tr:
        body()  # eager, on the current stream
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body()
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(graph):
            body()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                h0 = time.time_ns()
                graph.replay()
                torch.cuda.synchronize()
                host.append((h0, time.time_ns()))
    spans = tr.device_spans()
    replayed = [s for s in spans if s.replayed]
    assert [s.name for s in replayed] == ["step", "inner"] * 5
    assert [s.name for s in spans if not s.replayed] == ["step", "inner"] * 2
    for s in spans:
        assert s.end_ns > s.start_ns
        if s.name == "inner":
            p = spans[s.parent]
            assert p.name == "step"
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    slack = 20_000  # ns: the offset is measured to a few microseconds
    for (h0, h1), step in zip(host, replayed[::2]):
        assert h0 - slack <= step.start_ns < step.end_ns <= h1 + slack, (
            h0, step.start_ns, step.end_ns, h1)
    assert tr.counters["ones"] == 8 * 7
    assert tr.counters["trace.marks_lost"] == 0
    starts = np.sort([t for n, t in _kineto(prof) if "mark_kernel" in n])
    assert len(starts) == 4 * 5, len(starts)
    marks = np.sort([t for s in replayed for t in (s.start_ns, s.end_ns)])
    intervals = np.abs(np.diff(marks) - np.diff(starts))
    assert intervals.max() < 1_000, intervals

    off = torch.cuda.CUDAGraph()
    with torch.cuda.graph(off):
        body()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        off.replay()
        torch.cuda.synchronize()
    assert not any("mark_kernel" in n for n, _ in _kineto(prof))


def test_tracer_small_ring_on_the_card(monkeypatch):
    _require_cuda()
    from tinycarlo_torch.utils import profiling

    monkeypatch.setattr(profiling, "RING_MARKS", 8)
    with profiling.tracing() as tr:
        for _ in range(20):
            with profiling.device_span("x"):
                pass
    assert tr.counters["trace.marks_lost"] == 40 - 8
    assert len(tr.device_spans()) == 4


def test_tracer_leaves_rollout_and_gym_outputs():
    """A rendering rollout (3 eager steps, 17 replays) and 30 gym steps
    give the same outputs bit for bit with tracing on and off; the gym
    shim keeps a graph for each; its spans split the step into host work
    and the wait."""
    _require_cuda()
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch import vector
    from tinycarlo_torch.benchmarks import bench as pbench
    from tinycarlo_torch.gym_env import TinyCarloEnv
    from tinycarlo_torch.utils import profiling

    params = fenv.make_env_params(pbench.CONFIG)
    n = 64

    def policy(obs, env_state, generator):
        steer = torch.rand(n, generator=generator, device="cuda") * 2 - 1
        return {"car_control": torch.stack(
            [torch.full_like(steer, 0.5), steer], -1),
            "maneuver": torch.zeros(n, dtype=torch.int32, device="cuda")}

    def roll():
        vstate, _ = vector.reset(params, n, seed=6, render=False)
        return vector.rollout(params, vstate, policy, 20,
                              max_episode_steps=7)[1]

    off = roll()
    with profiling.tracing() as tr:
        on = roll()
    assert all(torch.equal(off[k], on[k]) for k in off)
    replayed = [s for s in tr.device_spans() if s.replayed]
    assert sum(s.name == "rollout.step" for s in replayed) == 17
    assert sum(s.name == "render" for s in replayed) == 17
    e = params.map_data.packed_edges.shape[1]
    nxb = -(-params.cfg.camera.resolution[1] // 128)
    assert tr.counters["render.copies"] == 20 * n * e * nxb

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = TinyCarloEnv(config=os.path.join(
        repo, "examples", "config_simple_layout.yaml"))

    def steps():
        env.reset(seed=4)
        rng = np.random.default_rng(4)
        out = []
        for _ in range(30):
            obs, r, te, tr_, info = env.step(
                {"car_control": rng.uniform(-1, 1, 2),
                 "maneuver": int(rng.integers(0, 4))})
            out.append((obs, r, te, tr_, info["cte"]))
        return out

    off = steps()
    with profiling.tracing() as tr:
        on = steps()
    assert len(env.step_graphs.entries) == 2
    for a, b in zip(off, on):
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    waits = [s for s in tr.spans if s.name == "gym.wait" and s.call_id]
    assert len(waits) == 30 and all(s.end_ns > s.start_ns for s in waits)


# ---- the render's front end (ops/csrc/front.cu) ----------------------------

def _front_params(name, thickness=None, resolution=None,
                  dtype=torch.float32):
    """The benchmark's configuration `name` on the card, its camera's
    thickness or resolution replaced when given."""
    import json

    from tinycarlo_torch import env as fenv

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "portbench", "configs", f"{name}.json")
    with open(path) as f:
        cfg = json.load(f)["config"]
    cfg["map"]["json_path"] = os.path.join(os.path.dirname(path),
                                           cfg["map"]["json_path"])
    if thickness is not None:
        cfg["camera"]["line_thickness"] = thickness
    if resolution is not None:
        cfg["camera"]["resolution"] = list(resolution)
    return fenv.make_env_params(cfg, dtype=dtype, device="cuda")


def _front_poses(params, n, seed):
    """(n + 16, 3, 4) camera poses: n cars at the spawn table's rows in
    turn, then 16 cars at random positions over the map and random yaws
    (edges behind the camera and past max_range), 4 of them with their
    depth row replaced: 0 (every endpoint on the camera plane), the near
    plane's depth (every endpoint at z = -1e-7), and two that tilt the map
    through the near plane, far from the camera."""
    from tinycarlo_torch import camera as cam
    from tinycarlo_torch import env as fenv

    md = params.map_data
    dtype = md.packed_nodes.dtype
    rows = torch.arange(n, device="cuda") % md.spawns.count
    state, _, _ = fenv.reset(params, n, spawn_row=rows, render=False)
    nodes = md.packed_nodes[0]
    lo, hi = nodes.min(0).values, nodes.max(0).values
    g = torch.Generator(device="cuda").manual_seed(seed)
    pos = lo + (hi - lo) * torch.rand((16, 2), generator=g, device="cuda",
                                      dtype=dtype)
    yaw = torch.rand(16, generator=g, device="cuda", dtype=dtype) * 6.3
    rand = torch.matmul(params.camera.E,
                        cam.car_world_to_body_matrix(pos, yaw))
    mid = ((lo + hi) / 2).tolist()
    for i, row in enumerate(([0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, -1e-7],
                             [1.0, 0.0, 0.0, -mid[0]],
                             [0.0, -1.0, 0.0, mid[1]])):
        rand[i, 2] = torch.tensor(row, dtype=dtype)
    return torch.cat([fenv._camera_pose(params, state), rand]).contiguous()


def _front_args(params, pose):
    md = params.map_data
    cam = params.cfg.camera
    e = md.packed_edges.shape[1]
    return (md.packed_nodes, md.packed_edges, md.packed_edge_mask,
            md.packed_edge_layer, pose, params.camera.K, md.n_layers,
            tuple(cam.resolution), cam.line_thickness, cam.max_range,
            rk._budget(e, cam.resolution[1], cam.max_visible_segments),
            md.packed_layer_bounds)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# (config, envs, thickness, resolution): the benchmark's two cells (lane
# blocks 2 and 5), thickness 1 on both, one lane block at 120x128, B = 1
FRONT_CASES = [
    ("simple_layout-128x160", 4096, None, None),
    ("knuffingen-480x640", 512, None, None),
    ("simple_layout-128x160", 256, 1, None),
    ("knuffingen-480x640", 64, 1, None),
    ("simple_layout-128x160", 256, 2, (120, 128)),
    ("simple_layout-128x160", 256, 1, (120, 128)),
    ("knuffingen-480x640", 1, None, None),
]


@pytest.mark.parametrize("name,n,t,res", FRONT_CASES)
def test_front_kernel_matches_plain(name, n, t, res):
    """The front kernel's bundle equals the torch composition's, all 8
    tensors bit for bit, on spawn-table states and poses that clip at the
    near plane and the range; the masks and rank kernels' frames from
    both bundles are equal."""
    _require_cuda()
    params = _front_params(name, t, res)
    pose = _front_poses(params, n, seed=n)
    if n == 1:
        pose = pose[:1].contiguous()
    args = _front_args(params, pose)
    before = rk.front_kernel.launches
    got = rk.front_kernel(*args)
    assert rk.front_kernel.launches == before + 1
    want = rk.front_plain(*args)
    torch.cuda.synchronize()
    for name_, g, w_ in zip(("idx", "ax", "ay", "abx", "aby", "inv", "bw",
                             "counts"), got, want):
        assert g.dtype == w_.dtype and g.shape == w_.shape, name_
        assert torch.equal(_bits(g), _bits(w_)), name_
    assert int(want[-1][0].sum()) > 0
    md = params.map_data
    cam = params.cfg.camera
    res_ = tuple(cam.resolution)
    for kernel in (rk.masks_kernel, rk.rank_kernel):
        assert torch.equal(kernel(got, md.n_layers, res_, cam.line_thickness),
                           kernel(want, md.n_layers, res_,
                                  cam.line_thickness))


def test_front_kernel_float64_and_overflow():
    """float64 params (the projection in float64, as the composition's)
    and a budget of 3 segments, which drops copies."""
    _require_cuda()
    params = _front_params("simple_layout-128x160", dtype=torch.float64)
    pose = _front_poses(params, 128, seed=2)
    args = list(_front_args(params, pose))
    for k in (args[10], 3 * 2):
        args[10] = k
        got = rk.front_kernel(*args)
        want = rk.front_plain(*args)
        for g, w_ in zip(got, want):
            assert torch.equal(_bits(g), _bits(w_))
    assert int(want[-1][3].sum()) > 0
    with pytest.raises(ValueError, match="float32"):
        rk.front_kernel(*args[:4], pose.half(), *args[5:])


def test_front_kernel_in_the_render_and_its_graph():
    """`render_observation_batch` on the card launches the front kernel
    once a render and counts its envs in `render.front`; a replayed graph
    of the render equals the eager render, classes and rgb."""
    _require_cuda()
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.utils import profiling

    params = _front_params("simple_layout-128x160")
    n = 512
    rows = torch.arange(n, device="cuda") % params.map_data.spawns.count
    state, _, _ = fenv.reset(params, n, spawn_row=rows, render=False)
    for fmt in ("classes", "rgb"):
        before = rk.front_kernel.launches
        with profiling.tracing() as tr:
            eager = fenv.render_observation_batch(params, state, fmt=fmt)
        assert rk.front_kernel.launches == before + 1
        assert tr.counters["render.front"] == n
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fenv.render_observation_batch(params, state, fmt=fmt)
        torch.cuda.current_stream().wait_stream(stream)
        with torch.cuda.graph(graph):
            static = fenv.render_observation_batch(params, state, fmt=fmt)
        assert rk.front_kernel.launches == before + 3
        static.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, eager)


# ---- the env step's per-car work (ops/csrc/car.cu) -------------------------

# every output of the per-car work, in `_car_fields`' order
CAR_FIELDS = ("position", "position_front", "rotation", "steering_angle",
              "radius", "velocity", "local_path", "local_path_len",
              "last_maneuver", "truncated", "cte", "heading_error",
              "laneline_distances", "info_local_path", "info_local_path_len",
              "info_velocity", "reward", "terminated")


def _car_fields(out):
    """The outputs of `env._car_work` (or its plain version) as one tuple
    of tensors, floats viewed as int32 bits."""
    car, truncated, info, reward, terminated = out
    ts = (car.position, car.position_front, car.rotation, car.steering_angle,
          car.radius, car.velocity, car.local_path, car.local_path_len,
          car.last_maneuver, truncated, info["cte"], info["heading_error"],
          info["laneline_distances"], info["local_path"],
          info["local_path_len"], info["velocity"], reward, terminated)
    return tuple(_bits(t) for t in ts)


def _car_compare(params, car, action, wrapped, bad):
    """One step of the kernel and of the composition from `car`; adds
    each field's count of differing elements to `bad` (on the card, no
    wait) and returns the kernel's outputs."""
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.ops import car_kernel as ck

    before = ck.car_kernel.launches
    got = fenv._car_work(params, car, action, wrapped)
    assert ck.car_kernel.launches == before + 1
    want = fenv._car_work_plain(params, car, action, wrapped)
    for i, (g, w_) in enumerate(zip(_car_fields(got), _car_fields(want))):
        assert g.dtype == w_.dtype and g.shape == w_.shape, CAR_FIELDS[i]
        bad[i] += (g != w_).sum()
    return got


def _car_actions(rng, n, step, man_dtype):
    """Random actions past the clamp, steering 0 on every fourth env (the
    straight branch once the rate limit lets it), reverse on every eighth,
    maneuver (step + env) % 4."""
    control = rng.uniform(-1.3, 1.3, (n, 2)).astype(np.float32)
    control[::4, 1] = 0.0
    control[1::8, 0] = -np.abs(control[1::8, 0])
    man = (step + np.arange(n)) % 4
    return {"car_control": torch.tensor(control, device="cuda"),
            "maneuver": torch.tensor(man, dtype=man_dtype, device="cuda")}


# (config, envs): both benchmark maps at 1, 512 and 4096 envs
CAR_CASES = [(name, n) for name in ("simple_layout-128x160",
                                    "knuffingen-480x640")
             for n in (1, 512, 4096)]


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("name,n", CAR_CASES)
def test_car_kernel_matches_composition(name, n, wrapped):
    """The car kernel's step equals the torch composition's, every output
    bit for bit, over 320 steps of random actions with the maneuvers
    cycling (u-turn entries every step), reverse and straight driving,
    respawns on truncation, a cte past 10 track widths or 80 steps; the
    steps include truncations and failed first hops (int64 maneuvers when
    wrapped)."""
    _require_cuda()
    from tinycarlo_torch import car as car_mod
    from tinycarlo_torch import vector

    params = _front_params(name)
    md = params.map_data
    tw = params.cfg.car.track_width
    rows = torch.arange(n, device="cuda") % md.spawns.count
    car = car_mod.car_reset(md, params.cfg.car, rows)
    age = torch.zeros(n, dtype=torch.int32, device="cuda")
    rng = np.random.default_rng(n + 7 * wrapped)
    bad = torch.zeros(len(CAR_FIELDS), dtype=torch.int64, device="cuda")
    events = torch.zeros(3, dtype=torch.int64, device="cuda")
    man_dtype = torch.int64 if wrapped else torch.int32
    for step in range(320):
        action = _car_actions(rng, n, step, man_dtype)
        new, truncated, info, _, _ = _car_compare(params, car, action,
                                                  wrapped, bad)
        man = action["maneuver"].to(torch.int32)
        kept = truncated & (new.last_maneuver != man)  # failed first hop
        events += torch.stack([truncated.sum(), kept.sum(),
                               ((man == 2) & (car.last_maneuver != 2)).sum()])
        age += 1
        done = truncated | (info["cte"].abs() > 10 * tw) | (age >= 80)
        fresh = car_mod.car_reset(
            md, params.cfg.car, (rows + step) % md.spawns.count)
        car = vector._select(done, fresh, new)
        age = torch.where(done, 0, age)
    torch.cuda.synchronize()
    assert bad.tolist() == [0] * len(CAR_FIELDS), dict(
        zip(CAR_FIELDS, bad.tolist()))
    n_trunc, n_kept, n_uturn = events.tolist()
    assert n_uturn > 0
    if n >= 512:
        assert n_trunc > n_kept > 0


def _car_edge_state(params, n_rows):
    """A state of crafted cars: parked on packed-edge endpoints (velocity
    and action 0, so the rear axle stays on the node), on vertical
    lanepath edges, on edges into a dead end (a failed first hop) and one
    hop before one (a walk that truncates), the rest at spawn rows; the
    crafted cars' last maneuver is 1. Returns (state, crafted rows)."""
    from tinycarlo_torch import car as car_mod

    md = params.map_data
    lp = md.lanepath
    rows = torch.arange(n_rows, device="cuda") % md.spawns.count
    car = car_mod.car_reset(md, params.cfg.car, rows)
    nodes, edges = lp.nodes, lp.edges[lp.edge_mask]
    pn = md.packed_nodes[0]
    pe = md.packed_edges[0][:md.packed_layer_bounds[-1]]
    dx = nodes[edges[:, 1], 0] - nodes[edges[:, 0], 0]
    vertical = edges[dx == 0]
    dead = torch.nonzero(lp.node_mask & (lp.next_count == 0))[:, 0]
    into_dead = edges[torch.isin(edges[:, 1], dead)]
    # (pp, p) whose p leads on to a dead end alone, pp with a predecessor
    only = into_dead[lp.next_count[into_dead[:, 0]] == 1, 0]
    before_dead = edges[torch.isin(edges[:, 1], only)
                        & (lp.prev_count[edges[:, 0]] > 0)]
    groups = [("endpoint", pn[pe[:, 0]]), ("vertical", vertical),
              ("into_dead", into_dead), ("before_dead", before_dead)]
    r = 0
    for kind, src in groups:
        k = min(len(src), 8)
        assert k > 0, kind
        sl = slice(r, r + k)
        if kind == "endpoint":
            car.position[sl] = src[:k]
        else:
            e = src[:k].to(torch.int32)
            car.local_path[sl] = e[:, None, :].expand(-1, 4, 2)
            car.local_path_len[sl] = 4
            # the rear axle 0.02 m behind the edge's end, on its line
            p0, p1 = nodes[e[:, 0]], nodes[e[:, 1]]
            d = p1 - p0
            d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
            car.position[sl] = p1 - 0.02 * d
            car.rotation[sl] = torch.atan2(d[:, 1], d[:, 0])
        car.velocity[sl] = 0.0 if kind == "endpoint" else 0.1
        car.last_maneuver[sl] = 1
        r += k
    return car, r


def test_car_kernel_edge_cases():
    """Bit-equal on crafted cars (`_car_edge_state`): rear axles on packed
    endpoints (within_edge_bounds' early True), cte on vertical edges, a
    failed first hop (path and last maneuver kept) and a lookahead that
    truncates, each with every maneuver, wrapped and not."""
    _require_cuda()
    for name in ("simple_layout-128x160", "knuffingen-480x640"):
        params = _front_params(name)
        car, r = _car_edge_state(params, 64)
        n = car.position.shape[0]
        bad = torch.zeros(len(CAR_FIELDS), dtype=torch.int64, device="cuda")
        for m in range(4):
            control = torch.zeros((n, 2), device="cuda")
            control[8:r, 0] = 0.5
            action = {"car_control": control,
                      "maneuver": torch.full((n,), m, dtype=torch.int32,
                                             device="cuda")}
            for wrapped in (False, True):
                new, truncated, info, _, _ = _car_compare(
                    params, car, action, wrapped, bad)
            if m == 0:
                # parked on the node: the rear axle has not moved
                assert torch.equal(new.position[:8], car.position[:8])
                kept = truncated & (new.last_maneuver != m)
                assert bool(kept[:r].any()) and bool(
                    (truncated & ~kept)[:r].any()), name
        torch.cuda.synchronize()
        assert bad.tolist() == [0] * len(CAR_FIELDS), (name, dict(
            zip(CAR_FIELDS, bad.tolist())))


def test_car_kernel_graph_and_counters():
    """`env.step` launches the car kernel once a step and counts its envs
    in "car.kernel"; "car.resnaps" reads the u-turn entries the
    composition's inputs give (0 at maneuver 0); a captured and replayed
    step equals the eager step; an expanded action gives the
    composition's step."""
    _require_cuda()
    from tinycarlo_torch import env as fenv
    from tinycarlo_torch.ops import car_kernel as ck
    from tinycarlo_torch.utils import profiling

    params = _front_params("knuffingen-480x640")
    n = 512
    rows = torch.arange(n, device="cuda") % params.map_data.spawns.count
    state, _, _ = fenv.reset(params, n, spawn_row=rows, render=False)
    rng = np.random.default_rng(3)
    for step, cycle in enumerate((False, True, True)):
        action = _car_actions(rng, n, step, torch.int32)
        if not cycle:
            action["maneuver"].zero_()
        entries = int(((action["maneuver"] == 2)
                       & (state.car.last_maneuver != 2)).sum())
        before = ck.car_kernel.launches
        with profiling.tracing() as tr:
            state, _, _, _, _, _ = fenv.step(params, state, action,
                                             render=False)
        assert ck.car_kernel.launches == before + 1
        assert tr.counters["car.kernel"] == n
        assert tr.counters["car.resnaps"] == entries
        assert (entries > 0) == cycle
    action = _car_actions(rng, n, 5, torch.int32)
    eager = fenv.step(params, state, action, render=True)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fenv.step(params, state, action, render=True)
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        static = fenv.step(params, state, action, render=True)
    flat = lambda out: [_bits(t) for t in (  # noqa: E731
        *(getattr(out[0].car, f) for f in CAR_FIELDS[:9]), out[1], out[2],
        out[3], out[4], *out[5].values())]
    for t in flat(static):
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    for i, (g, w_) in enumerate(zip(flat(static), flat(eager))):
        assert torch.equal(g, w_), i
    # an expanded (strided) action, as callers pass one action to all envs
    bad = torch.zeros(len(CAR_FIELDS), dtype=torch.int64, device="cuda")
    action = {"car_control": torch.tensor([[0.4, 0.1]],
                                          device="cuda").expand(n, 2),
              "maneuver": torch.tensor([2], device="cuda").expand(n)}
    _car_compare(params, state.car, action, False, bad)
    assert bad.tolist() == [0] * len(CAR_FIELDS)
