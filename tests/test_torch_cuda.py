"""The port's CUDA kernels against their plain PyTorch versions on the
card. These tests need an NVIDIA GPU and nvcc and skip without them: a
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
