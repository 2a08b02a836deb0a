"""The masks kernel's plain version (tinycarlo_torch.ops.rasterize_kernels.
rasterize_masks_env_plain) against the JAX package's Pallas kernels in
interpret mode on the same compaction bundle, and against the dense
rasterizers.

Rule: at thickness 1 the masks are equal bit for bit. At t >= 2 they may
differ only on stroke-boundary pixels, by
tests/test_rasterize_pallas.py's `_assert_equal_up_to_stroke_boundary`
(XLA's CPU backend may contract the stamp's products into fused
multiply-adds; the plain version and the CUDA kernel round every
operation).

The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterize_pallas import _assert_equal_up_to_stroke_boundary
from tests.test_torch_compaction import random_segments
from tinycarlo_torch.ops import rasterize as pras
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_tpu.ops import rasterize as jras
from tinycarlo_tpu.ops import rasterize_pallas as rp

B, L, E = 4, 3, 40


def _case(seed, h, w, t, k_per_block=E):
    """Random segments and the JAX package's production bundle for them."""
    segs = random_segments(seed, B, E, h, w, L)
    u0, v0, u1, v1, draw, edge_layer = segs
    k = k_per_block * rk._n_xblocks(w)
    bundle = jax.jit(partial(
        rp.compact_env_idx_soa, k=k, gran=16, h=h, thickness=t,
        n_layers=L, w=w,
    ))(*(jnp.asarray(x) for x in (u0, v0, u1, v1, draw)),
       edge_layer=jnp.asarray(edge_layer))
    return segs, bundle


def _torch_bundle(bundle):
    return tuple(torch.from_numpy(np.array(x)) for x in bundle)


def _per_layer(segs):
    """Per-env (L, E, 2) endpoints and (L, E) draw masks for the boundary
    rule and the dense rasterizers."""
    u0, v0, u1, v1, draw, edge_layer = segs
    onehot = edge_layer[None, :] == np.arange(L)[:, None]  # (L, E)
    for b in range(B):
        p0 = np.broadcast_to(np.stack([u0[b, 0], v0[b, 0]], -1), (L, E, 2))
        p1 = np.broadcast_to(np.stack([u1[b, 0], v1[b, 0]], -1), (L, E, 2))
        yield (np.ascontiguousarray(p0), np.ascontiguousarray(p1),
               draw[b, 0][None, :] & onehot)


def _assert_masks(got, want, segs, t):
    """got/want (B, L, H, W) against the boundary rule, env by env."""
    assert got.shape == want.shape
    for b, (p0, p1, draw) in enumerate(_per_layer(segs)):
        _assert_equal_up_to_stroke_boundary(
            got[b], want[b], jnp.asarray(p0), jnp.asarray(p1),
            jnp.asarray(draw), t,
        )


# (t, h, w, k per block): t=1 exact; the lane split at w=160; h=30 not a
# multiple of the 16-row band; an oversubscribed budget.
CASES = [(1, 32, 160, E), (2, 32, 160, 5), (3, 30, 48, E)]


@pytest.mark.parametrize("t,h,w,kb", CASES)
def test_plain_matches_env_idx_kernel(t, h, w, kb):
    segs, bundle = _case(10 + t, h, w, t, kb)
    want = np.asarray(rp.rasterize_env_idx(
        bundle, L, (h, w), t, gran=16, split=True, interpret=True
    ))
    got = rk.rasterize_masks_env_plain(_torch_bundle(bundle), L, (h, w), t)
    assert got.dtype == torch.uint8
    _assert_masks(got.numpy(), want, segs, t)
    assert want.sum() > 0 and not want[0].any()  # env 0 draws nothing
    if kb < E:
        assert np.asarray(bundle[-1])[3].sum() > 0  # copies were dropped


def test_plain_float_matches_env_idx_kernel():
    """float32 0/1 output, the TD3 feature path's dtype."""
    t, h, w = 2, 32, 160
    segs, bundle = _case(20, h, w, t)
    want = np.asarray(rp.rasterize_env_idx(
        bundle, L, (h, w), t, gran=16, split=True, interpret=True,
        out_dtype=jnp.float32,
    ))
    got = rk.rasterize_masks_env_plain(
        _torch_bundle(bundle), L, (h, w), t, out_dtype=torch.float32
    )
    assert got.dtype == torch.float32
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    _assert_masks(got.numpy(), want, segs, t)


def test_plain_matches_env_dma_kernel():
    """The uint8 DMA kernel (the bench's production path), sliced to w."""
    t, h, w = 2, 32, 160
    segs, bundle = _case(30, h, w, t)
    want = np.asarray(rp.rasterize_env_dma(
        bundle, L, (h, w), t, gran=16, split=True, group=4, nbuf=2,
        interpret=True,
    ))[..., :w]
    got = rk.rasterize_masks_env_plain(_torch_bundle(bundle), L, (h, w), t)
    _assert_masks(got.numpy(), want, segs, t)


@pytest.mark.parametrize("t,h,w", [(1, 32, 160), (2, 30, 48), (3, 32, 160)])
def test_plain_matches_dense(t, h, w):
    """The plain version on the port's own bundle against the port's dense
    rasterizer, and that against the JAX package's dense rasterizer."""
    segs = random_segments(40 + t, B, E, h, w, L)
    u0, v0, u1, v1, draw, edge_layer = (torch.from_numpy(x) for x in segs)
    got = rk.rasterize_masks_packed_soa(
        u0[:, 0], v0[:, 0], u1[:, 0], v1[:, 0], draw[:, 0], edge_layer, L,
        (h, w), t, max_visible=None,
    )
    dense = []
    for b, (p0, p1, dr) in enumerate(_per_layer(segs)):
        mine = pras.rasterize_masks(
            torch.from_numpy(p0), torch.from_numpy(p1),
            torch.from_numpy(dr), (h, w), t,
        ).numpy()
        theirs = np.asarray(jax.jit(
            jras.rasterize_masks, static_argnums=(3, 4)
        )(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(dr), (h, w), t))
        _assert_equal_up_to_stroke_boundary(
            mine, theirs, jnp.asarray(p0), jnp.asarray(p1),
            jnp.asarray(dr), t,
        )
        dense.append(mine)
    _assert_masks(got.numpy(), np.stack(dense), segs, t)
    assert got.numpy().sum() > 0


def c_argtypes(source, symbol):
    """The ctypes argument types of `symbol`'s C parameter list in
    ops/csrc/`source`, pointers as c_void_p."""
    import ctypes
    import os
    import re

    with open(os.path.join(os.path.dirname(rk.__file__), "csrc",
                           source)) as f:
        src = f.read()
    decl = re.search(rf'extern "C" int {symbol}\((.*?)\)', src, re.S)
    kinds = []
    for param in decl.group(1).split(","):
        ctype = param.strip().rsplit(" ", 1)[0]
        kinds.append(ctypes.c_void_p if "*" in param
                     else {"int": ctypes.c_int, "float": ctypes.c_float}[ctype])
    return kinds


def test_binding_matches_c_signature():
    """The ctypes argument types follow tc_masks_launch's parameter list in
    masks.cu, one for one (a mismatch only shows when the kernel launches)."""
    assert c_argtypes("masks.cu", "tc_masks_launch") == rk.MasksKernel.ARGTYPES


@pytest.mark.parametrize("kernel", [rk.FrameSoaKernel, rk.EnvSoaKernel,
                                    rk.EnvSegKernel])
def test_soa_binding_matches_c_signature(kernel):
    """The same for the frame, env and segment kernels: each wrapper's
    ctypes argument types follow its C launch function's parameter list in
    ops/csrc/<NAME>.cu."""
    assert c_argtypes(f"{kernel.NAME}.cu", kernel.SYMBOL) == kernel.ARGTYPES


def test_wrapper_dispatch_and_counter():
    """On CPU tensors the wrapper takes the plain version and counts no
    launch; the exact stroke at t >= 2 routes to the exact compaction and
    the exact kernel's plain version instead of the masks kernel."""
    t, h, w = 2, 32, 160
    _, bundle = _case(50, h, w, t)
    tb = _torch_bundle(bundle)
    before = rk.masks_kernel.launches
    out = rk.masks_kernel(tb, L, (h, w), t)
    assert rk.masks_kernel.launches == before
    np.testing.assert_array_equal(
        out.numpy(), rk.rasterize_masks_env_plain(tb, L, (h, w), t).numpy()
    )
    segs = random_segments(51, B, E, h, w, L)
    u0, v0, u1, v1, draw, lay = (torch.from_numpy(x) for x in segs)
    args = (u0[:, 0], v0[:, 0], u1[:, 0], v1[:, 0], draw[:, 0])
    exact = rk.rasterize_masks_packed_soa(*args, lay, L, (h, w), t,
                                          stroke="exact")
    assert rk.masks_kernel.launches == before
    want = rk.rasterize_masks_exact_env_plain(rk.compact_env_exact_soa(
        *args, E * rk._n_xblocks(w), h, t, edge_layer=lay, n_layers=L, w=w,
    ), L, (h, w), t)
    assert torch.equal(exact, want) and exact.sum() > 0
