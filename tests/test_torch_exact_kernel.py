"""The exact kernel's plain version (tinycarlo_torch.ops.rasterize_kernels.
rasterize_masks_exact_env_plain) against the JAX package's Pallas
`_kernel_env_exact` in interpret mode, both fed the same bundle: the
port's `compact_env_exact_soa`, which equals the JAX package's element for
element in float64 (tests/test_torch_exact.py). Feeding the Pallas kernel
that bundle spares a compile of the JAX compaction per case.

Tolerance: none. uint8 output equal bit for bit; the plain version's
float32 output is exactly (uint8 > 0) as 0/1 (the Pallas kernel's float
output is 0/255, ROADMAP F0).

The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_exact import exact_segments
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_tpu.ops import rasterize_pallas as rp


@pytest.mark.parametrize("t,w", [(2, 160), (3, 96)])
def test_exact_plain_matches_jax_kernel(t, w):
    """The plain version equals rasterize_env_exact(interpret=True) on the
    same bundle bit for bit in uint8; its float32 output is exactly
    (uint8 > 0) as 0/1. An oversubscribed budget drops copies; env 0 draws
    nothing."""
    h, L = 32, 3
    segs = exact_segments(7 * t + w, 3, 12, h, w, L)
    k = 2 * rk._n_xblocks(w)  # oversubscribed: copies are dropped
    tb = rk.compact_env_exact_soa(
        *(torch.from_numpy(np.ascontiguousarray(x[:, 0])) for x in segs[:5]),
        k, h, t, edge_layer=torch.from_numpy(segs[5]), n_layers=L, w=w,
    )
    jb = (jnp.asarray(tb[0].numpy()),
          tuple(jnp.asarray(f.numpy()) for f in tb[1]),
          jnp.asarray(tb[2].numpy()))
    want = np.asarray(rp.rasterize_env_exact(jb, L, (h, w), t,
                                             interpret=True))
    got = rk.rasterize_masks_exact_env_plain(tb, L, (h, w), t)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    got_f = rk.rasterize_masks_exact_env_plain(tb, L, (h, w), t,
                                               out_dtype=torch.float32)
    assert got_f.dtype == torch.float32
    assert torch.equal(got_f, (got > 0).float())
    assert want.sum() > 0 and not want[0].any()
    assert int(tb[2][3].sum()) > 0
