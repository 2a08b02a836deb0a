"""The plain versions of the output-floor probes (tinycarlo_torch.ops.
probe_kernels `ovl_plain`, `fill_plain`, `skip_plain`) against the JAX
package's probe kernels of benchmarks/exp_r2.py, run with
interpret=True on the same values: equal.

exp_r2.py defines its Pallas kernels as closures inside `main()`
(`okernel` :156, the three `zkernel`s :192, :206, :224, `dkernel` :261),
so they cannot be imported; the copies below are those closures with the
script's sizes as arguments, at N = 8, L = 5, H = 128, W = 160. The
dkernel's output starts as whatever memory held, so `dskip` is compared
on its live frames only. XLA's CPU fuses okernel's multiply and add, so
a start where the fused and the unfused chain end on two sides of an
integer is held against the unfused chain in numpy instead. Then the probe modes' grammar, and the
rasterizer benchmark's probe modes on the CPU.

The CUDA kernels are held against the plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tinycarlo_torch.benchmarks import rasterize_bench as rb
from tinycarlo_torch.ops import probe_kernels as pk

N, NL, H, W = 8, 5, 128, 160
WP, NBUF = 256, 3  # dkernel's frame width and staging buffers


def jax_ovl(i, kk, n=N):
    """exp_r2.py:156-177."""
    def okernel(i_ref, o_ref, sc):
        v = i_ref[0]
        sc[:] = jnp.full((128, 128), v.astype(jnp.float32))

        def fma(_, x):
            return x * 1.000001 + 0.0001

        acc = jax.lax.fori_loop(0, kk, fma, sc[:])
        sc[:] = acc
        u = sc[0, 0].astype(jnp.int32).astype(jnp.uint8)
        for l in range(NL):
            o_ref[0, l] = jnp.full((H, W), u)

    return pl.pallas_call(
        okernel,
        grid=(n,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((1, NL, H, W), lambda ii: (ii, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, NL, H, W), jnp.uint8),
        scratch_shapes=[pltpu.VMEM((128, 128), jnp.float32)],
        interpret=True,
    )(jnp.float32(i).reshape(1))


def jax_dmaflat(i, g, n=N):
    """exp_r2.py:185-202."""
    rows = NL * H * W // 128

    def zkernel(i_ref, o_ref):
        for gg in range(g):
            o_ref[gg] = jnp.full((rows, 128), i_ref[0])

    return pl.pallas_call(
        zkernel,
        grid=(n // g,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((g, rows, 128), lambda ii: (ii, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, rows, 128), jnp.uint8),
        interpret=True,
    )(jnp.float32(i).astype(jnp.uint8).reshape(1))


def jax_dmaf32(i, n=N):
    """exp_r2.py:205-220, with its checksum sample."""
    def zkernel(i_ref, o_ref):
        for l in range(NL):
            o_ref[0, l] = jnp.full((H, W), i_ref[0])

    out = pl.pallas_call(
        zkernel,
        grid=(n,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((1, NL, H, W), lambda ii: (ii, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, NL, H, W), jnp.float32),
        interpret=True,
    )(jnp.float32(i).reshape(1))
    return out, jnp.sum(out[0, 0, 0, :4]).astype(jnp.uint32)


def jax_dma(i, g, n=N):
    """exp_r2.py:221-236."""
    def zkernel(i_ref, o_ref):
        v = i_ref[0]
        for gg in range(g):
            for l in range(NL):
                o_ref[gg, l] = jnp.full((H, W), v)

    return pl.pallas_call(
        zkernel,
        grid=(n // g,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((g, NL, H, W), lambda ii: (ii, 0, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((n, NL, H, W), jnp.uint8),
        interpret=True,
    )(jnp.float32(i).astype(jnp.uint8).reshape(1))


def jax_dskip(i, livem, n=N):
    """exp_r2.py:239-327 (the dkernel and its checksum sample) with the
    live mask `livem` (NL, n) int32."""
    livej = jnp.asarray(livem)

    def dkernel(live_ref, i_ref, o_ref, st, sems):
        ii = jnp.asarray(pl.program_id(0), jnp.int32)
        buf = jax.lax.rem(ii, jnp.int32(NBUF))

        def cp(inst, q, l):
            return pltpu.make_async_copy(
                st.at[q * NL + l], o_ref.at[inst * NL + l],
                sems.at[q * NL + l])

        for l in range(NL):
            @pl.when((ii >= NBUF) & (live_ref[l, ii - NBUF] > 0))
            def _reclaim(l=l):
                cp(ii - NBUF, buf, l).wait()

        for l in range(NL):
            @pl.when(live_ref[l, ii] > 0)
            def _emit(l=l):
                st[buf * NL + l] = jnp.full((H, WP), i_ref[0], jnp.uint8)
                cp(ii, buf, l).start()

        for d in range(NBUF):
            for l in range(NL):
                @pl.when((ii == n - 1) & (ii >= d)
                         & (live_ref[l, ii - d] > 0))
                def _drain(d=d, l=l):
                    cp(ii - d, jax.lax.rem(ii - d, jnp.int32(NBUF)),
                       l).wait()

    out = pl.pallas_call(
        dkernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(n,),
            in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
            out_specs=pl.BlockSpec(memory_space=pl.ANY),
            scratch_shapes=[pltpu.VMEM((NBUF * NL, H, WP), jnp.uint8),
                            pltpu.SemaphoreType.DMA((NBUF * NL,))],
        ),
        out_shape=jax.ShapeDtypeStruct((n * NL, H, WP), jnp.uint8),
        interpret=True,
    )(livej, jnp.float32(i).astype(jnp.uint8).reshape(1))
    return out


def _live(seed, n=N):
    """(NL, n) int32: layer 0 empty, layer 1 full, the rest ragged."""
    live = (np.random.default_rng(seed).random((NL, n)) < 0.5).astype(
        np.int32)
    live[0] = 0
    live[1] = 1
    return live


@pytest.mark.parametrize("kk", [0, 3])
@pytest.mark.parametrize("i", [0, 29])
def test_ovl_plain_matches_okernel(kk, i):
    want = np.asarray(jax_ovl(i, kk))
    got = pk.ovl_kernel(torch.empty((N, NL, H, W), dtype=torch.uint8),
                        float(i), kk)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0, 0, 0] == i


@pytest.mark.parametrize("kk,v,u", [(1, 0.9999, 1), (64, 254.99, 255),
                                    (512, 99.93, 100)])
def test_ovl_plain_chain_crosses_an_integer_like_okernel(kk, v, u):
    """Starts whose integer part the chain changes: 0.9999 reaches
    1.000001 in one round, 254.99 reaches 255 in round 29 of 64 and 99.93
    reaches 100 in round 367 of 512, so a kernel that skips or shortens the
    chain, or has a wrong constant, gives another byte."""
    want = np.asarray(jax_ovl(v, kk, n=2))
    got = pk.ovl_plain(torch.empty((2, NL, H, W), dtype=torch.uint8), v, kk)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0, 0, 0] == u != int(v)


def _chain_f32(v, kk):
    """The multiply-add chain in numpy float32, the multiply and the add
    each rounded."""
    x = np.float32(v)
    for _ in range(kk):
        x = np.float32(x * np.float32(pk.FMA_MUL)) + np.float32(pk.FMA_ADD)
    return x


def test_ovl_plain_rounds_the_multiply_and_the_add_apart():
    """16.9998836517334 goes to 16.999998 when the multiply and the add
    are rounded apart (the plain version, and the CUDA kernel under
    -fmad=false), to 17 when they are fused. XLA's CPU fuses them, so the
    interpret-mode okernel gives 17 here and this start is held against
    the separately rounded chain in numpy instead."""
    v = 16.9998836517334
    x = _chain_f32(v, 1)
    assert np.float32(16.999998) == x < 17
    got = pk.ovl_plain(torch.empty((1, NL, H, W), dtype=torch.uint8), v, 1)
    assert bool((got == 16).all())
    for kk, v in ((64, 254.99), (512, 99.93)):
        got = pk.ovl_plain(torch.empty((1, 1), dtype=torch.uint8), v, kk)
        assert int(got[0, 0]) == int(_chain_f32(v, kk))


def test_ovl_plain_wraps_like_okernel():
    """A value past 255 wraps in the int32 -> uint8 cast, as on the TPU."""
    want = np.asarray(jax_ovl(300.0, 1, n=1))
    got = pk.ovl_plain(torch.empty((1, NL, H, W), dtype=torch.uint8), 300.0,
                       1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0, 0, 0] == 300 - 256


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("i", [0, 29])
def test_fill_plain_matches_zkernels(g, i):
    """The flat (N, 800, 128) and the (N, L, H, W) uint8 fills, g envs per
    grid step; the wrapper's group changes nothing in the result."""
    flat = pk.fill_kernel(torch.empty((N, NL * H * W // 128, 128),
                                      dtype=torch.uint8), i, g)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jax_dmaflat(i, g)))
    frames = pk.fill_kernel(torch.empty((N, NL, H, W), dtype=torch.uint8),
                            i, g)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(jax_dma(i, g)))


@pytest.mark.parametrize("i", [0, 29])
def test_fill_plain_matches_f32_zkernel(i):
    want, sample = jax_dmaf32(i)
    got = pk.fill_kernel(torch.empty((N, NL, H, W), dtype=torch.float32), i)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0, 0, 0, :4].sum()) == int(sample) == 4 * i


@pytest.mark.parametrize("i", [0, 29])
def test_skip_plain_matches_dkernel_on_live_frames(i):
    livem = _live(i)
    want = np.asarray(jax_dskip(i, livem)).reshape(N, NL, H, WP)
    got = pk.skip_kernel(torch.zeros((N * NL, H, WP), dtype=torch.uint8),
                         torch.from_numpy(livem), i)
    got = got.numpy().reshape(N, NL, H, WP)
    live = livem.T > 0
    assert live.any() and not live.all()
    np.testing.assert_array_equal(got[live], want[live])
    assert not got[~live].any()  # dead frames keep the zeros


def test_wrappers_check_their_arguments():
    u8 = torch.empty((2, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="0..255"):
        pk.fill_kernel(u8, 256)
    with pytest.raises(ValueError, match="group"):
        pk.fill_kernel(u8, 1, 0)
    with pytest.raises(ValueError, match="KK"):
        pk.ovl_kernel(u8, 1.0, -1)
    with pytest.raises(ValueError, match="live"):
        pk.skip_kernel(u8, torch.ones((2, 2), dtype=torch.int32), 1)
    before = [k.launches for k in pk.KERNELS]
    assert pk.fill_kernel(u8, 7) is u8 and bool((u8 == 7).all())
    assert [k.launches for k in pk.KERNELS] == before  # CPU: plain versions


@pytest.mark.parametrize("mode,parsed", [
    ("ovl0", ("ovl", 0)), ("ovl512", ("ovl", 512)),
    ("dmaflat", ("dmaflat", 1)), ("dmaflat16", ("dmaflat", 16)),
    ("dmaf32", ("dmaf32", 1)), ("dma", ("dma", 1)), ("dma4", ("dma", 4)),
    ("dskip", ("dskip", None)), ("dskipall", ("dskipall", None)),
    ("ovl", None), ("dmaf16", None), ("dskip2", None), ("idx", None),
])
def test_probe_mode_grammar(mode, parsed):
    assert rb.parse_probe(mode) == parsed


def test_probe_mode_grammar_rejects_empty_groups():
    with pytest.raises(ValueError, match="envs per block"):
        rb.parse_probe("dma0")
    with pytest.raises(ValueError, match="unknown mode"):
        rb.run(["ovl"], device="cpu", n_envs=2, iters=1, repeats=1)


def test_bench_probe_modes_on_cpu():
    """`run(probe modes, device="cpu")` at 8 envs and 3 iterations: each
    checksum what the iterations' values 0, 1, 2 give (ovl's 0.9999,
    1.9999, 2.9999 become 1, 2, 3 through a chain of KK >= 1 rounds and
    stay 0, 1, 2 at KK = 0), dskip's live share
    that of the reset's drawn layers, no kernel launched, a bound per
    mode (bytes; ovl512 operations)."""
    lines = []
    results = rb.run(rb.PROBES, device="cpu", n_envs=8, iters=3, repeats=1,
                     log=lines.append)
    assert len(lines) == 1 + len(rb.PROBES)
    frame_bytes = 8 * NL * H * W
    for mode in rb.PROBES:
        r = results[mode]
        assert r["launches"] == 0 and len(r["ms"]) == 1
        assert r["kernel_ms"] > 0 and r["bound_ms"] > 0
        assert (r["library_ms"] is None) == mode.startswith("ovl")
        if mode == "dmaf32":
            assert r["checksum"] == 4 * 3
        elif mode.startswith("ovl"):
            crossed = 3 if mode != "ovl0" else 0
            assert r["checksum"] == (3 + crossed) * frame_bytes
        elif mode.startswith("dskip"):
            live = round(r["live_share"] * 8 * NL)
            assert r["checksum"] == 3 * live * 4 * WP
        else:
            assert r["checksum"] == 3 * frame_bytes
            assert r["bytes"] >= frame_bytes
    assert results["dskipall"]["live_share"] == 1.0
    assert 0 < results["dskip"]["live_share"] < 1
    assert results["ovl512"]["bound_by"] == "operations"
    assert results["ovl512"]["ops"] == 8 * 128 * 128 * 512 * 2
    assert results["dma"]["bound_by"] == "bytes"
    assert results["dmaf32"]["bytes"] == 4 * frame_bytes
