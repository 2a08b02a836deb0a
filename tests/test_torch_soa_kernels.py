"""The plain versions of the frame, env and segment kernels
(tinycarlo_torch.ops.rasterize_kernels `rasterize_compact_soa_plain`,
`rasterize_compact_env_soa_plain`, `rasterize_env_seg_plain`) against the
JAX package's Pallas kernels `_kernel`, `_kernel_env` and
`_kernel_env_seg` run with interpret=True on the same bundle: bit for bit.

The slice: the rasterizer benchmark's path at B = 8, 64x160, from the JAX
package's reset states projected by the port (`camera.project_layer` per
layer, the packed projection for the packed layouts), through the port's
compactions and plain versions, against the JAX package's projection,
compactions and interpret kernels: frames equal wherever the env's live
slots are equal, elsewhere up to stroke-boundary pixels
(tests/test_rasterize_pallas.py:84-122). Then the benchmark module runs
every mode on the CPU, and the wrappers take their plain path on CPU
tensors.

The CUDA kernels are held against the plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_rasterize_pallas import _assert_equal_up_to_stroke_boundary
from tests.test_torch_common import bench_config, to_numpy_tree
from tests.test_torch_soa import (
    jax_project_layers,
    points,
    port_project_layers,
    soa_segments,
)
from tinycarlo_torch import car as pcar
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch.benchmarks import rasterize_bench as rb
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.ops import rasterize_pallas as rp


def _torch(bundle):
    return tuple(torch.from_numpy(np.array(x)) for x in bundle)


def _assert_frames_equal(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0, 255} and got.any()


# (seed, B, L, E, h, w, t, gran, k per layer): the three strokes, both
# band heights, one to three lane blocks, odd / oversubscribed budgets
KERNEL_CASES = [
    (11, 3, 2, 24, 40, 48, 1, 8, 24),
    (12, 3, 3, 20, 30, 160, 2, 16, 5),
    (13, 3, 2, 24, 44, 300, 3, 8, 13),
]
KERNEL_IDS = [f"t{c[6]}-g{c[7]}-{c[4]}x{c[5]}" for c in KERNEL_CASES]
# (case, split): unsplit needs no w, which the t = 1 clip requires
KERNEL_SPLITS = [(c, s) for c in KERNEL_CASES for s in (True, False)
                 if s or c[6] >= 2]
KERNEL_SPLIT_IDS = [
    f"{KERNEL_IDS[KERNEL_CASES.index(c)]}-{'split' if s else 'unsplit'}"
    for c, s in KERNEL_SPLITS]


@pytest.mark.parametrize("case", KERNEL_CASES, ids=KERNEL_IDS)
def test_frame_kernel_plain_equals_pallas(case):
    seed, b, nl, e, h, w, t, gran, k = case
    u0, v0, u1, v1, draw = soa_segments(seed, b, nl, e, h, w)
    p0, p1 = points(u0, v0, u1, v1)
    soa = jax.jit(partial(rp.compact_soa, k=k, gran=gran, h=h, thickness=t,
                          w=w))(jnp.asarray(p0), jnp.asarray(p1),
                                jnp.asarray(draw))
    want = rp.rasterize_compact_soa(soa, (h, w), t, gran=gran, interpret=True)
    _assert_frames_equal(
        rk.rasterize_compact_soa_plain(_torch(soa), (h, w), t, gran), want)


@pytest.mark.parametrize("case,split", KERNEL_SPLITS, ids=KERNEL_SPLIT_IDS)
def test_env_kernel_plain_equals_pallas(case, split):
    seed, b, nl, e, h, w, t, gran, k = case
    u0, v0, u1, v1, draw = soa_segments(seed, b, nl, e, h, w)
    p0, p1 = points(u0, v0, u1, v1)
    soa = jax.jit(partial(rp.compact_env_soa, k=k * nl * 2, gran=gran, h=h,
                          thickness=t, w=w if split else None))(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(draw))
    want = rp.rasterize_compact_env_soa(soa, nl, (h, w), t, gran=gran,
                                        split=split, interpret=True)
    _assert_frames_equal(rk.rasterize_compact_env_soa_plain(
        _torch(soa), nl, (h, w), t, gran, split), want)


@pytest.mark.parametrize("case,split", KERNEL_SPLITS, ids=KERNEL_SPLIT_IDS)
def test_seg_kernel_plain_equals_pallas(case, split):
    seed, b, nl, e, h, w, t, gran, k = case
    segs = soa_segments(seed, b, nl, e, h, w)
    soa = jax.jit(partial(rp.compact_env_seg, k=k * nl, gran=gran, h=h,
                          thickness=t, w=w if split else None))(
        *(jnp.asarray(x) for x in segs))
    split = split and w > 128
    want = rp.rasterize_env_seg(soa, nl, (h, w), t, gran=gran, split=split,
                                interpret=True)
    _assert_frames_equal(rk.rasterize_env_seg_plain(
        _torch(soa), nl, (h, w), t, gran, split), want)


@pytest.fixture(scope="module")
def slice_inputs():
    """8 reset states of the JAX package at bench.py's config, 64x160:
    each package's per-layer and packed projections of them, and the
    port's params."""
    res = (64, 160)
    cfg = bench_config(res)
    jp = jenv.make_env_params(cfg)
    vstate, _ = jax.jit(partial(jvec.reset, jp, n_envs=8, render=False))(
        jax.random.key(1))
    car = vstate.env.car
    pp = convert.env_params_from_numpy(to_numpy_tree(jp), cfg, device="cpu")
    pcs = pcar.car_reset(pp.map_data, pp.cfg.car, torch.zeros(8, dtype=torch.long))
    pcs.position = torch.from_numpy(np.array(car.position))
    pcs.rotation = torch.from_numpy(np.array(car.rotation))
    jl = jax_project_layers(jp, car, res)
    pl = [x for x in port_project_layers(pp, car, res)]
    jpk = [np.asarray(x) for x in jax.jit(jenv._project_packed_batch)(
        jp, vstate.env)]
    ppk = list(penv._project_packed_batch(pp, penv.EnvState(car=pcs)))
    return res, jp, pp, jl, pl, jpk, ppk


def _live_rows(bundle, b, seg):
    """Per env, what a kernel reads of the bundle: its counts and, slot by
    slot, the fields of the live slots (s < the live count; zeros for the
    others). Dead slots carry undrawn segments, some projected to ~1e9 px,
    where the two packages' float32 projections differ."""
    counts = np.asarray(bundle[-1])
    if seg:
        idx, *fields = (np.asarray(x) for x in bundle[:-1])
        k = idx.shape[1] - 7
        fields = [np.take_along_axis(f, idx[:, :k], 1) for f in fields]
        n = counts[0][:, None]
    else:
        fields = [np.asarray(x) for x in bundle[:-1]]
        k = fields[0].shape[-1]
        n = counts[0].reshape(fields[0].shape[:-1])[..., None]
    live = np.arange(k) < n
    rows = [counts.reshape(counts.shape[0], b, -1).transpose(1, 0, 2)]
    rows += [np.where(live, f, 0) for f in fields]
    return np.concatenate([r.reshape(b, -1).astype(np.float64) for r in rows],
                          axis=1)


@pytest.mark.parametrize("mode", ["full", "env", "cur", "seg"])
def test_slice_bench_path(slice_inputs, mode):
    """The benchmark's compaction + kernel of `mode` at its k and gran
    (scaled to the frame), port against JAX from the same states."""
    res, jp, pp, jl, pl, jpk, ppk = slice_inputs
    h, w = res
    t = 2
    nl = jp.map_data.n_layers
    lay = jp.map_data.packed_edge_layer
    if mode in ("full", "env"):
        (jp0, jp1, jdraw), (tp0, tp1, tdraw) = jl, pl
        jargs = (jnp.asarray(jp0), jnp.asarray(jp1), jnp.asarray(jdraw))
        targs = (tp0, tp1, tdraw)
        if mode == "full":
            want_soa = jax.jit(partial(rp.compact_soa, k=rb.K, gran=rb.GRAN,
                                       h=h, thickness=t))(*jargs)
            want = rp.rasterize_compact_soa(want_soa, res, t, gran=rb.GRAN,
                                            interpret=True)
            soa = rk.compact_soa(*targs, rb.K, rb.GRAN, h, t)
            got = rk.frame_soa_kernel(soa, res, t, rb.GRAN)
        else:
            want_soa = jax.jit(partial(rp.compact_env_soa, k=rb.K,
                                       gran=rb.GRAN, h=h, thickness=t))(*jargs)
            want = rp.rasterize_compact_env_soa(want_soa, nl, res, t,
                                                gran=rb.GRAN, interpret=True)
            soa = rk.compact_env_soa(*targs, rb.K, rb.GRAN, h, t)
            got = rk.env_soa_kernel(soa, nl, res, t, rb.GRAN)
        p0s, p1s, draws = jp0, jp1, jdraw
    else:
        (jp0, jp1, jdraw), (tp0, tp1, tdraw) = jpk, ppk
        e = jp0.shape[1]
        k = min(rb.MAXVIS * 2, e * 2)
        kw = dict(edge_layer=lay, n_layers=nl, w=w)
        tkw = dict(kw, edge_layer=pp.map_data.packed_edge_layer)
        if mode == "cur":
            want_soa = jax.jit(partial(rp.compact_env_soa, k=k,
                                       gran=rb.GRAN_PACKED, h=h, thickness=t,
                                       **kw))(
                *(jnp.asarray(x)[:, None] for x in (jp0, jp1, jdraw)))
            want = rp.rasterize_compact_env_soa(
                want_soa, nl, res, t, gran=rb.GRAN_PACKED, split=True,
                interpret=True)
            soa = rk.compact_env_soa(tp0[:, None], tp1[:, None],
                                     tdraw[:, None], k, rb.GRAN_PACKED, h, t,
                                     **tkw)
            got = rk.env_soa_kernel(soa, nl, res, t, rb.GRAN_PACKED,
                                    split=True)
        else:
            jsoa = [jnp.asarray(x)[:, None] for x in
                    (jp0[..., 0], jp0[..., 1], jp1[..., 0], jp1[..., 1],
                     jdraw)]
            want_soa = jax.jit(partial(
                rp.compact_env_seg, k=min(rb.MAXVIS, e), gran=rb.GRAN_PACKED,
                h=h, thickness=t, **kw))(*jsoa)
            want = rp.rasterize_env_seg(want_soa, nl, res, t,
                                        gran=rb.GRAN_PACKED, split=True,
                                        interpret=True)
            soa = rk.compact_env_seg(
                tp0[:, None, :, 0], tp0[:, None, :, 1], tp1[:, None, :, 0],
                tp1[:, None, :, 1], tdraw[:, None], min(rb.MAXVIS, e),
                rb.GRAN_PACKED, h, t, **tkw)
            got = rk.env_seg_kernel(soa, nl, res, t, rb.GRAN_PACKED,
                                    split=True)
        # the boundary rule reads per-layer endpoints: the packed edges of
        # each layer, the others undrawn
        onehot = np.asarray(lay)[None, :] == np.arange(nl)[:, None]
        p0s = np.broadcast_to(jp0[:, None], (jp0.shape[0], nl) + jp0.shape[1:])
        p1s = np.broadcast_to(jp1[:, None], p0s.shape)
        draws = jdraw[:, None, :] & onehot[None]
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.any()
    b = got.shape[0]
    seg = mode == "seg"
    same = (_live_rows([x.numpy() for x in soa], b, seg)
            == _live_rows(want_soa, b, seg)).all(axis=1)
    assert same.sum() >= b // 2, f"bundles differ in {b - same.sum()} envs"
    for i in range(b):
        if same[i]:
            np.testing.assert_array_equal(got[i], want[i])
        else:
            _assert_equal_up_to_stroke_boundary(
                got[i], want[i], np.ascontiguousarray(p0s[i]),
                np.ascontiguousarray(p1s[i]), draws[i], t)


def test_bench_module_runs_every_mode_on_cpu():
    """`run(device="cpu")` at B = 8 and 2 iterations: every mode, the
    kernel modes of one projection rendering the same masks, nothing
    dropped, no kernel launched (CPU tensors take the plain versions)."""
    before = {k.NAME: k.launches for k in rb.KERNELS}
    lines = []
    results = rb.run(device="cpu", n_envs=8, iters=2, log=lines.append)
    assert set(results) == set(rb.MODES)
    assert len(lines) == 1 + len(rb.MODES)
    for mode in rb.MODES:
        r = results[mode]
        assert len(r["ms"]) == rb.REPEATS and r["dropped"] == 0
        assert r["checksum"] > 0 and r["launches"] == 0
        assert r["compact_ms"] > 0
        assert (r["kernel_ms"] is not None) == (mode in rb.KERNEL_OF)
        assert lines[1 + rb.MODES.index(mode)].startswith(f"{mode}: med ")
    for group in (("full", "env"), ("cur", "seg", "idx")):
        assert len({results[m]["checksum"] for m in group}) == 1
    assert {k.NAME: k.launches for k in rb.KERNELS} == before


def test_bench_main_empty_draws_nothing(monkeypatch):
    """`main([..., "--empty"])` runs the kernel modes on frames that draw
    nothing: every mask zero (checksum 0), nothing dropped. `run` is held
    to the CPU at B = 8 (main itself runs on the card)."""
    results, lines, real_run = {}, [], rb.run

    def cpu_run(modes, empty):
        results.update(real_run(modes, device="cpu", n_envs=8, iters=2,
                                repeats=1, empty=empty, log=lines.append))

    monkeypatch.setattr(rb, "run", cpu_run)
    assert rb.main(list(rb.KERNEL_OF) + ["--empty"]) == 0
    assert set(results) == set(rb.KERNEL_OF)
    assert "0.00 live segs/frame" in lines[0]
    for r in results.values():
        assert r["checksum"] == 0 and r["dropped"] == 0


def test_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors each wrapper returns its plain version's masks and
    counts no launch."""
    h, w, t, nl = 30, 160, 2, 2
    u0, v0, u1, v1, draw = (torch.from_numpy(x)
                            for x in soa_segments(21, 3, nl, 16, h, w))
    p0, p1 = torch.stack([u0, v0], -1), torch.stack([u1, v1], -1)
    cases = [
        (rk.frame_soa_kernel, rk.rasterize_compact_soa_plain,
         rk.compact_soa(p0, p1, draw, 16, 8, h, t), ((h, w), t, 8)),
        (rk.env_soa_kernel, rk.rasterize_compact_env_soa_plain,
         rk.compact_env_soa(p0, p1, draw, 64, 16, h, t, w=w),
         (nl, (h, w), t, 16, True)),
        (rk.env_seg_kernel, rk.rasterize_env_seg_plain,
         rk.compact_env_seg(u0, v0, u1, v1, draw, 32, 8, h, t),
         (nl, (h, w), t, 8, False)),
    ]
    for kernel, plain, soa, args in cases:
        before = kernel.launches
        got = kernel(soa, *args)
        assert kernel.launches == before
        assert torch.equal(got, plain(soa, *args)) and got.any()
