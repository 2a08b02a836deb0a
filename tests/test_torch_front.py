"""The front kernel's routing (ops/csrc/front.cu) on the CPU: a torch
mirror of its stable three-way partition (block-wide prefix sums over
chunks of the kernel's size, carried across them, then a scatter) held
equal to `_route_slots`' idx and counts element for element, and the
render's front end left on the torch composition on CPU tensors.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds
its bundle against `front_plain` there)."""
import json
import os

import numpy as np
import pytest
import torch

from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAN = rk._GRAN
# front.cu's kMaxThreads and kPad
MAX_THREADS = 512
PAD = 7


def block_threads(le: int) -> int:
    """front.cu's `block_threads`: LE cut into ceil(LE / 512) equal chunks,
    a warp multiple."""
    chunks = -(-le // MAX_THREADS)
    per = -(-le // chunks)
    return -(-per // 32) * 32


def partition_slots(nb, k, win, copy_layer, n_layers):
    """The front kernel's routing of (B, LE) band counts: groups short (0 <
    nb <= win/gran), tall (nb > win/gran) and the rest; per chunk of
    `block_threads(LE)` copies the inclusive prefix sums of the short and
    tall flags, carried across chunks, give each copy its slot; the first
    kk = min(k, LE) slots are scattered, then 7 copies of the last. Returns
    (idx, counts) in `_route_slots`' layout."""
    bsz, le = nb.shape
    short = (nb > 0) & (nb <= win // GRAN)
    tall = nb > win // GRAN
    n_short = short.sum(-1, dtype=torch.int32)
    n_tall = tall.sum(-1, dtype=torch.int32)
    kk = min(k, le)
    chunk = block_threads(le)
    slot = torch.empty((bsz, le), dtype=torch.int64)
    carry_s = torch.zeros(bsz, dtype=torch.int64)
    carry_t = torch.zeros(bsz, dtype=torch.int64)
    for c0 in range(0, le, chunk):
        s = short[:, c0:c0 + chunk].long()
        t = tall[:, c0:c0 + chunk].long()
        es = torch.cumsum(s, -1) - s
        et = torch.cumsum(t, -1) - t
        tid = torch.arange(s.shape[1])
        other = (n_short + n_tall)[:, None] + (c0 - carry_s - carry_t)[:, None] \
            + tid - es - et
        slot[:, c0:c0 + chunk] = torch.where(
            s.bool(), carry_s[:, None] + es,
            torch.where(t.bool(), n_short[:, None] + carry_t[:, None] + et,
                        other))
        carry_s += s.sum(-1)
        carry_t += t.sum(-1)
    idx = torch.full((bsz, kk + PAD), -1, dtype=torch.int32)
    rows, copies = torch.nonzero(slot < kk, as_tuple=True)
    idx[rows, slot[rows, copies]] = copies.to(torch.int32)
    idx[:, kk:] = idx[:, kk - 1:kk]
    n_elig = n_short + n_tall
    n_all = torch.clamp_max(n_elig, k)
    per_layer = torch.stack([((nb > 0) & (copy_layer == l)).sum(
        -1, dtype=torch.int32) for l in range(n_layers)])
    counts = torch.cat([torch.stack([
        n_all, torch.zeros_like(n_all), torch.clamp_max(n_short, k),
        n_elig - n_all]), per_layer])
    return idx, counts


def _layers(e, n_layers, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(np.sort(rng.integers(0, n_layers, e)),
                        dtype=torch.int32)


def _check(nb, k, win, lay, nxb, n_layers):
    """The mirror against `_route_slots` on band counts `nb` of copies
    whose edges have layers `lay`."""
    bsz, le = nb.shape
    want_idx, want_counts = rk._route_slots(nb, k, win, lay[None].expand(
        bsz, -1), nxb, n_layers, None)
    copy_layer = lay.repeat_interleave(nxb)[None]
    got_idx, got_counts = partition_slots(nb, k, win, copy_layer, n_layers)
    assert torch.equal(got_idx, want_idx)
    assert torch.equal(got_counts, want_counts)
    return want_counts


def _random_nb(seed, bsz, le, p_elig, p_tall=0.3, hi=9):
    rng = np.random.default_rng(seed)
    elig = rng.random((bsz, le)) < p_elig
    tall = rng.random((bsz, le)) < p_tall
    nb = np.where(tall, rng.integers(3, hi, (bsz, le)),
                  rng.integers(1, 3, (bsz, le)))
    return torch.tensor(np.where(elig, nb, 0), dtype=torch.int32)


@pytest.mark.parametrize("nxb", [1, 2, 5])
@pytest.mark.parametrize("e,kb", [(100, 7), (100, 100), (100, 130),
                                  (744, 128), (263, 128)])
def test_partition_equals_route_slots_random(nxb, e, kb):
    """Random band counts, k below LE (copies dropped), k = LE and k above
    it; 744 x 5 copies cut into eight chunks, 263 x 2 into two."""
    n_layers = 5
    nb = _random_nb(e * 10 + nxb + kb, 12, e * nxb, 0.3)
    counts = _check(nb, kb * nxb, 32, _layers(e, n_layers, e), nxb, n_layers)
    if kb < 10:
        assert int(counts[3].sum()) > 0


@pytest.mark.parametrize("nxb", [1, 2, 5])
@pytest.mark.parametrize("case", ["none", "all", "talls", "overflow"])
def test_partition_equals_route_slots_corners(nxb, case):
    """No eligible copy; every copy eligible; talls only; more eligible
    copies than slots (dropped > 0). The win of a 16-row frame (one band)
    makes every two-band copy tall."""
    n_layers, e = 3, 150
    le = e * nxb
    p = {"none": 0.0, "all": 1.0, "talls": 1.0, "overflow": 0.8}[case]
    nb = _random_nb(le + len(case), 6, le, p, p_tall=1.0 if case == "talls"
                    else 0.3)
    k = 40 * nxb if case == "overflow" else le
    counts = _check(nb, k, 32, _layers(e, n_layers, nxb), nxb, n_layers)
    if case == "talls":
        assert int(counts[2].sum()) == 0 < int(counts[0].sum())
    if case == "overflow":
        assert int(counts[3].min()) > 0
    if case == "none":
        assert int(counts[0].sum()) == 0
    # one band a window: nb = 2 is tall
    _check(nb, k, 16, _layers(e, n_layers, nxb), nxb, n_layers)


def _portbench_params(name):
    path = os.path.join(REPO, "portbench", "configs", f"{name}.json")
    with open(path) as f:
        cfg = json.load(f)["config"]
    cfg["map"]["json_path"] = os.path.join(os.path.dirname(path),
                                           cfg["map"]["json_path"])
    return fenv.make_env_params(cfg, device="cpu")


@pytest.mark.parametrize("name", ["simple_layout-128x160",
                                  "knuffingen-480x640"])
def test_partition_equals_route_slots_on_the_maps(name):
    """Every spawn point of the benchmark's two maps, and 8 envs stepped
    away from them: the band counts of the composition's bundle (`bw`'s
    low bits) routed by the mirror equal its idx and counts."""
    params = _portbench_params(name)
    md = params.map_data
    cam_cfg = params.cfg.camera
    h, w = cam_cfg.resolution
    rows = torch.arange(md.spawns.count)
    state, _, _ = fenv.reset(params, len(rows), spawn_row=rows, render=False)
    vs, _ = vector.reset(params, 8, seed=3, render=False)
    for _ in range(20):
        vs, *_ = vector.step(params, vs, {
            "car_control": torch.tensor([[0.6, 0.3]]).expand(8, 2),
            "maneuver": torch.zeros(8, dtype=torch.int32)}, render=False)
    for st in (state, vs.env):
        u0, v0, u1, v1, draw = fenv._project_packed_batch_soa(params, st)
        e = draw.shape[-1]
        k = rk._budget(e, w, cam_cfg.max_visible_segments)
        bundle = rk.compact_env_idx_soa(
            u0, v0, u1, v1, draw, k, h, cam_cfg.line_thickness,
            edge_layer=md.packed_edge_layer, n_layers=md.n_layers, w=w,
            layer_bounds=md.packed_layer_bounds)
        nb = bundle[6] & (rk._NB_PACK - 1)
        _, _, win = rk._window_rows(h)
        copy_layer = md.packed_edge_layer.repeat_interleave(
            rk._n_xblocks(w))[None]
        idx, counts = partition_slots(nb, k, win, copy_layer, md.n_layers)
        assert torch.equal(idx, bundle[0])
        assert torch.equal(counts, bundle[7])
        assert int(counts[0].sum()) > 0


def test_front_kernel_not_launched_on_cpu():
    """A CPU render takes the torch composition: `render.front` stays 0
    and the front kernel's wrapper counts no launch, while the compaction
    span and its counters are kept; the bundle is `front_plain`'s."""
    params = _portbench_params("simple_layout-128x160")
    state, _, _ = fenv.reset(params, 4, spawn_row=torch.arange(4),
                             render=False)
    before = rk.front_kernel.launches
    with profiling.tracing() as tr:
        for fmt in ("classes", "rgb"):
            fenv.render_observation_batch(params, state, fmt=fmt)
    assert rk.front_kernel.launches == before
    assert tr.counters.get("render.front", 0) == 0
    e = params.map_data.packed_edges.shape[1]
    assert tr.counters["render.copies"] == 2 * 4 * e * 2
    names = [s.name for s in tr.device_spans()]
    assert names.count("render.compact") == 2
