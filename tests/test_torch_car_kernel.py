"""The car kernel's reductions and its u-turn gate (ops/csrc/car.cu) on the
CPU: a torch mirror of its lane-strided first-wins (value, index) minimum
held equal to torch's argmin as `car._first_argmins` and
`geometry._masked_argmin` use it; a mirror of its per-car gate (the
re-snap scan run for the u-turn entries alone) held equal to the ungated
`find_local_path`; and `env.step` on CPU tensors left on the torch
composition.

The kernel itself runs only on the card (tests/test_torch_cuda.py holds
every output of `env._car_work` against `env._car_work_plain` there)."""
import json
import os
import re
from dataclasses import fields, replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tinycarlo_torch import car as car_mod
from tinycarlo_torch import env as fenv
from tinycarlo_torch import geometry as geo
from tinycarlo_torch import vector
from tinycarlo_torch.ops import car_kernel as ck
from tinycarlo_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = ["simple_layout-128x160", "knuffingen-480x640"]
LANES = 32


def _portbench_params(name, dtype=torch.float32):
    path = os.path.join(REPO, "portbench", "configs", f"{name}.json")
    with open(path) as f:
        cfg = json.load(f)["config"]
    cfg["map"]["json_path"] = os.path.join(os.path.dirname(path),
                                           cfg["map"]["json_path"])
    return fenv.make_env_params(cfg, dtype=dtype, device="cpu")


def _before(a, ia, b, ib):
    """car.cu's `before`: torch argmin's order (NaN first, ties to the
    lower index), elementwise."""
    return torch.where(torch.isnan(a), ~torch.isnan(b) | (ia < ib),
                       torch.where(a == b, ia < ib, a < b))


def _take(v, i, nv, ni):
    keep = _before(nv, ni, v, i)
    return torch.where(keep, nv, v), torch.where(keep, ni, i)


def lane_argmin(d, lo, hi):
    """The kernel's reduction of d[:, lo:hi] for every row: lane j takes
    (d[k], k) for k = lo + j, lo + j + 32, ... in turn, then the lanes
    meet by the butterfly (xor 16, 8, 4, 2, 1); every lane ends with the
    same index. An empty range gives (inf, INT_MAX), which the kernel
    turns into index 0."""
    rows = d.shape[0]
    v = torch.full((rows, LANES), float("inf"), dtype=d.dtype)
    i = torch.full((rows, LANES), 2**31 - 1, dtype=torch.int64)
    lane = torch.arange(LANES)
    for start in range(lo, hi, LANES):
        k = start + lane
        live = k < hi
        kk = torch.where(live, k, lo)
        nv = torch.where(live, d[:, kk], float("inf"))
        ni = torch.where(live, k, 2**31 - 1).expand(rows, -1)
        v, i = _take(v, i, nv, ni)
    for o in (16, 8, 4, 2, 1):
        partner = lane ^ o
        v, i = _take(v, i, v[:, partner], i[:, partner])
    assert torch.equal(i, i[:, :1].expand(-1, LANES))
    return i[:, 0]


def _layer_argmins(d, bounds, n_layers):
    """car.cu's per-layer pass: index 0 for an edgeless layer."""
    return torch.stack(
        [lane_argmin(d, bounds[l], bounds[l + 1]) if bounds[l + 1] > bounds[l]
         else torch.zeros(d.shape[0], dtype=torch.int64)
         for l in range(n_layers)], dim=-1)


def _positions(md, n, seed):
    nodes = md.packed_nodes[0]
    lo, hi = nodes.min(0).values, nodes.max(0).values
    g = torch.Generator().manual_seed(seed)
    pos = lo + (hi - lo) * torch.rand((n, 2), generator=g)
    # a few positions exactly on nodes: ties between an edge's neighbours
    pos[:8] = nodes[torch.arange(8) * 7 % nodes.shape[0]]
    return pos


@pytest.mark.parametrize("name", MAPS)
def test_lane_argmin_equals_first_argmins_on_the_maps(name):
    """The summed endpoint distances of the packed edges (car_info's
    scan) and of the lanepath edges masked to those within 30 degrees of
    a random direction (the u-turn re-snap) from 256 positions: the
    mirror's per-layer indices equal `car._first_argmins`, its masked
    index `geometry._masked_argmin`."""
    md = _portbench_params(name).map_data
    pos = _positions(md, 256, seed=len(name))[:, None, :]
    pn, pe = md.packed_nodes[0], md.packed_edges[0]
    p0, p1 = geo.edge_endpoints(pn, pe)
    d = torch.abs(geo.distance(pos, p0) + geo.distance(pos, p1))
    bounds = md.packed_layer_bounds
    assert torch.equal(_layer_argmins(d, bounds, md.n_layers),
                       car_mod._first_argmins(d, bounds, md.n_layers))

    lp = md.lanepath
    g = torch.Generator().manual_seed(1)
    direction = (torch.rand(256, generator=g) * 2 - 1) * torch.pi
    ori = geo.edge_orientations(lp.nodes, lp.edges)
    valid = (torch.abs(geo.clip_angle(ori - direction[:, None]))
             <= np.radians(30.0)) & lp.edge_mask
    p0, p1 = geo.edge_endpoints(lp.nodes, lp.edges)
    d = torch.abs(geo.distance(pos, p0) + geo.distance(pos, p1))
    masked = torch.where(valid, d, geo._BIG)
    assert torch.equal(lane_argmin(masked, 0, masked.shape[1]),
                       geo._masked_argmin(d, valid))
    assert bool(valid.any(-1).all())


def test_lane_argmin_ties_infinities_nans_and_empty_layers():
    """Random rows over few distinct values (ties everywhere), with rows
    all +inf, rows with a NaN or two, one-element layers and edgeless
    layers, split across lane-block boundaries."""
    rng = np.random.default_rng(0)
    d = torch.tensor(rng.integers(0, 4, (300, 203)), dtype=torch.float32)
    d[::7] = float("inf")
    d[3::11, 40] = float("inf")
    d[5::13, 100] = float("nan")
    d[5::26, 33] = float("nan")
    d[6::17, 170:] = -0.0
    d[6::17, 171] = 0.0
    bounds = (0, 0, 31, 32, 100, 100, 165, 203, 203)
    n_layers = len(bounds) - 1
    assert torch.equal(_layer_argmins(d, bounds, n_layers),
                       car_mod._first_argmins(d, bounds, n_layers))
    valid = torch.tensor(rng.random((300, 203)) < 0.3)
    valid[::9] = False
    assert torch.equal(lane_argmin(torch.where(valid, d, geo._BIG), 0, 203),
                       geo._masked_argmin(d, valid))


def gated_find_local_path(md, state, maneuver):
    """The kernel's per-car gate: the u-turn entries run `find_local_path`
    (and its re-snap scan) on their own rows; every other car runs it on a
    map whose re-snap can find no edge (every lanepath edge masked), as if
    the scan had not run: the composition discards the scan's result for
    those cars."""
    entry = (maneuver.to(torch.int32) == 2) & (state.last_maneuver != 2)
    blind = replace(md, lanepath=replace(
        md.lanepath, edge_mask=torch.zeros_like(md.lanepath.edge_mask)))
    out = {}
    truncated = torch.empty_like(entry)
    for rows, m in ((entry, md), (~entry, blind)):
        if not bool(rows.any()):
            continue
        sub = car_mod.CarState(**{f.name: getattr(state, f.name)[rows]
                                  for f in fields(state)})
        new, trunc = car_mod.find_local_path(m, sub, maneuver[rows])
        truncated[rows] = trunc
        for f in ("local_path", "local_path_len", "last_maneuver"):
            kept = out.setdefault(f, getattr(state, f).clone())
            kept[rows] = getattr(new, f)
    return replace(state, **out), truncated, int(entry.sum())


@pytest.mark.parametrize("name", MAPS)
def test_uturn_gate_equals_ungated_find_local_path(name):
    """300 steps of 32 cars under random actions with the maneuvers
    cycling 0-3 (a u-turn entry every fourth car a step), respawned on
    truncation: the gated walk's path, length, last maneuver and
    truncation equal the ungated walk's every step."""
    params = _portbench_params(name)
    md = params.map_data
    cfg = params.cfg
    n = 32
    rows = torch.arange(n) % md.spawns.count
    car = car_mod.car_reset(md, cfg.car, rows)
    rng = np.random.default_rng(5)
    entries = truncations = 0
    for step in range(300):
        control = torch.tensor(rng.uniform(-1, 1, (n, 2)), dtype=torch.float32)
        man = torch.tensor((step + np.arange(n)) % 4, dtype=torch.int32)
        moved, _ = car_mod.car_step(md, cfg.car, cfg.sim.T, car,
                                    control[:, 0], control[:, 1],
                                    torch.zeros_like(man))
        # the kinematics from car_step, then the walk from the old path
        moved = replace(moved, local_path=car.local_path,
                        local_path_len=car.local_path_len,
                        last_maneuver=car.last_maneuver)
        want, want_trunc = car_mod.find_local_path(md, moved, man)
        got, got_trunc, k = gated_find_local_path(md, moved, man)
        for f in ("local_path", "local_path_len", "last_maneuver"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (step, f)
        assert torch.equal(got_trunc, want_trunc), step
        entries += k
        truncations += int(want_trunc.sum())
        fresh = car_mod.car_reset(md, cfg.car, (rows + step) % md.spawns.count)
        car = vector._select(want_trunc, fresh, want)
    assert entries >= 300 * n // 4 - n and truncations > 0


def test_step_not_launched_on_cpu():
    """A CPU step takes the torch composition: "car.kernel" and
    "car.resnaps" stay 0 and the kernel's wrapper counts no launch; the
    step's outputs are `_car_work_plain`'s, with position and
    orientation added to its info."""
    params = _portbench_params("simple_layout-128x160")
    n = 8
    state, _, _ = fenv.reset(params, n, spawn_row=torch.arange(n),
                             render=False)
    action = {"car_control": torch.full((n, 2), 0.5),
              "maneuver": torch.arange(n) % 4}
    before = ck.car_kernel.launches
    with profiling.tracing() as tr:
        new, obs, reward, terminated, truncated, info = fenv.step(
            params, state, action, render=False)
    assert ck.car_kernel.launches == before
    assert tr.counters.get("car.kernel", 0) == 0
    assert tr.counters.get("car.resnaps", 0) == 0
    assert obs is None
    car, trunc, want, rew, term = fenv._car_work_plain(params, state.car,
                                                       action, False)
    assert list(info) == list(want) + ["position", "orientation"]
    for key in want:
        assert torch.equal(info[key], want[key]), key
    assert info["position"] is new.car.position
    assert info["orientation"] is new.car.rotation
    for a, b in ((reward, rew), (terminated, term), (truncated, trunc)):
        assert torch.equal(a, b)


def test_applies_only_to_cuda_float32_without_a_grid():
    """The kernel applies to a CUDA float32 state and action on a map
    without a LanelineGrid; the three cases that keep the composition are
    each decided by the input: CPU tensors, another dtype, a grid. (A
    stand-in gives a CUDA tensor's device and dtype without a card.)"""
    md = _portbench_params("simple_layout-128x160").map_data

    def on(device, dtype=torch.float32):
        return SimpleNamespace(device=torch.device(device), dtype=dtype)

    def car(position):
        return SimpleNamespace(position=position)

    assert ck.applies(md, car(on("cuda")), on("cuda"))
    assert not ck.applies(md, car(on("cpu")), on("cpu"))
    assert not ck.applies(md, car(on("cuda", torch.float64)),
                          on("cuda", torch.float64))
    assert not ck.applies(md, car(on("cuda")), on("cuda", torch.float64))
    assert not ck.applies(replace(md, laneline_grid=object()),
                          car(on("cuda")), on("cuda"))


def test_argument_arrays_match_the_source():
    """The wrapper's argument names are as many as car.cu's enums name,
    and the kernel's envs a block and layer limit are the source's."""
    with open(os.path.join(REPO, "tinycarlo_torch", "ops", "csrc",
                           "car.cu")) as f:
        src = f.read()

    def enum(name):
        body = re.search(r"enum %s \{([^}]*)\}" % name, src).group(1)
        return [t.strip() for t in body.split(",") if t.strip()]

    assert len(enum("In")) - 1 == len(ck._IN)  # less kNumIn
    assert len(enum("Out")) - 1 == len(ck._OUT)
    assert enum("Ints")[-1] == "kBounds"
    assert len(enum("Ints")) - 1 == len(ck._INTS)
    assert len(enum("Floats")) - 1 == len(ck._FLOATS)
    assert f"kWarps = {ck.ENVS_PER_BLOCK};" in src
    assert f"kMaxLayers = {ck.MAX_LAYERS};" in src
