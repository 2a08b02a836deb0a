"""The port's LanelineGrid (tinycarlo_torch.map_compiler) and the grid
branch of its car_info against the JAX package's (tinycarlo_tpu.
map_compiler.LanelineGrid, car.py:310-397).

The grid arrays equal JAX's; the grid branch equals the port's full scan
bit for bit within the grid's domain (float64 and float32; positions
fuzzed over the domain, an eighth of them on cell boundaries, as
tests/test_query_grid.py does); and the port's grid car_info equals JAX's
grid car_info within 1e-9 in float64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import KNUFFINGEN_MAP, SIMPLE_LAYOUT_MAP
from tests.test_torch_common import assert_trees_equal, port_tree, to_numpy_tree
from tinycarlo_torch import car as pcar
from tinycarlo_torch.config import CarConfig as PCarConfig
from tinycarlo_torch.config import MapConfig as PMapConfig
from tinycarlo_torch.map_compiler import compile_map as port_compile
from tinycarlo_tpu import car as jcar
from tinycarlo_tpu.config import CarConfig as JCarConfig
from tinycarlo_tpu.config import MapConfig as JMapConfig
from tinycarlo_tpu.map_compiler import compile_map as jax_compile

MAPS = {"simple_layout": (SIMPLE_LAYOUT_MAP, 450),
        "knuffingen": (KNUFFINGEN_MAP, 150)}
TDT = {"float64": torch.float64, "float32": torch.float32}


def _port_maps(name, dtype, **grid_kw):
    path, ppm = MAPS[name]
    grid_kw.setdefault("query_grid", True)
    md_g = port_compile(PMapConfig(json_path=path, pixel_per_meter=ppm,
                                   **grid_kw), dtype=TDT[dtype], device="cpu")
    md_f = port_compile(PMapConfig(json_path=path, pixel_per_meter=ppm),
                        dtype=TDT[dtype], device="cpu")
    return md_g, md_f


def _fuzz_positions(grid, n, seed):
    """(n, 2) float64 positions uniform over the grid's domain, the first
    n // 8 snapped to cell corners (tests/test_query_grid.py:54-64)."""
    rng = np.random.default_rng(seed)
    o = grid.origin.double().numpy()
    cell = 1.0 / float(grid.inv_cell)
    hi = o + np.asarray([grid.nx * cell, grid.ny * cell])
    pos = rng.uniform(o, hi, size=(n, 2))
    pos[: n // 8] = o + np.round((pos[: n // 8] - o) / cell) * cell
    return pos


def _port_states(md, pos, dtype):
    n = pos.shape[0]
    position = torch.as_tensor(pos, dtype=dtype)
    rot = torch.linspace(-3.0, 3.0, n, dtype=torch.float64).to(dtype)
    front = position + torch.tensor(0.0487, dtype=dtype) * torch.stack(
        [torch.cos(rot), torch.sin(rot)], dim=-1)
    edge = md.lanepath.edges[0]
    return pcar.CarState(
        position=position, position_front=front, rotation=rot,
        steering_angle=torch.zeros(n, dtype=dtype),
        radius=torch.zeros(n, dtype=dtype),
        velocity=torch.full((n,), 0.1, dtype=dtype),
        local_path=edge.expand(n, pcar.PATH_LEN, 2).to(torch.int32).clone(),
        local_path_len=torch.full((n,), 2, dtype=torch.int32),
        last_maneuver=torch.zeros(n, dtype=torch.int32),
    )


def _assert_infos_equal(got, want):
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                      err_msg=k)


@pytest.mark.parametrize("name", sorted(MAPS))
def test_grid_arrays_equal_jax(name):
    """cand_idx, cand_p0/p1, origin, inv_cell (values and dtype), nx, ny
    and layer_bounds equal the JAX package's."""
    path, ppm = MAPS[name]
    want = jax_compile(JMapConfig(json_path=path, pixel_per_meter=ppm,
                                  query_grid=True), dtype=jnp.float32)
    got = port_compile(PMapConfig(json_path=path, pixel_per_meter=ppm,
                                  query_grid=True), device="cpu")
    assert want.laneline_grid is not None
    assert_trees_equal(port_tree(got.laneline_grid),
                       to_numpy_tree(want.laneline_grid))


def test_grid_none_where_pruning_does_not_pay():
    """One cell keeps nearly every edge: both packages build no grid."""
    path, ppm = MAPS["simple_layout"]
    kw = dict(json_path=path, pixel_per_meter=ppm, query_grid=True,
              query_grid_cells=1)
    assert jax_compile(JMapConfig(**kw)).laneline_grid is None
    assert port_compile(PMapConfig(**kw), device="cpu").laneline_grid is None


def test_compile_map_passes_cells_and_margin():
    """compile_map hands MapConfig's query_grid_cells and
    query_grid_margin to `_build_laneline_grid`: the cell counts and
    origin follow JAX's."""
    path, ppm = MAPS["simple_layout"]
    kw = dict(json_path=path, pixel_per_meter=ppm, query_grid=True,
              query_grid_cells=1024, query_grid_margin=0.25)
    want = jax_compile(JMapConfig(**kw)).laneline_grid
    got = port_compile(PMapConfig(**kw), device="cpu").laneline_grid
    assert (got.nx, got.ny) == (want.nx, want.ny)
    assert got.nx * got.ny < 4096 // 2
    np.testing.assert_array_equal(got.origin.numpy(),
                                  np.asarray(want.origin))


@pytest.mark.parametrize("name,dtype,n,seed", [
    ("simple_layout", "float64", 512, 0),
    ("simple_layout", "float32", 512, 0),
    ("knuffingen", "float64", 256, 1),
])
def test_grid_matches_full_scan(name, dtype, n, seed):
    """The grid branch gives the full scan's car_info bit for bit."""
    md_g, md_f = _port_maps(name, dtype)
    assert md_g.laneline_grid is not None and md_f.laneline_grid is None
    st = _port_states(md_g, _fuzz_positions(md_g.laneline_grid, n, seed),
                      TDT[dtype])
    cfg = PCarConfig()
    _assert_infos_equal(pcar.car_info(md_g, cfg, st),
                        pcar.car_info(md_f, cfg, st))


def test_grid_invariants():
    """tests/test_query_grid.py:97-114 on the port's grid: every cell keeps
    a candidate of each non-empty layer, candidates are packed first and
    in ascending packed order within their layer's slice."""
    md_g, _ = _port_maps("simple_layout", "float64")
    g = md_g.laneline_grid
    idx = g.cand_idx.numpy()
    bounds, pb = g.layer_bounds, md_g.packed_layer_bounds
    for l in range(md_g.n_layers):
        block = idx[:, bounds[l]: bounds[l + 1]]
        if pb[l + 1] > pb[l]:
            assert (block >= 0).any(axis=1).all()
        for row in block:
            live = row >= 0
            v = row[live]
            assert np.all(np.diff(v) > 0)
            assert np.all(v >= pb[l]) and np.all(v < pb[l + 1])
            # live candidates first, pads after
            assert not np.any(live[np.argmin(live):]) or live.all()


def test_grid_car_info_matches_jax():
    """The port's grid car_info against the JAX package's grid car_info
    (its one-hot row routing) on the same float64 states: within 1e-9."""
    md_g, _ = _port_maps("simple_layout", "float64")
    path, ppm = MAPS["simple_layout"]
    jmd = jax_compile(JMapConfig(json_path=path, pixel_per_meter=ppm,
                                 query_grid=True), dtype=jnp.float64)
    st = _port_states(md_g, _fuzz_positions(md_g.laneline_grid, 256, 3),
                      torch.float64)
    got = pcar.car_info(md_g, PCarConfig(), st)
    jst = jcar.CarState(**{f.name: jnp.asarray(getattr(st, f.name).numpy())
                           for f in dataclasses.fields(st)})
    jcfg = JCarConfig()
    want = jax.jit(jax.vmap(lambda s: jcar.car_info(jmd, jcfg, s)))(jst)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-9, err_msg=k)
