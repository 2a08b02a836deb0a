"""tinycarlo_torch.map_compiler against tinycarlo_tpu.map_compiler: every
MapData array equal (values and dtype) on the vendored maps."""
import dataclasses
import os

import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_common import (
    REPO,
    assert_trees_equal,
    port_tree,
    to_numpy_tree,
)
from tinycarlo_torch.config import load_config as port_load
from tinycarlo_torch.map_compiler import compile_map as port_compile
from tinycarlo_tpu.config import MapConfig, load_config as jax_load
from tinycarlo_tpu.map_compiler import compile_map as jax_compile

CASES = [
    ("config_simple_layout.yaml", torch.float32, jnp.float32),
    ("config_simple_layout.yaml", torch.float64, jnp.float64),
    ("config_knuffingen.yaml", torch.float32, jnp.float32),
    ("loop_track.json", torch.float32, jnp.float32),
]


@pytest.mark.parametrize("source,tdt,jdt", CASES)
def test_map_data_equal(source, tdt, jdt):
    if source.endswith(".yaml"):
        path = os.path.join(REPO, "examples", source)
        jcfg, base = jax_load(path)
        pcfg, _ = port_load(path)
        jmap, pmap = jcfg.map, pcfg.map
    else:
        base = None
        jmap = MapConfig(
            json_path=os.path.join(REPO, "examples", "maps", source),
            pixel_per_meter=450,
        )
        pmap = jmap
    want = to_numpy_tree(jax_compile(jmap, base_path=base, dtype=jdt))
    got = port_tree(port_compile(pmap, base_path=base, dtype=tdt,
                                 device="cpu"))
    # MapConfig.query_grid defaults to False: neither map carries a grid
    assert "laneline_grid" not in want and got["laneline_grid"] is None
    assert_trees_equal(got, want)
    assert got["packed_layer_bounds"][-1] > 0
    # with the grid on, the LanelineGrid arrays are equal too (or None in
    # both where pruning would not pay)
    jgrid = jax_compile(dataclasses.replace(jmap, query_grid=True),
                        base_path=base, dtype=jdt).laneline_grid
    pgrid = port_compile(dataclasses.replace(pmap, query_grid=True),
                         base_path=base, dtype=tdt,
                         device="cpu").laneline_grid
    assert (jgrid is None) == (pgrid is None)
    if jgrid is not None:
        assert_trees_equal(port_tree(pgrid), to_numpy_tree(jgrid))
