"""The port's scale-out layer (tinycarlo_torch.parallel) on gloo CPU ranks,
against the port's single-process paths and the JAX package's
tinycarlo_tpu.parallel.

Ranks are spawned processes (a `spawn` multiprocessing context) that
rendezvous through a FileStore under the test's tmp_path, so parallel
test workers never race for a TCP port; each spawn has a deadline. The
worker functions below import no JAX: the JAX package runs only in the
parent, for the oracles.

One spawn of 4 ranks (the module fixture `battery`) runs every check of
a (data 2 x model 2) mesh: the mesh and feeding helpers, the TP nets,
the SP renderers and the DP x TP x SP TD3 chunk; a spawn of 2 ranks runs
a DP `vector.step` (tests/test_multihost.py:66-114's check). The tests
compare the ranks' results with the single-process port (bit for bit
unless stated) and with the JAX package:

  * JAX's `rasterize_masks_sp` (dense), `rasterize_masks_packed_sp` and
    `render_observation_batch_sp` (classes) run as tests/test_parallel.py
    runs them, in interpret mode on a model = 2 mesh of the 8-device CPU
    backend. JAX's float `out_dtype` is `where(combined > 0, 1, 0)` of
    the same OR (sp.py:183-184), so the port's float frames are held to
    JAX's uint8 frame > 0. Each JAX SP render compiles for ~30 s in
    interpret mode (the exact stroke's for over two minutes), so the
    port's SP rank and exact frames are held to the port's unsharded
    renders, which tests/test_torch_rank.py and
    tests/test_torch_exact*.py hold to the JAX package's.
  * TP: the sharded nets' outputs within rtol 1e-5 of the unsharded nets
    (tests/test_parallel.py:25-84's tolerance), gradients likewise.
  * The DP x TP x SP chunk: per-env outputs, queue and replay storage
    within the stated tolerances of the single-process chunk, and equal
    bit for bit on every rank; with the learner replicated (DP x SP)
    everything is bit-equal to the single-process chunk.
"""
import dataclasses
import multiprocessing
import os
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIMPLE_LAYOUT = os.path.join(REPO, "examples", "maps", "simple_layout.json")

# tests/test_env.py's CONFIG (simple_layout, classes, t = 2) at 32x40
CONFIG = {
    "sim": {"fps": 30, "observation_space_format": "classes"},
    "car": {"wheelbase": 0.0487, "track_width": 0.027,
            "max_velocity": 0.15, "max_steering_angle": 30,
            "steering_speed": 30, "max_acceleration": 0.1,
            "max_deceleration": 1.0},
    "camera": {"position": [0.0, -0.005, 0.04], "orientation": [22, 0, 0],
               "resolution": [32, 40], "fov": 80, "max_range": 0.5,
               "line_thickness": 2},
    "map": {"json_path": SIMPLE_LAYOUT, "pixel_per_meter": 450},
}
SP_ENVS, SP_SEED = 4, 2
# the SP env renders run in float64 (both packages' projections agree to
# the bit there; in float32 the two frameworks' rounding moves a pixel)
SP_DTYPE = torch.float64
# the chunk (tests/_multihost_chunk_common.py's nets and replay, 16x24
# frames): max_episode_steps 2 makes every env respawn in the chunk, and
# 32 envs x 3 steps overrun the 64-slot replay, so eviction draws are used.
# 32 envs give each data rank 16 rows: MKL's float32 products take another
# kernel below 16 rows, whose bits differ from the same rows' in a larger
# batch, so smaller shards could not be held bit for bit to the
# single-process chunk's 32-row products.
CHUNK_ENVS, CHUNK_STEPS, CHUNK_SEED = 32, 3, 7
REPLAY = 64
SPAWN_DEADLINE_S = 240


def config(resolution=(32, 40), thickness=2, fmt="classes", stroke=None):
    cfg = {k: dict(v) for k, v in CONFIG.items()}
    cfg["camera"].update(resolution=list(resolution),
                         line_thickness=thickness)
    if stroke is not None:
        cfg["camera"]["stroke"] = stroke
    cfg["sim"]["observation_space_format"] = fmt
    return cfg


# ---- ranks ------------------------------------------------------------------

def _run_rank(rank, world, init_file, out_dir, job):
    torch.set_num_threads(1)
    from tinycarlo_torch.parallel import multihost

    multihost.initialize(init_method="file://" + init_file,
                         world_size=world, rank=rank, backend="gloo")
    try:
        result = JOBS[job](rank)
        torch.save(result, os.path.join(out_dir, f"{job}_{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def spawn(job, world, tmp_path):
    """Run JOBS[job] on `world` gloo ranks; returns each rank's result."""
    ctx = multiprocessing.get_context("spawn")
    init_file = str(tmp_path / f"{job}.store")
    procs = [ctx.Process(target=_run_rank,
                         args=(r, world, init_file, str(tmp_path), job))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"{job} ranks exited {codes}"
    return [torch.load(tmp_path / f"{job}_{r}.pt", weights_only=False)
            for r in range(world)]


def sp_inputs(kind):
    """The numpy-seeded inputs of the SP cases (tests/test_parallel.py's
    shapes)."""
    if kind == "dense":
        rng = np.random.default_rng(0)
        L, E, H, W = 3, 16, 32, 48
        return dict(p0=rng.uniform(0, W, (L, E, 2)).astype(np.float32),
                    p1=rng.uniform(0, H, (L, E, 2)).astype(np.float32),
                    draw=rng.random((L, E)) < 0.7, res=(H, W), t=2)
    rng = np.random.default_rng(5)
    B, E, H, W, L = 4, 50, 32, 160, 3  # E % 4 != 0: the padding
    u0 = rng.uniform(-5, W + 5, (B, E)).astype(np.float32)
    v0 = rng.uniform(-5, H + 5, (B, E)).astype(np.float32)
    return dict(
        u0=u0, v0=v0,
        u1=u0 + rng.uniform(-30, 30, (B, E)).astype(np.float32),
        v1=v0 + rng.uniform(-12, 12, (B, E)).astype(np.float32),
        draw=rng.random((B, E)) < 0.7,
        layer=rng.integers(0, L, (E,)).astype(np.int32), L=L, res=(H, W),
        t=2)


def sp_states(params):
    """SP_ENVS spawned states, the same on every rank and in the parent."""
    from tinycarlo_torch import vector

    return vector.reset(params, SP_ENVS, seed=SP_SEED, render=False)[0].env


# the SP env renders: name -> (config kwargs, render kwargs)
ENV_CASES = {
    "classes": ({}, {}),
    "classes_dp": ({}, {"data_sharded": True}),
    "float32": ({}, {"out_dtype": torch.float32}),
    "rank": ({"fmt": "rank"}, {"fmt": "rank"}),
    "exact": ({"stroke": "exact"}, {}),
    "exact_rank": ({"fmt": "rank", "stroke": "exact"}, {"fmt": "rank"}),
}


def tp_nets():
    """name -> (unsharded module, inputs), seeded alike everywhere."""
    from tinycarlo_torch.models import tinycar_net as tn

    rng = np.random.default_rng(11)
    f = torch.as_tensor(rng.normal(size=(8, 256)), dtype=torch.float32)
    fq = torch.as_tensor(rng.normal(size=(8, 4, 256)), dtype=torch.float32)
    m = tn.one_hot(torch.as_tensor(rng.integers(0, 3, 8)), 3,
                   torch.float32)
    a = torch.as_tensor(rng.uniform(-1, 1, (8, 1)), dtype=torch.float32)
    nets = {"critic": (tn.TinycarCritic(), (f, m, a)),
            "actor": (tn.TinycarActor(), (f, m)),
            "actor_temporal": (tn.TinycarActorTemporal(seq_len=4), (fq, m)),
            "critic_temporal": (tn.TinycarCriticTemporal(seq_len=4),
                                (fq, m, a))}
    for i, (net, _) in enumerate(nets.values()):
        tn.flax_init_(net, torch.Generator().manual_seed(i))
    return nets


def tp_forward_backward(net, inputs):
    """(outputs, {parameter name: gradient of sum(outputs**2)})."""
    out = net(*inputs)
    grads = torch.autograd.grad((out ** 2).sum(), list(net.parameters()))
    return out.detach(), {n: g for (n, _), g in
                          zip(net.named_parameters(), grads)}


def chunk_setup():
    from tinycarlo_torch import env as penv
    from tinycarlo_torch.train import td3
    from tinycarlo_torch.train.td3_loop import LoopConfig

    params = penv.make_env_params(config((16, 24), thickness=1),
                                  device="cpu")
    cfg = td3.TD3Config(seq_len=2, batch_size=8)
    loop_cfg = LoopConfig(replay_size=REPLAY, max_episode_steps=2,
                          obs_dtype=torch.float32)
    return params, cfg, loop_cfg


def encoder_apply(obs):
    """A fixed obs -> (B, 256) map (tests/_multihost_chunk_common.py's toy
    frozen encoder): the learner under test is the TD3 stack."""
    x = obs.to(torch.float32)
    f = x.reshape(x.shape[0], -1)
    f = torch.nn.functional.pad(f, (0, (-f.shape[1]) % 256))
    return f.reshape(x.shape[0], -1, 256).mean(dim=1)


def run_chunk(mesh=None, tp=True):
    """The chunk from init_loop(CHUNK_SEED): single-process without
    `mesh`; else DP x SP over `mesh` (the env rows sharded over data, the
    replay and loop scalars replicated, the SP renderer inside the chunk)
    and, with `tp`, the learner TP-sharded over model (tests/
    _multihost_chunk_common.run_sharded_chunk's placement). Returns the
    outputs, the (global) queue and the replay storage."""
    from tinycarlo_torch.parallel import mesh as pmesh
    from tinycarlo_torch.parallel import tp as ptp
    from tinycarlo_torch.parallel.sp import render_observation_batch_sp
    from tinycarlo_torch.train.td3_loop import chunk, init_loop

    params, cfg, loop_cfg = chunk_setup()
    state = init_loop(params, cfg, loop_cfg, CHUNK_ENVS, seed=CHUNK_SEED)
    kw = {}
    if mesh is not None:
        for f in ("vstate", "queue", "noise", "maneuver", "sigma",
                  "ep_count"):
            setattr(state, f, pmesh.shard_batch(getattr(state, f), mesh))
        state.buf = pmesh.replicate(state.buf, mesh)
        if tp:
            ts = state.td3_state
            for net, opt in (("actor", "opt_actor"),
                             ("critic1", "opt_critic1"),
                             ("critic2", "opt_critic2")):
                module = getattr(ts, net)
                o = getattr(ts, opt)
                o.mu = ptp.shard_state_dict(module, o.mu, mesh)
                o.nu = ptp.shard_state_dict(module, o.nu, mesh)
                for name in (net, net + "_target"):
                    ptp.shard_params(getattr(ts, name), mesh)
        kw = dict(mesh=mesh, obs_render_fn=lambda p, s, out_dtype:
                  render_observation_batch_sp(p, s, mesh,
                                              out_dtype=out_dtype))
    state, out = chunk(state, params, cfg, loop_cfg, encoder_apply,
                       CHUNK_STEPS, graph=False, **kw)
    queue = state.queue
    if mesh is not None:
        from tinycarlo_torch.train.td3_loop import _DataParallel

        queue = _DataParallel(mesh, queue.shape[0]).gather(queue)
    return {"out": out, "queue": queue, "buf": state.buf.storage,
            "filled": state.buf.filled}


def _battery(rank):
    import torch.distributed as dist

    from tinycarlo_torch import env as penv
    from tinycarlo_torch.parallel import mesh as pmesh
    from tinycarlo_torch.parallel import multihost, sp
    from tinycarlo_torch.parallel import tp as ptp

    res = {}
    mesh4 = pmesh.make_mesh(device_type="cpu")
    mesh = pmesh.make_mesh(model=2, device_type="cpu")
    # a mesh over the first 2 of the 4 ranks
    sub = pmesh.make_mesh(data=2, model=1, device_type="cpu")
    res["mesh"] = {
        "shape4": (pmesh.axis_size(mesh4, "data"),
                   pmesh.axis_size(mesh4, "model")),
        "shape": (pmesh.axis_size(mesh, "data"),
                  pmesh.axis_size(mesh, "model")),
        "coord": (pmesh.axis_index(mesh, "data"),
                  pmesh.axis_index(mesh, "model")),
        "model_group": dist.get_process_group_ranks(
            pmesh.axis_group(mesh, "model")),
        "data_group": dist.get_process_group_ranks(
            pmesh.axis_group(mesh, "data")),
        "rows": multihost.local_batch_slice(16, mesh),
        "rows_world": multihost.local_batch_slice(16),
        "sub": ((pmesh.axis_size(sub, "data"), pmesh.axis_size(sub, "model"),
                 pmesh.axis_index(sub, "data")) if rank < 2 else None),
    }
    x = torch.arange(16 * 6, dtype=torch.float32).reshape(16, 6)
    res["shard_batch"] = pmesh.shard_batch({"x": x, "n": 3}, mesh)
    res["global_array"] = multihost.global_array(x, mesh,
                                                 (None, "model"))
    res["host_local"] = multihost.host_local_array(
        (16, 6), mesh, lambda rows: x[rows] * 2)
    mine = torch.full((3,), float(rank))
    flags = torch.tensor([rank % 2 == 1, True])
    res["replicate"] = pmesh.replicate({"v": mine, "b": flags}, mesh)

    res["tp"] = {}
    for name, (net, inputs) in tp_nets().items():
        ptp.shard_params(net, mesh)
        res["tp"][name] = tp_forward_backward(net, inputs)

    d = sp_inputs("dense")
    res["dense"] = sp.rasterize_masks_sp(
        torch.as_tensor(d["p0"]), torch.as_tensor(d["p1"]),
        torch.as_tensor(d["draw"]), d["res"], d["t"], mesh)
    p = sp_inputs("packed")
    args = [torch.as_tensor(p[k]) for k in
            ("u0", "v0", "u1", "v1", "draw", "layer")]
    for key, kw in (("packed", {}), ("packed_dp", {"data_sharded": True}),
                    ("packed_exact", {"stroke": "exact"})):
        res[key] = sp.rasterize_masks_packed_sp(
            *args, p["L"], p["res"], p["t"], mesh, **kw)
    for name, (ckw, rkw) in ENV_CASES.items():
        params = penv.make_env_params(config(**ckw), dtype=SP_DTYPE,
                                      device="cpu")
        res["env_" + name] = sp.render_observation_batch_sp(
            params, sp_states(params), mesh, **rkw)
    try:
        sp.render_observation_batch_sp(
            params, sp_states(params), mesh, fmt="rank",
            out_dtype=torch.float32)
        res["rank_float_raises"] = False
    except ValueError:
        res["rank_float_raises"] = True

    res["chunk_tp"] = run_chunk(mesh, tp=True)
    res["chunk_dp_sp"] = run_chunk(mesh, tp=False)
    if rank == 0:
        # the single-process chunk, in a process like the ranks' (one
        # thread: a CPU product's bits can depend on the thread count)
        res["chunk_single"] = run_chunk()
    return res


DP_ENVS, DP_STEPS = 16, 3


def dp_step_run(mesh=None):
    """DP_STEPS renders and steps of DP_ENVS envs at a constant action:
    single-process without `mesh`, else this rank's rows with
    the respawn rows drawn for the whole batch (tests/test_multihost.py's
    step check). Returns the stacked per-env outputs (this rank's rows)."""
    from tinycarlo_torch import env as penv
    from tinycarlo_torch import vector
    from tinycarlo_torch.parallel import mesh as pmesh

    params = penv.make_env_params(config(), device="cpu")
    state, _ = vector.reset(params, DP_ENVS, seed=0, render=False)
    rows = slice(0, DP_ENVS)
    if mesh is not None:
        rows = pmesh.data_rows(DP_ENVS, mesh)
        state = pmesh.shard_batch(state, mesh)
    n = rows.stop - rows.start
    action = {"car_control": torch.tensor([[0.5, 0.1]]).expand(n, 2),
              "maneuver": torch.zeros(n, dtype=torch.int32)}
    outs = []
    for _ in range(DP_STEPS):
        respawn = None  # vector.step's own draw
        if mesh is not None:
            respawn = torch.randint(params.map_data.spawns.count,
                                    (DP_ENVS,), generator=state.generator,
                                    device=state.episode_step.device)[rows]
        state, obs, rew, term, trunc, info = vector.step(
            params, state, action, max_episode_steps=2,
            respawn_rows=respawn)
        outs.append({"obs": obs, "reward": rew, "cte": info["cte"],
                     "done": term | trunc,
                     "position": state.env.car.position})
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def _dp_step(rank):
    from tinycarlo_torch.parallel import mesh as pmesh

    return dp_step_run(pmesh.make_mesh(data=2, device_type="cpu"))


JOBS = {"battery": _battery, "dp_step": _dp_step}


# ---- tests --------------------------------------------------------------------

@pytest.fixture(scope="module")
def battery(tmp_path_factory):
    return spawn("battery", 4, tmp_path_factory.mktemp("battery"))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def test_mesh_shapes(battery):
    """make_mesh over 4 ranks: data 4 x model 1 by default; (data 2 x
    model 2) with the model axis innermost, so ranks r and r ^ 1 share a
    model group (tests/test_parallel.py:15-23); a (2 x 1) mesh over the
    first two ranks."""
    for r, res in enumerate(battery):
        m = res["mesh"]
        assert m["shape4"] == (4, 1) and m["shape"] == (2, 2)
        assert m["coord"] == (r // 2, r % 2)
        assert sorted(m["model_group"]) == sorted([r, r ^ 1])
        assert sorted(m["data_group"]) == sorted([r % 2, r % 2 + 2])
        assert m["rows"] == slice(8 * (r // 2), 8 * (r // 2) + 8)
        assert m["rows_world"] == slice(4 * r, 4 * r + 4)
        assert m["sub"] == ((2, 1, r) if r < 2 else None)


def test_feeding_helpers(battery):
    """shard_batch, global_array, host_local_array and replicate."""
    x = torch.arange(16 * 6, dtype=torch.float32).reshape(16, 6)
    for r, res in enumerate(battery):
        rows = slice(8 * (r // 2), 8 * (r // 2) + 8)
        _eq(res["shard_batch"]["x"], x[rows])
        assert res["shard_batch"]["n"] == 3
        _eq(res["global_array"], x[:, 3 * (r % 2): 3 * (r % 2) + 3])
        _eq(res["host_local"], x[rows] * 2)
        # broadcast from mesh coordinate (0, 0): rank 0's values
        _eq(res["replicate"]["v"], torch.zeros(3))
        _eq(res["replicate"]["b"], torch.tensor([False, True]))


def _jax_plan_set(plan):
    """A JAX tp_plan as {(module, layer, leaf): kind} in the port's names."""
    names = {"_ManeuverTrunk_0": "trunk", "_ActorHead_0": "head"}
    leaf = {"kernel": "weight", "bias": "bias"}
    return {tuple(names.get(n, n) for n in k[:-1]) + (leaf[k[-1]],): v
            for k, v in plan.items()}


def test_tp_plans():
    """tp_plan shards the JAX package's set on the critic, the actor and
    the temporal nets, and never the frozen encoder's fc1."""
    import jax
    import jax.numpy as jnp

    from tinycarlo_torch.models import tinycar_net as tn
    from tinycarlo_torch.parallel import tp_plan
    from tinycarlo_tpu import models as jm
    from tinycarlo_tpu import parallel as jpar

    f = jnp.ones((2, 256))
    fq = jnp.ones((2, 4, 256))
    m = jax.nn.one_hot(jnp.zeros((2,), jnp.int32), 3)
    a = jnp.zeros((2, 1))
    cases = [
        (tn.TinycarCritic(), jm.TinycarCritic(), (f, m, a)),
        (tn.TinycarActor(), jm.TinycarActor(), (f, m)),
        (tn.TinycarActorTemporal(seq_len=4), jm.TinycarActorTemporal(),
         (fq, m)),
        (tn.TinycarCriticTemporal(seq_len=4), jm.TinycarCriticTemporal(),
         (fq, m, a)),
    ]
    for port_net, jax_net, inputs in cases:
        shapes = jax.eval_shape(jax_net.init, jax.random.key(0), *inputs)
        want = jpar.tp_plan(shapes["params"])
        got = tp_plan(port_net)
        assert got == _jax_plan_set(want), (type(port_net), got, want)
    assert tp_plan(tn.TinycarCritic()) == {
        ("fc1", "weight"): "column", ("fc1", "bias"): "column",
        ("fc2", "weight"): "row"}
    combo = tp_plan(tn.TinycarCombo())
    assert combo and not any(k[0] == "encoder" for k in combo)


@pytest.mark.parametrize("name", ["critic", "actor", "actor_temporal",
                                  "critic_temporal"])
def test_tp_numerics(battery, name):
    """The TP-sharded net's outputs and gradients on every rank equal the
    unsharded net's within rtol 1e-5 (a shard's gradient: the matching
    slice of the full one); the two ranks of a model group agree bit for
    bit."""
    from tinycarlo_torch.parallel.tp import tp_plan

    net, inputs = tp_nets()[name]
    plan = {".".join(k): v for k, v in tp_plan(net).items()}
    want_out, want_grads = tp_forward_backward(net, inputs)
    for r, res in enumerate(battery):
        out, grads = res["tp"][name]
        np.testing.assert_allclose(out, want_out, rtol=1e-5, atol=1e-6)
        _eq(out, battery[r ^ 1]["tp"][name][0])
        i = r % 2
        for pname, g in want_grads.items():
            kind = plan.get(pname)
            if kind == "column":
                g = g.chunk(2, dim=0)[i]
            elif kind == "row":
                g = g.chunk(2, dim=1)[i]
            np.testing.assert_allclose(grads[pname], g, rtol=1e-5,
                                       atol=1e-6, err_msg=pname)


def _jax_mesh():
    from tinycarlo_tpu import parallel as jpar

    return jpar.make_mesh(data=1, model=2)


def test_sp_dense(battery):
    """rasterize_masks_sp equals the unsharded dense masks and JAX's
    rasterize_masks_sp on every rank."""
    import jax.numpy as jnp

    from tinycarlo_torch.ops import rasterize as pras
    from tinycarlo_tpu.parallel.sp import rasterize_masks_sp

    d = sp_inputs("dense")
    want = pras.rasterize_masks(torch.as_tensor(d["p0"]),
                                torch.as_tensor(d["p1"]),
                                torch.as_tensor(d["draw"]), d["res"], d["t"])
    jwant = rasterize_masks_sp(jnp.asarray(d["p0"]), jnp.asarray(d["p1"]),
                               jnp.asarray(d["draw"]), d["res"], d["t"],
                               _jax_mesh())
    _eq(want, jwant)
    assert int(want.sum()) > 0
    for res in battery:
        _eq(res["dense"], want)


def test_sp_packed(battery):
    """rasterize_masks_packed_sp (the padded edge axis, 50 edges over 2
    shards) equals the unsharded kernel path and JAX's
    rasterize_masks_packed_sp; DP x SP returns the rank's rows; the exact
    stroke equals the unsharded exact path."""
    import jax.numpy as jnp

    from tinycarlo_torch.ops import rasterize_kernels as prk
    from tinycarlo_tpu.parallel.sp import rasterize_masks_packed_sp

    p = sp_inputs("packed")
    keys = ("u0", "v0", "u1", "v1", "draw", "layer")
    args = [torch.as_tensor(p[k]) for k in keys]
    want = prk.rasterize_masks_packed_soa(*args, p["L"], p["res"], p["t"])
    want_x = prk.rasterize_masks_packed_soa(*args, p["L"], p["res"],
                                            p["t"], stroke="exact")
    jwant = rasterize_masks_packed_sp(
        *[jnp.asarray(p[k]) for k in keys], p["L"], p["res"], p["t"],
        _jax_mesh(), interpret=True)
    _eq(want, jwant)
    assert int(want.sum()) > 0 and int(want_x.sum()) > 0
    for r, res in enumerate(battery):
        _eq(res["packed"], want)
        _eq(res["packed_dp"], want[2 * (r // 2): 2 * (r // 2) + 2])
        _eq(res["packed_exact"], want_x)


def _port_render(name):
    from tinycarlo_torch import env as penv

    ckw, rkw = ENV_CASES[name]
    params = penv.make_env_params(config(**ckw), dtype=SP_DTYPE,
                                  device="cpu")
    fmt = rkw.get("fmt")
    return penv.render_observation_batch(
        params, sp_states(params), fmt=fmt,
        out_dtype=rkw.get("out_dtype")), params


def _jax_sp_render(params):
    """JAX's render_observation_batch_sp (classes) of the port's SP
    states, and JAX's packed projection of them (p0, p1, draw) with the
    edge layers."""
    import jax
    import jax.numpy as jnp

    from tinycarlo_tpu import car as jcar
    from tinycarlo_tpu import env as jenv
    from tinycarlo_tpu.parallel.sp import render_observation_batch_sp

    car = sp_states(params).car
    jparams = jenv.make_env_params(config(), dtype=jnp.float64)
    jstate = jenv.EnvState(
        car=jcar.CarState(**{f.name: jnp.asarray(getattr(car, f.name))
                             for f in dataclasses.fields(car)}),
        key=jax.random.split(jax.random.key(0), SP_ENVS))
    frame = np.asarray(render_observation_batch_sp(
        jparams, jstate, _jax_mesh(), interpret=True))
    p0, p1, draw = (np.asarray(x) for x in
                    jenv._project_packed_batch(jparams, jstate))
    return frame, (p0, p1, draw,
                   np.asarray(jparams.map_data.packed_edge_layer))


@pytest.mark.parametrize("name", sorted(ENV_CASES))
def test_sp_env_render(battery, name):
    """render_observation_batch_sp on simple_layout at 32x40, 4 envs:
    every rank's frame equals the port's unsharded render (its data rows
    with data_sharded)."""
    want, _ = _port_render(name)
    assert float(want.sum()) > 0
    _, rkw = ENV_CASES[name]
    for r, res in enumerate(battery):
        w = want[2 * (r // 2): 2 * (r // 2) + 2] if rkw.get(
            "data_sharded") else want
        assert res["env_" + name].dtype == w.dtype
        _eq(res["env_" + name], w, name)


def test_sp_env_render_matches_jax(battery):
    """The port's SP frames against JAX's render_observation_batch_sp on
    the same float64 states: equal but for stroke-boundary pixels of
    JAX's projected segments, under 0.5% of them -- the rule the port's
    unsharded renders meet against JAX's (tests/test_torch_slice.py
    `_boundary_pixel`, test_torch_eval.py): the two frameworks' projections
    differ in their last bits, and a pixel on a stroke's radius can flip.
    Also as the float frame (JAX's float out_dtype is its uint8 frame >
    0)."""
    from tests.test_torch_slice import _boundary_pixel

    _, params = _port_render("classes")
    jwant, (p0, p1, draw, layer) = _jax_sp_render(params)
    assert jwant.sum() > 0
    t = params.cfg.camera.line_thickness
    for res in battery:
        for got in (res["env_classes"].numpy(),
                    res["env_float32"].numpy() * 255):
            diff = np.argwhere(got != jwant)
            assert len(diff) < 0.005 * got.size, len(diff)
            for b, l, y, x in diff:
                sel = draw[b] & (layer == l)
                a = np.trunc(np.clip(p0[b][sel], -1e6, 1e6))
                c = np.trunc(np.clip(p1[b][sel], -1e6, 1e6))
                assert _boundary_pixel(float(x), float(y), a, c, t), (
                    f"non-boundary pixel differs at {(b, l, y, x)}")


def test_sp_rank_float_raises(battery):
    """A float out_dtype with fmt="rank" raises (the JAX function ignores
    it)."""
    assert all(res["rank_float_raises"] for res in battery)


def _chunk_flat(res):
    return {**{"out." + k: v for k, v in res["out"].items()},
            "queue": res["queue"],
            **{"buf." + k: v for k, v in res["buf"].items()},
            "filled": res["filled"]}


@pytest.fixture(scope="module")
def single_chunk(battery):
    return _chunk_flat(battery[0]["chunk_single"])


def test_dp_sp_chunk_bit_equal(battery, single_chunk):
    """The chunk with the SP renderer inside it, envs sharded over data
    and the learner replicated, equals the single-process chunk bit for
    bit on every rank: outputs (losses included), queue and replay."""
    assert int(single_chunk["filled"]) == REPLAY < CHUNK_ENVS * CHUNK_STEPS
    assert bool(single_chunk["out.done"].any())
    for res in battery:
        got = _chunk_flat(res["chunk_dp_sp"])
        for k, v in single_chunk.items():
            _eq(got[k], v, k)


# the DP x TP x SP chunk against the single-process chunk: TP sums the
# row-parallel products over the model group, another order of the same
# float32 sum, so the actor's actions (and the losses) move in their last
# bits: 6e-8 at most on this chunk's actions, 2.2e-7 relative on its
# losses. The environments' steps do not see that change here: rewards,
# cte, episode ends, queue and replay observations stay bit-equal
# (tests/test_multihost.py:116-168 holds the JAX package's TP chunk to
# the unsharded one at rtol 1e-6 on the rollout, 1e-4 on the losses).
TP_TOL = {"buf.a": dict(rtol=0, atol=1e-6),
          **{"out." + k: dict(rtol=1e-6, atol=0) for k in
             ("critic1_loss", "critic2_loss", "actor_loss",
              "update_losses")}}


def test_dp_tp_sp_chunk(battery, single_chunk):
    """BASELINE config 5's DP x TP x SP chunk on 4 ranks: every rank holds
    the same outputs, queue and replay bit for bit (the data replicas
    stay equal with no gradient all-reduce); against the single-process
    chunk the per-env outputs, queue and replay are bit-equal but for the
    actions (TP_TOL), and the losses are within rtol 1e-6."""
    flat = [_chunk_flat(res["chunk_tp"]) for res in battery]
    for got in flat[1:]:
        for k, v in flat[0].items():
            _eq(got[k], v, k)
    got = flat[0]
    for k, v in single_chunk.items():
        if k in TP_TOL:
            np.testing.assert_allclose(got[k], v, err_msg=k, **TP_TOL[k])
        else:
            _eq(got[k], v, k)


def test_dp_vector_step(tmp_path):
    """A 2-rank DP vector.step of 16 envs (each rank its 8 rows, the
    respawn rows drawn for the whole batch) equals the single-process
    step bit for bit: frames, rewards, cte, episode ends and positions
    over 3 steps with respawns."""
    want = dp_step_run()
    assert bool(want["done"].any())
    for r, got in enumerate(spawn("dp_step", 2, tmp_path)):
        rows = slice(8 * r, 8 * r + 8)
        for k, v in want.items():
            _eq(got[k], v[:, rows], k)
