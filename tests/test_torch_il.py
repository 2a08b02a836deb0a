"""The port's imitation learning (tinycarlo_torch.train.il, train/logging.py,
convert's combo and IL state conversions, and the IL example) against the
JAX package's, on the CPU.

Tolerances:
- BatchNorm in train mode (ConvBlock) on a (8, 3, 5, 5) float64 batch:
  the running mean and variance equal flax's batch_stats within 1e-12,
  the output within rtol 1e-10 (flax computes var = E[x^2] - E[x]^2,
  torch its two-pass variance: they differ in the last bits, so the exact
  checks take float64);
- train_step from the same flax-initialised weights: float64 (the flax
  combo built with dtype float64), two steps, losses and parameters rtol
  1e-10, running statistics atol 1e-12 (after the second step the
  means 1e-11: see CONV_BIAS_ATOL); float32, losses and running
  statistics rtol 1e-4 (XLA's and torch's float32 sums differ in order;
  after the second step the variances only, CONV_BIAS_ATOL);
- train_chunk with the JAX package's own `jax.random` draws replayed in
  the test and injected: losses rtol 1e-4 in float32;
- the camera randomization at the same (pitch, fov): E and K atol 1e-12
  in float64;
- collection in float64 with the JAX chunk's draws (camera, reset rows,
  OU normals, respawn rows) injected: labels and positions within 1e-9
  (torch's and XLA's libm differ in the last bits), keep and the CTE
  auto-resets equal. The JAX chunk returns only obs, steering and keep,
  so the test also steps a copy of its body op by op (`_jax_steps`) for
  the positions, resets and respawn rows, held first against the JAX
  chunk itself (labels within 1e-12, frames equal). Frames: at t = 1,
  under 0.05% of the chunk's pixels may differ (ROADMAP F3); at t = 2, only
  stroke-boundary pixels (tests/test_torch_slice.py's rule). DAgger runs
  the exact stroke at 48x160, where both packages render equal frames in
  float64, so that the net's actions agree;
- npz: the port's file read by the JAX package gives the flax combo's
  eval output within rtol 1e-5 of the port's; the bundled checkpoint in
  and out byte-equal; the logging CSVs byte-equal.
"""
import filecmp
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from tests.test_env import CONFIG
from tests.test_torch_common import bench_config, torch_threads
from tests.test_torch_slice import _assert_obs, _respawn_rows
from tinycarlo_torch import convert
from tinycarlo_torch import env as penv
from tinycarlo_torch.models import tinycar_net as pnet
from tinycarlo_torch.train import il as pil
from tinycarlo_torch.train import logging as plog
from tinycarlo_tpu import env as jenv
from tinycarlo_tpu import vector as jvec
from tinycarlo_tpu.models import tinycar_net as jnet
from tinycarlo_tpu.train import il as jil
from tinycarlo_tpu.train import logging as jlog
from tinycarlo_tpu.train.stanley import stanley_steering as j_stanley
from tinycarlo_tpu.wrapper.functional import WrapperStack, cte_termination

RTOL64, ATOL_STATS = 1e-10, 1e-12
OBS_64 = (5, 64, 160)


def _to64(tree):
    return jax.tree.map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _jax_state(cfg, dtype, key=0):
    """The JAX package's il.create at OBS_64, in `dtype` (float64: the
    combo computes in float64, its variables and Adam state cast)."""
    state = jil.create(jax.random.key(key), OBS_64, cfg)
    if dtype == jnp.float32:
        return state
    variables = _to64(state.variables)
    return jil.ILState(
        variables=variables,
        opt_state=optax.adam(cfg.learning_rate).init(variables["params"]),
        model=jnet.TinycarCombo(dtype=jnp.float64))


def _pcfg(jcfg, **kw):
    return pil.ILConfig(**{f: getattr(jcfg, f)
                           for f in pil.ILConfig.__dataclass_fields__}, **kw)


def _batch(rng, n, dtype):
    x = rng.random((n, 64, 160, 5))
    m = np.eye(3)[rng.integers(0, 3, n)]
    y = rng.uniform(-2.0, 2.0, (n, 1))
    jb = {"x": jnp.asarray(x, dtype), "m": jnp.asarray(m, dtype),
          "y": jnp.asarray(y, dtype)}
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    pb = {"x": _t(x, tdt).permute(0, 3, 1, 2).contiguous(),
          "m": _t(m, tdt), "y": _t(y, tdt)}
    return jb, pb


# A conv bias ahead of BatchNorm has a zero gradient in exact arithmetic
# (the batch mean takes it out again); its rounding-level gradients, which
# Adam scales up to ~lr * g / eps, move it by ~1e-10 in either package
CONV_BIAS_ATOL = 1e-9


def _assert_tree_close(got, want, rtol, atol, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_close(got[k], want[k], rtol, atol, f"{what}/{k}")
        return
    if what.endswith("Conv_0/bias"):
        atol = max(atol, CONV_BIAS_ATOL)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---- BatchNorm in train mode ----------------------------------------------

def test_bn_train_mode_matches_flax():
    """One train-mode forward of a ConvBlock on a (8, 3, 5, 5) float64
    batch: the running statistics move as flax's do (the biased batch
    variance; torch's BatchNorm2d takes the unbiased one)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 5, 5, 3))
    jblock = jnet.ConvBlock(4, dtype=jnp.float64)
    variables = _to64(jblock.init(jax.random.key(0), jnp.asarray(x)))
    variables["batch_stats"] = jax.tree.map(
        lambda v: v + jnp.asarray(rng.uniform(0.1, 0.5, v.shape)),
        variables["batch_stats"])
    want, mutated = jblock.apply(variables, jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
    block = pnet.ConvBlock(3, 4).double()
    conv, bn = variables["params"]["Conv_0"], variables["params"][
        "BatchNorm_0"]
    stats = variables["batch_stats"]["BatchNorm_0"]
    with torch.no_grad():
        block.conv1.weight.copy_(_t(np.transpose(conv["kernel"],
                                                 (3, 2, 0, 1))))
        block.conv1.bias.copy_(_t(conv["bias"]))
        block.bn1.weight.copy_(_t(bn["scale"]))
        block.bn1.bias.copy_(_t(bn["bias"]))
        block.bn1.running_mean.copy_(_t(stats["mean"]))
        block.bn1.running_var.copy_(_t(stats["var"]))
    block.train()
    got = block(_t(x).permute(0, 3, 1, 2))
    new = mutated["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(block.bn1.running_mean.numpy(),
                               np.asarray(new["mean"]), rtol=0,
                               atol=ATOL_STATS)
    np.testing.assert_allclose(block.bn1.running_var.numpy(),
                               np.asarray(new["var"]), rtol=0,
                               atol=ATOL_STATS)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=RTOL64, atol=1e-12)


def test_bn_eval_mode_unchanged():
    """Eval mode is torch's BatchNorm2d on the running statistics, and
    reads them without moving them."""
    torch.manual_seed(0)
    block = pnet.ConvBlock(3, 4).double().eval()
    with torch.no_grad():
        block.bn1.running_mean.uniform_(-1, 1)
        block.bn1.running_var.uniform_(0.5, 2)
    x = torch.randn(6, 3, 9, 9, dtype=torch.float64)
    before = [b.clone() for b in block.buffers()]
    want = torch.relu(torch.nn.functional.batch_norm(
        block.conv1(x), block.bn1.running_mean, block.bn1.running_var,
        block.bn1.weight, block.bn1.bias, False, 0.0, pnet.BN_EPS))
    assert torch.equal(block(x), want)
    assert all(torch.equal(a, b) for a, b in zip(before, block.buffers()))


# ---- the learner --------------------------------------------------------------

@pytest.mark.parametrize("turn_weight", [0.0, 2.0])
def test_train_step_matches_jax_float64(turn_weight):
    jcfg = jil.ILConfig(learning_rate=1e-3, turn_weight=turn_weight)
    jstate = _jax_state(jcfg, jnp.float64)
    pstate = convert.il_state_from_flax(jax.device_get(jstate), _pcfg(jcfg),
                                        device="cpu")
    assert next(pstate.model.parameters()).dtype == torch.float64
    rng = np.random.default_rng(1)
    jstep = jax.jit(partial(jil.train_step, cfg=jcfg))
    for step in range(2):
        jb, pb = _batch(rng, 8, jnp.float64)
        jstate, jloss = jstep(jstate, batch=jb)
        pstate, ploss = pil.train_step(pstate, _pcfg(jcfg), pb)
        np.testing.assert_allclose(ploss.item(), float(jloss), rtol=RTOL64)
        got = convert.il_state_to_flax(pstate, _pcfg(jcfg))
        want = jax.device_get(jstate)
        for k, v in jax.tree_util.tree_leaves_with_path(
                want.variables["batch_stats"]):
            path = [p.key for p in k]
            # the second step's batch means carry the conv biases, which
            # differ by up to CONV_BIAS_ATOL, at the weight 1 - 0.99
            atol = (0.01 * CONV_BIAS_ATOL if step and path[-1] == "mean"
                    else ATOL_STATS)
            np.testing.assert_allclose(
                got["variables"]["batch_stats"][path[0]][path[1]][path[2]][
                    path[3]], np.asarray(v), rtol=0, atol=atol,
                err_msg=f"step {step}: {path}")
    assert not pstate.model.training
    _assert_tree_close(got["variables"]["params"],
                       want.variables["params"], RTOL64, 1e-14, "params")
    adam = want.opt_state[0]
    assert int(got["opt_state"]["count"]) == int(adam.count) == 2
    _assert_tree_close(got["opt_state"]["mu"], adam.mu, RTOL64, 1e-14, "mu")
    _assert_tree_close(got["opt_state"]["nu"], adam.nu, RTOL64, 1e-18, "nu")


def test_train_step_matches_jax_float32():
    jcfg = jil.ILConfig(learning_rate=1e-3)
    jstate = _jax_state(jcfg, jnp.float32)
    pstate = convert.il_state_from_flax(jax.device_get(jstate), _pcfg(jcfg),
                                        device="cpu")
    rng = np.random.default_rng(2)
    jstep = jax.jit(partial(jil.train_step, cfg=jcfg))
    for step in range(2):
        jb, pb = _batch(rng, 8, jnp.float32)
        jstate, jloss = jstep(jstate, batch=jb)
        pstate, ploss = pil.train_step(pstate, _pcfg(jcfg), pb)
        np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-4)
        got = convert.il_state_to_flax(pstate, _pcfg(jcfg))
        want = jax.device_get(jstate.variables["batch_stats"])
        for k, v in jax.tree_util.tree_leaves_with_path(want):
            path = [p.key for p in k]
            # in float32 Adam moves the conv biases (CONV_BIAS_ATOL) by up
            # to ~lr on rounding noise, which the second step's batch
            # means carry; the variances do not see a shift
            if step and path[-1] == "mean":
                continue
            np.testing.assert_allclose(
                got["variables"]["batch_stats"][path[0]][path[1]][path[2]][
                    path[3]], v, rtol=1e-4, atol=1e-7,
                err_msg=f"step {step}: {path}")


def _dataset(rng, n, m=None):
    """n random samples; the per-maneuver pools as the JAX example builds
    them (examples/train_stanley_il.py:113-124). `m`: the maneuvers."""
    x = rng.integers(0, 256, (n, *OBS_64)).astype(np.uint8)
    m = rng.integers(0, 3, n).astype(np.int32) if m is None else m
    y = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    pools, pool_n = [], []
    mx = max((m == i).sum() for i in range(3))
    for i in range(3):
        ids = np.where(m == i)[0]
        pool_n.append(len(ids))
        pools.append(np.resize(ids, mx))
    return {"x": x, "m": m, "y": y, "pools": np.stack(pools).astype(np.int32),
            "pool_n": np.asarray(pool_n, np.int32)}


def _jax_chunk_draws(key, data, batch, n_steps, balanced):
    """The indices the JAX train_chunk draws (il.py:155-180) from its key."""
    n = data["x"].shape[0]
    out = []
    for k in jax.random.split(key, n_steps):
        if balanced:
            n_m = data["pools"].shape[0]
            per = batch // n_m
            ks = jax.random.split(k, n_m + 1)
            parts = [np.asarray(data["pools"][m])[np.asarray(
                jax.random.randint(ks[m], (per,), 0, data["pool_n"][m]))]
                for m in range(n_m)]
            rem = batch - per * n_m
            if rem:
                parts.append(np.asarray(jax.random.randint(
                    ks[n_m], (rem,), 0, n)))
            out.append(np.concatenate(parts))
        else:
            out.append(np.asarray(jax.random.randint(k, (batch,), 0, n)))
    return torch.from_numpy(np.stack(out).astype(np.int64))


# the round-5 IL run's collection (docs/training_artifacts/il_r5_nodr_run.log:
# --chunk-steps 512 --m2x 2 --no-dr, 30 000 samples of 16 envs) cut to 2
# envs of 136 steps (above the default 128), the samples cut in proportion
R5_ENVS, R5_STEPS, R5_CYCLE = 2, 136, (0, 1, 2, 2)
R5_SAMPLES = 30_000 * R5_ENVS * R5_STEPS // (16 * 512)


def _round5_maneuvers():
    """M of both packages' collect_dataset under the round-5 flags (equal,
    and split as the JAX run's [8192, 8192, 13616] scaled), and the
    balanced pools of the port's example for it."""
    from tinycarlo_torch.examples import train_stanley_il as ex

    cfg = dict(CONFIG)
    cfg["camera"] = dict(CONFIG["camera"], resolution=[32, 40])
    jX, jM, jY = jil.collect_dataset(
        jenv.make_env_params(cfg), jil.ILConfig(camera_dr=False),
        jax.random.key(0), R5_SAMPLES, n_envs=R5_ENVS, chunk_steps=R5_STEPS,
        maneuver_cycle=R5_CYCLE)
    with torch_threads(1):
        pX, pM, pY = pil.collect_dataset(
            penv.make_env_params(cfg, device="cpu"),
            pil.ILConfig(camera_dr=False), 0, R5_SAMPLES, n_envs=R5_ENVS,
            chunk_steps=R5_STEPS, maneuver_cycle=R5_CYCLE)
    assert pX.shape == jX.shape and pX.dtype == jX.dtype == np.uint8
    assert pY.shape == jY.shape and np.isfinite(pY).all()
    np.testing.assert_array_equal(pM, jM)
    per_chunk = R5_ENVS * R5_STEPS // 2  # every 2nd frame
    split = [2 * per_chunk, 2 * per_chunk, R5_SAMPLES - 4 * per_chunk]
    assert [(pM == m).sum() for m in range(3)] == split
    data = ex.make_data(pX, pM, pY, torch.device("cpu"), balance=True)
    return pM, data["pools"].numpy(), data["pool_n"].numpy()


@pytest.mark.parametrize("balanced", [False, True, "round5"])
def test_train_chunk_matches_jax(balanced):
    """The "round5" case: the balanced draws over the round-5 collection's
    maneuvers (`_round5_maneuvers`), the pools the port's example builds
    equal to the JAX example's."""
    jcfg = jil.ILConfig(batch_size=8)
    n_steps = 4
    data = _dataset(np.random.default_rng(3), 20)
    if balanced == "round5":
        m, pools, pool_n = _round5_maneuvers()
        data = _dataset(np.random.default_rng(3), len(m), m.astype(np.int32))
        np.testing.assert_array_equal(pools, data["pools"])
        np.testing.assert_array_equal(pool_n, data["pool_n"])
    if not balanced:
        data = {k: data[k] for k in ("x", "m", "y")}
    jstate = _jax_state(jcfg, jnp.float32)
    pstate = convert.il_state_from_flax(jax.device_get(jstate), _pcfg(jcfg),
                                        device="cpu")
    key = jax.random.key(7)
    draws = _jax_chunk_draws(key, data, 8, n_steps, balanced)
    jstate, jlosses = jax.jit(partial(jil.train_chunk, cfg=jcfg,
                                      n_steps=n_steps))(
        jstate, key=key, data={k: jnp.asarray(v) for k, v in data.items()})
    pdata = {k: torch.from_numpy(v) for k, v in data.items()}
    pdata["m"] = pdata["m"].long()
    pstate, plosses = pil.train_chunk(pstate, _pcfg(jcfg), pdata, n_steps,
                                      draws=draws)
    assert plosses.shape == (n_steps,)
    np.testing.assert_allclose(plosses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    assert int(pstate.opt.count) == n_steps
    assert pstate.runtime.step_graphs.eager == n_steps  # no graph on the CPU


def test_balanced_draw_takes_each_pool():
    """batch_size // M indices from each maneuver's pool, in pool order,
    then a uniform remainder; the draws stay in the live part of each
    pool."""
    data = {k: torch.from_numpy(v)
            for k, v in _dataset(np.random.default_rng(4), 30).items()}
    cfg = pil.ILConfig(batch_size=11)
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(50):
        idx = pil.draw_indices(cfg, data, g)
        assert idx.shape == (11,) and idx.dtype == torch.int64
        m = data["m"][idx]
        for i in range(3):
            assert (m[3 * i:3 * i + 3] == i).all()
        seen.update(idx[:9].tolist())
        assert ((idx[9:] >= 0) & (idx[9:] < 30)).all()
    assert seen == set(range(30))  # every sample is reachable


def test_create_is_flax_initialised():
    cfg = pil.ILConfig()
    a = pil.create((128, 160, 3), cfg, seed=3, device="cpu")
    b = pil.create((128, 160, 3), cfg, seed=3, device="cpu")
    assert a.model.encoder.convs[0].conv1.in_channels == 3
    assert a.model.encoder.fc1.in_features == 64 * 4 * 5
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                 b.model.parameters()))
    assert not a.model.training and int(a.opt.count) == 0
    assert all(not m.bias.any() for m in a.model.modules()
               if isinstance(m, torch.nn.Linear))
    c = pil.create(OBS_64, cfg, device="cpu")
    assert c.model.encoder.convs[0].conv1.in_channels == 5
    if not torch.cuda.is_available():  # the entry points default to "cuda"
        from tinycarlo_torch.examples import train_stanley_il as ex

        with pytest.raises(RuntimeError, match="CUDA"):
            pil.create(OBS_64, cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            ex.main([])


# ---- checkpoints ----------------------------------------------------------------

def test_il_state_round_trip():
    """il_state_to_flax inverts il_state_from_flax exactly, Adam included."""
    jcfg = jil.ILConfig(learning_rate=1e-3)
    jstate = _jax_state(jcfg, jnp.float32)
    rng = np.random.default_rng(5)
    jstate, _ = jax.jit(partial(jil.train_step, cfg=jcfg))(
        jstate, batch=_batch(rng, 4, jnp.float32)[0])
    want = jax.device_get(jstate)
    pstate = convert.il_state_from_flax(want, _pcfg(jcfg), device="cpu")
    got = convert.il_state_to_flax(pstate, _pcfg(jcfg))
    _assert_tree_close(got["variables"], want.variables, 0, 0, "variables")
    _assert_tree_close(got["opt_state"]["mu"], want.opt_state[0].mu, 0, 0)
    _assert_tree_close(got["opt_state"]["nu"], want.opt_state[0].nu, 0, 0)


def test_port_npz_reads_in_jax(tmp_path):
    """The port writes the flat flax-path npz; the JAX package's
    load_variables_npz and flax combo reproduce the port's eval output,
    and the port's load_variables_npz reads the same tree back."""
    cfg = pil.ILConfig(learning_rate=1e-3)
    state = pil.create(OBS_64, cfg, seed=2, device="cpu")
    rng = np.random.default_rng(6)
    for _ in range(2):  # move the weights and the running statistics
        pil.train_step(state, cfg, _batch(rng, 4, jnp.float32)[1])
    path = str(tmp_path / "combo.npz")
    pil.save_variables_npz(path, state)
    assert pil.load_variables_npz is pnet.load_variables_npz
    variables = jil.load_variables_npz(path)
    jb, pb = _batch(rng, 6, jnp.float32)
    want = jnet.TinycarCombo().apply(variables, jb["x"], jb["m"],
                                     train=False)
    with torch.no_grad():
        got = state.model(pb["x"], pb["m"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    back = convert.combo_state_dict_from_flax(pil.load_variables_npz(path))
    for k, v in state.model.state_dict().items():
        assert torch.equal(back[k], v.to(back[k].dtype)) or k.endswith(
            "num_batches_tracked"), k


def test_bundled_checkpoint_round_trip(tmp_path):
    """The bundled 3_128_160 checkpoint through the port's combo and back
    out: the same keys in the same order, every array byte-equal."""
    src = os.path.join(os.path.dirname(pnet._PRETRAINED_DIR), "pretrained",
                       "tinycar_combo_flax_3_128_160.npz")
    model = pnet.load_pretrained((3, 128, 160), device="cpu")
    path = str(tmp_path / "out.npz")
    pil.save_variables_npz(path, model)
    with np.load(src) as a, np.load(path) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


# ---- the camera ---------------------------------------------------------------

def test_randomize_camera_matches_jax():
    cfg = bench_config((32, 40))
    jp = jenv.make_env_params(cfg, dtype=jnp.float64)
    pp = penv.make_env_params(cfg, dtype=torch.float64, device="cpu")
    for seed in range(4):
        key = jax.random.key(seed)
        kp, kf = jax.random.split(key)
        pitch = int(jax.random.randint(kp, (), 10, 20))
        fov = int(jax.random.randint(kf, (), 90, 130))
        want = jil.randomize_camera(jp, key).camera
        got = pil.camera_matrices(pp, pitch, fov)
        np.testing.assert_allclose(got.E.numpy(), np.asarray(want.E),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(got.K.numpy(), np.asarray(want.K),
                                   rtol=0, atol=1e-12)
    g = torch.Generator().manual_seed(0)
    draws = np.array([pil.camera_draw(g) for _ in range(400)])
    assert draws[:, 0].min() == 10 and draws[:, 0].max() == 19
    assert draws[:, 1].min() == 90 and draws[:, 1].max() == 129
    p1 = pil.randomize_camera(pp, g)
    assert p1.camera.E.dtype == torch.float64 and p1.cfg is pp.cfg


# ---- collection -----------------------------------------------------------------

def _jax_steps(jp, jcfg, key, n, steps, maneuver, model=None,
               variables=None):
    """The JAX collection chunk (il.py:245-322, DAgger :347-404) stepped op
    by op in the test, from the same key: its outputs, and what the JAX
    chunk does not return -- the positions and resets after each step,
    the states before each step (for the frame rule), and every draw the
    port needs (camera, reset rows, OU normals, respawn rows)."""
    k_cam, k_reset, k_scan = jax.random.split(key, 3)
    kp, kf = jax.random.split(k_cam)
    draws = {"pitch": int(jax.random.randint(kp, (), 10, 20)),
             "fov": int(jax.random.randint(kf, (), 90, 130))}
    jp = jil.randomize_camera(jp, k_cam)
    stack = WrapperStack(termination_fns=(partial(
        cte_termination, max_cte=jcfg.collect_max_cte, number_of_steps=1),))
    vstate, _ = jvec.reset(jp, k_reset, n, stack=stack, render=False)
    count = jp.map_data.spawns.count
    draws["reset"] = np.asarray([
        jax.random.randint(jax.random.split(k)[1], (), 0, count)
        for k in jax.random.split(k_reset, n)]).astype(np.int64)
    step = jax.jit(partial(jvec.step, jp, stack=stack, render=False))
    render = jax.jit(partial(jenv.render_observation_batch, jp))
    info = jax.jit(jax.vmap(partial(jenv._info, jp)))(vstate.env)
    dtype = jp.camera.E.dtype
    noise = jnp.zeros((n, jcfg.action_dim), dtype)
    m = jnp.broadcast_to(jnp.asarray(maneuver, jnp.int32), (n,))
    act_m = jnp.where(m != 2, m, 3)
    if model is not None:
        apply = jax.jit(lambda obs: model.apply(
            variables, jnet.pre_obs(obs),
            jax.nn.one_hot(m, jcfg.maneuver_dim, dtype=jnp.float32),
            train=False))
    keys = jax.random.split(k_scan, steps)
    rec = {k: [] for k in ("ou", "respawn", "obs", "steering", "position",
                           "done", "states")}
    max_steer = jp.cfg.car.max_steering_angle
    for i in range(steps):
        sample = (i + 1) % jcfg.skip_steps == 0
        steering = j_stanley(info["cte"], info["heading_error"], jcfg.speed,
                             jcfg.k, max_steer)
        rec["states"].append(vstate.env)
        if model is None:
            eps = jax.random.normal(keys[i], noise.shape, dtype)
            rec["ou"].append(np.asarray(eps))
            noise = (noise + jcfg.noise_theta * (0.0 - noise)
                     + jcfg.noise_sigma * eps)
            obs = (render(vstate.env) if sample else None)
            steer = (steering + noise[:, 0]).astype(dtype)
        else:
            obs = render(vstate.env)
            steer = jnp.clip(apply(obs)[:, 0], -1.0, 1.0).astype(dtype)
        rec["obs"].append(None if obs is None else np.asarray(obs))
        rec["respawn"].append(_respawn_rows(vstate.env.key, count))
        vstate, _, _, term, trunc, info = step(vstate, {
            "car_control": jnp.stack([jnp.full((n,), jcfg.speed, dtype),
                                      steer], axis=-1),
            "maneuver": act_m})
        rec["steering"].append(np.asarray(steering))
        rec["position"].append(np.asarray(vstate.env.car.position))
        rec["done"].append(np.asarray(term | trunc))
    for k in ("respawn",) + (("ou",) if model is None else ()):
        draws[k] = torch.from_numpy(np.stack(rec[k]))
    draws["reset"] = torch.from_numpy(draws["reset"])
    return jp, draws, rec


def _check_collection(jp, jtraj, rec, ptraj, steps, skip):
    """The JAX chunk against the op-by-op copy, then the port against
    both."""
    keep = np.asarray(jtraj["keep"]).astype(bool)
    assert keep.tolist() == [(i + 1) % skip == 0 for i in range(steps)]
    np.testing.assert_array_equal(ptraj["keep"].numpy(), keep)
    np.testing.assert_allclose(np.stack(rec["steering"]),
                               np.asarray(jtraj["steering"]), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(ptraj["steering"].numpy(),
                               np.asarray(jtraj["steering"]), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(ptraj["position"].numpy(),
                               np.stack(rec["position"]), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ptraj["done"].numpy(),
                                  np.stack(rec["done"]))
    jproject = jax.jit(partial(jenv._project_packed_batch, jp))
    t = jp.cfg.camera.line_thickness
    pobs, jobs = ptraj["obs"].numpy(), np.asarray(jtraj["obs"])
    assert pobs.shape == jobs.shape and pobs.dtype == np.uint8
    rendered = [i for i in range(steps) if rec["obs"][i] is not None]
    for i in range(steps):
        if i not in rendered:
            assert not jobs[i].any() and not pobs[i].any()
            continue
        np.testing.assert_array_equal(rec["obs"][i], jobs[i])
        if t > 1:
            _assert_obs(pobs[i], jobs[i], jp, jproject, rec["states"][i])
    if t == 1:  # over the chunk's frames, as tests/test_torch_rollout.py
        assert (pobs[rendered] != jobs[rendered]).mean() < 5e-4
    assert pobs[keep].any()


@pytest.mark.parametrize("thickness", [1, 2])
def test_collect_chunk_matches_jax_float64(thickness):
    """The expert chunk at the IL tests' config (32x40 classes), 4 envs x
    24 steps, a CTE cut of 0.005 m so that auto-resets fire."""
    cfg = dict(CONFIG)
    cfg["camera"] = dict(CONFIG["camera"], resolution=[32, 40],
                         line_thickness=thickness)
    jp = jenv.make_env_params(cfg, dtype=jnp.float64)
    pp = penv.make_env_params(cfg, dtype=torch.float64, device="cpu")
    jcfg = jil.ILConfig(collect_max_cte=0.005)
    n, steps, key = 4, 24, jax.random.key(11 + thickness)
    jtraj = jax.jit(partial(jil.collect_chunk, jp, jcfg, n_envs=n,
                            chunk_steps=steps))(
        key, maneuver=jnp.full((n,), 2, jnp.int32))
    jp2, draws, rec = _jax_steps(jp, jcfg, key, n, steps, 2)
    ptraj = pil.collect_chunk(pp, _pcfg(jcfg), None, n, steps, 2,
                              draws=draws, trace=True)
    _check_collection(jp2, jtraj, rec, ptraj, steps, jcfg.skip_steps)
    assert ptraj["done"].any()  # the CTE cut respawned a car


def test_collect_chunk_dagger_matches_jax_float64():
    """The DAgger chunk at 48x160 under the exact stroke (frames equal in
    float64, so the nets see the same pixels), 4 envs x 10 steps, the
    combo in float64 from the same flax weights."""
    cfg = bench_config((48, 160))
    cfg["camera"] = dict(cfg["camera"], stroke="exact")
    jp = jenv.make_env_params(cfg, dtype=jnp.float64)
    pp = penv.make_env_params(cfg, dtype=torch.float64, device="cpu")
    jcfg = jil.ILConfig(collect_max_cte=0.03)
    state = jil.create(jax.random.key(9), (5, 48, 160), jcfg)
    variables = _to64(state.variables)
    model = jnet.TinycarCombo(dtype=jnp.float64)
    pmodel = pil.state_from_state_dict(
        convert.combo_state_dict_from_flax(jax.device_get(variables),
                                           torch.float64), _pcfg(jcfg),
        device="cpu").model
    n, steps, key = 4, 10, jax.random.key(21)
    jtraj = jax.jit(partial(jil.collect_chunk_dagger, jp, jcfg, n_envs=n,
                            chunk_steps=steps, model=model))(
        key, maneuver=jnp.asarray([0, 1, 2, 1], jnp.int32),
        variables=variables)
    jp2, draws, rec = _jax_steps(jp, jcfg, key, n, steps, [0, 1, 2, 1],
                                 model, variables)
    ptraj = pil.collect_chunk_dagger(
        pp, _pcfg(jcfg), None, n, steps, torch.tensor([0, 1, 2, 1]),
        pmodel, draws=draws, trace=True)
    _check_collection(jp2, jtraj, rec, ptraj, steps, jcfg.skip_steps)
    assert np.asarray(jtraj["obs"]).any(axis=(1, 2, 3, 4)).all()


@pytest.fixture(scope="module")
def params32():
    cfg = dict(CONFIG)
    cfg["camera"] = dict(CONFIG["camera"], resolution=[32, 40])
    return penv.make_env_params(cfg, device="cpu")


def test_collect_dataset(params32):
    """tests/test_il_collect.py's asserts on the port."""
    stats = {}
    X, M, Y = pil.collect_dataset(params32, pil.ILConfig(), 0, n_samples=120,
                                  n_envs=4, chunk_steps=32, stats=stats)
    assert X.shape == (120, *penv.observation_shape(params32))
    assert X.dtype == np.uint8 and (X > 0).any()
    assert M.dtype == np.float32 and set(np.unique(M)) <= {0.0, 1.0, 2.0}
    assert Y.dtype == np.float32 and Y.shape == (120, 1)
    assert np.isfinite(Y).all() and Y.std() > 0
    # 64 samples a chunk, 2 chunks: one render per kept frame, no graph
    assert stats == {"renders": 32, "captures": 0, "replays": 0}


def test_collect_dataset_dagger(params32):
    cfg = pil.ILConfig()
    state = pil.create(penv.observation_shape(params32), cfg, seed=9,
                       device="cpu")
    X, M, Y = pil.collect_dataset_dagger(
        params32, cfg, torch.Generator().manual_seed(0), n_samples=60,
        model=state.model, n_envs=4, chunk_steps=16)
    assert X.shape == (60, *penv.observation_shape(params32))
    assert X.dtype == np.uint8 and (X > 0).any()
    assert set(np.unique(M)) <= {0.0, 1.0, 2.0} and M.dtype == np.float32
    assert np.isfinite(Y).all() and Y.std() > 0 and Y.dtype == np.float32


# ---- logging ----------------------------------------------------------------

def test_logging_csvs_equal_jax(tmp_path):
    """The port's writers give the JAX package's CSVs byte for byte, the
    weight changes of a combo's snapshots keyed by its flax paths."""
    rng = np.random.default_rng(8)
    c1, c2, a = (list(rng.standard_normal(7)) for _ in range(3))
    rews = list(rng.uniform(0, 10, 5))
    jcfg = jil.ILConfig(learning_rate=1e-3)
    jstate = _jax_state(jcfg, jnp.float32)
    jhist, phist = {}, {}
    jstep = jax.jit(partial(jil.train_step, cfg=jcfg))
    for step in range(3):
        jlog.snapshot_params(jstate.variables["params"], step * 200, jhist)
        pstate = convert.il_state_from_flax(jax.device_get(jstate),
                                            _pcfg(jcfg), device="cpu")
        plog.snapshot_params(pstate.model, step * 200, phist)
        jstate, _ = jstep(jstate, batch=_batch(rng, 4, jnp.float32)[0])
    assert set(phist[0]) == set(jhist[0])
    jch, pch = jlog.weight_changes(jhist), plog.weight_changes(phist)
    for d, mod, ch in ((tmp_path / "jax", jlog, jch),
                       (tmp_path / "port", plog, pch)):
        mod.save_losses(str(d), c1, c2, a, suffix="il")
        mod.save_rewards(str(d), rews)
        mod.save_series(str(d), "cte", c1)
        mod.save_weight_changes(str(d), "combo", ch, step_interval=200)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 5
    for name in names:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name,
                           shallow=False), name
    assert plog.ma([1.0, 2.0, 3.0, 4.0], 2) == jlog.ma([1.0, 2.0, 3.0, 4.0],
                                                        2)
    assert plog.avg_w([1.0] * 3, 5) == float("inf")
    # a TD3 net is keyed by its flax paths too
    from tinycarlo_torch.train import td3 as ptd3

    actor = ptd3.make_nets(ptd3.TD3Config(seq_len=3))[0]
    hist = {}
    plog.snapshot_params(actor, 0, hist)
    assert "_TemporalConv_0/Conv_0/kernel" in hist[0]


# ---- the example ------------------------------------------------------------------

def test_example_main_and_its_repairs(tmp_path, monkeypatch):
    """The port's examples/train_stanley_il.py at a tiny size on the CPU
    (64x160 classes, 4 envs): it collects, trains, saves and evaluates.
    Its two repairs of the JAX example: `--steps 100`, which trained zero
    steps there, trains one whole chunk of 500; a cache collected with
    other flags, which was reused there, is refused."""
    from tinycarlo_torch.examples import train_stanley_il as ex

    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump(bench_config((64, 160))))
    argv = ["--config", str(config), "--device", "cpu", "--samples", "32",
            "--envs", "4", "--chunk-steps", "16", "--steps", "100",
            "--batch", "4", "--eval-steps", "4", "--eval-episodes", "2",
            "--balance"]
    monkeypatch.setenv("IL_DATA", str(tmp_path / "data.npz"))
    monkeypatch.setenv("IL_MODEL", str(tmp_path / "model.npz"))
    monkeypatch.delenv("IL_LOSS_CSV", raising=False)
    r = ex.main(argv)
    assert r["samples"] == 32 and r["collect_samples_per_s"] > 0
    assert sum(r["split"]) == 32
    assert len(r["losses"]) == ex.CHUNK and np.isfinite(r["losses"]).all()
    assert set(r["eval"]) == {0, 1, 2}
    assert np.isfinite(r["eval"][0]["cte_avg"])
    assert os.path.exists(r["model"])
    assert jil.load_variables_npz(r["model"])["params"]["encoder"]
    stale = list(argv)
    stale[stale.index("--samples") + 1] = "64"
    with pytest.raises(ValueError, match="collected with"):
        ex.main(stale)
    again = ex.main(argv[:argv.index("--steps")] + ["--steps", "0"]
                    + argv[argv.index("--steps") + 2:])
    assert again["collect_samples_per_s"] is None  # the cache was read
    assert again["samples"] == 32 and again["losses"] == []
