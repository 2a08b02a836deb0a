"""The port's TD3 nets and learner (tinycarlo_torch.models.tinycar_net,
train/td3.py, convert.td3_state_from_flax) against the JAX package's.

Tolerances:
- forward passes of the four new nets on converted weights, and the
  losses and gradients of one critic and one actor update on
  tests/test_train.py's `td3_setup` batch, in float32: rtol 1e-5, atol
  1e-6 (XLA's and torch's float32 sums run in different orders);
- two train_steps in float64 (the JAX nets built with dtype float64, as
  flax's defaults compute in float32): losses and every parameter after
  them, rtol 1e-10. Adam's first steps amplify rounding (u ~ -lr sign(g)),
  so float32 parameters after updates are not compared element by
  element;
- Adam against optax.adam on the same numpy gradients, float64: rtol
  1e-13 (float64 rounding; b^t's pow may differ in the last bit);
- the state conversion round trip, the skip, the soft update: exact.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tinycarlo_torch import convert
from tinycarlo_torch.models import tinycar_net as pnet
from tinycarlo_torch.train import td3 as ptd3
from tinycarlo_tpu.models import tinycar_net as jnet
from tinycarlo_tpu.train import td3 as jtd3

RTOL32, ATOL32 = 1e-5, 1e-6
RTOL64 = 1e-10


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _nets64(cfg):
    """td3._nets with float64 computation (flax's modules default to
    float32 compute)."""
    if cfg.temporal:
        return (jnet.TinycarActorTemporal(
                    maneuver_dim=cfg.maneuver_dim, action_dim=cfg.action_dim,
                    seq_len=cfg.seq_len, dtype=jnp.float64),
                jnet.TinycarCriticTemporal(
                    maneuver_dim=cfg.maneuver_dim, action_dim=cfg.action_dim,
                    seq_len=cfg.seq_len, dtype=jnp.float64))
    return (jnet.TinycarActor(maneuver_dim=cfg.maneuver_dim,
                              action_dim=cfg.action_dim, dtype=jnp.float64),
            jnet.TinycarCritic(maneuver_dim=cfg.maneuver_dim,
                               action_dim=cfg.action_dim, dtype=jnp.float64))


def _to64(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _pcfg(cfg):
    return ptd3.TD3Config(batch_size=cfg.batch_size, seq_len=cfg.seq_len,
                          temporal=cfg.temporal)


@pytest.fixture(scope="module")
def td3_setup():
    """tests/test_train.py's td3_setup: TD3Config(seq_len=4, batch_size=16),
    td3.create(key 0) and a numpy-seeded batch; with the port's state
    converted from it and the batch as tensors."""
    cfg = jtd3.TD3Config(seq_len=4, batch_size=16)
    state = jtd3.create(jax.random.key(0), cfg)
    rng = np.random.default_rng(0)
    batch = {
        "x": jnp.asarray(rng.standard_normal((16, 4, 256)), jnp.float32),
        "m": jax.nn.one_hot(jnp.asarray(rng.integers(0, 3, 16)), 3),
        "a": jnp.asarray(rng.standard_normal((16, 1)), jnp.float32),
        "r": jnp.asarray(rng.standard_normal((16, 1)), jnp.float32),
        "x1": jnp.asarray(rng.standard_normal((16, 4, 256)), jnp.float32),
    }
    batch["m1"] = batch["m"]
    pstate = convert.td3_state_from_flax(jax.device_get(state), _pcfg(cfg),
                                         device="cpu")
    pbatch = {k: _t(v, torch.float32) for k, v in batch.items()}
    return cfg, state, batch, pstate, pbatch


def _assert_grads(pnet_, pgrads, jgrads, temporal, rtol, atol):
    paths = convert.td3_param_paths(pnet_, temporal)
    names = [n for n, _ in pnet_.named_parameters()]
    assert len(names) == len(pgrads)
    for name, g in zip(names, pgrads):
        path, kind = paths[name]
        want = jgrads
        for p in path:
            want = want[p]
        np.testing.assert_allclose(
            g.detach().numpy(), convert.to_port_layout(want, kind),
            rtol=rtol, atol=atol, err_msg=name)


# ---- the nets -------------------------------------------------------------

NETS = ["temporal_conv", "actor_temporal", "critic", "critic_temporal"]


@pytest.mark.parametrize("which", NETS)
def test_new_nets_forward_match_flax(which):
    seq, b = 5, 7
    rng = np.random.default_rng(NETS.index(which))
    f_seq = rng.standard_normal((b, seq, 256)).astype(np.float32)
    f = rng.standard_normal((b, 256)).astype(np.float32)
    m = np.eye(3, dtype=np.float32)[rng.integers(0, 3, b)]
    a = rng.uniform(-1, 1, (b, 1)).astype(np.float32)
    key = jax.random.key(NETS.index(which))
    if which == "temporal_conv":
        jmod = jnet._TemporalConv((32, 16, 16))
        params = jmod.init(key, f_seq)["params"]
        want = jmod.apply({"params": params}, f_seq)
        port = pnet._TemporalConv(seq, (32, 16, 16))
        with torch.no_grad():
            for i, conv in enumerate(port.convs):
                k = params[f"Conv_{i}"]
                conv.weight.copy_(_t(np.transpose(k["kernel"], (2, 1, 0))))
                conv.bias.copy_(_t(k["bias"]))
        got = port(_t(f_seq))
    else:
        temporal = which != "critic"
        x = f_seq if temporal else f
        if which == "actor_temporal":
            jmod = jnet.TinycarActorTemporal(seq_len=seq)
            port = pnet.TinycarActorTemporal(seq_len=seq)
            args = (x, m)
        else:
            jmod = (jnet.TinycarCriticTemporal(seq_len=seq) if temporal
                    else jnet.TinycarCritic())
            port = (pnet.TinycarCriticTemporal(seq_len=seq) if temporal
                    else pnet.TinycarCritic())
            args = (x, m, a)
        params = jmod.init(key, *args)["params"]
        want = jmod.apply({"params": params}, *args)
        convert.load_td3_net_from_flax(port, jax.device_get(params),
                                       temporal)
        got = port(*(_t(v) for v in args))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL32, atol=ATOL32)


def test_flax_init_distribution():
    """flax_init_: lecun-normal kernels truncated at 2 std (|w| <= 2 std,
    std ~ sqrt(1 / fan_in)), zero biases, drawn from the generator."""
    net = pnet.TinycarCriticTemporal(seq_len=10)
    pnet.flax_init_(net, torch.Generator().manual_seed(0))
    w = net.fc1.weight  # fan_in 768
    std = np.sqrt(1.0 / 768)
    assert abs(w.std().item() / std - 1.0) < 0.03
    assert w.abs().max().item() <= 2 * std / pnet._TRUNC_STD + 1e-7
    assert all(not m.bias.any() for m in net.modules()
               if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d)))
    again = pnet.flax_init_(pnet.TinycarCriticTemporal(seq_len=10),
                            torch.Generator().manual_seed(0))
    assert all(torch.equal(p, q) for p, q in zip(net.parameters(),
                                                 again.parameters()))


def _reference_state_dict(rng, in_ch=3, flat=64 * 4 * 5):
    """A reference-format TinycarCombo state dict (examples/models/
    tinycar_net.py key names), random numpy-seeded values."""
    sd = {}
    chans = (in_ch, 24, 36, 48, 64, 64)
    f = lambda *s: torch.tensor(rng.standard_normal(s) * 0.1,  # noqa: E731
                                dtype=torch.float32)
    for i in range(5):
        p = f"encoder.convs.{i}."
        sd[p + "conv1.weight"] = f(chans[i + 1], chans[i], 3, 3)
        sd[p + "conv1.bias"] = f(chans[i + 1])
        sd[p + "bn1.weight"] = 1.0 + f(chans[i + 1])
        sd[p + "bn1.bias"] = f(chans[i + 1])
        sd[p + "bn1.running_mean"] = f(chans[i + 1])
        sd[p + "bn1.running_var"] = 1.0 + f(chans[i + 1]).abs()
        sd[p + "bn1.num_batches_tracked"] = torch.tensor(3)
    sd["encoder.fc1.weight"] = f(256, flat)
    sd["encoder.fc1.bias"] = f(256)
    for j, (o, i) in enumerate(((100, 3), (200, 100), (256, 200))):
        sd[f"actor.fcm{j + 1}.weight"] = f(o, i)
        sd[f"actor.fcm{j + 1}.bias"] = f(o)
    for j, (o, i) in enumerate(((200, 512), (100, 200), (100, 100),
                                (1, 100))):
        sd[f"actor.fc{j + 1}.weight"] = f(o, i)
        sd[f"actor.fc{j + 1}.bias"] = f(o)
    return sd


def test_load_torch_state_dict_matches_jax(tmp_path):
    """A reference-format checkpoint written here with torch.save: the
    port's combo loaded with its load_torch_state_dict and the JAX
    package's combo loaded with its own give the same actions."""
    rng = np.random.default_rng(3)
    path = str(tmp_path / "combo.pt")
    torch.save(_reference_state_dict(rng), path)
    port = pnet.TinycarCombo(in_channels=3).eval()
    port.load_state_dict(pnet.load_torch_state_dict(path))
    jvars = jnet.load_torch_state_dict(path)
    x = rng.uniform(0, 1, (4, 128, 160, 3)).astype(np.float32)
    m = np.eye(3, dtype=np.float32)[[0, 1, 2, 1]]
    want = jnet.TinycarCombo().apply(jvars, x, m)
    with torch.no_grad():
        got = port(_t(x).permute(0, 3, 1, 2), _t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    bad = str(tmp_path / "bad.pt")
    torch.save(_reference_state_dict(rng, flat=64 * 3), bad)
    with pytest.raises(ValueError, match="encoder output"):
        pnet.load_torch_state_dict(bad)


# ---- the learner -----------------------------------------------------------

def test_td3_state_round_trip(td3_setup):
    """JAX TD3State -> port -> the JAX layout again, equal, also after a
    train step has filled the Adam moments and counts."""
    cfg, state, batch, _, _ = td3_setup
    stepped, _ = jax.jit(partial(jtd3.train_step, cfg=cfg))(state,
                                                           batch=batch)
    stepped, _ = jax.jit(partial(jtd3.train_step, cfg=cfg))(stepped,
                                                           batch=batch)
    pcfg = _pcfg(cfg)
    for s in (state, stepped):
        host = jax.device_get(s)
        port = convert.td3_state_from_flax(host, pcfg, device="cpu")
        back = convert.td3_state_to_flax(port, pcfg)
        for name in ("actor", "actor_target", "critic1", "critic2",
                     "critic1_target", "critic2_target"):
            for (kp, a), b in zip(
                    jax.tree_util.tree_flatten_with_path(back[name])[0],
                    jax.tree.leaves(getattr(host, name))):
                np.testing.assert_array_equal(a, b, err_msg=f"{name}{kp}")
        for name in ("opt_actor", "opt_critic1", "opt_critic2"):
            adam = getattr(host, name)[0]
            assert int(back[name]["count"]) == int(adam.count)
            for which in ("mu", "nu"):
                for a, b in zip(jax.tree.leaves(back[name][which]),
                                jax.tree.leaves(getattr(adam, which))):
                    np.testing.assert_array_equal(a, b)
        assert int(back["steps"]) == int(host.steps)
    assert int(port.steps) == 2 and int(port.opt_actor.count) == 1


def test_critic_update_losses_and_grads(td3_setup):
    cfg, state, batch, pstate, pbatch = td3_setup
    ta = jtd3.apply_actor(cfg, state.actor_target, batch["x1"], batch["m1"])
    tq1 = jtd3.apply_critic(cfg, state.critic1_target, batch["x1"],
                            batch["m1"], ta)
    tq2 = jtd3.apply_critic(cfg, state.critic2_target, batch["x1"],
                            batch["m1"], ta)
    target = jnp.minimum(tq1, tq2) * cfg.discount_factor + batch["r"]

    def loss_fn(params):
        q = jtd3.apply_critic(cfg, params, batch["x"], batch["m"],
                              batch["a"])
        return jnp.mean((target - q) ** 2)

    (pl1, pl2), (pg1, pg2) = ptd3.critic_losses_and_grads(
        pstate, _pcfg(cfg), pbatch)
    for pl, pg, params, net in ((pl1, pg1, state.critic1, pstate.critic1),
                                (pl2, pg2, state.critic2, pstate.critic2)):
        jl, jg = jax.value_and_grad(loss_fn)(params)
        np.testing.assert_allclose(pl.item(), float(jl), rtol=RTOL32)
        _assert_grads(net, pg, jax.device_get(jg), True, RTOL32 * 10,
                      ATOL32)
    _, (l1, l2) = jtd3.critic_update(state, cfg, batch)
    np.testing.assert_allclose([pl1.item(), pl2.item()],
                               [float(l1), float(l2)], rtol=RTOL32)


def test_actor_update_loss_and_grads(td3_setup):
    cfg, state, batch, pstate, pbatch = td3_setup

    def loss_fn(params):
        a = jtd3.apply_actor(cfg, params, batch["x"], batch["m"])
        return -jnp.mean(jtd3.apply_critic(cfg, state.critic1, batch["x"],
                                           batch["m"], a))

    jl, jg = jax.value_and_grad(loss_fn)(state.actor)
    pl, pg = ptd3.actor_loss_and_grads(pstate, _pcfg(cfg), pbatch)
    np.testing.assert_allclose(pl.item(), float(jl), rtol=RTOL32)
    _assert_grads(pstate.actor, pg, jax.device_get(jg), True, RTOL32 * 10,
                  ATOL32)


def test_train_steps_match_jax_float64(td3_setup, monkeypatch):
    """Two train_steps in float64: step 1 skips the actor (actor_loss 0,
    targets unchanged), step 2 updates it and soft-moves every target;
    losses and all parameters and moments as the JAX package's."""
    cfg, state, batch, _, _ = td3_setup
    monkeypatch.setattr(jtd3, "_nets", _nets64)
    jstate = _to64(state)
    jbatch = _to64(batch)
    pcfg = _pcfg(cfg)
    pstate = convert.td3_state_from_flax(jax.device_get(jstate), pcfg,
                                         device="cpu")
    assert next(pstate.actor.parameters()).dtype == torch.float64
    pbatch = {k: _t(v) for k, v in jbatch.items()}
    step = jax.jit(partial(jtd3.train_step, cfg=cfg))
    for i in range(2):
        targets = [p.clone() for p in pstate.critic1_target.parameters()]
        jstate, jl = step(jstate, batch=jbatch)
        _, pl = ptd3.train_step(pstate, pcfg, pbatch)
        for k in jl:
            np.testing.assert_allclose(pl[k].item(), float(jl[k]),
                                       rtol=RTOL64, err_msg=k)
        if i == 0:
            assert pl["actor_loss"].item() == 0.0
            assert all(torch.equal(a, b) for a, b in zip(
                targets, pstate.critic1_target.parameters()))
        else:
            assert pl["actor_loss"].item() != 0.0
            tau = pcfg.tau
            for old, online, new in zip(targets,
                                        pstate.critic1.parameters(),
                                        pstate.critic1_target.parameters()):
                assert torch.equal(new, tau * online + (1 - tau) * old)
    back = convert.td3_state_to_flax(pstate, pcfg)
    host = jax.device_get(jstate)
    for name in ("actor", "critic1", "critic2", "actor_target",
                 "critic1_target", "critic2_target"):
        for a, b in zip(jax.tree.leaves(back[name]),
                        jax.tree.leaves(getattr(host, name))):
            np.testing.assert_allclose(a, b, rtol=RTOL64, atol=1e-14)
    for a, b in zip(jax.tree.leaves(back["opt_actor"]["mu"]),
                    jax.tree.leaves(host.opt_actor[0].mu)):
        np.testing.assert_allclose(a, b, rtol=RTOL64, atol=1e-16)
    assert int(pstate.steps) == 2 and int(pstate.opt_critic1.count) == 2


def test_adam_matches_optax_float64():
    """ptd3.adam_update against optax.adam on the same parameters and
    gradients, 4 steps, float64: parameters, moments and count."""
    rng = np.random.default_rng(7)
    shapes = {"w": (5, 3), "b": (3,), "k": (2, 4, 3)}
    params = {k: rng.standard_normal(s) for k, s in shapes.items()}
    tx = optax.adam(2e-4)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(jparams)
    names = list(shapes)
    pparams = [torch.tensor(params[k]) for k in names]
    popt = ptd3.AdamState(
        count=torch.zeros((), dtype=torch.int32),
        mu={k: torch.zeros(shapes[k], dtype=torch.float64) for k in names},
        nu={k: torch.zeros(shapes[k], dtype=torch.float64) for k in names})
    for _ in range(4):
        grads = {k: rng.standard_normal(s) * 10.0 ** rng.integers(-6, 2)
                 for k, s in shapes.items()}
        grads["b"][0] = 0.0
        upd, opt = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                             opt, jparams)
        jparams = optax.apply_updates(jparams, upd)
        ptd3.adam_update(pparams, [torch.tensor(grads[k]) for k in names],
                         popt, names, 2e-4)
        for k, p in zip(names, pparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]),
                                       rtol=1e-13, atol=0)
            np.testing.assert_allclose(popt.mu[k].numpy(),
                                       np.asarray(opt[0].mu[k]), rtol=1e-13)
            np.testing.assert_allclose(popt.nu[k].numpy(),
                                       np.asarray(opt[0].nu[k]), rtol=1e-13)
        assert int(popt.count) == int(opt[0].count)


def test_select_action_clip_and_shift(td3_setup):
    cfg, state, batch, pstate, pbatch = td3_setup
    pcfg = _pcfg(cfg)
    a = ptd3.select_action(pstate, pcfg, pbatch["x"], pbatch["m"],
                           torch.full((16, 1), 10.0), steering_shift=-0.01)
    assert bool((a == 1.0).all())
    a2 = ptd3.select_action(pstate, pcfg, pbatch["x"], pbatch["m"],
                            torch.zeros(16, 1), steering_shift=-0.01)
    want = jtd3.select_action(state, cfg, batch["x"], batch["m"],
                              jnp.zeros((16, 1)), -0.01)
    np.testing.assert_allclose(a2.numpy(), np.asarray(want), rtol=RTOL32,
                               atol=ATOL32)


def test_create_is_seeded_and_device_independent():
    """td3.create draws on the CPU from its seed: the same seed gives the
    same learner, targets equal to the online nets, zero moments."""
    cfg = ptd3.TD3Config(seq_len=3)
    a = ptd3.create(cfg, seed=4, device="cpu")
    b = ptd3.create(cfg, seed=4, device="cpu")
    for x, y in zip(a.actor.parameters(), b.actor.parameters()):
        assert torch.equal(x, y)
    for x, y in zip(a.critic1.parameters(), a.critic1_target.parameters()):
        assert torch.equal(x, y) and not y.requires_grad
    assert not any(torch.equal(x, y) for x, y in zip(
        a.critic1.parameters(), a.critic2.parameters()) if x.ndim > 1)
    assert int(a.opt_actor.count) == 0 and int(a.steps) == 0
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            ptd3.create(cfg)
