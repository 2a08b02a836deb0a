"""The port's fused TD3 step (tinycarlo_torch.train.td3_loop) against the
benchmark's plain reference, portbench/reference/td3_ref.py, on the CPU.

The TD3 cell's configuration cut to a small size: 8 envs, a 32x40 rgb
camera, a 128-slot replay (the warm chunk of 16 steps wraps it, so the
followed steps evict), batch 16, 4 updates a step (actor at 2 and 4),
seeded random weights (flax's initialisers) for the encoder and the nets.
The reference follows two fused steps, each from the port's state before
it, with the port's generators' states.

Tolerances: on the CPU both sides run the same torch kernels on the same
inputs in the same order (the reference's functional conv / linear /
batch-norm calls are what the port's modules call; Adam in optax's
order on both sides), so the env step, the frames, the replay's slots,
the stored maneuvers, the draws and the counts are equal exactly, and
the floating results are held to 1e-6 relative (actions, rewards,
features) and 1e-5 relative (losses; parameters, targets and Adam
moments as the norm of the gap over the norm of the step's change),
room for a reduction the two sides might order differently.
"""
import pytest
import torch

from portbench import run as harness
from portbench.drivers import td3 as driver
from portbench.reference import td3_check, td3_ref
from tests.test_torch_common import torch_threads
from tinycarlo_torch.models.tinycar_net import (TinycarActorTemporal,
                                                TinycarCriticTemporal,
                                                TinycarEncoder,
                                                encoder_flat_features,
                                                flax_init_)
from tinycarlo_torch.train import td3 as ptd3

CELL = "simple_layout.td3-rgb-1024"
SEED = 2_147_483_659
ENVS, WARM_STEPS, REPLAY, BATCH = 8, 16, 128, 16


@pytest.fixture(autouse=True)
def one_thread():
    """The eager steps of a few envs run faster on one thread, the more
    so when several test workers share the cores."""
    with torch_threads(1):
        yield


def tiny_run(seed=SEED):
    _, _, run, _ = harness.prepare(CELL, seed, 0.0, torch.device("cpu"))
    run.traffic = dict(run.traffic, envs=ENVS, steps_per_chunk=WARM_STEPS)
    run.config["config"]["camera"]["resolution"] = [32, 40]
    run.config["learner"] = dict(run.config["learner"], replay_size=REPLAY,
                                 batch_size=BATCH)
    return run


@pytest.fixture(scope="module")
def followed():
    """A tiny cell's two followed steps (its records) and the run."""
    run = tiny_run()
    with torch_threads(1):
        c = driver.Cell(run)
        c._follow()
    return run, c.records


def _config(run):
    return {"config": run.env_config("rgb"),
            "learner": run.config["learner"]}


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def _group_gap(prog, ref, prev, group):
    p, r, o = (td3_check._group_tensors(s, group) for s in (prog, ref, prev))
    num = td3_check._norm([x - y for x, y in zip(p, r)])
    return td3_check._ratio(num, td3_check._norm(
        [y - z for y, z in zip(r, o)]))


def test_reference_follows_two_fused_steps(followed):
    run, rec = followed
    config = _config(run)
    mp = config["config"]["map"]
    m = td3_ref.sim.load_map(mp["json_path"], mp["pixel_per_meter"],
                             mp["spawn_points"])
    assert int(rec["snaps"][0]["filled"]) == REPLAY  # evicting
    for i in range(2):
        prev, prog = rec["snaps"][i], rec["snaps"][i + 1]
        out = td3_check.program_outputs(rec, i)
        ref_state, ref = td3_ref.step(prev, rec["encoder"], config, m)
        # every update ran: four, critics always, the actor at 2 and 4
        ul = out["update_losses"]
        assert ul.shape == (4, 3) and bool((ul[:, :2] != 0).all())
        assert not ul[0::2, 2].any() and bool((ul[1::2, 2] != 0).all())
        assert _rel(ul, ref["update_losses"]) <= 1e-5
        assert torch.equal(out["done"], ref["done"])
        assert _rel(out["reward"], ref["reward"]) <= 1e-6
        assert _rel(prog["queue"][:, 0], ref["features"]) <= 1e-6
        assert torch.equal(out["frames"], ref["frames"])
        slots = ref["slots"]
        assert _rel(prog["replay"]["a"][slots], ref["rows"]["a"]) <= 1e-6
        assert torch.equal(prog["replay"]["m"][slots], ref["rows"]["m"])
        assert torch.equal(prog["maneuver"], ref_state["maneuver"])
        for k in td3_ref.CAR:
            assert torch.equal(prog["car"][k], ref_state["car"][k]), k
        assert torch.equal(prog["gen_loop"], ref_state["gen_loop"])
        assert torch.equal(prog["gen_env"], ref_state["gen_env"])
        for group in ("nets", "targets", "mu", "nu"):
            assert _group_gap(prog, ref_state, prev, group) <= 1e-5, group
    checks = td3_check.check(run, rec)
    assert harness.judge(checks), checks


def test_bfloat16_control_fails(followed):
    run, rec = followed
    checks = td3_check.check(run, rec, stand_in="bfloat16")
    assert not harness.judge(checks), checks


def test_a_dropped_update_fails(monkeypatch):
    """The port's step with its third update left out (its losses 0, its
    state untouched) fails the comparison."""
    run = tiny_run(SEED + 1)
    c = driver.Cell(run)
    calls = []
    step = ptd3.train_step

    def dropped(state, cfg, batch, do_actor=None):
        calls.append(1)
        if len(calls) % 4 == 3:
            zero = torch.zeros(())
            return state, {"critic1_loss": zero, "critic2_loss": zero,
                           "actor_loss": zero}
        return step(state, cfg, batch, do_actor)

    monkeypatch.setattr(ptd3, "train_step", dropped)
    c._follow()
    monkeypatch.undo()
    checks = c.check()
    got = dict((n, v) for n, v, _ in checks)
    assert got["loss_rel_gap"] > 0 and got["param_rel_gap"] > 0
    assert not harness.judge(checks), checks


def test_reference_nets_are_the_ports_modules():
    """The reference's functional encoder, actor and critic give the
    port's modules' outputs bit for bit on the same state dict."""
    gen = torch.Generator().manual_seed(3)
    enc = flax_init_(TinycarEncoder(3, flat_features=encoder_flat_features(
        32, 40)), gen).eval()
    with torch.no_grad():
        for bn in (b.bn1 for b in enc.convs):
            bn.running_mean.uniform_(-0.1, 0.1, generator=gen)
            bn.running_var.uniform_(0.5, 2.0, generator=gen)
    actor = flax_init_(TinycarActorTemporal(seq_len=10), gen)
    critic = flax_init_(TinycarCriticTemporal(seq_len=10), gen)
    frames = torch.randint(0, 256, (4, 32, 40, 3), generator=gen,
                           dtype=torch.uint8)
    f = torch.randn((4, 10, 256), generator=gen)
    m = torch.eye(3)[torch.tensor([0, 1, 2, 1])]
    a = torch.rand((4, 1), generator=gen) * 2 - 1
    with torch.no_grad():
        want_enc = enc((frames.float() / 255.0).permute(0, 3, 1, 2)
                       .contiguous())
        got_enc = td3_ref.encoder(enc.state_dict(), frames, 5)
        assert torch.equal(got_enc, want_enc)
        assert torch.equal(td3_ref.actor(dict(actor.named_parameters()),
                                         f, m), actor(f, m))
        assert torch.equal(td3_ref.critic(dict(critic.named_parameters()),
                                          f, m, a), critic(f, m, a))
