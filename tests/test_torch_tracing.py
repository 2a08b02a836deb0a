"""The port's tracer (tinycarlo_torch.utils.profiling `tracing`, `span`,
`device_span`, the counters) on the CPU: off it is a shared no-op that
records, launches and counts nothing through a whole rollout and gym
steps; on it nests spans under their parents and call ids on the clock
torch.profiler stamps its events in, leaves the rollout's and the gym
shim's outputs bit for bit as they were, counts the compaction's live and
dropped copies as its own `counts` say, and survives a ring too small for
the marks. On the CPU a device span's marks read the host clock (the work
runs synchronously); the mark kernel itself runs on the card only."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from tests.test_torch_common import bench_config, torch_threads
from tinycarlo_torch import env as fenv
from tinycarlo_torch import vector
from tinycarlo_torch.gym_env import TinyCarloEnv
from tinycarlo_torch.ops import rasterize_kernels as rk
from tinycarlo_torch.utils import profiling

RES = (32, 40)
N_ENVS, STEPS, GYM_STEPS = 8, 20, 50


def _params(**camera):
    cfg = bench_config(RES)
    cfg["camera"] = dict(cfg["camera"], **camera)
    return fenv.make_env_params(cfg, device="cpu")


def _policy(obs, env_state, generator):
    b = env_state.car.position.shape[0]
    steer = torch.rand(b, generator=generator) * 2.0 - 1.0
    return {"car_control": torch.stack([torch.full((b,), 0.5), steer], -1),
            "maneuver": torch.zeros(b, dtype=torch.int32)}


def _rollout(params):
    state, _ = vector.reset(params, N_ENVS, seed=3, render=False)
    return vector.rollout(params, state, _policy, STEPS, keep_obs=True,
                          max_episode_steps=15)


def _gym_steps(n=GYM_STEPS):
    env = TinyCarloEnv(config=bench_config(RES), device="cpu")
    env.reset(seed=11)
    rng = np.random.default_rng(11)
    out = []
    for _ in range(n):
        obs, reward, term, trunc, info = env.step(
            {"car_control": rng.uniform(-1, 1, 2),
             "maneuver": int(rng.integers(0, 4))})
        out.append((obs, reward, term, trunc, info["cte"], info["position"]))
        if term or trunc:
            env.reset()
    return out


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_off_is_a_shared_noop():
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b", call=True)
    assert profiling.span("a") is profiling.device_span("c", "cpu")
    with profiling.span("a"), profiling.device_span("c"):
        profiling.count("n", 3)
        profiling.device_count("m", torch.ones(4))
    with profiling.held_counts() as held:
        profiling.count("n", 3)
    assert held == {}


def test_off_records_and_enqueues_nothing(monkeypatch):
    """Through a whole rollout and gym steps, tracing off: no mark, no
    launch, no device counter, no profiler range, no span."""
    def called(*args, **kwargs):
        raise AssertionError("tracing work with tracing off")

    for name in ("_mark", "_device_count", "_count"):
        monkeypatch.setattr(profiling.Tracer, name, called)
    monkeypatch.setattr(profiling, "_launcher", called)
    monkeypatch.setattr(profiling, "_profiler_range", called)
    monkeypatch.setattr(profiling._HostSpan, "__init__", called)
    monkeypatch.setattr(profiling._DeviceSpan, "__init__", called)
    _rollout(_params())
    _gym_steps(5)


def test_spans_nest_with_parents_and_call_ids():
    with profiling.tracing() as tr:
        with profiling.span("call", call=True):
            with profiling.span("a"):
                with profiling.span("b"):
                    pass
            with profiling.device_span("d", "cpu"):
                with profiling.device_span("e", "cpu"):
                    pass
        with profiling.span("call", call=True):
            with profiling.span("a"):
                pass
        with profiling.span("loose"):
            pass
    names = [(s.name, s.parent, s.call_id) for s in tr.spans]
    assert names == [("call", -1, 1), ("a", 0, 1), ("b", 1, 1),
                     ("call", -1, 2), ("a", 3, 2), ("loose", -1, 0)]
    for s in tr.spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = tr.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    dev = [(s.name, s.parent, s.replayed) for s in tr.device_spans()]
    assert dev == [("d", -1, False), ("e", 0, False)]
    assert tr.counters["trace.marks_lost"] == 0
    assert not profiling.enabled()


def test_nested_sessions_raise():
    with profiling.tracing():
        with pytest.raises(RuntimeError):
            with profiling.tracing():
                pass


def test_span_brackets_the_profilers_event():
    """Spans and torch.profiler share a clock: the kineto start of a
    range opened inside a span, and of the span's own range, lie inside
    it."""
    with profiling.tracing() as tr, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("outer"):
            with record_function("inner"):
                torch.ones(8).sum()
    outer = tr.spans[0]
    starts = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()}
    for name in ("inner", "outer"):
        assert outer.start_ns <= starts[name] <= outer.end_ns, name


def test_rollout_equal_with_tracing_on_and_off():
    params = _params()
    off = _rollout(params)
    with profiling.tracing() as tr:
        on = _rollout(params)
    _assert_same(off[1], on[1])
    _assert_same([t for t in vector.graphs.tensors(off[0])],
                 [t for t in vector.graphs.tensors(on[0])])
    assert [s.name for s in tr.spans] == ["rollout"]
    dev = tr.device_spans()
    by = {}
    for s in dev:
        by[s.name] = by.get(s.name, 0) + 1
    assert by == {"rollout.step": STEPS, "render": STEPS,
                  "render.compact": STEPS, "vector.step": STEPS}
    steps = [i for i, s in enumerate(dev) if s.name == "rollout.step"]
    assert all(dev[i].parent in steps for i, s in enumerate(dev)
               if s.name in ("render", "vector.step"))
    e = params.map_data.packed_edges.shape[1]
    assert tr.counters["render.copies"] == STEPS * N_ENVS * e
    assert 0 < tr.counters["render.live_copies"] \
        <= tr.counters["render.copies"]


def test_gym_steps_equal_with_tracing_on_and_off():
    off = _gym_steps()
    with profiling.tracing() as tr:
        on = _gym_steps()
    _assert_same(off, on)
    steps = [s for s in tr.spans if s.name == "gym.step"]
    assert len(steps) == GYM_STEPS
    assert [s.call_id for s in steps] == list(range(1, GYM_STEPS + 1))
    for s in tr.spans:  # reset() unpacks outside any step
        if s.name in ("gym.stage_in", "gym.unpack") and s.call_id:
            assert tr.spans[s.parent].name == "gym.step"
    stage = [s for s in tr.spans if s.name == "gym.stage_in"]
    assert [s.call_id for s in stage] == [s.call_id for s in steps]


def test_live_and_dropped_counters_equal_route_slots():
    """A slot budget small enough to drop copies: the counters are the
    batch sums of rows 0 and 3 of the compaction's counts."""
    params = _params(max_visible_segments=3)
    state, _ = vector.reset(params, N_ENVS, seed=5, render=False)
    u0, v0, u1, v1, draw = fenv._project_packed_batch_soa(params, state.env)
    cam = params.cfg.camera
    md = params.map_data
    _, bundle = rk._packed_bundle(
        rk.compact_env_idx_soa, u0, v0, u1, v1, draw, md.packed_edge_layer,
        md.n_layers, tuple(cam.resolution), cam.line_thickness,
        cam.max_visible_segments, md.packed_layer_bounds)
    counts = bundle[-1]
    with profiling.tracing() as tr:
        fenv.render_observation_batch(params, state.env)
    assert tr.counters["render.live_copies"] == int(counts[0].sum())
    assert tr.counters["render.dropped_copies"] == int(counts[3].sum()) > 0
    overflow = fenv.check_segment_overflow(params, state.env)
    assert tr.counters["render.dropped_copies"] == int(overflow.sum())


def test_held_counts_count_at_each_replay():
    with profiling.tracing() as tr:
        with profiling.held_counts() as held:
            profiling.count("n", 5)
        assert held == {"n": 5} and "n" not in tr.counters
        for _ in range(3):
            profiling.add_counts(held)
    assert tr.counters["n"] == 15


def test_td3_chunk_counts_updates_and_rows():
    """A traced chunk of 4-update steps (policy_delay 2): U x steps
    updates, U / 2 x steps of them actor updates, B x steps replay rows."""
    from tinycarlo_torch.train import td3
    from tinycarlo_torch.train import td3_loop

    params = _params()
    cfg = td3.TD3Config(seq_len=3, batch_size=N_ENVS)
    loop_cfg = td3_loop.LoopConfig(replay_size=64, max_episode_steps=50,
                                   updates_per_step=4)
    state = td3_loop.init_loop(params, cfg, loop_cfg, N_ENVS, seed=2)

    def encoder(obs):
        return obs.float().reshape(obs.shape[0], -1)[:, :256]

    steps = 3
    with torch_threads(1), profiling.tracing() as tr:
        _, out = td3_loop.chunk(state, params, cfg, loop_cfg, encoder, steps)
    assert bool((out["update_losses"][:, :, 0] != 0).all())
    assert tr.counters["td3.updates"] == 4 * steps
    assert tr.counters["td3.actor_updates"] == 2 * steps
    assert tr.counters["td3.rows_inserted"] == N_ENVS * steps


def test_small_ring_counts_lost_marks(monkeypatch):
    monkeypatch.setattr(profiling, "RING_MARKS", 8)
    with profiling.tracing() as tr:
        for _ in range(20):
            with profiling.device_span("x", "cpu"):
                pass
    assert tr.counters["trace.marks_lost"] == 40 - 8
    spans = tr.device_spans()
    assert len(spans) == 4 and all(s.name == "x" for s in spans)


def test_pair_marks_drops_what_the_ring_lost():
    with profiling.tracing():
        with profiling.device_span("p", "cpu"), profiling.device_span("q"):
            pass
    p, q = profiling._IDS["p"], profiling._IDS["q"]
    # an end whose begin was lost, an outer span, a replayed inner span,
    # an inner span never closed
    marks = [(q * 4 + 1, 1), (p * 4, 2), (q * 4 + 2, 3), (q * 4 + 3, 4),
             (q * 4, 5), (p * 4 + 1, 6)]
    spans = profiling.pair_marks(marks)
    assert [(s.name, s.start_ns, s.end_ns, s.parent, s.replayed)
            for s in spans] == [("p", 2, 6, -1, False),
                                ("q", 3, 4, 0, True)]
