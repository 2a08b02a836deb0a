"""The step-graph cache (tinycarlo_torch.utils.graphs `StepGraphs`) on the
CPU: off the card, or with the owner's graph flag off, every step runs
eagerly and nothing is captured; with the card's warm-up and capture
stood in for by plain calls, a key is captured once per tracing mode,
replays return the captured result, re-add the capture's held host
counts and open the owner's replay span. The capture itself, its stream
and its launch check need the card (tests/test_torch_cuda.py)."""
import pytest
import torch

from tinycarlo_torch.utils import graphs, profiling


@pytest.mark.parametrize("device,graph", [("cpu", True), ("cpu", False),
                                          ("cuda", False)])
def test_eager_path_counts_eager_runs(device, graph):
    steps = graphs.StepGraphs(device, name="owner")
    x = torch.zeros(1)

    def step():
        x.add_(1)
        return x.clone()

    outs = [steps.run("k", step, graph) for _ in range(3)]
    assert [float(o) for o in outs] == [1.0, 2.0, 3.0]
    assert (steps.eager, steps.captures, steps.replays) == (3, 0, 0)
    assert steps.entries == {} and steps.replays_by_key == {}


class _Graph:
    """A stand-in for a captured graph, whose replay, like a real one's,
    runs no Python of the step: it logs the step's result."""

    def __init__(self, out, log):
        self.out, self.log = out, log

    def replay(self):
        self.log.append(("replay", self.out))

    def pool(self):
        return (0, 1)


def test_keys_hold_the_tracing_mode(monkeypatch):
    """Each (key, tracing mode) is warmed up and captured once; a replay
    returns the captured result, adds the host counts its capture held
    and opens "<name>.replay"; tracing off and on keep graphs apart."""
    log = []

    def record(step, launches, generators, pool):
        assert all(n == 0 for n in launches.values())
        out = step()
        return _Graph(out, log), out

    monkeypatch.setattr(graphs, "warm_up", lambda fn: fn())
    monkeypatch.setattr(graphs, "_record", record)
    steps = graphs.StepGraphs("cpu", name="owner")
    steps.cuda = True

    def step(key):
        log.append(("run", key))
        profiling.count("owner.steps", 2)
        return key

    assert [steps.run("a", lambda: step("a")) for _ in range(3)] == ["a"] * 3
    with profiling.tracing() as tr:
        for key in ("a", "b", "a", "a"):
            assert steps.run(key, lambda k=key: step(k)) == key
    assert set(steps.entries) == {("a", False), ("a", True), ("b", True)}
    # each new (key, mode): a warm-up and a capture; then replays
    run, replay = ("run", "a"), ("replay", "a")
    assert log == [run, run, replay, replay,
                   run, run, ("run", "b"), ("run", "b"), replay, replay]
    assert (steps.eager, steps.captures, steps.replays) == (3, 3, 4)
    assert steps.replays_by_key == {"a": 4}
    # traced: the 2 warm-ups count as they run, the 2 replays add the
    # counts their capture held
    assert tr.counters["owner.steps"] == 2 * 4
    assert [s.name for s in tr.spans] == ["owner.replay"] * 2
