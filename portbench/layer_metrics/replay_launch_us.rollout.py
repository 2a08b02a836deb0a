"""replay_launch_us.rollout: median host us of one `g.replay()` of the
rollout's graph (span `rollout.replay`): the launch the host pays a
step. From the program's tracer (`portbench/spans.py`); None without its
spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, spans.replay_launch_us)
