"""wait_ms.gym: ms a gym step waits on the card: the copy out and its
synchronize (span `gym.wait`), per step. From the program's tracer
(`portbench/spans.py`); None without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, spans.gym_wait_ms)
