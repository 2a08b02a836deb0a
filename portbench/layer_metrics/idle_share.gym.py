"""idle_share.gym: % of the wall time of `trace_steps` env.step() calls
with no device operation running: 1 - the traced window's busy time over
the wall time of the same steps timed without the profiler."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
