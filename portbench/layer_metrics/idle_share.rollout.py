"""idle_share.rollout: % of the wall time of a rollout call with no device
operation running: 1 - the traced call's busy time over the wall time of
a call timed without the profiler."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
