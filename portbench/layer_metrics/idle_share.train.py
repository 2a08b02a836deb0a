"""idle_share.train: % of the wall time of a TD3 chunk with no device
operation running: 1 - the traced chunk's busy time over the wall time of
a chunk timed without the profiler."""
from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
