"""live_copy_share.rollout: % of the copies the compaction sorts (counter
`render.copies`, B x LE a render) that take a slot
(`render.live_copies`): the useful share of its sort. From the program's
tracer (`portbench/spans.py`); None without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, spans.live_copy_share)
