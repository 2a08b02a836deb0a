"""compact_span_ms.rollout: median device ms of the compaction in a
replayed rollout step (device span `render.compact`). From the program's
tracer (`portbench/spans.py`); None without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, lambda p: spans.replayed_ms(p, "render.compact"))
