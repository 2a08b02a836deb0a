"""render_span_ms.rollout: median device ms of the render in a replayed
rollout step (device span `render`: projection, compaction, K1). From
the program's tracer (`portbench/spans.py`); None without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, lambda p: spans.replayed_ms(p, "render"))
