"""vector_step_span_ms.rollout: median device ms of `vector.step` in a
replayed rollout step (device span `vector.step`: car, info, shaping,
auto-reset). From the program's tracer (`portbench/spans.py`); None
without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, lambda p: spans.replayed_ms(p, "vector.step"))
