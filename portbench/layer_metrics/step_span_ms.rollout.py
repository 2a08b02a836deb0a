"""step_span_ms.rollout: median device ms of one replayed rollout step
(device span `rollout.step`: render, policy, `vector.step` and the
writes of the captured step). From the program's tracer
(`portbench/spans.py`); None without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, lambda p: spans.replayed_ms(p, "rollout.step"))
