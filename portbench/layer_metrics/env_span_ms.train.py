"""env_span_ms.train: median device ms of the env step in a replayed TD3
step (device span `td3.env_step`: `vector.step`'s car, info, wrappers and
auto-reset, and the K3 rgb render). From the program's tracer
(`portbench/spans.py`); None without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, lambda p: spans.replayed_ms(p, "td3.env_step"))
