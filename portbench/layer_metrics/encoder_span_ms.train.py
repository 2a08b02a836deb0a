"""encoder_span_ms.train: median device ms of the frozen encoder's
forward in a replayed TD3 step (device span `td3.encoder`). From the
program's tracer (`portbench/spans.py`); None without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, lambda p: spans.replayed_ms(p, "td3.encoder"))
