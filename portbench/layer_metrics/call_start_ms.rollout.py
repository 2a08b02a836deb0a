"""call_start_ms.rollout: host ms a rollout call spends before its first
replay: its eager warm-up steps (span `rollout.warmup`) and its capture
(`rollout.capture`), per call. From the program's tracer
(`portbench/spans.py`); None without its spans."""
from portbench import spans


def read(ctx):
    return spans.read(ctx, spans.call_start_ms)
