"""update_span_ms.train: device ms of one TD3 update in a replayed step:
the median over the replayed steps of their `td3.update` spans' summed ms
(a step's spans follow its `td3.policy` span), over the updates a step
ran (counter `td3.updates` over the pass's steps). From the program's
tracer (`portbench/spans.py`); None without its spans or counter."""
import bisect
import statistics

from portbench import spans


def per_update_ms(prog):
    updates = prog["counters"].get("td3.updates")
    starts = [s[1] for s in spans.replayed_spans(prog, "td3.policy")]
    if not updates or not starts or not prog["steps"]:
        return None
    per_step = {}
    for s in spans.replayed_spans(prog, "td3.update"):
        i = bisect.bisect_right(starts, s[1]) - 1
        per_step[i] = per_step.get(i, 0) + s[2] - s[1]
    if not per_step:
        return None
    med = statistics.median(per_step.values()) / 1e6
    return med / (updates / prog["steps"])


def read(ctx):
    return spans.read(ctx, per_update_ms)
