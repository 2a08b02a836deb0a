"""step_mfu.rollout: % of the whole rollout step's least time in its
measured time (the wall time of a call timed without the profiler, over
its steps). Least time: each observation byte written once and the car
state read and written once, at the HBM rate (the step's arithmetic
binds far less)."""
from portbench import peaks


def read(ctx):
    f = ctx.facts
    if not f.get("steps") or not f.get("wall_s"):
        return None
    least = peaks.least_s(f["obs_bytes"] + 2 * f["car_state_bytes"])
    return 100.0 * least / (f["wall_s"] / f["steps"])
