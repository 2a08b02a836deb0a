"""step_mfu.train: % of a TD3 loop step's least time in its measured time
(the wall time of a chunk timed without the profiler, over its steps).
Least time: the larger of the step's operations (the encoder's forward
over the batch's frames, the policy's actor, the four updates' forward
and backward; `portbench/td3_work.py`) at the float32 peak outside the
tensor cores (TF32 is off) and its least bytes at the HBM rate."""
from portbench import peaks


def read(ctx):
    f = ctx.facts
    if not f.get("steps") or not f.get("wall_s") \
            or not f.get("flops_per_step"):
        return None
    least = peaks.least_s(f["bytes_per_step"], f["flops_per_step"],
                          peaks.PEAK_F32_PER_S)
    return 100.0 * least / (f["wall_s"] / f["steps"])
