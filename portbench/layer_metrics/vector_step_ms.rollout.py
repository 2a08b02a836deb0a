"""vector_step_ms.rollout: device-busy ms a step of a replayed CUDA graph
of `vector.step(render=False)` alone at the cell's batch: the car step,
the local-path walk, car_info, shaping and auto-reset."""
from portbench import readers


def read(ctx):
    return readers.busy_ms(ctx, "vector_step")
