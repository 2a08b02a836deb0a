"""render_ms.rollout: device-busy ms of a replayed CUDA graph of
`env.render_observation_batch` alone at the cell's batch: the packed
projection, the compaction and the masks kernel (K1)."""
from portbench import readers


def read(ctx):
    return readers.busy_ms(ctx, "render")
