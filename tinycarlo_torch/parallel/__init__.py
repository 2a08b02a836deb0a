"""Scale-out: device meshes, DP env sharding, TP learner, SP rasterisation.

Counterpart of tinycarlo_tpu/parallel/__init__.py. Explicit strategy
accounting against the reference (SURVEY.md §2.5), which has none of
DP/TP/PP/SP/EP: DP = env-batch sharding over the `data` axis
(`mesh.shard_batch`), TP = Megatron column / row sharding of the learner
MLPs over `model` (`tp.shard_params`), SP = segment-axis sharded
rasterisation (`sp.rasterize_masks_sp`, `sp.render_observation_batch_sp`).
PP and EP remain explicit non-goals at tinycar_net scale: the deepest
network is a 5-block convnet (nothing to pipeline across stages) and
there are no experts to route.

One rank per process over `torch.distributed` (`multihost.initialize`);
the collectives are explicit calls over the mesh's axis groups. The JAX
package's `batch_sharding` (a JAX NamedSharding) has no torch meaning and
is not ported.
"""
from tinycarlo_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    replicate,
    shard_batch,
)
from tinycarlo_torch.parallel.sp import rasterize_masks_sp  # noqa: F401
from tinycarlo_torch.parallel.tp import shard_params, tp_plan  # noqa: F401
