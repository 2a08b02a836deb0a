"""Real-world bridge: the port's map/reward machinery as a digital twin
around hardware cars and cameras (tinycarlo_tpu/real_world). See `base`
for the backend contract, `env` for the Gymnasium env, `tracking` for UDP
pose ingestion."""
from tinycarlo_torch.real_world.base import (  # noqa: F401
    RealWorldCamera,
    RealWorldCar,
    pose_reset,
    pose_step,
    snap_to_lanepath,
)
from tinycarlo_torch.real_world.env import (  # noqa: F401
    TinyCarloRealWorldEnv,
    register_backend,
)
from tinycarlo_torch.real_world.tracking import PoseTracker  # noqa: F401
