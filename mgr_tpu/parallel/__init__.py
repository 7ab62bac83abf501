"""Device-mesh parallelism: mesh construction, sharding rules, collectives.

The reference is single-GPU, batch-2, no comms backend (SURVEY.md §2.3).
This package is the first-class equivalent: ``jax.sharding.Mesh``
axes ``data`` (DP) and ``model`` (TP), XLA-inserted collectives (NCCL
between GPUs).
"""

from mgr_tpu.parallel.mesh import make_mesh  # noqa: F401
from mgr_tpu.parallel.sharding import (  # noqa: F401
    batch_pspec,
    param_pspecs,
    shard_batch,
    shard_params,
)
