"""Multi-device scaling on torch.distributed (the port of
``online_gp_tpu/parallel``)."""

from online_gp_torch.parallel.dryrun import dryrun_multichip
from online_gp_torch.parallel.grid import gather_wiski_state, shard_wiski_state
from online_gp_torch.parallel.mesh import (
    batched_trials_step,
    localgp_experts_step,
    make_mesh,
    replicate,
    shard_leading,
    sharded_pred_stream_blocked,
    sharded_stream_blocked,
)

__all__ = [
    "make_mesh",
    "shard_leading",
    "replicate",
    "batched_trials_step",
    "sharded_stream_blocked",
    "sharded_pred_stream_blocked",
    "localgp_experts_step",
    "shard_wiski_state",
    "gather_wiski_state",
    "dryrun_multichip",
]
