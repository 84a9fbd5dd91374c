from thinktwice_tpu_torch.parallel.launch import Group, init_group, spawn
from thinktwice_tpu_torch.parallel.worlds import (
    batched_reset,
    batched_rollout,
    gather_worlds,
    make_world_group,
    shard_worlds,
    summarize_events,
    world_slice,
)

__all__ = ["Group", "batched_reset", "batched_rollout", "gather_worlds", "init_group",
           "make_world_group", "shard_worlds", "spawn", "summarize_events", "world_slice"]
