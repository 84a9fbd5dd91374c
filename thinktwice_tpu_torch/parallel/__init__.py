from thinktwice_tpu_torch.parallel.worlds import (
    batched_reset,
    batched_rollout,
    summarize_events,
)

__all__ = ["batched_reset", "batched_rollout", "summarize_events"]
