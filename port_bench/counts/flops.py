"""Model FLOPs of a forward counted from shapes by
`torch.utils.flop_counter.FlopCounterMode`, on the benchmark's own
reference modules."""

from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def count_flops(fn, *args, **kwargs) -> int:
    """Floating-point operations of fn(*args, **kwargs) (a multiply-add is
    two)."""
    with FlopCounterMode(display=False) as fc:
        fn(*args, **kwargs)
    return int(fc.get_total_flops())
