from thinktwice_tpu_torch.harness.statistics import (
    RouteResult,
    compute_route_statistics,
    compute_global_statistics,
)
from thinktwice_tpu_torch.harness.route_parser import parse_routes_file

__all__ = [
    "RouteResult",
    "compute_route_statistics",
    "compute_global_statistics",
    "parse_routes_file",
]
