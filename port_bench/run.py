"""The benchmark of thinktwice_tpu_torch: one run of one cell.

    python3 port_bench/run.py --workload roach_rl6.grid64 --seed 7 --seconds 30 --trace 0

Loads the cell's configuration and traffic (named in BENCHMARK.json), sets
up and warms up, measures for --seconds, compares what the window produced
with the plain reference, and prints the result as the last line of
standard output: the end-to-end metrics with --trace 0, the per-layer
metrics (and the profiler's breakdown) with --trace 1. The numbers
compared and their limits are the last lines of standard error and the
last key of the result. It exits non-zero, printing no result, without
enough CUDA devices or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the program's kernel caches at fixed paths inside the checkout (K1 and K2
# build into thinktwice_tpu_torch/_build/), so only a cell's first run there
# builds and compiles
CACHE = os.path.join(ROOT, ".bench_cache")

FORBIDDEN = ("jax", "jaxlib", "flax", "thinktwice_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: thinktwice_tpu_torch is not thinktwice_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")

    import torch

    from port_bench import harness, registry

    bench = registry.load_benchmark()
    chips = registry.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark may not reach JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
