"""Model FLOPs utilisation, in percent: the model FLOPs of the window's
policy forwards (counted once in set-up, from shapes, by FlopCounterMode on the
reference's model; recomputation not counted) over the window's seconds
times the dense peak of the precision the configuration declares for its
matrix work (`counts/peaks.json`)."""


def read(run: dict):
    n, per = run.get("policy_calls"), run.get("flops_per_call")
    if not n or not per or not run.get("window_s"):
        return None
    return 100.0 * n * per / (run["window_s"] * run["peak_flop_per_s"])
