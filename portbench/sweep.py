"""Find the highest rate the paced cell's job sustains: run the open-loop
driver at several fixed rates in one process and report, per rate, the
latency, the generator's lag and whether the backlog grew.

    python3 -m portbench.sweep --workload kafka_window.paced \
        --seconds 20 --seed 5 --rates 30e6,35e6,40e6

A rate is sustained when the 95th percentile of the dispatch lag over the
window stays under one block's span: blocks go out as their records
arrive, with no backlog longer than a block. The paced cell's
``rate_records_per_s`` is four fifths of the highest sustained rate,
found once and written into its file.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="kafka_window.paced")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    for rate in (float(x) for x in args.rates.split(",")):
        out = harness.run_cell(args.workload, args.seed, args.seconds,
                               False, "cuda",
                               overrides={"rate_records_per_s": rate})
        res = out["ctx"].results
        lag = res["dispatch_lag_ms"]
        cfg = out["ctx"].config
        span_ms = (cfg["block_steps"] * cfg["parallelism"] * cfg["batch"]
                   / rate * 1e3)
        print(json.dumps({
            "rate": rate, "correct": out["line"]["correct"],
            "latency_ms_p50": res["latency_ms_p50"],
            "latency_ms_p95": res["latency_ms_p95"],
            "lag_ms_p95": harness.quantile(lag, 0.95),
            "block_span_ms": span_ms,
            "sustained": harness.quantile(lag, 0.95) < span_ms,
            "records_per_s": res["records_per_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
