"""Read the compared numbers of sound runs, of the controls and of the
planted faults, several seeds in one process, at a cell's own size:

    python3 -m portbench.controls --workload allround.steady \
        --seconds 5 --seeds 11,12,13 --fault drop_overflow

``--fault none`` gives the sound runs' readings; the controls and faults
are those of ``faults.py``. One JSON line per seed. The limits of
``BENCHMARK.json``'s cells are set from these readings (PERF.md); the
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import faults, harness


def read(workload: str, seed: int, seconds: float, fault: str,
         device="cuda", overrides=None) -> dict:
    cell = harness.load_json("workloads", workload)
    config = harness.load_json("configs", cell["config"])
    ov = dict(overrides or {})
    ov.update(faults.overrides(fault, {**config, **ov}))
    tamper = faults.rollback if fault == "rollback" else None
    with faults.planted(fault):
        out = harness.run_cell(workload, seed, seconds, False, device,
                               overrides=ov, tamper=tamper)
    line = out["line"]
    return {"workload": workload, "seed": seed, "fault": fault,
            "correct": line["correct"], "compared": out["compared"],
            "attempted": line["attempted"], "metrics": line["metrics"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="none",
                    choices=("none",) + faults.FAULTS + faults.CONTROLS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(read(args.workload, seed, args.seconds,
                              args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
