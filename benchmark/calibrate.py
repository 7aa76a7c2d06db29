"""Read a cell's compared numbers on many seeds in one process: the
program's (the lower readings of the limits), the control's and each
fault's (the upper readings).  One JSON line a seed.

    python3 -m benchmark.calibrate --workload ecoli_pacbio.assemble \\
        --plan "none:11,12,13;control:14,15,16;graph:17,18,19" [--seconds 1]

Each seed is a run of the cell as ``benchmark.run`` makes it (generate,
warm up, whole passes, judge), with the plant in place for the window
when one is named.  The benchmark's own runs never plant anything.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--plan", required=True,
                    help="PLANT:SEEDS;...: a plant (none, or one of the "
                         "stage's PLANTS) and the seeds it runs on")
    ap.add_argument("--seconds", type=float, default=1.0)
    a = ap.parse_args(argv)
    run.cache_dirs()
    plan = [(p, int(s)) for part in a.plan.split(";")
            for p, seeds in [part.split(":")] for s in seeds.split(",")]
    for i, (plant, seed) in enumerate(plan):
        plant = None if plant == "none" else plant
        t = time.time()
        r = run.run_cell(a.workload, seed, a.seconds, False, plant=plant,
                         warm=i == 0)
        print(json.dumps({
            "workload": a.workload, "seed": seed, "plant": plant,
            "correct": r["correct"], "passes_s": r["passes_s"],
            "run_s": time.time() - t,
            "memory_peak_bytes": r["device"]["memory_peak_bytes"],
            **r["readings"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
