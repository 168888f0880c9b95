"""The readings that the limits of ``correct`` are set from, on the card:

    python benchmark/readings.py --workload <name> --seeds 1,2,3 [--control N] [--out f]

Each seed is one run of the cell as the benchmark makes it (``cell.run``)
with a window just long enough to hold its judged frame or render; on
the first N seeds (``--control N``) the run also gives the numbers of
the control, the reference computed in bfloat16 in the program's place,
which has to come out not correct. One JSON line a seed, on standard
output and appended to ``--out``. The benchmark's own runs never run
this.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from benchmark.harness import cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0,
                    help="run the control on the first this many seeds")
    ap.add_argument("--out")
    a = ap.parse_args()
    for k, seed in enumerate(int(x) for x in a.seeds.split(",")):
        t0 = time.perf_counter()
        out = cell.run(a.workload, seed, 0.0, False, control=k < a.control)
        line = {"workload": a.workload, "seed": seed,
                "program": {n: v["value"] for n, v in out["compared"].items()},
                "seconds": time.perf_counter() - t0}
        if "control_bf16" in out:
            line["control_bf16"] = out["control_bf16"]
        print(json.dumps(line), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
