"""The readings that a cell's correctness limits are set from.

    python3 fiabench/calibrate.py --workload <name> --seeds 12 --control 3 \\
        --seconds 3 [--first-seed N] [--out calib.jsonl]

In one process, for each of ``--seeds`` seeds: a whole run of the cell
(set-up, a short window at the cell's own load, the check), printing the
numbers its check compared, the program's readings. For the first
``--control`` seeds also the control's: the plain reference computed one
precision below the configuration's (TF32 products, ``precision.py``),
put in the program's place on the same sampled queries and judged by the
same comparison. A limit lies above the largest program reading and
below the smallest control reading (PERF.md gives both). Needs the card;
the benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time

#: what a run's check read besides its compared numbers: the raw
#: relative errors and the condition number of the worst query
LOOK = ("ihvp_err_cond", "score_err_cond", "ihvp_err", "score_err",
        "worst_cond")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from fiabench import cell, check
    from fiabench.spec import Spec

    spec = Spec(os.path.join(ROOT, "BENCHMARK.json"))
    rows = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        out, (cfg, params, ratings, sample) = cell.run(
            spec, args.workload, seed, args.seconds, False, "cuda",
            keep=True)
        row = {"workload": args.workload, "seed": seed, "side": "program",
               "correct": out["correct"], "jobs": out["attempted"],
               **{n: c["value"] for n, c in out["checks"].items()},
               **out["compared"], "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if k < args.control:
            r = check.compare(cfg, params, ratings, sample, "cuda:0",
                              precision="tf32")
            row = {"workload": args.workload, "seed": seed, "side": "control",
                   **{n: r[n] for n in ("count_mismatch", *LOOK,
                                        "compared", "kink_excused")}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    prog = [r for r in rows if r["side"] == "program"]
    ctrl = [r for r in rows if r["side"] == "control"]
    summary = {"workload": args.workload, "side": "summary"}
    for n in ("ihvp_err_cond", "score_err_cond"):
        summary[f"{n}.lower"] = max(r[n] for r in prog)
        summary[f"{n}.upper"] = min((r[n] for r in ctrl), default=None)
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
