"""Readings that set a cell's correctness limit: whole runs of the cell,
judged by the harness's own comparison, of the program on many seeds (the
lower reading) and of the control on a few (the upper reading).

    python3 portbench/control.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 7 8 9 [--seconds 5] [--out portbench/out/control.jsonl]

Each seed is one ``harness.run_cell`` in this process, with a short window
at the cell's own load: its ``correct`` and the numbers it compared
(``checks``: the largest residual ratio of the sampled answers, the
unsolved requests) are printed a line a run.  The control is the program's
own path one precision down, ``harness.CONTROL``: ``solve(dtype=float32,
refine=False)``, through an f32 preconditioner built in set-up where the mix
builds one there, for an f64 cell and for the df64-refined mixed cell
alike.  A sound control run reads ``correct`` false.  The benchmark's runs
never run this.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness

    rows = []
    for side, seeds, program in (("program", args.seeds, None),
                                 ("control", args.control_seeds,
                                  harness.CONTROL)):
        for seed in seeds:
            res, _ = harness.run_cell(args.workload, seed, args.seconds,
                                      False, t_start=time.perf_counter(),
                                      program=program)
            row = {"workload": args.workload, "side": side, "seed": seed,
                   "correct": res["correct"], "attempted": res["attempted"],
                   **{k: v["value"] for k, v in res["checks"].items()}}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
