"""What the program's spans cover in a traced benchmark run.

Reads the Chrome trace and the requests that ``portbench/run.py
--trace 1`` leaves in ``portbench/out/`` and prints one JSON object:

* ``h2d``: the device's ``Memcpy HtoD`` time, and the share of it whose
  copy was issued inside a ``cpkrylov.upload`` span (the copy's runtime
  call, matched by its correlation id);
* ``idle``: the traced window's idle time, the share of it that no
  program span names (labelled ``portbench.request / python`` or
  ``cpkrylov.solve_mixed / python``), and the ten largest labels;
* ``build``: for each traced request's ``cpkrylov.build`` span, its length,
  the share of it that the ``cpkrylov.build.*`` spans cover, and the host
  time of the ``cpkrylov.upload`` spans inside it;
* ``traced_wall_ms``: the traced requests' wall times, and
  ``untraced_wall_ms`` the mean of the others.

Run from the root of a checkout after a traced run of the cell:

    python3 tools/trace_report.py <cell> [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench.trace import Trace, union_s  # noqa: E402

UNNAMED = ("portbench.request / python", "cpkrylov.solve_mixed / python")
BUILD_PARTS = ("cpkrylov.build.order", "cpkrylov.build.ldl",
               "cpkrylov.build.probe", "cpkrylov.build.pack")


def _spans(events, name):
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X" and e.get("name") == name
            and e.get("cat") == "user_annotation"]


def _within(t, spans) -> bool:
    return any(lo <= t <= hi for lo, hi in spans)


def report(cell: str, out_dir: str) -> dict:
    with open(os.path.join(out_dir, f"{cell}.trace.json")) as f:
        events = json.load(f)["traceEvents"]
    with open(os.path.join(out_dir, f"{cell}.requests.json")) as f:
        requests = json.load(f)
    tr = Trace(events)
    reqs = tr.spans("portbench.request")
    lo, hi = reqs[0][0], reqs[-1][1]

    launch_ts = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "correlation" in e.get(
                "args", {}):
            launch_ts[e["args"]["correlation"]] = float(e["ts"])
    uploads = _spans(events, "cpkrylov.upload")
    h2d_total = h2d_in = 0.0
    unmatched = 0
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "gpu_memcpy"
                and "HtoD" in e.get("name", "")
                and lo <= float(e["ts"]) <= hi):
            dur = float(e["dur"])
            h2d_total += dur
            t = launch_ts.get(e.get("args", {}).get("correlation"))
            if t is None:
                unmatched += 1
            elif _within(t, uploads):
                h2d_in += dur

    gaps = tr.idle_gaps(lo, hi, top=10 ** 6)
    idle = sum(v for _, v in gaps)
    unnamed = sum(v for n, v in gaps if n in UNNAMED)

    parts = [sp for n in BUILD_PARTS for sp in _spans(events, n)]
    build = []
    for b0, b1 in _spans(events, "cpkrylov.build"):
        if lo <= b0 and b1 <= hi:
            covered = union_s([sp for sp in parts if b0 <= sp[0]
                               and sp[1] <= b1], b0, b1)
            upload = sum(e - s for s, e in uploads if b0 <= s and e <= b1)
            build.append({"ms": (b1 - b0) / 1e3,
                          "covered": covered * 1e6 / (b1 - b0),
                          "upload_ms": upload / 1e3})

    ntrace = len(reqs)
    walls = [1e3 * r["wall_s"] for r in requests]
    rest = walls[ntrace:]
    return {
        "cell": cell,
        "h2d": {"ms": h2d_total / 1e3,
                "in_upload_share": h2d_in / h2d_total if h2d_total else None,
                "unmatched": unmatched},
        "idle": {"s": idle, "unnamed_share": unnamed / idle if idle else None,
                 "top": gaps[:10]},
        "build": build,
        "traced_wall_ms": walls[:ntrace],
        "untraced_wall_ms": sum(rest) / len(rest) if rest else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell")
    ap.add_argument("--out", default=os.path.join(ROOT, "portbench", "out"))
    args = ap.parse_args(argv)
    print(json.dumps(report(args.cell, args.out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
