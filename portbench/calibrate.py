"""Readings that the limits of `correct` are set from (not part of a
benchmark run): for each seed, one run of the cell at its own size with a
short window, the program's numbers against the plain reference, and with
--control the control's (the reference in the precision below the
configuration's, put in the program's place) on the same inputs.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 [--control]
        [--seconds 2] [--out <file.jsonl>]

One JSON line per seed, then one with the largest program reading and the
smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, control: bool, dev) -> dict:
    import torch

    from portbench import harness as H

    run = H.kind_module(cell.traffic["kind"]).Run(cell, seed, dev, H.SetupClock(time.perf_counter()))
    e2e = run.execute(seconds).get("e2e", {})
    got = run.readings()
    run.free_program()
    want = run.reference("fp32")
    out = {"workload": cell.name, "seed": seed, "e2e": e2e,
           "program": run.compare(got, want)}
    if control:
        out["control"] = run.compare(run.reference(cell.traffic["control"]), want)
    if hasattr(run, "left_out"):
        out["left_out"] = run.left_out
    del run, got, want
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--out")
    args = p.parse_args(argv)
    from portbench import harness as H
    from portbench import run as R

    cell = H.cell(args.workload)
    dev = R.open_card()
    sink = open(args.out, "a") if args.out else None
    lines = []
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            line = readings(cell, seed, args.seconds, args.control, dev)
            lines.append(line)
            for f in (sys.stdout, sink):
                if f is not None:
                    print(json.dumps(line), file=f, flush=True)
        summary = {"workload": cell.name,
                   "lower": {k: max(ln["program"][k] for ln in lines)
                             for k in lines[0]["program"]}}
        if args.control:
            summary["upper"] = {k: min(ln["control"][k] for ln in lines)
                                for k in lines[0]["control"]}
        for f in (sys.stdout, sink):
            if f is not None:
                print(json.dumps(summary), file=f, flush=True)
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
