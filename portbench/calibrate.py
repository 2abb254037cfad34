"""The readings that the limits of a cell's check are set from.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 3]
        [--out FILE]

Runs the cell once per seed in one process (set-up, a short window at
the cell's own sizes and load, the check) and prints, per seed, the
program's compared numbers; on the control seeds also the control's: the
reference computed in bfloat16 in the program's place and judged as the
program is; on the fault seeds also the readings with each of the
runner's planted faults (``FAULTS``).  A limit lies above the largest
program reading and below the smallest control (or fault) reading.  The
benchmark's runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.harness.loop import run_cell
    from portbench.harness.spec import load_cell, load_runner

    controls = {int(s) for s in args.control_seeds.split(",") if s}
    fault_seeds = {int(s) for s in args.fault_seeds.split(",") if s}
    faults = load_runner(load_cell(args.workload).traffic["runner"]).FAULTS
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run_cell(args.workload, seed, args.seconds, False, t0)
        row = {"seed": seed, "correct": res.line["correct"],
               "attempted": res.line["attempted"],
               "failed": res.line["failed"],
               "program": {n: v for n, v, _ in res.checks},
               "route": res.line["route"],
               "iterations": sorted({i for r in res.records
                                     for i in r.iterations}),
               "samples": res.samples}
        if seed in controls:
            row["control"] = res.cell.control(res.kept)
        del res
        if seed in fault_seeds:
            row["faults"] = {
                fault: {n: v for n, v, _ in run_cell(
                    args.workload, seed, args.seconds, False,
                    time.perf_counter(), fault=fault).checks}
                for fault in faults}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {"workload": args.workload,
               "program_max": {n: max(r["program"][n] for r in rows)
                               for n in rows[0]["program"]}}
    ctrl = [r["control"] for r in rows if "control" in r]
    if ctrl:
        summary["control_min"] = {n: min(c[n] for c in ctrl)
                                  for n in ctrl[0]}
    for fault in faults:
        got = [r["faults"][fault] for r in rows if "faults" in r]
        if got:
            summary[f"fault_min.{fault}"] = {n: min(g[n] for g in got)
                                             for n in got[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps({"rows": rows,
                                              "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
