"""Readings for a cell's correctness limits: control runs of the cell
on several seeds in one process (a short window at the cell's own load),
each judged by the same comparison as a benchmark run.

    python3 portbench/tools/calibrate.py --workload qwen2-72b.decode \
        --seeds 101,102,103 --seconds 4 --control q4_0

``--control q4_0``: the reference in q4_0, the format below the served
q8_0, in the program's place at each position of the sequences the
program served; the program's own gap on them is read beside it.
``--control int8_pages``: the program served with its int8 pages in
place of the configuration's bf16 pages. Prints one JSON line per seed:
whether the run came out correct, the numbers compared and their
limits, and the program's own readings.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", default="q4_0", choices=("q4_0",
                                                          "int8_pages"))
    args = ap.parse_args(argv)
    from portbench.core import bench
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        out = bench.run_cell(args.workload, seed, args.seconds, False, t,
                             control=args.control)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "control": args.control,
            "correct": out["correct"], "failed": out["failed"],
            "served_checked": out["served_checked"],
            "compared": out["compared"], **out.get("readings", {}),
            "memory_peak_bytes": out["device"]["memory_peak_bytes"],
            "run_s": time.time() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
