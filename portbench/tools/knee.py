"""Find a cell's knee: one serve of the cell's mix with every request
due at once, after the cell's own set-up. The knee is the steady
completion rate: completions over the middle half of them (the first
quarter fills the slots, the last drains them), with the output tokens
per second of the steps in the same span.

    python3 portbench/tools/knee.py --workload qwen2-72b.decode \
        --seed 11 --requests 96

Prints one JSON line. Run it on the card; the rate it finds is written
into the cell's file by hand, as a multiple of the knee.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    from portbench.core import bench, traffic
    from portbench.core.schedule import Schedule
    t_process = time.time()
    su = bench.setup(args.workload, args.seed, trace=False)
    # n requests of the mix (a rate of n over one second), all due at 0.
    n = args.requests
    specs = traffic.stream(su.mix, {"rate_rps": n, "ramp_s": 0.0},
                           args.seed, 1.0, su.hf["vocab_size"])
    for s in specs:
        s.arrival_s = 0.0
    setup_s = time.time() - t_process
    reqs = su.requests(specs)
    rep = su.engine.serve(reqs, seed=args.seed)
    done = sorted(s.t_done for s in rep.sequences)
    lo, hi = done[n // 4], done[(3 * n) // 4]
    sched = Schedule(rep.timeline.events,
                     {q.rid: q.prompt_len for q in reqs})
    steps = sched.in_window(lo, hi)
    print(json.dumps({
        "workload": args.workload, "requests": n, "setup_s": setup_s,
        "knee_rps": ((3 * n) // 4 - n // 4) / (hi - lo),
        "output_tok_s": sum(s.emitted for s in steps) / (hi - lo),
        "step_ms_p50": 1e3 * sorted(s.t_end - s.t_start
                                    for s in steps)[len(steps) // 2],
        "span_s": [lo, hi], "serve_s": rep.wall_s,
        "device": su.torch.cuda.get_device_name(su.dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
