#!/usr/bin/env python3
"""The knee of an open-loop serving cell: its traffic at a list of rates.

    python3 perfbench/sweep.py --workload serve.mpt-1b.chat --rates 1.2 1.4 1.6 \\
        --seconds 30 --seed 5 --schedule-seeds 22 23 --out sweep.jsonl

One process runs the cell's runner once a rate and schedule (the mix with
only ``rate_per_s`` and ``schedule_seed`` replaced), each with its warm
traffic, and prints a row for each: the offered rate, the requests of any
phase completed inside the window over its length, the backlog (queued
requests) at the window's start and close, the failed requests and the
TTFT and TPOT tails. The knee is the highest rate at which the backlog
does not grow over the window and no request fails, on every schedule;
the cell runs at about four fifths of it, written into its traffic file
as a number. This is found once, not in the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--schedule-seeds", type=int, nargs="+", default=[None],
                    help="schedules to sweep each rate on (default: the mix's own)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.calibrate import readings

    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for sched in args.schedule_seeds:
            for rate in args.rates:
                (r,) = readings(args.workload, [args.seed], args.seconds, rate=rate,
                                schedule_seed=sched, control=False)
                row = {"rate_per_s": rate, "schedule_seed": r["schedule_seed"],
                       "completed_in_window_per_s": r["completed_in_window_per_s"],
                       "window_tokens_per_s": r["window_tokens_per_s"],
                       "backlog_start": r["backlog"]["start"]["queue_depth"],
                       "backlog_close": r["backlog"]["close"]["queue_depth"],
                       "slots_start": r["backlog"]["start"]["live_slot_frac"],
                       "slots_close": r["backlog"]["close"]["live_slot_frac"],
                       "attempted": r["attempted"], "failed": r["failed"], **r["e2e"],
                       "ttft_p95_ms": r["ttft_p95_ms"], "tpot_p90_ms": r["tpot_p90_ms"],
                       "checks": r["checks"],
                       "tpot_p95_ms": r["tpot_p95_ms"],
                       "window_to_last_done_s": r["window_to_last_done_s"],
                       "generator_lag_max_s": r["generator_lag_max_s"]}
                f.write(json.dumps(row) + "\n")
                f.flush()
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
