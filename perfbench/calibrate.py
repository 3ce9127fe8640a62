#!/usr/bin/env python3
"""The readings that ``correct``'s limits are set from, on the card.

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 13 --seconds 8 \\
        [--fault <name>] [--rate <requests/s>] --out readings.jsonl

Runs the cell's runner once a seed in this one process, at the cell's own
sizes and load (a short window), with the lower-precision control read on
the same inputs: each run's line holds the program's numbers, the
control's, and the end-to-end metrics. ``--fault`` plants one of the
runner's faults in the timed path instead. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(workload: str, seeds: list[int], seconds: float, fault: str | None = None,
             rate: float | None = None, control: bool = True, files: tuple | None = None,
             schedule_seed: int | None = None):
    """Yield one dict of readings a seed. ``files`` (a configuration file
    and a mix name) reads a cell that ``BENCHMARK.json`` does not list."""
    import torch

    from perfbench import runtime, spec

    cell = spec.cell_from_files(workload, *files) if files else spec.load_cell(workload)
    if rate is not None:
        cell.traffic["rate_per_s"] = rate
    if schedule_seed is not None:
        cell.traffic["schedule_seed"] = schedule_seed
    dev = torch.device("cuda", 0)
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = runtime.Context(cell, seed, seconds, False, dev, t0, torch.cuda.get_device_name(0),
                              control=control and fault is None, fault=fault)
        res = spec.runner(cell).run(ctx)
        yield {"workload": workload, "seed": seed, "fault": fault, "seconds": seconds,
               "rate_per_s": cell.traffic.get("rate_per_s"),
               "schedule_seed": cell.traffic.get("schedule_seed"), "correct": res.correct,
               "checks": {n: [v, lim] for n, v, lim in res.checks}, "e2e": res.e2e,
               "attempted": res.attempted, "failed": res.failed, "setup_s": res.setup_s,
               "memory_peak_bytes": res.memory_peak_bytes, "run_s": time.perf_counter() - t0,
               **res.extra}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--files", nargs=2, metavar=("CONFIG_FILE", "MIX"), default=None,
                    help="a cell BENCHMARK.json does not list: its configuration file and mix")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for r in readings(args.workload, args.seeds, args.seconds, args.fault, args.rate,
                          True, tuple(args.files) if args.files else None):
            f.write(json.dumps(r, default=float) + "\n")
            f.flush()
            print(json.dumps(r, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
