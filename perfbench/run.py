#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card this process sees.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, traced,
``breakdown``; ``checks``, last, holds each number ``correct`` compared
with its limit, which also end standard error. Without a card (or with
fewer cards than the cell asks for), or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: build and kernel caches at fixed places inside the checkout
CACHE = ROOT / ".perfbench_cache"


def _environment() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv: list[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    _environment()
    sys.path.insert(0, str(ROOT))
    from perfbench import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this process sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from perfbench import runtime

    ctx = runtime.Context(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START, torch.cuda.get_device_name(0))
    result = spec.runner(cell).run(ctx)
    found = spec.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}: no result", file=sys.stderr)
        return 4
    line = runtime.result_line(ctx, result)
    readings = dict(result.extra)
    if result.record is not None:
        readings["matched_calls"] = result.record.host.get("matched")
        readings["pad_lost"] = result.record.pad_lost
    print("perfbench readings: " + json.dumps(readings, default=float), file=sys.stderr)
    runtime.print_checks(result)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
