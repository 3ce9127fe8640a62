"""What a runner is given and returns, and the result line it becomes."""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import sys

import torch

from perfbench import spec
from perfbench.trace import Record, Spans


@dataclasses.dataclass
class Context:
    """One run of one cell. ``control`` and ``fault`` are for the
    calibration runs (``calibrate.py``) and the tests, never the timed
    runs: ``control`` also reads the lower-precision reference, ``fault``
    names a fault planted in the timed path."""

    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    device_name: str = ""
    control: bool = False
    fault: str | None = None
    spans: Spans = dataclasses.field(default_factory=Spans)


@dataclasses.dataclass
class Result:
    attempted: int
    failed: int
    setup_s: float
    #: end-to-end metric name -> value (``--trace 0``)
    e2e: dict
    memory_peak_bytes: int
    #: (name, value, limit): ``correct`` when every value is at most its limit
    checks: list
    record: Record | None = None
    #: readings for calibration: the control's numbers and others
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in self.checks)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    order statistics; an infinite value stands for a failed request."""
    xs = sorted(values)
    if not xs:
        return math.nan
    k = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    if lo == hi or xs[hi] == xs[lo]:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def worst_leaf_gap(program: dict, reference: dict, keep: list[str]) -> float:
    """The largest gap between the program's and the reference's norm of a
    leaf, over the larger of that leaf's reference norm and the median
    leaf's."""
    med = statistics.median(reference[n] for n in keep)
    return max(abs(program[n] - reference[n]) / max(reference[n], med) for n in keep)


def result_line(ctx: Context, res: Result) -> dict:
    """The last line of standard output: the cell's end-to-end metrics
    (``--trace 0``) or its per-layer metrics (``--trace 1``), the device,
    and the numbers compared beside their limits, last."""
    cell = ctx.cell
    metrics = {}
    if not ctx.trace:
        for m in cell.end_to_end:
            name = m["name"]
            value = res.setup_s if name == "setup_s" else res.e2e[name]
            metrics[name] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.root).read(res.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": ctx.device_name,
              "count": cell.chips, "memory_peak_bytes": res.memory_peak_bytes}
    line = {"correct": res.correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": device}
    if ctx.trace:
        device["busy_s"] = res.record.busy_s
        device["window_s"] = res.record.window_s
        line["breakdown"] = res.record.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in res.checks}
    return line


def print_checks(res: Result, stream=sys.stderr) -> None:
    for name, v, lim in res.checks:
        print(f"check {name}: {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=stream, flush=True)
