"""Where a cell's pieces live, found by the names ``BENCHMARK.json`` gives.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each is a data file under this folder (``configs/<name>.json``,
``traffic/<name>.json``), the mix names the runner that runs it
(``runners/<runner>.py``), the cell's limits sit in ``limits/<cell>.json``
and each per-layer metric is a reader of its own (``metrics/<name>.py``).
Adding any of them is adding files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import sys
from types import ModuleType

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the timed process may not hold (compared whole,
#: so ``photon_tpu_torch`` is not ``photon_tpu``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "photon_tpu")


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    root: pathlib.Path
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_metrics(bench: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """The end-to-end metrics the cell reports, and the per-layer metrics
    of its traced run: those that list the cell, or that list no cells and
    move an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if _reports(m, cell)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, per_layer


def read_json(path: pathlib.Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"missing benchmark file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(by_name)}")
    w = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return cell_from_files(name, configs[w["config"]]["file"], w["traffic"], int(w["chips"]),
                           root, bench)


def cell_from_files(name: str, config_file: str, traffic: str, chips: int = 1,
                    root: pathlib.Path = ROOT, bench: dict | None = None) -> Cell:
    """A cell from its files, whether or not ``BENCHMARK.json`` lists it
    (its metrics are then those every cell reports)."""
    bench = load_benchmark(root) if bench is None else bench
    config = read_json(root / config_file)
    mix = read_json(root / "perfbench" / "traffic" / f"{traffic}.json")
    limits = read_json(root / "perfbench" / "limits" / f"{name}.json")
    e2e, per_layer = cell_metrics(bench, name)
    return Cell(name, root, chips, config, mix, limits, e2e, per_layer)


def load_module(path: pathlib.Path, name: str) -> ModuleType:
    """Import a file of this folder by its path (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner(cell: Cell) -> ModuleType:
    name = cell.traffic["runner"]
    return load_module(cell.root / "perfbench" / "runners" / f"{name}.py",
                       f"perfbench_runner_{name}")


def metric_reader(name: str, root: pathlib.Path = ROOT) -> ModuleType:
    return load_module(root / "perfbench" / "metrics" / f"{name}.py", f"perfbench_metric_{name}")


def forbidden_modules(modules=None) -> list[str]:
    """Names in ``sys.modules`` whose top-level name is forbidden."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN_MODULES)
