"""BENCHMARK.json against the benchmark's contract, and a cell added as
files and entries alone."""

import json
import re
import shutil

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    assert bench["paths"] == ["perfbench"] and bench["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    for kind, key in (("config", "configs"), ("workload", "workloads"),
                      ("end_to_end", "end_to_end"), ("per_layer", "per_layer")):
        names = [e["name"] for e in bench[key]]
        assert len(names) == len(set(names))
        for e in bench[key]:
            extra = set(e) - KEYS[kind]
            assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer") else set())
            assert KEYS[kind] <= set(e)
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])


def test_every_cell_finds_its_files(bench):
    cells = [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.chips in (1, 4) and len(w["why"]) <= 200
        assert (spec.HERE / "runners" / f"{cell.traffic['runner']}.py").is_file()
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)
        e2e = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in e2e for m in cell.per_layer)
    for m in bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for c in bench["configs"]:
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        assert set(conf["reduced"]) == set(c["reduced"])
        assert c["file"].startswith("perfbench/")


def test_a_cell_added_as_files_and_entries_is_found(tmp_path):
    """A later change adds a configuration, a mix, a metric and a cell by
    adding files and entries; the harness finds them by name, unedited."""
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    conf = json.loads((pb / "configs" / "mpt-1b.json").read_text())
    conf["name"] = "mpt-1b-short"
    (pb / "configs" / "mpt-1b-short.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "traffic" / "chat.json").read_text())
    mix.update(prompt_len={"dist": "uniform", "min": 32, "max": 256})
    (pb / "traffic" / "short.json").write_text(json.dumps(mix))
    (pb / "limits" / "serve.mpt-1b.short.json").write_text(json.dumps({"logit_gap": 1.0}))
    (pb / "metrics" / "slots.serve.py").write_text("def read(rec):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mpt-1b-short", "source": "https://example.org/x",
                             "file": "perfbench/configs/mpt-1b-short.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "serve.mpt-1b.short", "config": "mpt-1b-short",
                               "traffic": "short", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "serve.mpt-1b.chat" in m.get("workloads", []):
            m["workloads"].append("serve.mpt-1b.short")
    bench["per_layer"].append({"name": "slots.serve", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "scheduler",
                               "moves": "ttft_p90_ms", "workloads": ["serve.mpt-1b.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("serve.mpt-1b.short", root=tmp_path)
    assert cell.config["name"] == "mpt-1b-short"
    assert cell.traffic["prompt_len"]["dist"] == "uniform"
    assert cell.limits == {"logit_gap": 1.0}
    assert spec.runner(cell).run is not None
    assert [m["name"] for m in cell.per_layer] == ["slots.serve"]
    assert spec.metric_reader("slots.serve", tmp_path).read(None) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {
        m["name"] for m in spec.load_cell("serve.mpt-1b.chat").end_to_end}


def test_per_layer_metrics_follow_their_moves():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "m1", "moves": "a"}, {"name": "m2", "moves": "b"},
                           {"name": "m3", "moves": "a", "workloads": ["y"]}]}
    e2e, per_layer = spec.cell_metrics(bench, "x")
    assert [m["name"] for m in e2e] == ["a", "b"]
    assert [m["name"] for m in per_layer] == ["m1", "m2"]
    _, per_layer = spec.cell_metrics(bench, "y")
    assert [m["name"] for m in per_layer] == ["m1", "m3"]
