"""The result line's keys, and what the command does without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import runtime, spec, trace

CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


def _ctx(cell, traced):
    return runtime.Context(cell, 1, 1.0, traced, torch.device("cpu"), 0.0, "NVIDIA H100 80GB HBM3")


def test_untraced_line_has_the_contract_keys():
    cell = spec.load_cell("serve.mpt-1b.chat")
    e2e = {m["name"]: 1.5 for m in cell.end_to_end}
    res = runtime.Result(10, 0, 3.0, e2e, 123, [("logit_gap", 0.01, 0.1)])
    line = runtime.result_line(_ctx(cell, False), res)
    assert list(line) == CONTRACT + ["checks"]
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["metrics"]["setup_s"] == {"value": 3.0, "unit": "s"}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 123}
    assert line["correct"] is True and line["checks"] == {"logit_gap": {"value": 0.01, "limit": 0.1}}
    json.dumps(line)
    res.checks = [("logit_gap", 0.2, 0.1)]
    assert runtime.result_line(_ctx(cell, False), res)["correct"] is False


def test_traced_line_has_the_contract_keys():
    cell = spec.load_cell("serve.mpt-1b.chat")
    rec = trace.Record(cell.config, cell.traffic, window_s=2.0, busy_s=1.5,
                       kernels={"k": [3, 1.0]}, idle_gaps=[("engine.step", 0.01)],
                       host={"queue_waits": [0.1, 0.2], "step_walls": [0.05, 0.07],
                             "flops": 1e13, "seconds": 2.0})
    res = runtime.Result(3, 0, 3.0, {}, 5, [("logit_gap", 0.0, 1.0)], record=rec)
    line = runtime.result_line(_ctx(cell, True), res)
    assert list(line) == CONTRACT + ["breakdown", "checks"]
    assert line["device"]["busy_s"] == 1.5 and line["device"]["window_s"] == 2.0
    assert line["breakdown"] == {"device_ops": [["k", 1.0]], "idle_gaps": [["engine.step", 0.01]]}
    # a reader with nothing to read (no K4 call matched) leaves its metric out
    assert set(line["metrics"]) == {"queue_wait_ms_p90.serve", "engine_step_ms.serve",
                                    "mfu.serve", "device_idle.serve"}
    assert line["metrics"]["device_idle.serve"]["value"] == pytest.approx(25.0)
    assert line["metrics"]["engine_step_ms.serve"]["value"] == pytest.approx(60.0)


def _run(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "perfbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


ARGS = ("--workload", "serve.mpt-1b.chat", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0")


def test_no_card_no_result():
    out = _run(spec.ROOT, *ARGS)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, *ARGS)
    assert out.returncode != 0 and out.stdout.strip() == ""
