"""Eval Gauntlet: YAML task suites and category-weighted aggregation.

The port of ``photon_tpu/eval/gauntlet.py``, parsing the same two formats:

- a task suite, llm-foundry's ``icl_tasks`` list (``label``,
  ``dataset_uri``, ``num_fewshot``, ``icl_task_type``, the delimiters ...)
  resolved against a ``root_dir``;
- a gauntlet, ``eval_gauntlet.categories[].benchmarks[]`` with
  ``num_fewshot`` and ``random_baseline``, plus ``weighting``,
  ``subtract_random_baseline``, ``rescale_accuracy`` and named
  ``averages`` over category lists.

All four task types score (``icl.py``). The v0.3 suite and gauntlet are
copied under ``configs/``; their task data is read in place from
``photon_tpu/eval/local_data`` (``--tasks-root``).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any

import numpy as np
import yaml

from photon_tpu_torch.eval.icl import ICLTask, score_tasks

_SCOREABLE = {
    "multiple_choice", "language_modeling", "schema", "generation_task_with_answers",
}


@dataclasses.dataclass
class TaskSpec:
    label: str
    dataset_uri: str
    icl_task_type: str
    num_fewshot: tuple[int, ...] = (0,)
    continuation_delimiter: str = " "
    question_prelimiter: str = ""
    example_delimiter: str = "\n"
    cot_delimiter: str = ""
    early_stopping_criteria: tuple[str, ...] = ()
    do_normalization: bool = True

    @property
    def scoreable(self) -> bool:
        return self.icl_task_type in _SCOREABLE


@dataclasses.dataclass
class TaskSuite:
    """A parsed ``icl_tasks`` suite."""

    specs: list[TaskSpec]
    root_dir: pathlib.Path

    @classmethod
    def from_yaml(cls, path: str | pathlib.Path, root_dir: str | None = None) -> "TaskSuite":
        p = pathlib.Path(path)
        doc = yaml.safe_load(p.read_text()) or {}
        entries = doc.get("icl_tasks")
        if not isinstance(entries, list):
            raise ValueError(f"{p}: expected a top-level 'icl_tasks' list")
        root = pathlib.Path(root_dir or doc.get("root_dir") or p.parent)
        specs = []
        for e in entries:
            fewshot = e.get("num_fewshot", [0])
            if isinstance(fewshot, int):
                fewshot = [fewshot]
            specs.append(
                TaskSpec(
                    label=str(e["label"]),
                    dataset_uri=str(e["dataset_uri"]),
                    icl_task_type=str(e.get("icl_task_type", "multiple_choice")),
                    num_fewshot=tuple(int(f) for f in fewshot),
                    continuation_delimiter=str(e.get("continuation_delimiter", " ")),
                    question_prelimiter=str(e.get("question_prelimiter", "")),
                    example_delimiter=str(e.get("example_delimiter", "\n")),
                    cot_delimiter=str(e.get("cot_delimiter", "")),
                    early_stopping_criteria=tuple(
                        str(s) for s in e.get("early_stopping_criteria", [])
                    ),
                    do_normalization=bool(e.get("do_normalization", True)),
                )
            )
        return cls(specs, root)

    def load_tasks(
        self, labels_fewshot: dict[str, int] | None = None
    ) -> tuple[list[ICLTask], list[str]]:
        """Materialize jsonl-backed :class:`ICLTask`s.

        ``labels_fewshot`` (from a gauntlet config) filters to those labels
        and pins each one's fewshot count; without it every scoreable spec
        loads at its first ``num_fewshot``. Returns ``(tasks, skipped)``.
        """
        tasks: list[ICLTask] = []
        skipped: list[str] = []
        for spec in self.specs:
            if labels_fewshot is not None and spec.label not in labels_fewshot:
                continue
            if not spec.scoreable:
                skipped.append(f"{spec.label} ({spec.icl_task_type})")
                continue
            fewshot = (
                labels_fewshot[spec.label] if labels_fewshot is not None
                else spec.num_fewshot[0]
            )
            path = self.root_dir / spec.dataset_uri
            task = ICLTask.from_jsonl(
                path,
                name=spec.label,
                num_fewshot=fewshot,
                continuation_delimiter=spec.continuation_delimiter,
                question_prelimiter=spec.question_prelimiter,
                example_delimiter=spec.example_delimiter,
                cot_delimiter=spec.cot_delimiter,
                early_stopping_criteria=spec.early_stopping_criteria,
                do_normalization=spec.do_normalization,
            )
            if task.kind != spec.icl_task_type:
                raise ValueError(
                    f"{spec.label}: yaml says {spec.icl_task_type} but "
                    f"{path} rows look like {task.kind}"
                )
            tasks.append(task)
        return tasks, skipped


@dataclasses.dataclass
class Benchmark:
    name: str
    num_fewshot: int = 0
    random_baseline: float = 0.0
    scale: float = 1.0  # per-benchmark weight under non-EQUAL weighting


@dataclasses.dataclass
class GauntletConfig:
    """A parsed ``eval_gauntlet`` block."""

    categories: dict[str, list[Benchmark]]
    weighting: str = "EQUAL"
    subtract_random_baseline: bool = True
    rescale_accuracy: bool = True
    averages: dict[str, list[str]] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_yaml(cls, path: str | pathlib.Path) -> "GauntletConfig":
        doc = yaml.safe_load(pathlib.Path(path).read_text()) or {}
        g = doc.get("eval_gauntlet", doc)
        cats: dict[str, list[Benchmark]] = {}
        for cat in g.get("categories", []):
            cats[str(cat["name"])] = [
                Benchmark(
                    name=str(b["name"]),
                    num_fewshot=int(b.get("num_fewshot", 0)),
                    random_baseline=float(b.get("random_baseline", 0.0)),
                    scale=float(b.get("scale", 1.0)),
                )
                for b in cat.get("benchmarks", [])
            ]
        if not cats:
            raise ValueError(f"{path}: no categories in eval_gauntlet config")
        return cls(
            categories=cats,
            weighting=str(g.get("weighting", "EQUAL")),
            subtract_random_baseline=bool(g.get("subtract_random_baseline", True)),
            rescale_accuracy=bool(g.get("rescale_accuracy", True)),
            averages={
                str(k): [str(c) for c in v]
                for k, v in (g.get("averages") or {}).items()
            },
        )

    def labels_fewshot(self) -> dict[str, int]:
        return {b.name: b.num_fewshot for bs in self.categories.values() for b in bs}

    # -- scoring -----------------------------------------------------------
    def adjust(self, raw: float, baseline: float) -> float:
        """Baseline subtraction and rescale, floored at 0."""
        score = raw
        if self.subtract_random_baseline:
            score = score - baseline
        if self.rescale_accuracy and self.subtract_random_baseline:
            score = score / max(1.0 - baseline, 1e-9)
        return max(score, 0.0)

    def aggregate(self, raw_scores: dict[str, float]) -> dict[str, float]:
        """raw per-benchmark scores → adjusted benchmarks, category means,
        named averages, and an overall mean of categories."""
        out: dict[str, float] = {}
        cat_means: dict[str, float] = {}
        missing = 0
        for cat, benches in self.categories.items():
            vals, weights = [], []
            for b in benches:
                if b.name not in raw_scores:
                    # a configured benchmark with no raw score (typo'd name,
                    # task missing from the suite) must not silently shrink
                    # the category average — surface it as a metric
                    missing += 1
                    continue
                out[f"gauntlet/{cat}/{b.name}"] = adj = self.adjust(
                    raw_scores[b.name], b.random_baseline
                )
                vals.append(adj)
                weights.append(1.0 if self.weighting == "EQUAL" else b.scale)
            if vals and sum(weights) > 0:
                cat_means[cat] = float(np.average(vals, weights=weights))
                out[f"gauntlet/category/{cat}"] = cat_means[cat]
        if missing:
            out["gauntlet/missing_benchmarks"] = float(missing)
        for avg_name, cat_list in self.averages.items():
            present = [cat_means[c] for c in cat_list if c in cat_means]
            if present:
                out[f"gauntlet/{avg_name}"] = float(np.mean(present))
        if cat_means:
            out["gauntlet/average"] = float(np.mean(list(cat_means.values())))
        return out


def run_gauntlet_suite(
    tasks_yaml: str | pathlib.Path,
    gauntlet_yaml: str | pathlib.Path | None,
    tokenizer,
    model_apply,
    params: Any,
    *,
    root_dir: str | None = None,
    seq_len: int = 256,
    batch_size: int = 16,
    max_rows: int | None = None,
    model_cfg: Any = None,
) -> dict[str, float]:
    """Suite → tasks → raw scores → weighted category averages."""
    suite = TaskSuite.from_yaml(tasks_yaml, root_dir=root_dir)
    gauntlet = GauntletConfig.from_yaml(gauntlet_yaml) if gauntlet_yaml else None
    labels = gauntlet.labels_fewshot() if gauntlet else None
    tasks, skipped = suite.load_tasks(labels)
    if not tasks:
        raise ValueError(f"no scoreable tasks loaded from {tasks_yaml}")

    raw: dict[str, float] = {}
    out: dict[str, float] = {}
    for task, res in score_tasks(
        tasks, tokenizer, model_apply, params, seq_len, batch_size, max_rows,
        model_cfg=model_cfg,
    ):
        # every task kind reports accuracy (LM = greedy exact-match,
        # llm-foundry's InContextLearningLMAccuracy) — that is what the
        # gauntlet's baseline-subtracted averages expect
        raw[task.name] = res["accuracy"]
        out[f"icl/{task.name}/accuracy"] = res["accuracy"]
        if "logprob_per_token" in res:
            out[f"icl/{task.name}/logprob_per_token"] = res["logprob_per_token"]
    if gauntlet:
        out.update(gauntlet.aggregate(raw))
    if skipped:
        out["gauntlet/skipped_tasks"] = float(len(skipped))
    return out
