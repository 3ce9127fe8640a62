"""In-context-learning (ICL) evaluation: the Eval Gauntlet's scorers.

The port of ``photon_tpu/eval/icl.py``. Tasks are jsonl files in
llm-foundry's four ICL task types:

- multiple choice: ``{"query": str, "choices": [str], "gold": int}``;
- language modeling: ``{"context": str, "continuation": str}``;
- schema (winograd-style): ``{"context_options": [str], "continuation":
  str, "gold": int}``, the continuation scored under each context;
- generation with answers: ``{"context": str, "answer": str, "aliases":
  [str]}``, greedy decoding and normalized exact match.

Scoring sums log p(continuation | context) over the continuation's tokens
in fixed ``[batch_size, seq_len]`` batches: items are packed across row
boundaries and the last batch is padded with zero rows, so every forward
has the same shape (on the card, the flash forward kernel K1 runs over
the whole buffer). Generation decodes every batch of ``batch_size`` rows
through the KV cache (``models/decode.py``) when the model config is
given, else through one full forward a token. Every model call runs
under ``torch.inference_mode``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Callable, Iterable

import numpy as np
import torch

from photon_tpu_torch.models.decode import device_of


@dataclasses.dataclass
class ICLTask:
    name: str
    kind: str  # multiple_choice | language_modeling | schema | generation_task_with_answers
    rows: list[dict]
    category: str = "general"
    random_baseline: float = 0.0
    # few-shot prompting: the first num_fewshot rows other than the scored one
    num_fewshot: int = 0
    continuation_delimiter: str = ""  # suite YAMLs default to " " (llm-foundry)
    example_delimiter: str = "\n"
    question_prelimiter: str = ""
    cot_delimiter: str = ""  # generation tasks: answer extraction marker
    early_stopping_criteria: tuple[str, ...] = ()
    do_normalization: bool = True
    max_new_tokens: int = 16

    @classmethod
    def from_jsonl(cls, path: str | pathlib.Path, name: str | None = None,
                   category: str = "general", **kw: Any) -> "ICLTask":
        p = pathlib.Path(path)
        rows = [json.loads(line) for line in p.read_text().splitlines() if line.strip()]
        if not rows:
            raise ValueError(f"empty task file {p}")
        first = rows[0]
        if "choices" in first:
            kind, baseline = "multiple_choice", 1.0 / len(first["choices"])
        elif "context_options" in first:
            kind, baseline = "schema", 1.0 / len(first["context_options"])
        elif "answer" in first:
            kind, baseline = "generation_task_with_answers", 0.0
        else:
            kind, baseline = "language_modeling", 0.0
        return cls(name or p.stem, kind, rows, category, baseline, **kw)

    def _example_text(self, row: dict) -> str:
        if self.kind == "multiple_choice":
            return (f"{self.question_prelimiter}{row['query']}"
                    f"{self.continuation_delimiter}{row['choices'][int(row['gold'])]}")
        if self.kind == "schema":
            return (f"{self.question_prelimiter}{row['context_options'][int(row['gold'])]}"
                    f"{self.continuation_delimiter}{row['continuation']}")
        if self.kind == "generation_task_with_answers":
            return (f"{self.question_prelimiter}{row['context']}"
                    f"{self.continuation_delimiter}{self.cot_delimiter}{row['answer']}")
        return (f"{self.question_prelimiter}{row['context']}"
                f"{self.continuation_delimiter}{row['continuation']}")

    def _fewshot_prefix(self, row_idx: int) -> list[str]:
        if not self.num_fewshot:
            return []
        shots = [r for i, r in enumerate(self.rows) if i != row_idx][: self.num_fewshot]
        return [self._example_text(r) for r in shots]

    def build_context(self, row_idx: int, context_option: int | None = None) -> str:
        """Few-shot prefix + the scored row's own context or query."""
        row = self.rows[row_idx]
        parts = self._fewshot_prefix(row_idx)
        if self.kind == "multiple_choice":
            query = row["query"]
        elif self.kind == "schema":
            query = row["context_options"][context_option if context_option is not None else 0]
        else:
            query = row["context"]
        suffix = self.cot_delimiter if self.kind == "generation_task_with_answers" else ""
        parts.append(f"{self.question_prelimiter}{query}{self.continuation_delimiter}{suffix}")
        return self.example_delimiter.join(parts)


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_logprob_fn(model_apply: Callable, params: Any, seq_len: int) -> Callable:
    """``(tokens [B, S], mask [B, S]) -> (logprob [B], exact [B])``, tensors
    on the params' device.

    ``mask`` is 1.0 on continuation positions (token t predicted from
    t - 1); ``logprob`` sums log p(continuation | context), from an fp32
    log-softmax over ``logits[:, :-1]``; ``exact`` is 1.0 iff every
    masked position is greedy-correct (llm-foundry's
    ``InContextLearningLMAccuracy``)."""
    device = device_of(params)

    @torch.inference_mode()
    def logprob(tokens, mask):
        tokens = torch.as_tensor(tokens).to(device).long()
        mask = torch.as_tensor(mask).to(device)
        logits = model_apply(params, tokens)  # [B, S, V]
        logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        tgt = tokens[:, 1:]
        row = torch.gather(logp, -1, tgt[..., None])[..., 0]  # [B, S-1]
        m = mask[:, 1:]
        hit = (torch.argmax(logp, dim=-1) == tgt).float()
        exact = torch.prod(torch.where(m > 0, hit, torch.ones_like(hit)), dim=-1)
        return (row * m).sum(-1), exact

    del seq_len
    return logprob


def write_at_cursor(tokens: torch.Tensor, lengths: torch.Tensor,
                    nxt: torch.Tensor) -> torch.Tensor:
    """A copy of ``tokens [B, S]`` with ``nxt [B]`` at each row's cursor
    (clamped to the last slot): the one definition of the decode write,
    shared by the full-forward and KV-cache decoders."""
    out = tokens.clone()
    idx = torch.clamp(lengths.long(), 0, tokens.shape[1] - 1)
    out[torch.arange(tokens.shape[0], device=tokens.device), idx] = nxt.to(tokens.dtype)
    return out


def make_generate_fn(model_apply: Callable, params: Any) -> Callable:
    """A greedy decode step ``(tokens [B, S], lengths [B]) -> (tokens',
    lengths')`` appending one argmax token a row at its cursor, with one
    full forward over the fixed buffer."""
    device = device_of(params)

    @torch.inference_mode()
    def step(tokens, lengths):
        tokens = torch.as_tensor(tokens).to(device)
        lengths = torch.as_tensor(lengths).to(device)
        logits = model_apply(params, tokens.long())  # [B, S, V]
        idx = torch.clamp(lengths.long() - 1, 0, tokens.shape[1] - 1)
        last = logits[torch.arange(tokens.shape[0], device=device), idx]  # [B, V]
        tokens = write_at_cursor(tokens, lengths, torch.argmax(last, dim=-1))
        return tokens, torch.clamp(lengths + 1, max=tokens.shape[1])

    return step


_ARTICLES = ("a ", "an ", "the ")


def normalize_answer(text: str) -> str:
    """llm-foundry's answer normalization: lowercase, strip punctuation and
    a leading article, collapse whitespace."""
    text = text.lower().strip()
    text = "".join(c for c in text if c.isalnum() or c.isspace())
    for art in _ARTICLES:
        if text.startswith(art):
            text = text[len(art):]
    return " ".join(text.split())


def _evaluate_generation(task: ICLTask, tokenizer, generate_fn: Callable, seq_len: int,
                         batch_size: int, rows: list[dict]) -> dict[str, float]:
    """Greedy-decode ``max_new_tokens`` a row, cut at the first early-stop
    marker, and match (normalized) against ``answer`` and ``aliases``.
    Padding rows of the last batch are zeros with cursor 1."""
    gen = task.max_new_tokens
    room = seq_len - gen
    encoded, lengths = [], []
    for i in range(len(rows)):
        ctx = tokenizer.encode(task.build_context(i))[-room:]
        buf = np.zeros(seq_len, np.int32)
        buf[: len(ctx)] = ctx
        encoded.append(buf)
        lengths.append(len(ctx))
    correct = 0
    for start in range(0, len(rows), batch_size):
        chunk = encoded[start: start + batch_size]
        lens = lengths[start: start + batch_size]
        pad = batch_size - len(chunk)
        toks = np.stack(chunk + [np.zeros(seq_len, np.int32)] * pad)
        cur = np.asarray(lens + [1] * pad, np.int32)
        many = getattr(generate_fn, "many", None)
        if many is not None:  # KV cache: one prefill and n cheap steps
            toks, cur = many(toks, cur, gen)
        else:
            for _ in range(gen):
                toks, cur = generate_fn(toks, cur)
        out = _to_numpy(toks)
        for k, row in enumerate(rows[start: start + batch_size]):
            text = tokenizer.decode(out[k, lens[k]: lens[k] + gen].tolist())
            for stop in task.early_stopping_criteria or ("\n",):
                cut = text.find(stop)
                if cut != -1:
                    text = text[:cut]
            golds = [row["answer"], *row.get("aliases", [])]
            if task.do_normalization:
                text = normalize_answer(text)
                golds = [normalize_answer(g) for g in golds]
            else:
                text = text.strip()
                golds = [g.strip() for g in golds]
            correct += int(text in golds)
    return {"accuracy": correct / len(rows), "n_rows": float(len(rows))}


def _encode_pair(tokenizer, context: str, continuation: str, seq_len: int):
    """→ (tokens [S] int32, mask [S] fp32), the context cut from the left
    to fit; a continuation longer than ``seq_len - 1`` is cut from the
    right."""
    ctx = tokenizer.encode(context)
    cont = tokenizer.encode(continuation)
    if not cont:
        raise ValueError(f"continuation tokenizes to nothing: {continuation!r}")
    room = seq_len - len(cont)
    if room < 1:
        cont = cont[: seq_len - 1]
        room = seq_len - len(cont)
    ctx = ctx[-room:]
    toks = np.zeros(seq_len, np.int32)
    mask = np.zeros(seq_len, np.float32)
    n = len(ctx) + len(cont)
    toks[:n] = ctx + cont
    mask[len(ctx):n] = 1.0
    return toks, mask


def _score_stream(items: Iterable[tuple[np.ndarray, np.ndarray, float]], logprob_fn: Callable,
                  seq_len: int, batch_size: int,
                  length_normalize: bool) -> tuple[list[float], list[float]]:
    """Score (tokens, mask, n_cont) items in full batches regardless of row
    boundaries, one padded forward per ``batch_size`` items. Returns
    ``(scores, exact)``."""
    items = list(items)
    out: list[float] = []
    exact: list[float] = []
    for start in range(0, len(items), batch_size):
        buf = items[start: start + batch_size]
        toks = np.stack([t for t, _, _ in buf])
        masks = np.stack([m for _, m, _ in buf])
        pad = batch_size - len(buf)
        if pad:
            toks = np.concatenate([toks, np.zeros((pad, seq_len), np.int32)])
            masks = np.concatenate([masks, np.zeros((pad, seq_len), np.float32)])
        lps, ex = logprob_fn(toks, masks)
        lps = _to_numpy(lps)[: len(buf)]
        exact.extend(_to_numpy(ex)[: len(buf)].tolist())
        lens = np.asarray([n for _, _, n in buf])
        out.extend((lps / lens if length_normalize else lps).tolist())
    return out, exact


def evaluate_task(task: ICLTask, tokenizer, logprob_fn: Callable, seq_len: int,
                  batch_size: int = 16, length_normalize: bool = True,
                  max_rows: int | None = None,
                  generate_fn: Callable | None = None) -> dict[str, float]:
    """Score one task: ``{accuracy, n_rows}``, plus ``logprob_per_token``
    for language modeling."""
    rows = task.rows[:max_rows] if max_rows else task.rows
    row_idxs = range(len(rows))

    if task.kind == "generation_task_with_answers":
        if generate_fn is None:
            raise ValueError(f"{task.name}: generation task needs a generate_fn")
        return _evaluate_generation(task, tokenizer, generate_fn, seq_len, batch_size, rows)

    if task.kind in ("schema", "multiple_choice"):
        # (row, option) pairs scored across the batch dimension, then an
        # argmax within each row's span; multiple choice varies the
        # continuation, schema the context
        def options(i: int) -> list[tuple[str, str]]:
            if task.kind == "schema":
                return [(task.build_context(i, context_option=o), rows[i]["continuation"])
                        for o in range(len(rows[i]["context_options"]))]
            ctx = task.build_context(i)
            return [(ctx, choice) for choice in rows[i]["choices"]]

        items = []
        spans: list[tuple[int, int]] = []
        for i in row_idxs:
            start = len(items)
            for ctx, cont in options(i):
                t, m = _encode_pair(tokenizer, ctx, cont, seq_len)
                items.append((t, m, max(float(m.sum()), 1.0)))
            spans.append((start, len(items)))
        scores, _ = _score_stream(items, logprob_fn, seq_len, batch_size, length_normalize)
        correct = sum(int(np.argmax(scores[a:b])) == int(rows[i]["gold"])
                      for i, (a, b) in zip(row_idxs, spans))
        return {"accuracy": correct / len(rows), "n_rows": float(len(rows))}

    items = []
    for i in row_idxs:
        t, m = _encode_pair(tokenizer, task.build_context(i), rows[i]["continuation"], seq_len)
        items.append((t, m, max(float(m.sum()), 1.0)))
    lps, exact = _score_stream(items, logprob_fn, seq_len, batch_size, length_normalize=False)
    total_tok = sum(n for _, _, n in items)
    return {
        # greedy exact match over the whole continuation, which the
        # gauntlet averages as accuracy
        "accuracy": float(np.mean(exact)),
        "logprob_per_token": float(np.sum(lps)) / max(total_tok, 1.0),
        "n_rows": float(len(rows)),
    }


def score_tasks(tasks: Iterable[ICLTask], tokenizer, model_apply: Callable, params: Any,
                seq_len: int, batch_size: int = 16, max_rows: int | None = None,
                model_cfg: Any = None):
    """Build the scorers once and yield ``(task, result)`` pairs. With
    ``model_cfg`` generation decodes through the KV cache, else through
    one full forward a token."""
    logprob_fn = make_logprob_fn(model_apply, params, seq_len)
    if model_cfg is not None:
        from photon_tpu_torch.models.decode import make_cached_generate_fn

        generate_fn = make_cached_generate_fn(model_cfg, params, model_apply)
    else:
        generate_fn = make_generate_fn(model_apply, params)
    for task in tasks:
        yield task, evaluate_task(task, tokenizer, logprob_fn, seq_len, batch_size,
                                  max_rows=max_rows, generate_fn=generate_fn)


def run_gauntlet(tasks: Iterable[ICLTask], tokenizer, model_apply: Callable, params: Any,
                 seq_len: int = 256, batch_size: int = 16, max_rows: int | None = None,
                 model_cfg: Any = None, on_task: Callable | None = None) -> dict[str, float]:
    """Evaluate every task; per-category averages subtract each task's
    random baseline, rescale, and floor at 0. ``on_task(task, result,
    partial_out)`` fires after each task."""
    out: dict[str, float] = {}
    by_cat: dict[str, list[float]] = {}
    for task, res in score_tasks(tasks, tokenizer, model_apply, params, seq_len, batch_size,
                                 max_rows, model_cfg=model_cfg):
        for k, v in res.items():
            if k != "n_rows":
                out[f"icl/{task.name}/{k}"] = v
        if "accuracy" in res:
            score = (res["accuracy"] - task.random_baseline) / max(1.0 - task.random_baseline,
                                                                   1e-9)
            by_cat.setdefault(task.category, []).append(max(score, 0.0))
        if on_task is not None:
            on_task(task, res, out)
    for cat, scores in by_cat.items():
        out[f"icl/category/{cat}"] = float(np.mean(scores))
    if by_cat:
        out["icl/average"] = float(np.mean([out[f"icl/category/{c}"] for c in by_cat]))
    return out
