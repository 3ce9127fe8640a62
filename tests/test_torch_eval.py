"""The port's evaluation (``photon_tpu_torch/eval``, ``metrics/unigram.py``)
against the JAX package's.

CPU, fp32. One counterpart per case of ``tests/test_icl.py``,
``tests/test_gauntlet.py``, ``tests/test_eval_cli.py`` and the unigram
cases of ``tests/test_metrics.py``, each also held to the JAX result on
the same inputs:

- ICL scoring with the fake next-byte model: the same scores and
  aggregates as JAX (exact: the logits are ±10);
- the demo suite end to end on a tiny model with shared weights (KV-cache
  generation included): accuracies equal, log-probs within 1e-4 a token;
- the eval CLI (``--device cpu``) on a JAX-written ``.npz``, a round
  checkpoint with momenta, a centralized run and a converted PTS set: the
  same keys as ``photon_tpu.eval`` and values within 1e-5 (losses) or
  equal (accuracies);
- the unigram functions and accumulator within 1e-6.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

ROOT = pathlib.Path(__file__).resolve().parent.parent
VOCAB = 257
SEQ = 32
PORT_CONFIGS = ROOT / "photon_tpu_torch" / "eval" / "configs"
JAX_CONFIGS = ROOT / "photon_tpu" / "eval" / "configs"
TASKS_ROOT = ROOT / "photon_tpu" / "eval" / "local_data"
#: per-token log-probs and losses, fp32 on the CPU (matmul summation order)
LOGPROB_ATOL = 1e-4
LOSS_RTOL = 1e-5


def _apply(params, tokens):
    """The fake model of the JAX tests: next byte = current + 1."""
    return 20.0 * F.one_hot((tokens.long() + 1) % VOCAB, VOCAB).float() - 10.0


def _jax_apply(params, tokens):
    import jax
    import jax.numpy as jnp

    return 20.0 * jax.nn.one_hot((tokens + 1) % VOCAB, VOCAB, dtype=jnp.float32) - 10.0


def _tok():
    from photon_tpu_torch.data.tokenizer import ByteTokenizer

    return ByteTokenizer()


def _jax_tok():
    from photon_tpu.data.tokenizer import ByteTokenizer

    return ByteTokenizer()


# ---------------------------------------------------------------------------
# tests/test_icl.py
# ---------------------------------------------------------------------------

def test_task_from_jsonl(tmp_path):
    from photon_tpu_torch.eval import ICLTask

    rows = [{"query": "q", "choices": ["a", "b"], "gold": 0}] * 3
    p = tmp_path / "mc.jsonl"
    p.write_text("\n".join(json.dumps(r) for r in rows))
    task = ICLTask.from_jsonl(p, category="knowledge")
    assert (task.kind, task.random_baseline, task.name) == ("multiple_choice", 0.5, "mc")
    for name, row, kind in (("lm", {"context": "a", "continuation": "b"}, "language_modeling"),
                            ("sc", {"context_options": ["a", "b", "c"], "continuation": "d",
                                    "gold": 1}, "schema"),
                            ("gen", {"context": "a", "answer": "b"},
                             "generation_task_with_answers")):
        (tmp_path / f"{name}.jsonl").write_text(json.dumps(row) + "\n\n")
        assert ICLTask.from_jsonl(tmp_path / f"{name}.jsonl").kind == kind
    (tmp_path / "empty.jsonl").write_text("\n")
    with pytest.raises(ValueError, match="empty"):
        ICLTask.from_jsonl(tmp_path / "empty.jsonl")


def test_mc_scoring_prefers_predictable_continuation():
    from photon_tpu.eval import ICLTask as JaxTask
    from photon_tpu.eval import run_gauntlet as jax_run
    from photon_tpu_torch.eval import ICLTask, run_gauntlet

    rows = [{"query": "abcd", "choices": ["efgh", "zzzz"], "gold": 0},
            {"query": "mnop", "choices": ["xxxx", "qrst"], "gold": 1}]
    out = run_gauntlet([ICLTask("asc", "multiple_choice", rows, "synthetic", 0.5)], _tok(),
                       _apply, params=None, seq_len=SEQ, batch_size=8)
    assert out["icl/asc/accuracy"] == 1.0
    assert out["icl/category/synthetic"] == 1.0 and out["icl/average"] == 1.0
    assert out == jax_run([JaxTask("asc", "multiple_choice", rows, "synthetic", 0.5)],
                          _jax_tok(), _jax_apply, None, seq_len=SEQ, batch_size=8)


def test_lm_task_logprob():
    from photon_tpu.eval import ICLTask as JaxTask
    from photon_tpu.eval import make_logprob_fn as jax_logprob_fn
    from photon_tpu.eval.icl import evaluate_task as jax_evaluate
    from photon_tpu_torch.eval import ICLTask, evaluate_task, make_logprob_fn

    rows = [{"context": "abc", "continuation": "def"}, {"context": "xy", "continuation": "zq"}]
    res = evaluate_task(ICLTask("lm", "language_modeling", rows), _tok(),
                        make_logprob_fn(_apply, None, SEQ), SEQ, batch_size=4)
    # 4 continuation tokens the model predicts (log p ~ 0), one it does not (-20)
    assert res["logprob_per_token"] == pytest.approx(-4.0, abs=1e-3)
    assert res["accuracy"] == 0.5
    want = jax_evaluate(JaxTask("lm", "language_modeling", rows), _jax_tok(),
                        jax_logprob_fn(_jax_apply, None, SEQ), SEQ, batch_size=4)
    assert res.keys() == want.keys() and res["accuracy"] == want["accuracy"]
    np.testing.assert_allclose(res["logprob_per_token"], want["logprob_per_token"],
                               rtol=0, atol=1e-6)


def test_gauntlet_floor_at_zero():
    from photon_tpu_torch.eval import ICLTask, run_gauntlet

    rows = [{"query": "abcd", "choices": ["zzzz", "efgh"], "gold": 0}]  # the model picks wrong
    out = run_gauntlet([ICLTask("bad", "multiple_choice", rows, "synthetic", 0.5)], _tok(),
                       _apply, None, seq_len=SEQ, batch_size=8)
    assert out["icl/bad/accuracy"] == 0.0
    assert out["icl/category/synthetic"] == 0.0  # clamped, not negative


def test_encode_pair_truncation_matches_jax():
    from photon_tpu.eval.icl import _encode_pair as jax_encode
    from photon_tpu_torch.eval.icl import _encode_pair

    for ctx, cont in (("abc", "de"), ("x" * 40, "yz"), ("ab", "c" * 50), ("", "q")):
        (t, m), (jt, jm) = _encode_pair(_tok(), ctx, cont, 16), jax_encode(_jax_tok(), ctx,
                                                                           cont, 16)
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(m, jm)
        assert t.dtype == np.int32 and m.dtype == np.float32
    with pytest.raises(ValueError, match="nothing"):
        _encode_pair(_tok(), "abc", "", 16)


def test_score_stream_pads_full_batches():
    """Items are packed across rows into full ``[batch_size, seq_len]``
    forwards; the last one is padded with zero rows."""
    from photon_tpu_torch.eval.icl import _encode_pair, _score_stream, make_logprob_fn

    shapes = []
    inner = make_logprob_fn(_apply, None, SEQ)

    def spy(tokens, mask):
        shapes.append((tuple(np.shape(tokens)), int(np.asarray(tokens)[-1].sum())))
        return inner(tokens, mask)

    items = [(*_encode_pair(_tok(), "ab" * i, "cd", SEQ), 2.0) for i in range(1, 6)]
    scores, exact = _score_stream(items, spy, SEQ, 2, length_normalize=True)
    assert [s for s, _ in shapes] == [(2, SEQ)] * 3 and shapes[-1][1] == 0
    assert len(scores) == len(exact) == 5


# ---------------------------------------------------------------------------
# tests/test_gauntlet.py
# ---------------------------------------------------------------------------

def test_parse_reference_task_suite_format():
    import dataclasses

    from photon_tpu.eval.gauntlet import TaskSuite as JaxSuite
    from photon_tpu_torch.eval.gauntlet import TaskSuite

    suite = TaskSuite.from_yaml(PORT_CONFIGS / "tasks_demo.yaml")
    assert {s.label for s in suite.specs} == {"arc_demo", "copa_demo", "lambada_demo",
                                               "gsm_demo"}
    arc = next(s for s in suite.specs if s.label == "arc_demo")
    assert arc.icl_task_type == "multiple_choice" and arc.num_fewshot == (2,)
    assert arc.continuation_delimiter == "\nAnswer: "
    gsm = next(s for s in suite.specs if s.label == "gsm_demo")
    assert gsm.scoreable and gsm.cot_delimiter == "The answer is "
    for name in ("tasks_demo.yaml", "tasks_v0.3.yaml"):
        port = TaskSuite.from_yaml(PORT_CONFIGS / name)
        ref = JaxSuite.from_yaml(JAX_CONFIGS / name)
        assert [dataclasses.astuple(s) for s in port.specs] == \
            [dataclasses.astuple(s) for s in ref.specs]


def test_parse_reference_gauntlet_format():
    from photon_tpu.eval.gauntlet import GauntletConfig as JaxGauntlet
    from photon_tpu_torch.eval.gauntlet import GauntletConfig

    g = GauntletConfig.from_yaml(PORT_CONFIGS / "gauntlet_demo.yaml")
    cats = ["world_knowledge", "commonsense_reasoning", "language_understanding",
            "symbolic_problem_solving"]
    assert g.weighting == "EQUAL" and g.subtract_random_baseline and g.rescale_accuracy
    assert set(g.categories) == set(cats) and g.averages["core_average"] == cats
    assert g.labels_fewshot() == {"arc_demo": 2, "copa_demo": 0, "lambada_demo": 0,
                                  "gsm_demo": 0}
    for name in ("gauntlet_demo.yaml", "eval_gauntlet_v0.3.yaml"):
        port, ref = (GauntletConfig.from_yaml(PORT_CONFIGS / name),
                     JaxGauntlet.from_yaml(JAX_CONFIGS / name))
        assert port.labels_fewshot() == ref.labels_fewshot()
        assert port.averages == ref.averages and port.weighting == ref.weighting
        assert {c: [(b.name, b.random_baseline) for b in bs] for c, bs in port.categories.items()} \
            == {c: [(b.name, b.random_baseline) for b in bs] for c, bs in ref.categories.items()}


def test_suite_loads_all_four_task_types():
    from photon_tpu_torch.eval.gauntlet import TaskSuite

    suite = TaskSuite.from_yaml(PORT_CONFIGS / "tasks_demo.yaml", root_dir=str(TASKS_ROOT))
    tasks, skipped = suite.load_tasks()
    assert {t.name for t in tasks} == {"arc_demo", "copa_demo", "lambada_demo", "gsm_demo"}
    assert {t.kind for t in tasks} == {"multiple_choice", "language_modeling",
                                       "generation_task_with_answers"}
    assert skipped == []
    v03, skipped = TaskSuite.from_yaml(PORT_CONFIGS / "tasks_v0.3.yaml",
                                       root_dir=str(TASKS_ROOT)).load_tasks()
    assert len(v03) == 32 and skipped == []
    assert {t.kind for t in v03} == {"multiple_choice", "schema", "language_modeling",
                                     "generation_task_with_answers"}


def test_suite_type_mismatch_raises(tmp_path):
    from photon_tpu_torch.eval.gauntlet import TaskSuite

    (tmp_path / "t.jsonl").write_text(json.dumps({"context": "a", "continuation": "b"}))
    (tmp_path / "suite.yaml").write_text(
        "icl_tasks:\n  - label: t\n    dataset_uri: t.jsonl\n"
        "    icl_task_type: multiple_choice\n")
    with pytest.raises(ValueError, match="look like"):
        TaskSuite.from_yaml(tmp_path / "suite.yaml").load_tasks()


def test_fewshot_context_assembly():
    from photon_tpu.eval.icl import ICLTask as JaxTask
    from photon_tpu_torch.eval.icl import ICLTask

    rows = [{"query": "q0", "choices": ["a", "b"], "gold": 0},
            {"query": "q1", "choices": ["a", "b"], "gold": 1},
            {"query": "q2", "choices": ["a", "b"], "gold": 0}]
    kw = dict(num_fewshot=2, continuation_delimiter=": ", example_delimiter="\n")
    task = ICLTask("t", "multiple_choice", rows, **kw)
    assert task.build_context(1) == "q0: a\nq2: a\nq1: "  # the scored row is no shot
    gen = [{"context": f"c{i}", "answer": f"a{i}"} for i in range(3)]
    kw.update(cot_delimiter="A: ", question_prelimiter="Q: ")
    for args in (("t", "multiple_choice", rows), ("g", "generation_task_with_answers", gen)):
        for i in range(3):
            assert ICLTask(*args, **kw).build_context(i) == JaxTask(*args, **kw).build_context(i)


def test_batched_mc_matches_per_row_dispatch():
    """Scoring across row boundaries in full batches gives the per-row
    answer, also with a batch smaller than a row's choice count."""
    from photon_tpu_torch.eval.icl import ICLTask, evaluate_task, make_logprob_fn

    rows = [{"query": "abcd", "choices": ["efgh", "zzzz", "qqqq"], "gold": 0},
            {"query": "mnop", "choices": ["xxxx", "qrst", "aaaa"], "gold": 1},
            {"query": "stuv", "choices": ["wxyz", "bbbb", "cccc"], "gold": 0}]
    task = ICLTask("asc", "multiple_choice", rows)
    fn = make_logprob_fn(_apply, None, SEQ)
    assert evaluate_task(task, _tok(), fn, SEQ, batch_size=2)["accuracy"] == 1.0
    assert evaluate_task(task, _tok(), fn, SEQ, batch_size=8)["accuracy"] == 1.0


def test_aggregate_subtract_and_rescale():
    from photon_tpu_torch.eval.gauntlet import Benchmark, GauntletConfig

    out = GauntletConfig(categories={"cat_a": [Benchmark("b1", 0, 0.25)]}).aggregate(
        {"b1": 0.625})
    assert out["gauntlet/cat_a/b1"] == pytest.approx(0.5)  # (0.625 - 0.25) / 0.75
    assert out["gauntlet/category/cat_a"] == pytest.approx(0.5)
    assert out["gauntlet/average"] == pytest.approx(0.5)


def test_aggregate_named_averages_and_floor():
    from photon_tpu.eval.gauntlet import Benchmark as JaxBench
    from photon_tpu.eval.gauntlet import GauntletConfig as JaxGauntlet
    from photon_tpu_torch.eval.gauntlet import Benchmark, GauntletConfig

    def make(cls, bench):
        return cls(categories={"good": [bench("b1", 0, 0.5)], "bad": [bench("b2", 0, 0.5)],
                               "other": [bench("b3", 0, 0.0), bench("b4", 0, 0.0, 3.0)]},
                   averages={"core": ["good", "bad"], "none": ["missing"]},
                   weighting="SCALED")

    raw = {"b1": 1.0, "b2": 0.2, "b3": 0.4, "b4": 0.8, "b9": 0.5}
    out = make(GauntletConfig, Benchmark).aggregate(raw)
    assert out["gauntlet/good/b1"] == pytest.approx(1.0)
    assert out["gauntlet/bad/b2"] == 0.0  # below the baseline: floored, not negative
    assert out["gauntlet/core"] == pytest.approx(0.5) and "gauntlet/none" not in out
    assert out["gauntlet/category/other"] == pytest.approx((0.4 + 3 * 0.8) / 4)
    assert out == make(JaxGauntlet, JaxBench).aggregate(raw)
    del raw["b4"]
    assert make(GauntletConfig, Benchmark).aggregate(raw)["gauntlet/missing_benchmarks"] == 1.0


def test_demo_corpus_end_to_end():
    from photon_tpu.eval.gauntlet import run_gauntlet_suite as jax_suite
    from photon_tpu_torch.eval.gauntlet import run_gauntlet_suite

    kw = dict(seq_len=128, batch_size=8)
    out = run_gauntlet_suite(PORT_CONFIGS / "tasks_demo.yaml", PORT_CONFIGS / "gauntlet_demo.yaml",
                             _tok(), _apply, params=None, root_dir=str(TASKS_ROOT), **kw)
    for key in ("icl/arc_demo/accuracy", "icl/copa_demo/accuracy",
                "icl/lambada_demo/logprob_per_token", "gauntlet/category/world_knowledge",
                "gauntlet/core_average", "gauntlet/average", "icl/gsm_demo/accuracy"):
        assert key in out, key
    assert "gauntlet/skipped_tasks" not in out  # all four types score
    assert 0.0 <= out["icl/arc_demo/accuracy"] <= 1.0
    want = jax_suite(JAX_CONFIGS / "tasks_demo.yaml", JAX_CONFIGS / "gauntlet_demo.yaml",
                     _jax_tok(), _jax_apply, params=None, **kw)
    assert out.keys() == want.keys()
    for k in out:
        np.testing.assert_allclose(out[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def _tiny_model(seed=3, max_seq=128, alibi=False):
    """A tiny byte-vocab MPT in both packages with the same weights."""
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.config.schema import Config as JaxConfig
    from photon_tpu.models.mpt import MPTModel as JaxModel
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.codec.params import params_from_numpy
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.models.mpt import MPTModel

    jcfg = JaxConfig()
    m = jcfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 32, 2, 4, max_seq, 260
    m.attn_impl, m.compute_dtype, m.alibi, m.learned_pos_emb = "xla", "float32", alibi, not alibi
    jcfg.validate()
    mc = Config.from_dict(jcfg.to_dict()).validate("cpu").model
    jp = init_params(jcfg.model, seed=seed)
    meta, arrays = params_to_ndarrays(jp)
    tp = params_from_numpy(meta.names, arrays, mc, "cpu")
    jm, tm = JaxModel(jcfg.model), MPTModel(mc)
    return (jcfg.model, jp, lambda p, t: jm.apply({"params": p}, t)), \
        (mc, tp, lambda p, t: tm(p, t))


@pytest.mark.parametrize("alibi", [False, True])
def test_demo_corpus_matches_jax_on_shared_weights(alibi):
    """A real (tiny) model: MC, schema and LM scores through the logprob
    forward, generation through the KV cache (``model_cfg``)."""
    from photon_tpu.eval.gauntlet import run_gauntlet_suite as jax_suite
    from photon_tpu_torch.eval.gauntlet import run_gauntlet_suite

    (jmc, jp, japply), (mc, tp, tapply) = _tiny_model(alibi=alibi)
    kw = dict(seq_len=128, batch_size=4)
    out = run_gauntlet_suite(PORT_CONFIGS / "tasks_demo.yaml", PORT_CONFIGS / "gauntlet_demo.yaml",
                             _tok(), tapply, tp, root_dir=str(TASKS_ROOT), model_cfg=mc, **kw)
    want = jax_suite(JAX_CONFIGS / "tasks_demo.yaml", JAX_CONFIGS / "gauntlet_demo.yaml",
                     _jax_tok(), japply, jp, model_cfg=jmc, **kw)
    assert out.keys() == want.keys()
    for k in out:
        tol = LOGPROB_ATOL if k.endswith("logprob_per_token") else 0.0
        np.testing.assert_allclose(out[k], want[k], rtol=0, atol=tol, err_msg=k)


def test_generation_scorer_matches_jax_and_full_forward():
    """``_evaluate_generation`` with the KV-cache decoder and with the
    full-forward decoder, against JAX's, on rows whose answers the tiny
    model does and does not produce."""
    from photon_tpu.eval.icl import ICLTask as JaxTask
    from photon_tpu.eval.icl import _evaluate_generation as jax_gen
    from photon_tpu.models.decode import make_cached_generate_fn as jax_cached
    from photon_tpu_torch.eval.icl import ICLTask, _evaluate_generation, make_generate_fn
    from photon_tpu_torch.models.decode import make_cached_generate_fn

    (jmc, jp, japply), (mc, tp, tapply) = _tiny_model(seed=5, max_seq=64)
    probe = make_cached_generate_fn(mc, tp)
    rows = []
    for i, ctx in enumerate(["abc", "hello there", "x", "Q: 2+2?", "zz top"]):
        toks = np.zeros((1, 64), np.int32)
        ids = _tok().encode(ctx)
        toks[0, :len(ids)] = ids
        out, _ = probe.many(toks, np.asarray([len(ids)], np.int32), 4)
        made = _tok().decode(out[0, len(ids):len(ids) + 4].tolist()).split("\n")[0]
        rows.append({"context": ctx, "answer": made.strip() if i % 2 == 0 else "nope"})
    kw = dict(max_new_tokens=4, do_normalization=False)
    task, jtask = (ICLTask("g", "generation_task_with_answers", rows, **kw),
                   JaxTask("g", "generation_task_with_answers", rows, **kw))
    cached = _evaluate_generation(task, _tok(), make_cached_generate_fn(mc, tp), 64, 2, rows)
    full = _evaluate_generation(task, _tok(), make_generate_fn(tapply, tp), 64, 2, rows)
    want = jax_gen(jtask, _jax_tok(), jax_cached(jmc, jp), 64, 2, rows)
    assert cached == full == want


def test_normalize_answer_matches_jax():
    from photon_tpu.eval.icl import normalize_answer as jax_norm
    from photon_tpu_torch.eval.icl import normalize_answer

    for text in ("The Answer!", "  an  apple, pie ", "A", "the the end", "42."):
        assert normalize_answer(text) == jax_norm(text)
    assert normalize_answer("The  Eiffel-Tower!") == "eiffeltower"


# ---------------------------------------------------------------------------
# tests/test_eval_cli.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def central_run(tmp_path_factory):
    """A JAX centralized run (2 steps, params dumped) over a byte-vocab
    model, a PTS set converted from text, round checkpoints (the second
    with momenta) and a resolved YAML that reads the set."""
    from photon_tpu.centralized import run_centralized
    from photon_tpu.checkpoint import FileStore, npz_to_arrays
    from photon_tpu.checkpoint.server import ServerCheckpointManager
    from photon_tpu.train.param_ops import extend_with_momenta
    from photon_tpu_torch.data.convert import convert_corpus
    from tests.test_centralized import _cfg

    tmp = tmp_path_factory.mktemp("warm")
    cfg = _cfg(tmp)
    cfg.model.vocab_size, cfg.model.max_seq_len = 260, 32
    cfg.validate()
    run_centralized(cfg, total_steps=2, dump_params=True)
    meta, arrays = npz_to_arrays((tmp / "save" / "params_final.npz").read_bytes())
    mgr = ServerCheckpointManager(FileStore(tmp / "save" / "store"), "fed-run")
    mgr.save_round(1, meta, [a * 0.5 for a in arrays])
    mgr.save_round(2, *extend_with_momenta(meta, arrays, [a + 1 for a in arrays],
                                           [a * 2 for a in arrays]))
    text = (ROOT / "README.md").read_text().splitlines()[:400]
    convert_corpus(text, tmp / "data", _tok(), n_clients=2, seq_len=32, split="val")
    cfg.dataset.synthetic = False
    cfg.to_yaml(tmp / "cfg.yaml")
    return cfg, tmp


def _both_clis(args, capsys):
    """The JAX CLI's and the port's (``--device cpu``) JSON lines."""
    from photon_tpu.eval.__main__ import main as jax_main
    from photon_tpu_torch.eval.__main__ import main

    jax_main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got_ret = main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() == got_ret.keys()
    return got, want


def _assert_close(got, want):
    for k in got:
        if k == "eval/time":
            continue
        rtol = LOSS_RTOL if k.startswith("eval/") else 0.0
        atol = LOGPROB_ATOL if k.endswith("logprob_per_token") else 0.0
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def test_warm_start_loads_latest_central_params(central_run):
    from photon_tpu.checkpoint import FileStore as JaxStore
    from photon_tpu.federation.server import centralized_warm_start as jax_warm
    from photon_tpu_torch.checkpoint import FileStore
    from photon_tpu_torch.federation.server import centralized_warm_start

    cfg, tmp = central_run
    meta, params = centralized_warm_start(FileStore(tmp / "save" / "store"), cfg.run_uuid)
    jmeta, jparams = jax_warm(JaxStore(tmp / "save" / "store"), cfg.run_uuid)
    assert meta.names == jmeta.names and len(params) == len(meta.names)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(params, jparams))
    with pytest.raises(FileNotFoundError):
        centralized_warm_start(FileStore(tmp / "save" / "store"), "no-such-run")


def test_eval_cli_npz_and_icl(central_run, tmp_path, capsys):
    cfg, tmp = central_run
    rows = [{"query": "abc", "choices": ["d", "z"], "gold": 0},
            {"query": "hello", "choices": [" world", "!!"], "gold": 0},
            {"query": "x", "choices": ["y", "q", "r"], "gold": 2}]
    (tmp_path / "toy.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    (tmp_path / "lm.jsonl").write_text(json.dumps({"context": "ab", "continuation": "cd"}))
    got, want = _both_clis([
        "--params-npz", str(tmp / "save" / "params_final.npz"), "--config", str(tmp / "cfg.yaml"),
        "--dataset", "", "--icl-tasks", str(tmp_path / "*.jsonl"), "--tokenizer", "byte-fallback",
    ], capsys)
    assert "icl/toy/accuracy" in got and 0.0 <= got["icl/toy/accuracy"] <= 1.0
    assert "icl/lm/logprob_per_token" in got and "icl/average" in got
    _assert_close(got, want)


def test_federated_init_from_run(central_run):
    """``photon.init_from_run`` warm-starts the port's federated globals
    from the centralized run the JAX package wrote."""
    from photon_tpu_torch.config.schema import Config
    from photon_tpu_torch.federated import build_app

    cfg, tmp = central_run
    fed = Config.from_dict(cfg.to_dict())
    fed.run_uuid = "fed-from-central"
    fed.dataset.synthetic = True
    fed.photon.checkpoint = False
    fed.photon.init_from_run = cfg.run_uuid
    fed.fl.n_total_clients = fed.fl.n_clients_per_round = 2
    fed.validate("cpu")
    app = build_app(fed, device="cpu")
    try:
        from photon_tpu_torch.checkpoint import FileStore
        from photon_tpu_torch.federation.server import centralized_warm_start

        meta, params = centralized_warm_start(FileStore(tmp / "save" / "store"), cfg.run_uuid)
        assert app.metadata.names == meta.names
        for a, b in zip(app.strategy.current_parameters, params):
            np.testing.assert_array_equal(a, b)
    finally:
        app.driver.shutdown()


def test_eval_cli_store_round_source(central_run, capsys):
    """``--store/--run`` without ``--round`` loads the centralized
    checkpoint; with nothing to evaluate the line is ``{}``."""
    from photon_tpu_torch.eval.__main__ import main

    cfg, tmp = central_run
    main(["--store", str(tmp / "save" / "store"), "--run", cfg.run_uuid,
          "--config", str(tmp / "cfg.yaml"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == "{}"


@pytest.mark.parametrize("rnd", [-1, 1])
def test_eval_cli_round_dataset_and_suite(central_run, capsys, rnd):
    """A server round (round 2 carries momenta, which are split off) on
    the converted set and the demo suite: the JAX CLI's keys and values."""
    cfg, tmp = central_run
    got, want = _both_clis([
        "--store", str(tmp / "save" / "store"), "--run", "fed-run", "--round", str(rnd),
        "--config", str(tmp / "cfg.yaml"), "--dataset", str(tmp / "data"), "--eval-batches", "3",
        "--tasks-yaml", str(JAX_CONFIGS / "tasks_demo.yaml"),
        "--gauntlet-yaml", str(JAX_CONFIGS / "gauntlet_demo.yaml"),
        "--tasks-root", str(TASKS_ROOT), "--icl-max-rows", "3",
    ], capsys)
    assert {"eval/loss", "eval/perplexity", "eval/tokens", "gauntlet/average"} <= got.keys()
    assert got["eval/tokens"] == 3 * cfg.train.global_batch_size * (cfg.model.max_seq_len - 1)
    _assert_close(got, want)


def test_eval_cli_device_rules(central_run, monkeypatch):
    """``cuda`` is the default and raises without a card; the byte
    tokenizer must fit the model's vocabulary; HF tokenizers are
    refused."""
    from photon_tpu_torch.eval.__main__ import main

    cfg, tmp = central_run
    args = ["--params-npz", str(tmp / "save" / "params_final.npz"), "--config",
            str(tmp / "cfg.yaml")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args)
    with pytest.raises(NotImplementedError, match="byte-fallback"):
        main(args + ["--device", "cpu", "--icl-tasks", "x.jsonl", "--tokenizer", "gpt2"])
    small = cfg.to_dict()
    small["model"]["vocab_size"] = 64
    import yaml

    (tmp / "small.yaml").write_text(yaml.safe_dump(small))
    with pytest.raises(SystemExit, match="vocab"):
        main(["--store", str(tmp / "save" / "store"), "--run", cfg.run_uuid, "--config",
              str(tmp / "small.yaml"), "--device", "cpu", "--icl-tasks", "x.jsonl"])


# ---------------------------------------------------------------------------
# tests/test_metrics.py (unigram cases)
# ---------------------------------------------------------------------------

def test_pure_unigram_ce_uniform():
    from photon_tpu.metrics import pure_unigram_cross_entropy as jax_uni
    from photon_tpu_torch.metrics.unigram import pure_unigram_cross_entropy

    vocab = 16
    logp = np.full(vocab, -np.log(vocab), np.float32)
    targets = np.random.default_rng(0).integers(0, vocab, (4, 8))
    ce = float(pure_unigram_cross_entropy(torch.from_numpy(targets), torch.from_numpy(logp)))
    np.testing.assert_allclose(ce, np.log(vocab), rtol=1e-6)
    np.testing.assert_allclose(ce, float(jax_uni(targets, logp)), rtol=1e-6)


def test_normalized_ce_is_difference():
    import jax.numpy as jnp

    from photon_tpu.metrics import model_cross_entropy as jax_ce
    from photon_tpu.metrics import unigram_normalized_cross_entropy as jax_norm
    from photon_tpu_torch.metrics.unigram import (
        model_cross_entropy,
        pure_unigram_cross_entropy,
        unigram_normalized_cross_entropy,
    )

    rng = np.random.default_rng(1)
    vocab = 16
    logits = rng.normal(size=(2, 8, vocab)).astype(np.float32)
    targets = rng.integers(0, vocab, (2, 8))
    logp = np.log(rng.dirichlet(np.ones(vocab))).astype(np.float32)
    tl, tt, tp = map(torch.from_numpy, (logits, targets, logp))
    norm = float(unigram_normalized_cross_entropy(tl, tt, tp))
    ce = float(model_cross_entropy(tl, tt))
    np.testing.assert_allclose(norm, ce - float(pure_unigram_cross_entropy(tt, tp)), rtol=1e-6)
    np.testing.assert_allclose(ce, float(jax_ce(jnp.asarray(logits), jnp.asarray(targets))),
                               rtol=1e-6)
    np.testing.assert_allclose(norm, float(jax_norm(jnp.asarray(logits), jnp.asarray(targets),
                                                    jnp.asarray(logp))), rtol=1e-6, atol=1e-6)


def test_perfect_model_beats_unigram():
    from photon_tpu_torch.metrics.unigram import unigram_normalized_cross_entropy

    vocab = 8
    targets = torch.tensor([[1, 2, 3]])
    logits = torch.full((1, 3, vocab), -100.0)
    for i, t in enumerate(targets[0]):
        logits[0, i, t] = 100.0
    logp = torch.log(torch.full((vocab,), 1.0 / vocab))
    assert float(unigram_normalized_cross_entropy(logits, targets, logp)) < -1.0


def test_accumulator_token_weighted():
    from collections import Counter

    from photon_tpu.metrics import UnigramMetricAccumulator as JaxAcc
    from photon_tpu_torch.metrics.unigram import (
        UNIGRAM_METRIC_NAMES,
        UnigramMetricAccumulator,
        unigram_log_probs_from_counts,
    )

    vocab = 8
    logp = unigram_log_probs_from_counts(Counter({i: i + 1 for i in range(vocab)}), vocab)
    acc, ref = UnigramMetricAccumulator(unigram_log_probs=logp), JaxAcc(unigram_log_probs=logp)
    assert acc.compute() == {}
    rng = np.random.default_rng(2)
    for n in (4, 12):  # different batch sizes: the weighting matters
        logits = rng.normal(size=(1, n, vocab)).astype(np.float32)
        targets = rng.integers(0, vocab, (1, n))
        acc.update(logits, targets)
        ref.update(logits, targets)
    out, want = acc.compute(), ref.compute()
    assert set(out) == set(UNIGRAM_METRIC_NAMES) and acc.n_tokens == 16
    np.testing.assert_allclose(out["UnigramNormalizedLanguageCrossEntropy"],
                               out["LanguageCrossEntropy"] - out["PureUnigramCrossEntropy"],
                               rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(out[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
