"""``photon_tpu_torch.data.tokenizer.load_tokenizer`` on a local Hugging
Face tokenizer directory, against ``photon_tpu.data.tokenizer``.

Nothing is downloaded: a 512-entry byte-level BPE is trained with
``tokenizers`` on the repo's markdown and saved as a
``PreTrainedTokenizerFast`` under ``tmp_path`` (with ``HF_HUB_OFFLINE``
set), three ways: with an EOS, with only a pad token (the fixup promotes
it) and with neither (the fixup adds ``<|endoftext|>``). The two
packages' tokenizers give the same ids, decodes and EOS; ``data.convert``
shards written with it are byte-equal between the packages, and the eval
CLI's line with it equals the JAX CLI's. A hub name is still refused, and
without ``transformers`` the error names the package.
"""

import json
import os
import pathlib
import sys

import numpy as np
import pytest

from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

ROOT = pathlib.Path(__file__).resolve().parent.parent
TEXTS = ["Federated pre-training of MPT decoders on one H100.",
         "ünïcödé ✓ and tabs\tand  double  spaces", "", "x" * 300]
#: how a fixture tokenizer names its special tokens
KINDS = {"eos": {"eos_token": "<|endoftext|>"}, "pad": {"pad_token": "<pad>"}, "none": {}}


def _corpus() -> list[str]:
    lines = []
    for name in ("README.md", "ROADMAP.md", "PERF.md"):
        lines += (ROOT / name).read_text().splitlines()
    return [ln for ln in lines if ln.strip()]


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    root = tmp_path_factory.mktemp("tokenizers")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HF_HUB_OFFLINE", "1")
        bpe = Tokenizer(models.BPE())
        bpe.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        bpe.decoder = decoders.ByteLevel()
        bpe.train_from_iterator(_corpus(), trainers.BpeTrainer(
            vocab_size=512, special_tokens=["<|endoftext|>", "<pad>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False))
        dirs = {}
        for kind, special in KINDS.items():
            PreTrainedTokenizerFast(tokenizer_object=bpe, **special).save_pretrained(root / kind)
            dirs[kind] = str(root / kind)
    return dirs


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


@pytest.mark.parametrize("kind", list(KINDS))
def test_local_directory_matches_jax(tok_dirs, kind):
    """Ids, decodes, vocabulary and EOS equal the JAX package's, the EOS
    fixup included (a pad promoted, or ``<|endoftext|>`` set)."""
    from photon_tpu.data.tokenizer import load_tokenizer as jax_load
    from photon_tpu_torch.data.tokenizer import load_tokenizer

    tok, ref = load_tokenizer(tok_dirs[kind]), jax_load(tok_dirs[kind])
    assert tok.eos_token_id is not None
    assert (tok.eos_token, tok.eos_token_id, tok.vocab_size, len(tok)) == \
        (ref.eos_token, ref.eos_token_id, ref.vocab_size, len(ref))
    assert tok.vocab_size == 512
    want_eos = {"eos": "<|endoftext|>", "pad": "<pad>", "none": "<|endoftext|>"}[kind]
    assert tok.eos_token == want_eos
    for text in TEXTS + _corpus()[:50]:
        ids = tok.encode(text)
        assert ids == ref.encode(text)
        assert tok.decode(ids) == ref.decode(ids)
        assert tok.decode(ids) == text  # byte-level BPE round-trips


def test_convert_shards_byte_equal_to_jax(tok_dirs, tmp_path, capsys):
    from photon_tpu.data.convert import main as jax_main
    from photon_tpu_torch.data.convert import main

    src = tmp_path / "corpus.txt"
    src.write_text("\n".join(_corpus()))
    args = ["--text-files", str(src), "--tokenizer", tok_dirs["pad"], "--n-clients", "2",
            "--seq-len", "32", "--split", "val", "--samples-per-shard", "64"]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    capsys.readouterr()

    def tree(root: pathlib.Path) -> dict[str, bytes]:
        return {str(p.relative_to(root)): p.read_bytes()
                for p in sorted(root.rglob("*")) if p.is_file()}

    got, want = tree(tmp_path / "port"), tree(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) > 4
    for k in want:
        assert got[k] == want[k], k
    summary = json.loads((tmp_path / "port" / "conversion_val.json").read_text())
    assert summary["total_samples"] > 0 and summary["vocab_size"] == 512


def test_eval_cli_with_a_local_tokenizer_matches_jax(tok_dirs, tmp_path, capsys):
    """The eval CLI's ICL tasks tokenized by the directory: the JAX CLI's
    keys and values (the eval test's tolerances)."""
    from photon_tpu.checkpoint import arrays_to_npz
    from photon_tpu.codec.params import params_to_ndarrays
    from photon_tpu.config.schema import Config as JaxConfig
    from photon_tpu.eval.__main__ import main as jax_main
    from photon_tpu.models.mpt import init_params
    from photon_tpu_torch.eval.__main__ import main
    from tests.test_torch_eval import LOGPROB_ATOL

    cfg = JaxConfig()
    m = cfg.model
    m.d_model, m.n_layers, m.n_heads, m.max_seq_len, m.vocab_size = 32, 2, 2, 64, 520
    m.attn_impl, m.compute_dtype = "xla", "float32"
    cfg.validate()
    cfg.to_yaml(str(tmp_path / "cfg.yaml"))
    meta, arrays = params_to_ndarrays(init_params(m, seed=4))
    (tmp_path / "p.npz").write_bytes(arrays_to_npz(meta, arrays))
    rows = [{"query": "The port", "choices": [" runs on", " is a"], "gold": 0},
            {"query": "Federated", "choices": [" pre-training", " serving", " rounds"], "gold": 2}]
    (tmp_path / "mc.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    (tmp_path / "lm.jsonl").write_text(json.dumps({"context": "one H100", "continuation": " card"}))
    args = ["--params-npz", str(tmp_path / "p.npz"), "--config", str(tmp_path / "cfg.yaml"),
            "--dataset", "", "--icl-tasks", str(tmp_path / "*.jsonl"),
            "--tokenizer", tok_dirs["none"]]
    jax_main(args)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(args + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got.keys() == want.keys() and "icl/mc/accuracy" in got and "icl/lm/logprob_per_token" in got
    for k in got:
        np.testing.assert_allclose(got[k], want[k], atol=LOGPROB_ATOL, rtol=0.0, err_msg=k)


def test_hub_names_refused(tmp_path):
    from photon_tpu_torch.data.tokenizer import load_tokenizer

    for name in ("gpt2", "EleutherAI/gpt-neox-20b", str(tmp_path / "missing")):
        with pytest.raises(NotImplementedError, match="download"):
            load_tokenizer(name)


def test_missing_transformers_named(tok_dirs, monkeypatch):
    """Without ``transformers`` (the card's machine), a directory raises an
    error that names the package; nothing falls back to the byte
    tokenizer."""
    from photon_tpu_torch.data.tokenizer import load_tokenizer

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="'transformers'"):
        load_tokenizer(tok_dirs["eos"])
    assert load_tokenizer("byte-fallback").vocab_size == 257
    assert os.environ["HF_HUB_OFFLINE"] == "1"
