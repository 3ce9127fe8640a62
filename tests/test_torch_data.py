"""The port's offline data pipeline against the JAX package's.

``photon_tpu_torch.data.convert`` (tokenize, pack, deal round-robin,
freq dicts), ``data/unigram.py``, ``data/partition.py``,
``data/constants.py`` and ``data/tokenizer.py``, one counterpart per case
of ``tests/test_data.py`` (convert and unigram cases),
``tests/test_alibi_and_partition.py`` (partition cases) and
``tests/test_dataset_constants.py`` (the table). The gate: on the same
text, the port writes the JAX package's bytes (shards, indexes, freq
json, summary), and the port's loader replays them as JAX's does.
"""

import json
import pathlib
from collections import Counter

import numpy as np
import pytest

from tests._torch_threads import one_torch_thread  # noqa: F401 -- autouse: one torch thread

DOCS = ["hello world", "abcdef" * 10, "xyz" * 30, "more text here", "ünïcödé ✓"] * 6


def _tree_bytes(root: pathlib.Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _write_range_dataset(writer_cls, dataset_cls, path, n=100, seq=16, vocab=1000, per_shard=32):
    """Samples ``[i, i, ...]``: identity is visible from the value."""
    with writer_cls(path, seq, vocab, per_shard) as w:
        for i in range(n):
            w.write(np.full(seq, i, np.int64))
    return dataset_cls(path)


def test_byte_tokenizer_matches_jax_and_refuses_downloads():
    from photon_tpu.data.tokenizer import ByteTokenizer as JaxTok
    from photon_tpu_torch.data.tokenizer import ByteTokenizer, load_tokenizer

    tok, ref = load_tokenizer("byte-fallback"), JaxTok()
    assert isinstance(tok, ByteTokenizer)
    assert (tok.vocab_size, tok.eos_token_id, tok.name_or_path) == \
        (ref.vocab_size, ref.eos_token_id, ref.name_or_path)
    for text in DOCS[:5]:
        ids = tok.encode(text)
        assert ids == ref.encode(text) and tok.decode(ids + [256]) == ref.decode(ids + [256])
    for name in ("gpt2", "EleutherAI/gpt-neox-20b"):
        with pytest.raises(NotImplementedError, match="byte-fallback"):
            load_tokenizer(name)


def test_token_packer_matches_jax():
    from photon_tpu.data.convert import TokenPacker as JaxPacker
    from photon_tpu_torch.data.convert import TokenPacker

    p, ref = TokenPacker(seq_len=5, eos_id=0), JaxPacker(seq_len=5, eos_id=0)
    assert list(p.pack(np.array([1, 2, 3]))) == []  # + eos: 4 tokens, no full row
    out = list(p.pack(np.array([4, 5, 6])))
    assert len(out) == 1
    np.testing.assert_array_equal(out[0], [1, 2, 3, 0, 4])
    np.testing.assert_array_equal(list(p.pack(np.array([7, 8])))[0], [5, 6, 0, 7, 8])
    rng = np.random.default_rng(0)
    p, ref = TokenPacker(seq_len=7, eos_id=9), JaxPacker(seq_len=7, eos_id=9)
    for _ in range(20):
        ids = rng.integers(0, 9, rng.integers(0, 15))
        got, want = list(p.pack(ids)), list(ref.pack(ids))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_clients,seq_len,per_shard,max_samples",
                         [(2, 8, 4096, None), (3, 16, 2, None), (2, 8, 3, 7)])
def test_convert_corpus_byte_identical_to_jax(tmp_path, n_clients, seq_len, per_shard,
                                              max_samples):
    from photon_tpu.data.convert import convert_corpus as jax_convert
    from photon_tpu.data.tokenizer import ByteTokenizer as JaxTok
    from photon_tpu_torch.data.convert import convert_corpus
    from photon_tpu_torch.data.tokenizer import ByteTokenizer

    kw = dict(n_clients=n_clients, seq_len=seq_len, split="train",
              samples_per_shard=per_shard, max_samples=max_samples)
    got = convert_corpus(DOCS, tmp_path / "port", ByteTokenizer(), **kw)
    want = jax_convert(DOCS, tmp_path / "jax", JaxTok(), **kw)
    assert got == want and got["total_samples"] > 0
    port, ref = _tree_bytes(tmp_path / "port"), _tree_bytes(tmp_path / "jax")
    assert sorted(port) == sorted(ref) and port == ref


def test_convert_cli_byte_identical_to_jax(tmp_path, capsys):
    """The two CLIs on the same ``.txt`` and ``.jsonl`` files write the
    same bytes and print the same summary line."""
    from photon_tpu.data.convert import main as jax_main
    from photon_tpu_torch.data.convert import main

    txt = tmp_path / "a.txt"
    txt.write_text("\n".join(DOCS[:10]) + "\n\n")
    jsonl = tmp_path / "b.jsonl"
    jsonl.write_text("\n".join(json.dumps({"text": d}) for d in DOCS[5:15]) + "\n"
                     + json.dumps({"other": 1}) + "\n")
    args = ["--text-files", str(txt), str(jsonl), "--tokenizer", "byte-fallback",
            "--n-clients", "2", "--seq-len", "16", "--split", "val"]
    main(args + ["--out", str(tmp_path / "port"), "--device", "cpu"])
    port_line = capsys.readouterr().out.strip().splitlines()[-1]
    jax_main(args + ["--out", str(tmp_path / "jax")])
    jax_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(port_line) == json.loads(jax_line)
    assert _tree_bytes(tmp_path / "port") == _tree_bytes(tmp_path / "jax")
    assert (tmp_path / "port" / "client_1" / "val" / "unigram_freq.json").exists()


@pytest.mark.parametrize("source,tokenizer", [(["--hf-dataset", "allenai/c4"], "byte-fallback"),
                                              (["--dataset-key", "c4_en"], "byte-fallback"),
                                              (None, "gpt2")])
def test_convert_cli_refuses_what_needs_a_download(tmp_path, source, tokenizer):
    from photon_tpu_torch.data.convert import main

    (tmp_path / "x.txt").write_text("a\n")
    source = source or ["--text-files", str(tmp_path / "x.txt")]
    with pytest.raises(NotImplementedError, match="--text-files|byte-fallback"):
        main(source + ["--tokenizer", tokenizer, "--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_convert_cli_needs_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    import torch

    from photon_tpu_torch.data.convert import main

    (tmp_path / "x.txt").write_text("hello\n" * 20)
    args = ["--text-files", str(tmp_path / "x.txt"), "--tokenizer", "byte-fallback",
            "--n-clients", "1", "--seq-len", "8"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(args + ["--out", str(tmp_path / "gpu")])
    assert not (tmp_path / "gpu").exists()
    assert main(args + ["--out", str(tmp_path / "cpu"), "--device", "cpu"])["total_samples"] == 15


def test_convert_corpus_partitions_and_freqs(tmp_path):
    from photon_tpu_torch.data import ShardedDataset
    from photon_tpu_torch.data.convert import convert_corpus
    from photon_tpu_torch.data.tokenizer import ByteTokenizer
    from photon_tpu_torch.data.unigram import FREQ_FILENAME, count_tokens, load_freq_dict

    summary = convert_corpus(DOCS, tmp_path / "out", ByteTokenizer(), n_clients=2, seq_len=8)
    sizes = []
    for i in range(2):
        split = tmp_path / "out" / f"client_{i}" / "train"
        ds = ShardedDataset(split)
        sizes.append(len(ds))
        assert load_freq_dict(split / FREQ_FILENAME) == count_tokens(ds)
    assert abs(sizes[0] - sizes[1]) <= 1  # round-robin balance
    assert sum(sizes) == summary["total_samples"]


def test_loader_replays_converted_shards_as_jax(tmp_path):
    from photon_tpu.data import ShardedDataset as JaxDataset
    from photon_tpu.data import StreamingLoader as JaxLoader
    from photon_tpu_torch.data import ShardedDataset, StreamingLoader
    from photon_tpu_torch.data.convert import convert_corpus
    from photon_tpu_torch.data.tokenizer import ByteTokenizer

    convert_corpus(DOCS * 4, tmp_path, ByteTokenizer(), n_clients=2, seq_len=16,
                   samples_per_shard=8)
    split = tmp_path / "client_0" / "train"
    for shuffle in (False, True):
        port = StreamingLoader(ShardedDataset(split), batch_size=4, seed=1, shuffle=shuffle)
        ref = JaxLoader(JaxDataset(split), batch_size=4, seed=1, shuffle=shuffle)
        for _ in range(6):
            np.testing.assert_array_equal(next(port), next(ref))


def test_unigram_counts_merge_and_probabilities_match_jax(tmp_path):
    from photon_tpu.data import count_tokens as jax_count
    from photon_tpu.data import merge_freq_dicts as jax_merge
    from photon_tpu.data import probability_tensor as jax_probs
    from photon_tpu.data.unigram import save_freq_dict as jax_save
    from photon_tpu_torch.data import make_synthetic_dataset
    from photon_tpu_torch.data.unigram import (
        count_tokens,
        load_freq_dict,
        merge_freq_dicts,
        probability_tensor,
        save_freq_dict,
    )

    ds = make_synthetic_dataset(tmp_path / "syn", n_samples=8, seq_len=32, vocab_size=64)
    counts = count_tokens(ds)
    assert sum(counts.values()) == 8 * 32 and counts == jax_count(ds)
    merged = merge_freq_dicts([counts, Counter({0: 5})])
    assert merged[0] == counts[0] + 5 and merged == jax_merge([counts, Counter({0: 5})])
    probs = probability_tensor(counts, 64)
    assert probs.shape == (64,) and probs.dtype == np.float32
    np.testing.assert_allclose(probs.sum(), 1.0, rtol=1e-6)
    assert probs.tobytes() == jax_probs(counts, 64).tobytes()
    save_freq_dict(tmp_path / "a" / "f.json", merged)
    jax_save(tmp_path / "b" / "f.json", merged)
    assert (tmp_path / "a" / "f.json").read_bytes() == (tmp_path / "b" / "f.json").read_bytes()
    assert load_freq_dict(tmp_path / "a" / "f.json") == merged


def test_partition_round_robin_matches_jax(tmp_path):
    from photon_tpu.data import ShardedDataset as JaxDataset
    from photon_tpu.data.partition import partition_shards as jax_partition
    from photon_tpu_torch.data import ShardedDataset, ShardWriter, StreamingLoader
    from photon_tpu_torch.data.partition import partition_shards

    ds = _write_range_dataset(ShardWriter, ShardedDataset, tmp_path / "ds", per_shard=10)
    views = partition_shards(ds, 4)
    assert sum(len(v) for v in views) == 100
    seen = sorted(int(v[i][0]) for v in views for i in range(len(v)))
    assert seen == list(range(100))
    ref = jax_partition(JaxDataset(tmp_path / "ds"), 4)
    for v, r in zip(views, ref):
        assert v.shard_indices == r.shard_indices and len(v) == len(r)
        idx = np.arange(len(v))[::-1]
        np.testing.assert_array_equal(v.batch(idx), r.batch(idx))
    batch = next(StreamingLoader(views[0], batch_size=5, seed=0))
    assert batch.shape == (5, 16)


def test_partition_contiguous_and_errors(tmp_path):
    from photon_tpu_torch.data import ShardedDataset, ShardWriter
    from photon_tpu_torch.data.partition import partition_shards

    ds = _write_range_dataset(ShardWriter, ShardedDataset, tmp_path / "ds", n=40, per_shard=10)
    views = partition_shards(ds, 2, mode="contiguous")
    assert [int(v[0][0]) for v in views] == [0, 20]
    with pytest.raises(IndexError):
        views[0][len(views[0])]
    with pytest.raises(ValueError):
        partition_shards(ds, 5)
    with pytest.raises(ValueError):
        partition_shards(ds, 2, mode="banana")


def test_registry_covers_reference_languages():
    from photon_tpu_torch.data.constants import DATASETS_CONSTANTS, MC4_LANGUAGES

    assert set(MC4_LANGUAGES) == {
        "en", "sr", "la", "sw", "ur", "ms", "zh", "it", "es", "de", "el", "ru", "hi"
    }
    assert set(DATASETS_CONSTANTS) == {f"c4_{lang}" for lang in MC4_LANGUAGES}


def test_english_truncated_splits_match_reference():
    from photon_tpu_torch.data.constants import DATASETS_CONSTANTS

    en = DATASETS_CONSTANTS["c4_en"]
    assert en.splits["train_small"].truncated_samples == 100_000
    assert en.splits["val_small"].truncated_samples == 10_000
    assert en.splits["val_xsmall"].truncated_samples == 3_000
    assert en.splits["val_xxsmall"].truncated_samples == 100
    assert en.splits["train"].truncated_samples is None
    assert en.splits["validation"].folder_split == "val"


def test_non_english_languages_have_full_splits_only():
    from photon_tpu_torch.data.constants import DATASETS_CONSTANTS, MC4_LANGUAGES

    for lang in MC4_LANGUAGES:
        if lang == "en":
            continue
        consts = DATASETS_CONSTANTS[f"c4_{lang}"]
        assert set(consts.splits) == {"train", "validation"}
        for sp in consts:
            assert sp.truncated_samples is None and sp.name == lang
            assert sp.path == "allenai/c4"


def test_resolve_split_errors_are_actionable():
    from photon_tpu_torch.data.constants import resolve_split

    with pytest.raises(KeyError, match="unknown dataset key"):
        resolve_split("c4_xx", "train")
    with pytest.raises(KeyError, match="no split"):
        resolve_split("c4_sr", "train_small")
    assert resolve_split("c4_en", "val_small").folder_split == "val_small"


def test_constants_table_equals_jax():
    import dataclasses

    from photon_tpu.data.constants import DATASETS_CONSTANTS as JAX_TABLE
    from photon_tpu_torch.data.constants import DATASETS_CONSTANTS

    assert {k: {s: dataclasses.astuple(v) for s, v in c.splits.items()}
            for k, c in DATASETS_CONSTANTS.items()} == \
        {k: {s: dataclasses.astuple(v) for s, v in c.splits.items()}
         for k, c in JAX_TABLE.items()}
