"""Corpus → per-client PTS shards: the offline dataset pipeline.

The port of ``photon_tpu/data/convert.py``, writing the same bytes:
documents are tokenized, each gets an EOS, the concatenated stream is cut
into exact ``seq_len`` rows (no padding; the tail that does not fill a row
is dropped), and finished rows go round-robin to ``client_{i}/{split}/``
PTS datasets, each with its ``unigram_freq.json``; ``conversion_{split}.json``
sums it up::

    python -m photon_tpu_torch.data.convert --text-files a.txt b.jsonl \\
        --tokenizer byte-fallback --out /data/corpus --n-clients 2 --split val

Local ``.txt`` / ``.jsonl`` files are the only source (one document per
line; jsonl reads its ``text`` field). ``--hf-dataset`` and
``--dataset-key`` read Hugging Face datasets over the network and are
refused. ``--tokenizer`` is ``byte-fallback`` or a local Hugging Face
tokenizer directory (``transformers`` needed; a hub name is refused, it
would need a download). The freq dicts are counted on ``--device``
(default ``cuda``; the CPU only when asked for).
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Iterable, Iterator

import numpy as np
import torch

from photon_tpu_torch.data.shard_format import ShardedDataset, ShardWriter
from photon_tpu_torch.data.unigram import FREQ_FILENAME, count_tokens, save_freq_dict


def iter_text_files(paths: list[str]) -> Iterator[str]:
    for path in paths:
        p = pathlib.Path(path)
        with p.open() as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if p.suffix == ".jsonl":
                    doc = json.loads(line).get("text", "")
                    if doc:
                        yield doc
                else:
                    yield line


class TokenPacker:
    """EOS-joined document stream → exact ``[seq_len]`` samples."""

    def __init__(self, seq_len: int, eos_id: int) -> None:
        self.seq_len = seq_len
        self.eos_id = eos_id
        self._tail = np.zeros(0, np.int64)

    def pack(self, token_ids) -> Iterator[np.ndarray]:
        stream = np.concatenate([self._tail, np.asarray(token_ids, np.int64), [self.eos_id]])
        n_full = len(stream) // self.seq_len
        for i in range(n_full):
            yield stream[i * self.seq_len: (i + 1) * self.seq_len]
        self._tail = stream[n_full * self.seq_len:]


def convert_corpus(
    docs: Iterable[str],
    out_dir: str | pathlib.Path,
    tokenizer,
    n_clients: int = 1,
    seq_len: int = 2048,
    split: str = "train",
    samples_per_shard: int = 4096,
    max_samples: int | None = None,
    device: str | torch.device = "cpu",
) -> dict:
    """Tokenize and pack ``docs``, deal the samples round-robin over
    ``client_{i}/{split}`` PTS datasets, write each one's freq dict
    (counted on ``device``). Returns the summary that also lands in
    ``conversion_{split}.json``."""
    out = pathlib.Path(out_dir)
    vocab = int(tokenizer.vocab_size)
    eos = tokenizer.eos_token_id
    if eos is None:
        raise ValueError("tokenizer has no EOS token")
    writers = [
        ShardWriter(out / f"client_{i}" / split, seq_len, max(vocab, eos + 1), samples_per_shard)
        for i in range(n_clients)
    ]
    packer = TokenPacker(seq_len, eos)
    n_written = 0
    done = False
    for doc in docs:
        for sample in packer.pack(np.asarray(tokenizer.encode(doc), np.int64)):
            writers[n_written % n_clients].write(sample)
            n_written += 1
            if max_samples is not None and n_written >= max_samples:
                done = True
                break
        if done:
            break
    for i, w in enumerate(writers):
        w.close()
        ds = ShardedDataset(out / f"client_{i}" / split)
        save_freq_dict(out / f"client_{i}" / split / FREQ_FILENAME, count_tokens(ds, device))
    summary = {
        "n_clients": n_clients,
        "split": split,
        "seq_len": seq_len,
        "vocab_size": vocab,
        "total_samples": n_written,
        "tokenizer": getattr(tokenizer, "name_or_path", "unknown"),
    }
    (out / f"conversion_{split}.json").write_text(json.dumps(summary, indent=1))
    return summary


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="photon_tpu_torch.data.convert",
                                 description="Convert a corpus to per-client PTS shards")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf-dataset", help="HF dataset name (refused: needs the network)")
    src.add_argument("--dataset-key",
                     help="mC4 registry key (data/constants.py; refused: needs the network)")
    src.add_argument("--text-files", nargs="+", help="local .txt/.jsonl files, one doc per line")
    ap.add_argument("--hf-config", default=None)
    ap.add_argument("--hf-split", default="train")
    ap.add_argument("--tokenizer", default="gpt2")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n-clients", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--split", default=None,
                    help="output folder split name (default 'train')")
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--samples-per-shard", type=int, default=4096)
    ap.add_argument("--device", default="cuda",
                    help="where the freq dicts are counted: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.hf_dataset or args.dataset_key:
        raise NotImplementedError(
            "--hf-dataset and --dataset-key read Hugging Face datasets over the "
            "network, which photon_tpu_torch does not do; convert local files "
            "with --text-files"
        )
    from photon_tpu_torch.data.tokenizer import load_tokenizer
    from photon_tpu_torch.device import resolve_device

    tok = load_tokenizer(args.tokenizer)
    device = resolve_device(args.device)
    summary = convert_corpus(
        iter_text_files(args.text_files),
        args.out,
        tok,
        n_clients=args.n_clients,
        seq_len=args.seq_len,
        split=args.split or "train",
        samples_per_shard=args.samples_per_shard,
        max_samples=args.max_samples,
        device=device,
    )
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
