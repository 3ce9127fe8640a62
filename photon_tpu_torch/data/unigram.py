"""Per-client 1-gram (token frequency) dictionaries.

The port of ``photon_tpu/data/unigram.py``: the conversion pipeline
counts each client's tokens (on the card, from the convert CLI) and
writes ``unigram_freq.json``
(``{token: count}``, keys sorted) beside its split; federated eval reads
and merges them into the distribution the unigram-normalized metrics
use.
"""

from __future__ import annotations

import json
import pathlib
from collections import Counter

import numpy as np
import torch

from photon_tpu_torch.data.shard_format import ShardedDataset

FREQ_FILENAME = "unigram_freq.json"


def count_tokens(ds: ShardedDataset, device: str | torch.device = "cpu") -> Counter:
    """Token counts over every shard, one histogram (``bincount``) a shard
    on ``device``."""
    c: Counter = Counter()
    for shard_idx in range(len(ds.shard_sizes)):
        tokens = torch.from_numpy(ds._load(shard_idx).astype(np.int64)).to(device)
        counts = torch.bincount(tokens.reshape(-1))
        ids = torch.nonzero(counts).flatten()
        c.update(dict(zip(ids.tolist(), counts[ids].tolist())))
    return c


def save_freq_dict(path: str | pathlib.Path, counts: Counter) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps({str(k): v for k, v in sorted(counts.items())}))


def load_freq_dict(path: str | pathlib.Path) -> Counter:
    d = json.loads(pathlib.Path(path).read_text())
    return Counter({int(k): int(v) for k, v in d.items()})


def merge_freq_dicts(dicts: list[Counter]) -> Counter:
    """Per-client counts → the global distribution."""
    out: Counter = Counter()
    for d in dicts:
        out.update(d)
    return out


def probability_tensor(counts: Counter, vocab_size: int, smoothing: float = 1.0) -> np.ndarray:
    """Laplace-smoothed unigram probabilities, ``[vocab] float32``."""
    probs = np.full(vocab_size, smoothing, np.float64)
    for tok, n in counts.items():
        if 0 <= tok < vocab_size:
            probs[tok] += n
    probs /= probs.sum()
    return probs.astype(np.float32)
