"""Per-client 1-gram (token frequency) dictionaries: the parts of
``photon_tpu/data/unigram.py`` that federated eval reads. A client's
``unigram_freq.json`` (``{token: count}``) sits beside its train split."""

from __future__ import annotations

import json
import pathlib
from collections import Counter

import numpy as np

FREQ_FILENAME = "unigram_freq.json"


def load_freq_dict(path: str | pathlib.Path) -> Counter:
    d = json.loads(pathlib.Path(path).read_text())
    return Counter({int(k): int(v) for k, v in d.items()})


def probability_tensor(counts: Counter, vocab_size: int, smoothing: float = 1.0) -> np.ndarray:
    """Laplace-smoothed unigram probabilities, ``[vocab] float32``."""
    probs = np.full(vocab_size, smoothing, np.float64)
    for tok, n in counts.items():
        if 0 <= tok < vocab_size:
            probs[tok] += n
    probs /= probs.sum()
    return probs.astype(np.float32)
