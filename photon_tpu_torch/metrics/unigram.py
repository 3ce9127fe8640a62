"""Unigram log-probabilities for the unigram-normalized eval metrics (the
numpy part of ``photon_tpu/metrics/unigram.py``)."""

from __future__ import annotations

from collections import Counter

import numpy as np

from photon_tpu_torch.data.unigram import probability_tensor


def unigram_log_probs_from_counts(counts: Counter, vocab_size: int,
                                  smoothing: float = 1.0) -> np.ndarray:
    return np.log(probability_tensor(counts, vocab_size, smoothing))
