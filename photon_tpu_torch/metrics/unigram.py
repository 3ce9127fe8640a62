"""Unigram-normalized language-model metrics.

The port of ``photon_tpu/metrics/unigram.py``: metrics that compare
models across vocabularies by subtracting the cross-entropy a unigram
model reaches on the same tokens. Functions over torch tensors
(``logits [..., V]``, integer ``targets [...]``, ``unigram_log_probs
[V]``) and a token-weighted streaming accumulator for the host.
"""

from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from photon_tpu_torch.data.unigram import probability_tensor


def pure_unigram_cross_entropy(targets: torch.Tensor,
                               unigram_log_probs: torch.Tensor) -> torch.Tensor:
    """Mean CE of the unigram model on ``targets``."""
    return -unigram_log_probs[targets.long()].mean()


def model_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE of ``logits`` (computed in fp32) on ``targets``."""
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           targets.long().reshape(-1))


def unigram_normalized_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                                     unigram_log_probs: torch.Tensor) -> torch.Tensor:
    """Model CE − unigram CE: negative is better than the unigram model by
    that many nats a token, comparable across vocabularies."""
    return model_cross_entropy(logits, targets) - pure_unigram_cross_entropy(
        targets, unigram_log_probs)


UNIGRAM_METRIC_NAMES = (
    "PureUnigramCrossEntropy",
    "UnigramNormalizedLanguageCrossEntropy",
    "UnigramNormalizedPerplexity",
    "LanguageCrossEntropy",
    "LanguagePerplexity",
)


@dataclasses.dataclass
class UnigramMetricAccumulator:
    """Token-weighted sums over eval batches (``update``, then
    ``compute``)."""

    unigram_log_probs: np.ndarray
    ce_sum: float = 0.0
    uni_sum: float = 0.0
    n_tokens: int = 0

    def update(self, logits, targets) -> None:
        logits, targets = torch.as_tensor(logits), torch.as_tensor(targets)
        logp = torch.as_tensor(self.unigram_log_probs, device=targets.device)
        n = targets.numel()
        self.ce_sum += float(model_cross_entropy(logits, targets)) * n
        self.uni_sum += float(pure_unigram_cross_entropy(targets, logp)) * n
        self.n_tokens += n

    def compute(self) -> dict[str, float]:
        if self.n_tokens == 0:
            return {}
        ce = self.ce_sum / self.n_tokens
        uni = self.uni_sum / self.n_tokens
        norm = ce - uni
        return {
            "LanguageCrossEntropy": ce,
            "LanguagePerplexity": float(np.exp(min(ce, 30.0))),
            "PureUnigramCrossEntropy": uni,
            "UnigramNormalizedLanguageCrossEntropy": norm,
            "UnigramNormalizedPerplexity": float(np.exp(np.clip(norm, -30.0, 30.0))),
        }


def unigram_log_probs_from_counts(counts: Counter, vocab_size: int,
                                  smoothing: float = 1.0) -> np.ndarray:
    return np.log(probability_tensor(counts, vocab_size, smoothing))
