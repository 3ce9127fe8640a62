"""Deterministic, resumable streaming loader over PTS shards.

The port of ``photon_tpu/data/loader.py``: with the same seed it gives the
same batches in the same order, and resumes from the same state dict.

Role parity with mosaicml-streaming's ``StreamingDataset`` as photon uses it
(shuffle_seed / shuffle_block semantics,
``photon/clients/llm_config_functions.py:532-606``): the global sample order
for an epoch is a pure function of ``(seed, epoch)``, and the loader resumes
from ``(epoch, sample_in_epoch)`` exactly — the property photon's
``reset_dataset_state`` / client-timestamp bookkeeping depends on. (The
reference's ``num_canonical_nodes`` — order invariance under physical node
count — has no analog here: every client cid owns its own loader, so order
is node-count-invariant by construction.)

Shuffle model (block shuffle, MDS-like): the shard list is permuted, then
samples are shuffled inside fixed-size blocks of the concatenated permuted
stream. Order is computed lazily per block, O(block) memory.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from photon_tpu_torch.data.shard_format import ShardedDataset


def _rng(seed: int, *salt: int) -> np.random.Generator:
    h = hashlib.sha256(np.asarray([seed, *salt], np.int64).tobytes()).digest()
    return np.random.default_rng(np.frombuffer(h[:16], np.uint64))


@dataclass
class LoaderState:
    """Resumable position (reference analog: StreamingDataset state_dict)."""

    epoch: int = 0
    sample_in_epoch: int = 0

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "sample_in_epoch": self.sample_in_epoch}

    @classmethod
    def from_dict(cls, d: dict) -> "LoaderState":
        return cls(int(d["epoch"]), int(d["sample_in_epoch"]))


class StreamingLoader:
    """Batched iterator of ``[batch_size, seq_len] int32`` token arrays.

    Infinite: crossing an epoch boundary bumps ``epoch`` and reshuffles.
    ``drop_last`` semantics: a tail smaller than ``batch_size`` rolls into the
    next epoch's order (batches always full — jit-static shapes).
    """

    def __init__(
        self,
        dataset: ShardedDataset | str,
        batch_size: int,
        seed: int = 17,
        shuffle: bool = True,
        shuffle_block_size: int = 1 << 16,
        state: LoaderState | None = None,
    ) -> None:
        self.ds = ShardedDataset(dataset) if isinstance(dataset, (str, bytes)) or hasattr(dataset, "__fspath__") else dataset
        if len(self.ds) == 0:
            raise ValueError("empty dataset")
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.shuffle = shuffle
        self.block = int(shuffle_block_size)
        self.state = state or LoaderState()
        self._epoch_cache: tuple[int, np.ndarray] | None = None  # (epoch, shard order)
        self._block_cache: dict[tuple[int, int], np.ndarray] = {}  # (epoch, block) -> perm

    # -- epoch order -----------------------------------------------------
    def _shard_order(self, epoch: int) -> np.ndarray:
        if self._epoch_cache and self._epoch_cache[0] == epoch:
            return self._epoch_cache[1]
        n_shards = len(self.ds.shard_sizes)
        order = np.arange(n_shards)
        if self.shuffle:
            _rng(self.seed, epoch, 0).shuffle(order)
        self._epoch_cache = (epoch, order)
        return order

    def _epoch_index(self, epoch: int, pos: np.ndarray) -> np.ndarray:
        """Map epoch-order positions → global dataset indices (lazy, blockwise)."""
        order = self._shard_order(epoch)
        sizes = self.ds.shard_sizes[order]
        starts = np.concatenate([[0], np.cumsum(sizes)])  # in permuted stream
        global_starts = self.ds.shard_offsets[:-1]

        out = np.empty(len(pos), np.int64)
        if not self.shuffle:
            shard_pos = np.searchsorted(starts, pos, side="right") - 1
            for j, (sp, p) in enumerate(zip(shard_pos, pos)):
                out[j] = global_starts[order[sp]] + (p - starts[sp])
            return out

        # block shuffle: permute positions inside each block, then map. The
        # permutation is cached per (epoch, block) — consecutive batch
        # positions share a block, and recomputing a 64k permutation per
        # SAMPLE would dominate the loader hot path.
        for j, p in enumerate(pos):
            b, r = divmod(int(p), self.block)
            perm = self._block_cache.get((epoch, b))
            if perm is None:
                lo = b * self.block
                hi = min(lo + self.block, len(self.ds))
                perm = _rng(self.seed, epoch, 1, b).permutation(hi - lo)
                if len(self._block_cache) > 8:
                    self._block_cache.clear()
                self._block_cache[(epoch, b)] = perm
            lo = b * self.block
            q = lo + perm[r]
            sp = int(np.searchsorted(starts, q, side="right") - 1)
            out[j] = global_starts[order[sp]] + (q - starts[sp])
        return out

    # -- iteration -------------------------------------------------------
    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        n = len(self.ds)
        idxs = np.empty(self.batch_size, np.int64)
        filled = 0
        while filled < self.batch_size:
            take = min(self.batch_size - filled, n - self.state.sample_in_epoch)
            pos = np.arange(self.state.sample_in_epoch, self.state.sample_in_epoch + take)
            idxs[filled : filled + take] = self._epoch_index(self.state.epoch, pos)
            filled += take
            self.state.sample_in_epoch += take
            if self.state.sample_in_epoch >= n:
                self.state = LoaderState(self.state.epoch + 1, 0)
        return self.ds.batch(idxs)

    # -- resume ----------------------------------------------------------
    def state_dict(self) -> dict:
        return self.state.to_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = LoaderState.from_dict(d)

    def reset(self) -> None:
        """Rewind to the start of the stream — evals must score the SAME
        fixed window every time (reference evaluates a fixed set per round;
        a persistent loader would otherwise drift forward each call)."""
        self.state = LoaderState()

    def skip_samples(self, n: int) -> None:
        """Fast-forward ``n`` samples without touching data (resume path)."""
        total = self.state.epoch * len(self.ds) + self.state.sample_in_epoch + n
        self.state = LoaderState(total // len(self.ds), total % len(self.ds))


class ConcatDataset:
    """Concatenation of PTS datasets in order (reference:
    ``concatenate_streams`` for centralized training,
    ``llm_config_functions.py:277-317``). Duck-types ``ShardedDataset``
    for :class:`StreamingLoader` (shard_sizes/shard_offsets/batch)."""

    def __init__(self, datasets: list[ShardedDataset]) -> None:
        if not datasets:
            raise ValueError("no datasets")
        self.parts = datasets
        self.seq_len = datasets[0].seq_len
        self.vocab_size = max(d.vocab_size for d in datasets)
        for d in datasets:
            if d.seq_len != self.seq_len:
                raise ValueError("datasets disagree on seq_len")
        self.shard_sizes = np.concatenate([d.shard_sizes for d in datasets])
        self.shard_offsets = np.concatenate([[0], np.cumsum(self.shard_sizes)])
        self._part_starts = np.concatenate([[0], np.cumsum([len(d) for d in datasets])])

    def __len__(self) -> int:
        return int(self._part_starts[-1])

    def __getitem__(self, i: int) -> np.ndarray:
        p = int(np.searchsorted(self._part_starts, i, side="right") - 1)
        return self.parts[p][i - int(self._part_starts[p])]

    def batch(self, idxs: np.ndarray) -> np.ndarray:
        out = np.empty((len(idxs), self.seq_len), np.int32)
        for j, i in enumerate(idxs):
            out[j] = self[int(i)]
        return out


def make_synthetic_dataset(
    path: str,
    n_samples: int = 512,
    seq_len: int = 256,
    vocab_size: int = 50368,
    seed: int = 0,
    samples_per_shard: int = 128,
) -> ShardedDataset:
    """Deterministic Zipf-ish synthetic PTS dataset (tests / no-data bench);
    reference analog: none — photon always needs converted C4."""
    from photon_tpu_torch.data.shard_format import ShardWriter

    rng = np.random.default_rng(seed)
    with ShardWriter(path, seq_len, vocab_size, samples_per_shard) as w:
        for _ in range(n_samples):
            # zipf-distributed ids clipped to vocab — realistic token histogram
            toks = rng.zipf(1.3, size=seq_len).astype(np.int64) % vocab_size
            w.write(toks.astype(np.int64))
    return ShardedDataset(path)
