"""Shard-level partitioning: one PTS dataset → N client views.

The port of ``photon_tpu/data/partition.py``: split one converted dataset
across clients without copying bytes, each client view owning a subset of
the shards (round-robin, the IID partition, or contiguous ranges).
"""

from __future__ import annotations

import numpy as np

from photon_tpu_torch.data.shard_format import ShardedDataset


class ShardSubsetView:
    """A :class:`ShardedDataset` restricted to some of its shards, with
    the surface the loader reads (len, shard sizes and offsets, batch,
    seq_len)."""

    def __init__(self, ds: ShardedDataset, shard_indices: list[int]) -> None:
        if not shard_indices:
            raise ValueError("empty shard subset")
        self.ds = ds
        self.shard_indices = list(shard_indices)
        self.seq_len = ds.seq_len
        self.vocab_size = ds.vocab_size
        self.shard_sizes = ds.shard_sizes[self.shard_indices]
        self.shard_offsets = np.concatenate([[0], np.cumsum(self.shard_sizes)])

    def __len__(self) -> int:
        return int(self.shard_offsets[-1])

    def _to_parent_index(self, i: int) -> int:
        local_shard = int(np.searchsorted(self.shard_offsets, i, side="right") - 1)
        row = i - int(self.shard_offsets[local_shard])
        return int(self.ds.shard_offsets[self.shard_indices[local_shard]]) + row

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self):
            raise IndexError(i)
        return self.ds[self._to_parent_index(i)]

    def batch(self, idxs: np.ndarray) -> np.ndarray:
        parent = np.asarray([self._to_parent_index(int(i)) for i in idxs], np.int64)
        return self.ds.batch(parent)


def partition_shards(ds: ShardedDataset, n_clients: int,
                     mode: str = "round_robin") -> list[ShardSubsetView]:
    """Assign shards to clients ``round_robin`` (IID) or ``contiguous``
    (ordered ranges)."""
    n_shards = len(ds.shard_sizes)
    if n_shards < n_clients:
        raise ValueError(f"{n_shards} shards cannot cover {n_clients} clients; "
                         "re-convert with smaller samples_per_shard")
    if mode == "round_robin":
        groups = [list(range(c, n_shards, n_clients)) for c in range(n_clients)]
    elif mode == "contiguous":
        bounds = np.linspace(0, n_shards, n_clients + 1).astype(int)
        groups = [list(range(bounds[c], bounds[c + 1])) for c in range(n_clients)]
    else:
        raise ValueError(f"unknown partition mode {mode!r}")
    return [ShardSubsetView(ds, g) for g in groups]
