"""PTS — photon token shards: the on-disk pre-tokenized dataset format.

The port of ``photon_tpu/data/shard_format.py``, byte-compatible with it:
a dataset is a directory of fixed-length token-sample shards plus a JSON
index, and a reader ``mmap``s a shard and slices batches with zero
parsing. A batch is gathered and widened to int32 in one pass by the
native helper (``photon_tpu_torch.native.gather_rows``) where its library
builds, and by numpy otherwise, as in the JAX package.

Layout of ``shard_{i:05d}.pts``::

    [32B header][n_samples * seq_len * itemsize token payload]

Header (little-endian u32s): magic 'PTS1', version, n_samples, seq_len,
dtype code (2=uint16, 4=uint32), payload crc32 (0 = unchecked), 2 reserved.

``index.json`` at the dataset root records seq_len/dtype/shards/totals and is
the unit of dataset identity (reference: MDS ``index.json``).
"""

from __future__ import annotations

import json
import mmap
import os
import pathlib
import struct
import zlib
from dataclasses import dataclass

import numpy as np

from photon_tpu_torch import native

_MAGIC = 0x50545331  # "PTS1"
_VERSION = 1
_HEADER = struct.Struct("<8I")
_DTYPES = {2: np.uint16, 4: np.uint32}
_DTYPE_CODES = {np.dtype(np.uint16): 2, np.dtype(np.uint32): 4}

INDEX_NAME = "index.json"


def token_dtype(vocab_size: int) -> np.dtype:
    return np.dtype(np.uint16) if vocab_size <= 1 << 16 else np.dtype(np.uint32)


@dataclass(frozen=True)
class ShardInfo:
    name: str
    n_samples: int


class ShardWriter:
    """Stream fixed-length token samples into shards of ``samples_per_shard``.

    Reference analog: ``MDSWriter`` as driven by ``convert_dataset_hf.py``.
    """

    def __init__(
        self,
        out_dir: str | pathlib.Path,
        seq_len: int,
        vocab_size: int,
        samples_per_shard: int = 4096,
        checksum: bool = True,
    ) -> None:
        self.out_dir = pathlib.Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.seq_len = int(seq_len)
        self.vocab_size = int(vocab_size)
        self.dtype = token_dtype(vocab_size)
        self.samples_per_shard = int(samples_per_shard)
        self.checksum = checksum
        self._buf: list[np.ndarray] = []
        self._shards: list[ShardInfo] = []
        self._closed = False

    def write(self, tokens: np.ndarray) -> None:
        """Append one ``[seq_len]`` sample (or a ``[n, seq_len]`` block)."""
        tokens = np.asarray(tokens)
        if tokens.ndim == 1:
            tokens = tokens[None]
        if tokens.ndim != 2 or tokens.shape[1] != self.seq_len:
            raise ValueError(f"expected [n, {self.seq_len}] tokens, got {tokens.shape}")
        if tokens.size and int(tokens.max()) >= self.vocab_size:
            raise ValueError(f"token id {int(tokens.max())} >= vocab {self.vocab_size}")
        self._buf.append(tokens.astype(self.dtype))
        while sum(b.shape[0] for b in self._buf) >= self.samples_per_shard:
            self._flush(self.samples_per_shard)

    def _flush(self, n: int) -> None:
        stacked = np.concatenate(self._buf, axis=0) if len(self._buf) > 1 else self._buf[0]
        out, rest = stacked[:n], stacked[n:]
        self._buf = [rest] if rest.size else []
        name = f"shard_{len(self._shards):05d}.pts"
        payload = np.ascontiguousarray(out)
        crc = zlib.crc32(payload.tobytes()) if self.checksum else 0
        header = _HEADER.pack(
            _MAGIC, _VERSION, out.shape[0], self.seq_len,
            _DTYPE_CODES[self.dtype], crc, 0, 0,
        )
        tmp = self.out_dir / (name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(header)
            f.write(payload.tobytes())
        os.rename(tmp, self.out_dir / name)
        self._shards.append(ShardInfo(name, out.shape[0]))

    def close(self) -> dict:
        """Flush the tail shard and write ``index.json``; returns the index."""
        if self._closed:
            raise RuntimeError("writer already closed")
        self._closed = True
        n_tail = sum(b.shape[0] for b in self._buf)
        if n_tail:
            self._flush(n_tail)
        index = {
            "format": "pts",
            "version": _VERSION,
            "seq_len": self.seq_len,
            "vocab_size": self.vocab_size,
            "dtype": str(np.dtype(self.dtype)),
            "shards": [{"name": s.name, "n_samples": s.n_samples} for s in self._shards],
            "total_samples": sum(s.n_samples for s in self._shards),
        }
        tmp = self.out_dir / (INDEX_NAME + ".tmp")
        tmp.write_text(json.dumps(index, indent=1))
        os.rename(tmp, self.out_dir / INDEX_NAME)
        return index

    def __enter__(self) -> "ShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        if not self._closed and exc[0] is None:
            self.close()


class ShardedDataset:
    """mmap-backed random access over a PTS directory.

    ``ds[i]`` returns sample ``i`` as ``[seq_len] int32`` in global order
    (shards concatenated in index order). Maps are opened lazily and kept.
    """

    def __init__(self, path: str | pathlib.Path, validate: bool = False) -> None:
        self.path = pathlib.Path(path)
        index_file = self.path / INDEX_NAME
        if not index_file.exists():
            raise FileNotFoundError(f"no {INDEX_NAME} under {self.path}")
        self.index = json.loads(index_file.read_text())
        if self.index.get("format") != "pts":
            raise ValueError(f"not a PTS dataset: {self.path}")
        self.seq_len = int(self.index["seq_len"])
        self.vocab_size = int(self.index["vocab_size"])
        self.dtype = np.dtype(self.index["dtype"])
        self.shard_sizes = np.asarray([s["n_samples"] for s in self.index["shards"]], np.int64)
        self.shard_offsets = np.concatenate([[0], np.cumsum(self.shard_sizes)])
        self._maps: dict[int, np.ndarray] = {}
        if validate:
            for i in range(len(self.shard_sizes)):
                self._load(i, validate=True)

    def __len__(self) -> int:
        return int(self.shard_offsets[-1])

    def _load(self, shard_idx: int, validate: bool = False) -> np.ndarray:
        arr = self._maps.get(shard_idx)
        if arr is not None:
            return arr
        name = self.index["shards"][shard_idx]["name"]
        with open(self.path / name, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, version, n_samples, seq_len, code, crc, _, _ = _HEADER.unpack_from(mm, 0)
        if magic != _MAGIC or version != _VERSION:
            raise ValueError(f"bad shard header in {name}")
        if seq_len != self.seq_len or n_samples != self.shard_sizes[shard_idx]:
            raise ValueError(f"shard {name} disagrees with index")
        arr = np.frombuffer(mm, _DTYPES[code], count=n_samples * seq_len, offset=_HEADER.size)
        arr = arr.reshape(n_samples, seq_len)
        if validate and crc and zlib.crc32(arr.tobytes()) != crc:
            raise ValueError(f"checksum mismatch in {name}")
        self._maps[shard_idx] = arr
        return arr

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self):
            raise IndexError(i)
        shard_idx = int(np.searchsorted(self.shard_offsets, i, side="right") - 1)
        row = i - int(self.shard_offsets[shard_idx])
        return self._load(shard_idx)[row].astype(np.int32)

    def batch(self, idxs: np.ndarray) -> np.ndarray:
        """Gather ``[len(idxs), seq_len] int32`` (the loader's hot path),
        through the native fused gather and widen where its library builds
        (``photon_tpu_torch.native``; its numpy fallback otherwise)."""
        out = np.empty((len(idxs), self.seq_len), np.int32)
        rows = []
        for i in idxs:
            i = int(i)
            if not 0 <= i < len(self):
                raise IndexError(i)
            shard_idx = int(np.searchsorted(self.shard_offsets, i, side="right") - 1)
            rows.append(self._load(shard_idx)[i - int(self.shard_offsets[shard_idx])])
        native.gather_rows(rows, out)
        return out
