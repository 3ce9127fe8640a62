"""Content-addressed prefix reuse: share prompt-prefix KV blocks across
requests.

The port of ``photon_tpu/serve/prefix.py`` (host Python, no device work).
A KV block is a physical pool id, so two slots' tables may point at the
same block as long as neither writes it:

- **chain hashes** (:func:`prefix_hashes`): block ``j``'s key is
  ``blake2b(hash_{j-1} || tokens[j*bs:(j+1)*bs] as int32 bytes)``, so a
  hash names the whole prefix through block ``j``; the bytes equal the
  JAX package's.
- **refcounts** (``BlockAllocator.retain/free``): a shared block is held
  once per slot that maps it plus once by this cache; the last reference
  returns it to the free list.
- **the LRU** (:class:`PrefixCache`): hash → physical block, insertion
  order = LRU order. Eviction (pool pressure via :meth:`ensure_free`, an
  explicit cap, or a flush) drops only the cache's reference.

A cached block is full and every write of a request that maps it lands
past it: a hit shortens the chunk stream, which then starts at the cached
depth. The engine caps lookups at ``(len(prompt) - 1) // block_size``
blocks, so the final prompt token always runs (its logits give the first
sampled token), and inserts a prompt's blocks only after its last chunk.
A parameter swap flushes the cache: KV of the old params is invalid.
"""

from __future__ import annotations

import hashlib

import numpy as np


def prefix_hashes(prompt: list[int], block_size: int,
                  limit: int | None = None) -> list[bytes]:
    """Chain hashes of ``prompt``'s full blocks: ``out[j]`` names tokens
    ``[0, (j+1) * block_size)``. ``limit`` caps the number hashed."""
    n_full = len(prompt) // block_size
    if limit is not None:
        n_full = min(n_full, limit)
    out: list[bytes] = []
    prev = b""
    for j in range(n_full):
        block = np.asarray(prompt[j * block_size:(j + 1) * block_size], np.int32).tobytes()
        prev = hashlib.blake2b(prev + block, digest_size=16).digest()
        out.append(prev)
    return out


class PrefixCache:
    """LRU of hashed, allocator-referenced KV blocks. Scheduler-thread only
    (the scheduler loop owns admission and eviction), so no locking.
    ``max_blocks = 0``: no cap beyond the pool's pressure."""

    def __init__(self, allocator, max_blocks: int = 0) -> None:
        self.allocator = allocator
        self.max_blocks = max_blocks
        self._entries: dict[bytes, int] = {}  # insertion order == LRU order
        self.evictions = 0
        self.tokens_cached = 0  # prompt tokens whose prefill a hit skipped
        self.tokens_seen = 0  # all admitted prompt tokens

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        """Cached-token fraction over all admitted prompts."""
        return self.tokens_cached / self.tokens_seen if self.tokens_seen else 0.0

    def lookup(self, hashes: list[bytes], touch: bool = True) -> list[int]:
        """Physical blocks of the longest cached prefix of ``hashes`` (a
        gap ends it). Hits move to MRU unless ``touch=False`` (a read-only
        peek). Takes no references: the caller retains them."""
        out: list[int] = []
        for h in hashes:
            block = self._entries.get(h)
            if block is None:
                break
            if touch:
                del self._entries[h]  # re-insert = move to the end
                self._entries[h] = block
            out.append(block)
        return out

    def insert(self, hashes: list[bytes], blocks: list[int]) -> int:
        """Index ``blocks[j]`` under ``hashes[j]``, one allocator
        reference per newly indexed block; present hashes keep their
        block. Returns the number added."""
        added = 0
        for h, block in zip(hashes, blocks):
            if h in self._entries:
                continue
            if self.max_blocks and len(self._entries) >= self.max_blocks:
                self._evict_for_cap()
            self.allocator.retain([block])
            self._entries[h] = block
            added += 1
        return added

    def _evict_for_cap(self) -> None:
        """The cap's victim: the oldest unpinned entry (un-indexing a
        pinned one frees nothing and breaks a live chain), else the LRU
        head."""
        h = next((h for h, b in self._entries.items() if self.allocator.refcount(b) == 1),
                 None)
        self._drop(next(iter(self._entries)) if h is None else h)

    def _drop(self, h: bytes) -> None:
        # the cache's reference only: a block a live slot still maps
        # survives until that request evicts
        self.allocator.free([self._entries.pop(h)])
        self.evictions += 1

    def reclaimable(self, exclude: set[int] | None = None) -> int:
        """Entries only this cache holds (refcount 1), outside ``exclude``
        (blocks an admission is about to retain): evicting them frees
        blocks. :meth:`ensure_free` and the engine's admission agree on
        this predicate."""
        exclude = exclude or set()
        return sum(1 for b in self._entries.values()
                   if b not in exclude and self.allocator.refcount(b) == 1)

    def ensure_free(self, n: int) -> bool:
        """Evict unpinned entries, LRU first, until the allocator can
        cover ``n`` blocks. Pinned entries stay indexed."""
        if self.allocator.free_blocks >= n:
            return True
        for h in [h for h, b in self._entries.items() if self.allocator.refcount(b) == 1]:
            if self.allocator.free_blocks >= n:
                break
            self._drop(h)
        return self.allocator.free_blocks >= n

    def flush(self) -> int:
        """Drop every entry, pinned or not. Returns the number dropped."""
        dropped = len(self._entries)
        while self._entries:
            self._drop(next(iter(self._entries)))
        return dropped
