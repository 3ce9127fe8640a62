"""Paged per-cohort adapter pool: the KV pool's small sibling (the port of
``photon_tpu/serve/adapter_pool.py``).

One fixed device stack per adapter leaf, ``[pool_size + 1, L, ...]`` in
fp32, whose last page is the trash page: all-zero factors, the identity
adapter, so a slot with no cohort decodes the bare base through the same
step. A B page holds ``B · alpha/r``: the LoRA scale is folded in at load,
so the step runs its products with a scale of 1. Pages follow the KV blocks' refcounting
(:class:`~photon_tpu_torch.serve.cache.BlockAllocator`):

- the cohort → page index holds one reference per resident cohort;
- every slot decoding that cohort holds one more (:meth:`acquire` /
  :meth:`release` at admission and eviction);
- a cohort is evictable when only the index holds it: eviction drops the
  index's reference and the page goes back to the free list (a recycled
  page is overwritten whole by the next load, so no factor leaks from
  one cohort to another).

A page load is one indexed copy per leaf into the fixed stacks (no new
device allocation); the engine's step gathers each slot's page by row
(``leaf.index_select(0, rows)``). Thread discipline as the engine's: one
scheduler thread calls acquire/release/install_bank; HTTP handler threads
read :meth:`stats` only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from photon_tpu_torch.adapters.lora import AdapterSpec, adapter_metadata
from photon_tpu_torch.serve.cache import BlockAllocator, BlockLeakError


class AdapterPool:
    """Device-resident cohort adapter pages and the host bank."""

    def __init__(self, spec: AdapterSpec, pool_size: int,
                 device: str | torch.device = "cpu") -> None:
        if pool_size < 1:
            raise ValueError(f"need pool_size >= 1, got {pool_size}")
        self.spec = spec
        self.size = pool_size
        self.trash_page = pool_size
        self.allocator = BlockAllocator(pool_size)
        meta = adapter_metadata(spec)
        self._names = meta.names
        self._shapes = meta.shapes
        # each B page holds B · alpha/r, so the step skips the scale
        self._scales = [spec.scale if n.endswith("_lora_b") else 1.0 for n in meta.names]
        self._leaves = [torch.zeros((pool_size + 1,) + tuple(s), dtype=torch.float32,
                                    device=device) for s in meta.shapes]
        #: host bank: cohort -> flat adapter arrays (canonical order)
        self._bank: dict[str, list[np.ndarray]] = {}
        #: resident cohort -> page, in LRU order (oldest first)
        self._pages: dict[str, int] = {}
        self.loads = 0
        self.evictions = 0
        self.hits = 0
        self.requests = 0

    # -- bank -------------------------------------------------------------
    def check_bank(self, bank: dict[str, Sequence[np.ndarray]]) -> dict[str, list[np.ndarray]]:
        """Every cohort's arrays as fp32, checked against the spec (count
        and shapes); raises ``ValueError`` and changes nothing on a
        mismatch."""
        checked: dict[str, list[np.ndarray]] = {}
        for cohort, arrays in bank.items():
            arrays = [np.asarray(a, np.float32) for a in arrays]
            if len(arrays) != len(self._names):
                raise ValueError(f"cohort {cohort!r} adapter has {len(arrays)} arrays, "
                                 f"spec expects {len(self._names)}")
            for name, shape, a in zip(self._names, self._shapes, arrays):
                if tuple(a.shape) != tuple(shape):
                    raise ValueError(f"cohort {cohort!r} {name}: shape {tuple(a.shape)} "
                                     f"!= spec {tuple(shape)}")
            checked[cohort] = arrays
        return checked

    def install_bank(self, bank: dict[str, Sequence[np.ndarray]]) -> None:
        """Replace the host bank, after :meth:`check_bank`. Every resident
        page is dropped: factors trained against an old base are invalid
        under a new one. The engine calls this with no slot active (a
        swap)."""
        checked = self.check_bank(bank)
        self.flush()
        self._bank = checked

    def flush(self) -> None:
        """Drop every resident page (the index's references; callers have
        no slot active)."""
        for page in self._pages.values():
            self.allocator.free([page])
        self._pages.clear()

    def shrink(self) -> int:
        """Evict every resident page that no live slot pins, so unlike
        :meth:`flush` this is safe under traffic; an evicted cohort reloads
        from the host bank at its next admission. Returns the pages
        evicted."""
        dropped = 0
        for cohort, page in list(self._pages.items()):
            if self.allocator.refcount(page) != 1:
                continue
            self.allocator.free([self._pages.pop(cohort)])
            self.evictions += 1
            dropped += 1
        return dropped

    def has_cohort(self, cohort: str) -> bool:
        return cohort in self._bank

    def cohorts(self) -> list[str]:
        return sorted(self._bank)

    # -- admission --------------------------------------------------------
    def _evictable(self) -> str | None:
        """The least recently used resident cohort no slot pins."""
        return next((c for c, p in self._pages.items() if self.allocator.refcount(p) == 1), None)

    def can_acquire(self, cohort: str) -> bool:
        """A known cohort, and a page for it: resident, free, or an
        unpinned resident to evict."""
        if cohort not in self._bank:
            return False
        return (cohort in self._pages or self.allocator.free_blocks > 0
                or self._evictable() is not None)

    def acquire(self, cohort: str) -> int:
        """Pin ``cohort``'s page for one slot (one reference), loading it on
        a miss (evicting the least recently used unpinned resident when the
        pool is full). The caller :meth:`release`\\ s the page at eviction."""
        self.requests += 1
        if cohort not in self._bank:
            raise KeyError(f"unknown adapter cohort {cohort!r}")
        page = self._pages.pop(cohort, None)
        if page is not None:
            self.hits += 1
            self._pages[cohort] = page  # re-inserted: most recently used
            self.allocator.retain([page])
            return page
        ids = self.allocator.alloc(1)
        if ids is None:
            victim = self._evictable()
            if victim is None:
                raise RuntimeError("adapter pool exhausted: every page is pinned by a live "
                                   "slot (caller must can_acquire first)")
            self.allocator.free([self._pages.pop(victim)])
            self.evictions += 1
            ids = self.allocator.alloc(1)
        page = ids[0]
        with torch.no_grad():
            for leaf, arr, scale in zip(self._leaves, self._bank[cohort], self._scales):
                leaf[page].copy_(torch.from_numpy(arr))
                if scale != 1.0:
                    leaf[page].mul_(scale)
        self.loads += 1
        self._pages[cohort] = page  # the index's reference (alloc's)
        self.allocator.retain([page])  # the caller's pin
        return page

    def release(self, page: int) -> None:
        """Drop one slot's pin; the page stays resident (the index holds
        it) until LRU pressure evicts it. A page with no slot pin raises
        :class:`BlockLeakError` (it would consume the index's reference)."""
        if self.allocator.refcount(page) <= 1:
            raise BlockLeakError(f"releasing adapter page {page} with no outstanding pin")
        self.allocator.free([page])

    # -- the step ---------------------------------------------------------
    def gather(self, rows: torch.Tensor) -> list[torch.Tensor]:
        """Each slot's page, ``[n_slots, L, ...]`` per leaf in canonical
        order (``rows``: the slots' page ids on the pool's device), B
        scaled by alpha/r."""
        return [leaf.index_select(0, rows) for leaf in self._leaves]

    @property
    def nbytes(self) -> int:
        """Device bytes of the page stacks."""
        return sum(leaf.numel() * leaf.element_size() for leaf in self._leaves)

    def stats(self) -> dict[str, float]:
        return {
            "residents": float(len(self._pages)),
            "cohorts": float(len(self._bank)),
            "loads": float(self.loads),
            "evictions": float(self.evictions),
            "hit_rate": (self.hits / self.requests) if self.requests else 0.0,
        }
