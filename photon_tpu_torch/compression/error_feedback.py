"""Per-client error-feedback residuals for the lossy codec stages (the
port's copy of ``photon_tpu/compression/error_feedback.py``).

Classic EF-SGD/EF21 bookkeeping: whatever the lossy encoder drops (top-k) or
rounds away (int8) this round is remembered and *added back into next
round's delta before encoding*, so compression error is re-injected instead
of compounding:

    compensated_t = delta_t + residual_{t-1}
    residual_t    = compensated_t − decode(encode(compensated_t))

Residuals are keyed by client id and held as float32 (one extra model copy
per locally-resident client — the same order of memory as the personalized-
layer cache in ``client_runtime``). The store lives client-side, next to the
encoder; the server never sees residuals.

Scope caveat: the store is NODE-local. Under partial participation a cid's
residual is re-injected whenever that cid next trains *on the same node* —
late delivery of the dropped mass, which is ordinary EF-under-sampling
behavior. If the scheduler migrates a cid to another node, the old node's
residual waits until the cid returns there (or is dropped with the node),
degrading gracefully toward no-EF for roaming clients; nothing compounds.
"""

from __future__ import annotations

from typing import Hashable

import numpy as np


class ErrorFeedback:
    """Bounded LRU store: each residual is one fp32 model copy, so a node
    hosting many cids caps at ``max_entries`` copies — beyond it the
    least-recently-trained cid's residual is evicted (that cid degrades
    gracefully toward no-EF, exactly like a cid that migrated nodes)."""

    def __init__(self, max_entries: int = 16) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = max_entries
        self._residuals: dict[Hashable, list[np.ndarray]] = {}

    def matching_residual(self, key: Hashable, sizes: list[int]) -> list[np.ndarray] | None:
        """The residual list for ``key`` when its per-layer sizes match the
        payload being encoded; a mismatch (model shape changed under the
        key, e.g. momenta toggled) drops the now-meaningless residual."""
        res = self._residuals.get(key)
        if res is None:
            return None
        if len(res) != len(sizes) or any(r.size != n for r, n in zip(res, sizes)):
            del self._residuals[key]
            return None
        self._residuals[key] = self._residuals.pop(key)  # mark recently used
        return res

    def store(self, key: Hashable, residuals: list[np.ndarray]) -> None:
        """Replace ``key``'s residuals (already ``compensated − decoded``,
        one flat array per float layer), evicting the least-recently-used
        entry beyond ``max_entries``."""
        self._residuals.pop(key, None)
        self._residuals[key] = residuals
        while len(self._residuals) > self.max_entries:
            self._residuals.pop(next(iter(self._residuals)))

    def residual(self, key: Hashable) -> list[np.ndarray] | None:
        return self._residuals.get(key)

    def residual_norm(self, key: Hashable) -> float:
        res = self._residuals.get(key)
        if res is None:
            return 0.0
        return float(np.sqrt(sum(float(np.sum(np.square(r, dtype=np.float64))) for r in res)))

    def drop(self, key: Hashable) -> None:
        self._residuals.pop(key, None)

    def clear(self) -> None:
        self._residuals.clear()
