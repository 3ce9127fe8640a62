"""Client (per-cid) local-step checkpoints, in the JAX package's layout.

The port of ``photon_tpu/checkpoint/client.py``: a checkpoint is
``{run_uuid}/client_{cid}/ba{step}/`` holding ``params.npz``, ``opt.npz``
(the optimizer state under optax's flattened names) and ``state.bin``
(the step and the data-loader state), written last so that its presence
marks the checkpoint complete. A checkpoint written by either package
resumes in the other.
"""

from __future__ import annotations

import re
from typing import Any

import numpy as np

from photon_tpu_torch.checkpoint.serialization import (
    arrays_to_npz,
    bytes_to_state,
    npz_to_arrays,
    state_to_bytes,
)
from photon_tpu_torch.checkpoint.store import FileStore
from photon_tpu_torch.codec.params import ParamsMetadata


class ClientCheckpointManager:
    def __init__(self, store: FileStore, run_uuid: str) -> None:
        self.store = store
        self.run_uuid = run_uuid

    def _prefix(self, cid: int, step: int) -> str:
        return f"{self.run_uuid}/client_{cid}/ba{step}"

    def save(self, cid: int, step: int, params_meta: ParamsMetadata, params: list[np.ndarray],
             opt_meta: ParamsMetadata | None = None, opt_arrays: list[np.ndarray] | None = None,
             extra_state: dict[str, Any] | None = None) -> None:
        prefix = self._prefix(cid, step)
        self.store.put(f"{prefix}/params.npz", arrays_to_npz(params_meta, params))
        if opt_meta is not None and opt_arrays is not None:
            self.store.put(f"{prefix}/opt.npz", arrays_to_npz(opt_meta, opt_arrays))
        # the done-marker goes last: a checkpoint is "done" only when complete
        self.store.put(f"{prefix}/state.bin", state_to_bytes({"step": step, **(extra_state or {})}))

    def steps(self, cid: int) -> list[int]:
        out = set()
        for key in self.store.list(f"{self.run_uuid}/client_{cid}"):
            m = re.search(r"/ba(\d+)/state\.bin$", "/" + key)
            if m:
                out.add(int(m.group(1)))
        return sorted(out)

    def should_skip_round(self, cid: int, target_step: int) -> bool:
        """True iff the post-round checkpoint exists: the round was fully
        trained before a restart, so it is reused, not trained again."""
        return self.store.exists(f"{self._prefix(cid, target_step)}/state.bin")

    def load_params_only(self, cid: int, step: int) -> tuple[ParamsMetadata, list[np.ndarray]]:
        return npz_to_arrays(self.store.get(f"{self._prefix(cid, step)}/params.npz"))

    def latest_at_most(self, cid: int, step: int) -> int | None:
        """Latest checkpointed step ≤ ``step``."""
        candidates = [s for s in self.steps(cid) if s <= step]
        return max(candidates) if candidates else None

    def load(self, cid: int, step: int):
        """``(params_meta, params, (opt_meta, opt_arrays) or None, state)``."""
        prefix = self._prefix(cid, step)
        pm, pa = npz_to_arrays(self.store.get(f"{prefix}/params.npz"))
        opt = None
        if self.store.exists(f"{prefix}/opt.npz"):
            opt = npz_to_arrays(self.store.get(f"{prefix}/opt.npz"))
        return pm, pa, opt, bytes_to_state(self.store.get(f"{prefix}/state.bin"))

    def cleanup(self, cid: int, keep: int) -> list[int]:
        """Delete all but the newest ``keep`` checkpoints."""
        deleted = []
        for s in self.steps(cid)[:-keep] if keep > 0 else []:
            self.store.delete(self._prefix(cid, s))
            deleted.append(s)
        return deleted
