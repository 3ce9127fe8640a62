"""Server round checkpoints: save (in the background or not), resume,
garbage collection and cross-run import (the port of
``photon_tpu/checkpoint/server.py``, with the same store keys, so a round
written by either package resumes or serves in the other).

Layout ``{run_uuid}/server/{round}/``: ``current_server_parameters.npz``,
one ``{key}.npz`` per strategy state key, ``state.bin`` (the pickled
control state: history, client states, cumulative server steps, sampled
rounds) and ``manifest.json`` (per-object CRC32s, written last, so its
presence marks the round complete). A round is valid when its params,
its control state and every declared state key are present; resume
verifies the checksums and falls back past a corrupt round.
"""

from __future__ import annotations

import json
import threading
import time
import warnings
import zlib
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

PARAMS_FILE = "current_server_parameters.npz"
STATE_FILE = "state.bin"
MANIFEST_FILE = "manifest.json"


class ServerCheckpointManager:
    def __init__(self, store: FileStore, run_uuid: str) -> None:
        self.store = store
        self.run_uuid = run_uuid
        # at most ONE background write in flight; save/resume/load wait on it
        self._pending: threading.Thread | None = None
        self._pending_error: BaseException | None = None
        self._last_async_write_s = 0.0
        self._last_barrier_wait_s = 0.0
        # completed rounds never change: each is CRC-checked at most once
        self._verify_cache: dict[int, bool] = {}

    # -- async writer ----------------------------------------------------
    @property
    def last_async_write_s(self) -> float:
        """Seconds of the most recently completed background write."""
        return self._last_async_write_s

    @property
    def last_barrier_wait_s(self) -> float:
        """How long the latest :meth:`save_round_async` waited for the
        previous round's write."""
        return self._last_barrier_wait_s

    def wait_pending(self) -> None:
        """Join any in-flight background write and re-raise its error."""
        th = self._pending
        if th is not None:
            th.join()
            self._pending = None
        err, self._pending_error = self._pending_error, None
        if err is not None:
            raise RuntimeError("async checkpoint write failed") from err

    def save_round_async(
        self,
        server_round: int,
        metadata: ParamsMetadata,
        parameters: list[np.ndarray],
        strategy_state: dict[str, list[np.ndarray]] | None = None,
        server_state: dict[str, Any] | None = None,
        cleanup_keep: tuple[int, tuple[str, ...]] | None = None,
    ) -> float:
        """Wait for the previous write, then hand :meth:`save_round` (and,
        with ``cleanup_keep = (keep, state_keys)``, the GC) to a background
        thread; returns the enqueue seconds. The snapshot copies the
        containers, not the arrays: strategies rebind list slots each
        round and never write into an array, so the arrays it holds do not
        change under the writer."""
        t_barrier = time.monotonic()
        self.wait_pending()
        self._last_barrier_wait_s = time.monotonic() - t_barrier
        params = list(parameters)
        state = {k: list(v) for k, v in (strategy_state or {}).items()}
        server = dict(server_state or {})
        t_enqueue = time.monotonic()

        def _write() -> None:
            t0 = time.monotonic()
            try:
                self.save_round(server_round, metadata, params, state, server)
                if cleanup_keep is not None:
                    self.cleanup(*cleanup_keep)
            except BaseException as e:  # noqa: BLE001 — re-raised at the barrier
                self._pending_error = e
            finally:
                self._last_async_write_s = time.monotonic() - t0

        th = threading.Thread(target=_write, name=f"ckpt-write-r{server_round}", daemon=True)
        self._pending = th
        th.start()
        return time.monotonic() - t_enqueue

    # -- keys ------------------------------------------------------------
    def _round_prefix(self, server_round: int, run_uuid: str | None = None) -> str:
        return f"{run_uuid or self.run_uuid}/server/{server_round}"

    # -- save ------------------------------------------------------------
    def save_round(
        self,
        server_round: int,
        metadata: ParamsMetadata,
        parameters: list[np.ndarray],
        strategy_state: dict[str, list[np.ndarray]] | None = None,
        server_state: dict[str, Any] | None = None,
    ) -> None:
        prefix = self._round_prefix(server_round)
        self._verify_cache.pop(server_round, None)  # a resumed run rewrites rounds
        manifest: dict[str, int] = {}

        def _put(name: str, data: bytes) -> None:
            self.store.put(f"{prefix}/{name}", data)
            manifest[name] = zlib.crc32(data)

        _put(PARAMS_FILE, arrays_to_npz(metadata, parameters))
        for key, tensors in (strategy_state or {}).items():
            # per-layer state takes the param names; odd-length state (the
            # adaptive strategies' step counter) zero-padded index names
            names = (metadata.names if len(tensors) == len(metadata.names)
                     else [f"{i:06d}" for i in range(len(tensors))])
            _put(f"{key}.npz", arrays_to_npz(ParamsMetadata.from_ndarrays(names, tensors),
                                             tensors))
        _put(STATE_FILE, state_to_bytes(server_state or {}))
        self.store.put(f"{prefix}/{MANIFEST_FILE}",
                       json.dumps({"version": 1, "crc32": manifest}).encode())

    # -- discovery -------------------------------------------------------
    def list_rounds(self, run_uuid: str | None = None) -> list[int]:
        rounds: set[int] = set()
        for key in self.store.list(f"{run_uuid or self.run_uuid}/server"):
            parts = key.split("/")
            if len(parts) >= 3 and parts[-3] == "server":
                try:
                    rounds.add(int(parts[-2]))
                except ValueError:
                    continue
        return sorted(rounds)

    def is_valid_round(self, server_round: int, state_keys: tuple[str, ...] = (),
                       run_uuid: str | None = None) -> bool:
        """Presence of params, control state and every state key (cheap:
        resume and GC verify the checksums on top)."""
        prefix = self._round_prefix(server_round, run_uuid)
        needed = [f"{prefix}/{PARAMS_FILE}", f"{prefix}/{STATE_FILE}"]
        needed += [f"{prefix}/{k}.npz" for k in state_keys]
        return all(self.store.exists(k) for k in needed)

    def verify_round(self, server_round: int, run_uuid: str | None = None) -> bool:
        """CRC32-check every object the round's manifest lists (exactly
        what the round wrote). Rounds without a manifest verify vacuously
        (presence was their contract); this run's verdicts are memoized."""
        own = run_uuid is None or run_uuid == self.run_uuid
        if own and server_round in self._verify_cache:
            return self._verify_cache[server_round]
        prefix = self._round_prefix(server_round, run_uuid)
        mkey = f"{prefix}/{MANIFEST_FILE}"
        ok = True
        if self.store.exists(mkey):
            try:
                manifest = json.loads(self.store.get(mkey).decode())
                for name, crc in manifest.get("crc32", {}).items():
                    if zlib.crc32(self.store.get(f"{prefix}/{name}")) != int(crc):
                        ok = False
                        break
            except (OSError, ValueError, KeyError):
                ok = False  # unreadable or torn manifest
        if own:
            self._verify_cache[server_round] = ok
        return ok

    def valid_rounds(self, state_keys: tuple[str, ...] = ()) -> list[int]:
        return [r for r in self.list_rounds() if self.is_valid_round(r, state_keys)]

    def latest_complete_round(self, run_uuid: str | None = None) -> int | None:
        """The newest round whose manifest is present, or None: the hot-swap
        watcher's cheap poll. The manifest is written last and each put is
        atomic, so a torn round (objects up, manifest not yet) is never
        reported. Presence only: no object is read; rounds without a
        manifest are not reported."""
        for r in reversed(self.list_rounds(run_uuid)):
            if self.store.exists(f"{self._round_prefix(r, run_uuid)}/{MANIFEST_FILE}"):
                return r
        return None

    def resolve_resume_round(self, resume_round: int, state_keys: tuple[str, ...] = ()) -> int:
        """Non-negative → that round (checksums verified). Negative → index
        from the latest checksum-valid round (−1 = latest); a round that
        fails its CRCs is skipped with a warning."""
        self.wait_pending()
        valid = self.valid_rounds(state_keys)
        if not valid:
            raise FileNotFoundError(f"no valid checkpoints for run {self.run_uuid!r}")
        if resume_round >= 0:
            if resume_round not in valid:
                raise FileNotFoundError(
                    f"round {resume_round} is not a valid checkpoint (valid: {valid})")
            if not self.verify_round(resume_round):
                raise FileNotFoundError(
                    f"round {resume_round} checkpoint failed checksum verification")
            return resume_round
        want, seen_ok = -resume_round, 0
        for r in reversed(valid):
            if not self.verify_round(r):
                warnings.warn(f"round {r} checkpoint failed checksum verification — skipping it",
                              stacklevel=2)
                continue
            seen_ok += 1
            if seen_ok == want:
                return r
        raise FileNotFoundError(
            f"resume_round {resume_round} but only {seen_ok} checksum-valid rounds")

    # -- load ------------------------------------------------------------
    def load_round(self, server_round: int, state_keys: tuple[str, ...] = ()
                   ) -> tuple[ParamsMetadata, list[np.ndarray], dict[str, list[np.ndarray]],
                              dict[str, Any]]:
        self.wait_pending()
        prefix = self._round_prefix(server_round)
        metadata, parameters = npz_to_arrays(self.store.get(f"{prefix}/{PARAMS_FILE}"))
        strategy_state = {key: npz_to_arrays(self.store.get(f"{prefix}/{key}.npz"))[1]
                          for key in state_keys}
        server_state = bytes_to_state(self.store.get(f"{prefix}/{STATE_FILE}"))
        return metadata, parameters, strategy_state, server_state

    def load_round_params(self, server_round: int) -> tuple[ParamsMetadata, list[np.ndarray]]:
        """Params only: no strategy momenta, no control state."""
        self.wait_pending()
        return npz_to_arrays(self.store.get(f"{self._round_prefix(server_round)}/{PARAMS_FILE}"))

    # -- GC / import -----------------------------------------------------
    def cleanup(self, keep: int, state_keys: tuple[str, ...] = ()) -> list[int]:
        """Delete all but the newest ``keep`` checksum-valid rounds, and
        partial or corrupt rounds older than the newest good one; returns
        the deleted rounds."""
        valid = [r for r in self.valid_rounds(state_keys) if self.verify_round(r)]
        keep_set = set(valid[-keep:]) if keep > 0 else set(valid)
        deleted = []
        for r in self.list_rounds():
            if r not in keep_set and (r in valid or (valid and r < valid[-1])):
                self.store.delete(self._round_prefix(r))
                self._verify_cache.pop(r, None)
                deleted.append(r)
        return deleted

    def import_run(self, old_run_uuid: str, state_keys: tuple[str, ...] = ()) -> list[int]:
        """Copy every valid round of ``old_run_uuid`` into this run."""
        imported = []
        for r in self.list_rounds(old_run_uuid):
            if not self.is_valid_round(r, state_keys, old_run_uuid):
                continue
            src, dst = self._round_prefix(r, old_run_uuid), self._round_prefix(r)
            for key in self.store.list(src):
                self.store.copy(key, f"{dst}/{key[len(src):].lstrip('/')}")
            self._verify_cache.pop(r, None)
            imported.append(r)
        return imported
