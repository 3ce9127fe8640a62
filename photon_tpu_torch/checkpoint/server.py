"""Server round checkpoints: the read path serving needs, and a writer.

The port's copy of the parts of ``photon_tpu/checkpoint/server.py`` that
serving uses. Layout ``{run_uuid}/server/{round}/``:
``current_server_parameters.npz`` and ``manifest.json`` (per-object
CRC32s, written last, so its presence marks the round complete). The JAX
package also writes ``state.bin`` (pickled control state) and strategy
momenta; serving reads neither, so a round here is valid when its params
object is present and every object the manifest lists matches its CRC.
"""

from __future__ import annotations

import json
import warnings
import zlib

import numpy as np

from photon_tpu_torch.checkpoint.serialization import arrays_to_npz, npz_to_arrays
from photon_tpu_torch.checkpoint.store import FileStore
from photon_tpu_torch.codec.params import ParamsMetadata

PARAMS_FILE = "current_server_parameters.npz"
MANIFEST_FILE = "manifest.json"


class ServerCheckpointManager:
    def __init__(self, store: FileStore, run_uuid: str) -> None:
        self.store = store
        self.run_uuid = run_uuid
        # completed rounds never change: each is CRC-checked at most once
        self._verify_cache: dict[int, bool] = {}

    def _round_prefix(self, server_round: int) -> str:
        return f"{self.run_uuid}/server/{server_round}"

    # -- write -----------------------------------------------------------
    def save_round_params(self, server_round: int, metadata: ParamsMetadata,
                          parameters: list[np.ndarray]) -> None:
        """Write a params-only round in the JAX package's layout: the
        params npz, then the manifest with its CRC."""
        prefix = self._round_prefix(server_round)
        self._verify_cache.pop(server_round, None)
        data = arrays_to_npz(metadata, parameters)
        self.store.put(f"{prefix}/{PARAMS_FILE}", data)
        self.store.put(
            f"{prefix}/{MANIFEST_FILE}",
            json.dumps({"version": 1, "crc32": {PARAMS_FILE: zlib.crc32(data)}}).encode(),
        )

    # -- discovery -------------------------------------------------------
    def list_rounds(self) -> list[int]:
        rounds: set[int] = set()
        for key in self.store.list(f"{self.run_uuid}/server"):
            parts = key.split("/")
            if len(parts) >= 3 and parts[-3] == "server":
                try:
                    rounds.add(int(parts[-2]))
                except ValueError:
                    continue
        return sorted(rounds)

    def verify_round(self, server_round: int) -> bool:
        """CRC32-check every object the round's manifest lists. Rounds
        without a manifest verify vacuously (presence was their contract)."""
        if server_round in self._verify_cache:
            return self._verify_cache[server_round]
        prefix = self._round_prefix(server_round)
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
        self._verify_cache[server_round] = ok
        return ok

    def valid_rounds(self) -> list[int]:
        return [
            r for r in self.list_rounds()
            if self.store.exists(f"{self._round_prefix(r)}/{PARAMS_FILE}")
        ]

    def resolve_resume_round(self, resume_round: int) -> int:
        """Non-negative → that round (checksums verified). Negative →
        index from the latest checksum-valid round (−1 = latest); a round
        that fails its CRCs is skipped with a warning."""
        valid = self.valid_rounds()
        if not valid:
            raise FileNotFoundError(f"no valid checkpoints for run {self.run_uuid!r}")
        if resume_round >= 0:
            if resume_round not in valid:
                raise FileNotFoundError(
                    f"round {resume_round} is not a valid checkpoint (valid: {valid})"
                )
            if not self.verify_round(resume_round):
                raise FileNotFoundError(
                    f"round {resume_round} checkpoint failed checksum verification"
                )
            return resume_round
        want, seen_ok = -resume_round, 0
        for r in reversed(valid):
            if not self.verify_round(r):
                warnings.warn(
                    f"round {r} checkpoint failed checksum verification — skipping it",
                    stacklevel=2,
                )
                continue
            seen_ok += 1
            if seen_ok == want:
                return r
        raise FileNotFoundError(
            f"resume_round {resume_round} but only {seen_ok} checksum-valid rounds"
        )

    # -- load ------------------------------------------------------------
    def load_round_params(self, server_round: int) -> tuple[ParamsMetadata, list[np.ndarray]]:
        """Params-only load: no momenta, no pickled control state."""
        return npz_to_arrays(self.store.get(f"{self._round_prefix(server_round)}/{PARAMS_FILE}"))
