"""The adapter round's checkpoint layout (the port of
``photon_tpu/adapters/checkpoint.py``; the same store keys, so a round
written by either package resumes or serves in the other).

An adapter round is written like a plain federated round, through
``ServerCheckpointManager.save_round`` with extra state entries, so the
manifest's CRCs, torn-round detection, GC and the hot-swap watcher's
``latest_complete_round`` all apply unchanged::

    {run}/server/{round}/current_server_parameters.npz   the frozen base
    {run}/server/{round}/adapter__{cohort}.npz           each cohort's A/B
    {run}/server/{round}/astate__{cohort}__{key}.npz     its server optimizer
    {run}/server/{round}/state.bin                       control state
    {run}/server/{round}/manifest.json                   written last

A server reads the base (params only) and the ``adapter__*`` objects,
never the control state or the optimizer moments.
"""

from __future__ import annotations

import numpy as np

ADAPTER_KEY_PREFIX = "adapter__"
ADAPTER_STATE_PREFIX = "astate__"


def adapter_key(cohort: str) -> str:
    return f"{ADAPTER_KEY_PREFIX}{cohort}"


def adapter_state_key(cohort: str, state_key: str) -> str:
    return f"{ADAPTER_STATE_PREFIX}{cohort}__{state_key}"


def adapter_state_keys(cohorts, strategy_state_keys) -> tuple[str, ...]:
    """Every per-cohort object key a round writes (the ``state_keys`` that
    round validity and resume check)."""
    out = [adapter_key(c) for c in sorted(cohorts)]
    for c in sorted(cohorts):
        out.extend(adapter_state_key(c, k) for k in strategy_state_keys)
    return tuple(out)


def load_adapter_bank(mgr, server_round: int, cohorts) -> dict[str, list[np.ndarray]]:
    """Every cohort's adapter arrays from a round (the adapter objects
    only). ``cohorts``: the config's cohort map (its names are read)."""
    return {c: mgr.load_state_npz(server_round, adapter_key(c))[1] for c in sorted(cohorts)}
