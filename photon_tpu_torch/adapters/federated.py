"""The train side of the adapter plane: config wiring and the per-cohort
payload plumbing (the port of ``photon_tpu/adapters/federated.py``).

- :func:`configure_adapter_training` derives the model's LoRA knobs and
  the base-freeze pattern from ``photon.adapters``;
- :class:`AdapterTrainPlane` holds the frozen base payload, builds each
  client's broadcast (base + its cohort's adapter), takes the adapter
  rows out of a fit's result, and owns the per-cohort server strategies
  (``strategy/grouped.py``).

The collective runner (``federation/collective_round.py``) drives this
plane through its grouped exchange, as the JAX package's does; it also
runs from :meth:`AdapterTrainPlane.run_round`, host code over one
``ClientRuntime``: broadcast per cohort, a fit per client,
:meth:`~AdapterTrainPlane.extract_adapter`, then ``grouped_host_fold``
and each cohort's server update. :meth:`~AdapterTrainPlane.save_round`
writes the round as the JAX runner's ``save_checkpoint`` does (the frozen
base as the params object, ``adapter__{cohort}`` and
``astate__{cohort}__{key}`` as state objects, the per-cohort step
counters as ``adapter_t``, the step counter and the clients' states in
the control state), and :meth:`~AdapterTrainPlane.resume` reads it back.
"""

from __future__ import annotations

import time
import warnings

import numpy as np

from photon_tpu_torch.adapters.checkpoint import (
    adapter_key,
    adapter_state_key,
    adapter_state_keys,
)
from photon_tpu_torch.adapters.lora import (
    BASE_FREEZE_PATTERN,
    adapter_metadata,
    cohort_seed,
    init_adapter_arrays,
    merge_payload,
    spec_from_base,
    split_adapter,
)
from photon_tpu_torch.codec.params import ParamsMetadata
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.messages import FitIns
from photon_tpu_torch.strategy.grouped import CohortStrategies, cohort_of_map, grouped_host_fold


def configure_adapter_training(cfg: Config) -> Config:
    """Set ``model.lora_rank/alpha/targets`` from ``photon.adapters`` and
    add the base-freeze pattern to ``optimizer.freeze_patterns``, in place
    (idempotent; call it before a ``Trainer`` is built)."""
    ad = cfg.photon.adapters
    if not ad.enabled:
        return cfg
    cfg.model.lora_rank = int(ad.rank)
    cfg.model.lora_alpha = float(ad.alpha)
    cfg.model.lora_targets = tuple(ad.targets)
    if BASE_FREEZE_PATTERN not in cfg.optimizer.freeze_patterns:
        cfg.optimizer.freeze_patterns = list(cfg.optimizer.freeze_patterns) + [BASE_FREEZE_PATTERN]
    return cfg


class AdapterTrainPlane:
    """The host state of an adapter run: the frozen base, one adapter and
    one server-optimizer state per cohort, and the flat-payload plumbing
    between them and the LoRA model."""

    def __init__(self, cfg: Config, base_meta: ParamsMetadata,
                 base_arrays: list[np.ndarray]) -> None:
        ad = cfg.photon.adapters
        if not ad.cohorts:
            raise ValueError("photon.adapters.enabled needs a non-empty cohorts map "
                             "(cohort name -> [cid, ...])")
        self.fl = cfg.fl
        # the runner's control state, as the JAX collective runner keeps it
        self.server_steps_cumulative = 0
        self.client_states: dict[int, dict] = {}
        self.base_meta = base_meta
        self.base_arrays = [np.asarray(a, np.float32) for a in base_arrays]
        self.spec = spec_from_base(base_meta, ad.rank, ad.alpha, tuple(ad.targets))
        self.ameta = adapter_metadata(self.spec)
        self.cohort_of = cohort_of_map(ad.cohorts)
        self.strategies = CohortStrategies(cfg.fl, ad.cohorts.keys())
        self.cohort_names = self.strategies.names
        self.strategies.initialize({
            name: init_adapter_arrays(self.spec, cohort_seed(cfg.seed, name))[1]
            for name in self.cohort_names
        })
        # a client in no cohort trains a fresh identity adapter each round,
        # which nobody folds
        self._identity = init_adapter_arrays(self.spec, cohort_seed(cfg.seed, ""))[1]

    @property
    def n_cohorts(self) -> int:
        return len(self.cohort_names)

    def adapter_sizes(self) -> list[int]:
        """Per-leaf element counts of one adapter payload (the modeled wire
        unit of the collective runner's grouped exchange)."""
        return [int(np.prod(s, dtype=np.int64)) for s in self.ameta.shapes]

    def broadcast_payload(self, cid: int) -> tuple[ParamsMetadata, list[np.ndarray]]:
        """Base + this client's cohort adapter as one canonical payload."""
        name = self.cohort_of.get(int(cid))
        adapter = self.strategies.params(name) if name is not None else self._identity
        return merge_payload(self.base_meta, self.base_arrays, self.ameta, adapter)

    def extract_adapter(self, meta: ParamsMetadata, arrays: list[np.ndarray]) -> list[np.ndarray]:
        """A fit's full payload → its adapter rows, checked against the spec
        (the frozen base never leaves the client)."""
        _, _, ameta, aarrays = split_adapter(meta, arrays)
        if ameta.names != self.ameta.names:
            diff = next((f"{x!r} vs {y!r}" for x, y in zip(ameta.names, self.ameta.names)
                         if x != y), "length mismatch")
            raise ValueError(f"fit result's adapter names do not match the plane's spec; "
                             f"first diff: {diff}")
        return aarrays

    # -- the round ---------------------------------------------------------
    def run_round(self, runtime, server_round: int, cids: list[int]) -> dict[str, float]:
        """One adapter round on ``runtime`` (a ``ClientRuntime`` whose
        config :func:`configure_adapter_training` set up): each cohort's
        broadcast written once to the runtime's transport, a fit per client
        on the frozen base with ``fl.local_steps`` and ``fl.fit_config``,
        the adapter rows of every fit that landed folded per cohort, and
        each folded cohort's server update. A client whose fit failed is
        dropped with a warning; a cohort with no client that landed keeps
        its adapter, and a round in which no fit landed leaves
        ``server_steps_cumulative`` where it was. Returns the round's
        timings and each cohort's update metrics under ``{cohort}/``."""
        t_round = time.monotonic()
        ptrs = {}
        for cid in cids:
            name = self.cohort_of.get(int(cid))
            if name not in ptrs:
                ptrs[name] = runtime.transport.put(
                    f"adapter-bcast-r{server_round}-{name or '__base__'}",
                    *self.broadcast_payload(cid))
        t_fit = time.monotonic()
        landed: dict[int, tuple[list[np.ndarray], int]] = {}
        states = self.client_states
        for cid in cids:
            ins = FitIns(server_round=server_round, cids=[cid],
                         params=ptrs[self.cohort_of.get(int(cid))],
                         local_steps=self.fl.local_steps,
                         server_steps_cumulative=self.server_steps_cumulative,
                         client_states={cid: states[cid]} if cid in states else {},
                         config=dict(self.fl.fit_config))
            res = runtime.fit(ins, cid)
            if res.error:
                warnings.warn(f"adapter round {server_round}: cid {cid} failed "
                              f"({res.error.splitlines()[0][:120]}); dropped from its cohort",
                              stacklevel=2)
                continue
            if res.client_state:
                states[cid] = res.client_state
            meta, arrays = runtime.transport.get(res.params)
            landed[cid] = (self.extract_adapter(meta, arrays), res.n_samples)
            runtime.transport.free(res.params)
        for ptr in ptrs.values():
            runtime.transport.free(ptr)
        t_fold = time.monotonic()
        metrics: dict[str, float] = {}
        for name, (avg, n_total, k) in grouped_host_fold(landed, self.cohort_of).items():
            for key, val in self.strategies.apply_average(server_round, name, avg, n_total,
                                                          k).items():
                metrics[f"{name}/{key}"] = val
        if landed:
            self.server_steps_cumulative += self.fl.local_steps
        t_end = time.monotonic()
        metrics.update({"server/steps_cumulative": float(self.server_steps_cumulative),
                        "server/adapter_cohorts": float(len({self.cohort_of.get(c)
                                                             for c in landed} - {None})),
                        "server/fit_round_time": t_fold - t_fit,
                        "server/adapter_fold_time": t_end - t_fold,
                        "server/round_time": t_end - t_round})
        return metrics

    # -- checkpoints -------------------------------------------------------
    def checkpoint_state_keys(self) -> tuple[str, ...]:
        """Every state object an adapter round writes (what round validity
        and :meth:`resume` check)."""
        return adapter_state_keys(self.cohort_names, self.strategies.state_keys)

    def state_for_checkpoint(self) -> dict[str, list[np.ndarray]]:
        """``adapter__{cohort}`` and ``astate__{cohort}__{key}`` entries."""
        st = self.strategies
        adapters, opt = st.adapters_for_checkpoint(), st.state_for_checkpoint()
        out: dict[str, list[np.ndarray]] = {}
        for name in st.names:
            out[adapter_key(name)] = adapters[name]
            for skey, tensors in opt[name].items():
                out[adapter_state_key(name, skey)] = tensors
        return out

    def control_state(self) -> dict:
        """The control state a round carries beside its tensors (the JAX
        runner's vocabulary): the step counter, the clients' states and
        the cohorts' step counters as ``adapter_t``."""
        return {"server_steps_cumulative": self.server_steps_cumulative,
                "client_states": dict(self.client_states),
                "adapter_t": self.strategies.t_counters()}

    def save_round(self, mgr, server_round: int) -> None:
        """Write the round through ``mgr.save_round`` (its manifest last,
        so a hot-swap watcher sees only whole rounds): the frozen base,
        the cohorts' objects and :meth:`control_state`."""
        mgr.save_round(server_round, self.base_meta, self.base_arrays,
                       strategy_state=self.state_for_checkpoint(),
                       server_state={"server_round": server_round, **self.control_state()})

    def resume(self, mgr, resume_round: int = -1) -> tuple[int, dict]:
        """Load a checksum-valid adapter round (the newest for -1): the
        base, every cohort's adapter and server-optimizer state and step
        counter. Returns (the round, its control state)."""
        keys = self.checkpoint_state_keys()
        rnd = mgr.resolve_resume_round(resume_round, keys)
        meta, params, state, control = mgr.load_round(rnd, keys)
        if meta.names != self.base_meta.names:
            raise ValueError("the checkpoint's base does not match this plane's")
        self.base_arrays = [np.asarray(p, np.float32) for p in params]
        skeys = self.strategies.state_keys
        self.strategies.initialize(
            {n: state[adapter_key(n)] for n in self.cohort_names},
            {n: {k: state[adapter_state_key(n, k)] for k in skeys} for n in self.cohort_names},
            t={str(k): int(v) for k, v in (control.get("adapter_t") or {}).items()})
        self.server_steps_cumulative = int(control.get("server_steps_cumulative", 0))
        self.client_states = {int(k): v for k, v in control.get("client_states", {}).items()}
        return rnd, control
