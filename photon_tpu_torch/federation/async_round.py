"""Asynchronous federated rounds: a staleness-bounded buffered server that
never waits (the port of ``photon_tpu/federation/async_round.py``).

The synchronous round clock (``collective_round.py``) blocks every round
on the slowest survivor. This runner replaces it with a **version clock**:

- Clients stream deltas when *they* finish. The server buffers each
  arrival and advances the version whenever ``K = async_rounds.buffer_size``
  updates have landed, folding the buffer through the same device
  aggregation plane under staleness-discounted weights
  ``n_i · d(server_version − client_base_version)``
  (:func:`~photon_tpu_torch.parallel.collective_agg.discounted_fold_weights`).
- The elastic machinery reframes: the deadline becomes the staleness
  bound (a delta staler than ``max_staleness`` is rejected, counted and
  evented, and its client re-dispatched from the fresh version), quorum
  becomes the min-arrivals gate (a full buffer with fewer distinct
  contributors stalls the clock, never an aborted run), and a
  :class:`LivenessTracker` dead edge drops a client's in-flight delta.
- An arrival burst (several complete buffers at one instant, on the
  host-optimizer path) folds through the grouped average: B buffer
  averages in one exchange.

**Bit parity with the sync runner**: with equal client speeds and ``K ==
n_total_clients`` every buffer fills with all clients at staleness 0, the
weights come back int32 (the sync round's counts), the buffer order is the
sync stack order (heap ties break by dispatch sequence = cid order), and
every FitIns field matches the sync round's, so the async run is the
synchronous run bit for bit.

**Time model.** Client fits run eagerly at dispatch (a client trains on
exactly the version it was dispatched from), and the delta is delivered on
a discrete-event clock at ``fit_time_s × fit_delay_factor(cid)`` (chaos's
deterministic per-client slowdown). Staleness is assessed at arrival and
frozen on the buffered entry.

Scope: one process, many local clients; the constructor refuses a
``torch.distributed`` job of more than one process (a gang would need an
arrival-consensus plane).
"""

from __future__ import annotations

import heapq
import time
import warnings
from typing import Callable, Sequence

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.analysis.runtime import absorb_compiles, steady_point
from photon_tpu_torch.chaos import crash_point
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.collective_round import CollectiveFedRunner
from photon_tpu_torch.federation.membership import LIVE, LivenessTracker
from photon_tpu_torch.federation.messages import FitIns
from photon_tpu_torch.metrics.history import History
from photon_tpu_torch.parallel.collective_agg import (
    ClientMesh,
    discounted_fold_weights,
    grouped_weighted_average,
    hierarchical_weighted_average,
    mesh_replica,
    modeled_cross_slice_bytes,
    staleness_discount,
)
from photon_tpu_torch.utils.profiling import (
    ASYNC_ARRIVALS,
    ASYNC_BUFFER_FILL,
    ASYNC_DISCOUNT_MEAN,
    ASYNC_DROPPED,
    ASYNC_REJECTED,
    ASYNC_SIM_TIME,
    ASYNC_STALENESS_MAX,
    ASYNC_STALENESS_MEAN,
    ASYNC_STALLS,
    ASYNC_VERSION,
    AUTOPILOT_KNOB_MAX_STALENESS,
    CLIENT_FIT_DELAY_FACTOR,
    COLLECTIVE_AGG_TIME,
    COLLECTIVE_WIRE_BYTES,
    EVENT_ASYNC_DROP,
    EVENT_ASYNC_REJECT,
    EVENT_ASYNC_STALL,
    EVENT_ASYNC_VERSION,
    EVENT_COLLECTIVE_STRAGGLER,
    OPT_ALLGATHER_TIME,
    OPT_SHARD_FRAC,
    ROUND_FAILED,
    STEPS_CUMULATIVE,
)


class _Arrival:
    """One buffered client delta, staleness frozen at arrival."""

    __slots__ = ("cid", "arrays", "n_samples", "staleness")

    def __init__(self, cid: int, arrays: list[np.ndarray], n_samples: int,
                 staleness: int) -> None:
        self.cid = cid
        self.arrays = arrays
        self.n_samples = n_samples
        self.staleness = staleness


class AsyncFedRunner(CollectiveFedRunner):
    """Buffered asynchronous federated server over the collective plane.

    Reuses the sync runner end to end (mesh, client runtime, strategy
    replica, device plane, stacking, checkpoint bridge, eval exchange) and
    replaces only the clock: :meth:`run` drives the discrete-event loop.
    """

    def __init__(self, cfg: Config, process_cids: Sequence[int], mesh: ClientMesh | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 liveness: LivenessTracker | None = None,
                 device: str | torch.device | None = None) -> None:
        ar = cfg.photon.async_rounds
        if not ar.enabled:
            raise ValueError("AsyncFedRunner requires photon.async_rounds.enabled=true")
        super().__init__(cfg, process_cids, mesh=mesh, clock=clock, liveness=liveness,
                         device=device)
        if self.n_processes > 1:
            raise ValueError(
                "async rounds are single-controller (one process, many local "
                "clients): a multi-controller gang needs arrival consensus "
                "this runner does not provide"
            )
        if self._adapters_enabled:
            raise ValueError(
                "async rounds with photon.adapters are not supported yet — "
                "per-cohort adapter rounds stay on the synchronous clock"
            )
        self.K = int(ar.buffer_size or cfg.fl.n_total_clients)
        self.min_arrivals = int(ar.min_arrivals)
        self.max_staleness = int(ar.max_staleness)
        self.staleness_policy = ar.staleness_policy
        self.staleness_power = float(ar.staleness_power)
        self.fit_time_s = float(ar.fit_time_s)
        #: the version clock: strategy.current_parameters IS version v
        self.version = 0
        #: simulated seconds elapsed (the discrete-event clock)
        self.sim_time = 0.0
        self._heap: list[tuple[float, int]] = []  # (finish_time, seq)
        self._inflight: dict[int, tuple[int, list[np.ndarray], int, int]] = {}
        self._seq = 0
        self.buffer: list[_Arrival] = []
        self.rejected_total = 0
        self.dropped_total = 0
        self.stalls_total = 0
        self.folds_failed_total = 0
        self._zero_row_cache: list[np.ndarray] | None = None
        # the SLO autopilot's knob: the reject-rate rule widens the bound
        # when too many fits die at admission
        ap = telemetry.autopilot_active()
        if ap is not None:
            ap.register_knob(
                AUTOPILOT_KNOB_MAX_STALENESS,
                lambda: self.max_staleness,
                self.set_max_staleness,
                integer=True,
            )

    def set_max_staleness(self, max_staleness: int) -> None:
        """Runtime-mutable staleness bound. Loud reject on negative values;
        0 is legal (only same-version deltas fold)."""
        s = int(max_staleness)
        if s < 0:
            raise ValueError(
                f"set_max_staleness needs max_staleness >= 0, got "
                f"{max_staleness!r}"
            )
        self.max_staleness = s

    # -- dispatch ------------------------------------------------------------
    def _zero_row(self) -> list[np.ndarray]:
        """A zero delta row padding the buffer up to the full client axis:
        zero weight × zero row contributes exactly 0, so every buffer size
        folds over the one full mesh and the ZeRO-1 plane applies as is."""
        if self._zero_row_cache is None:
            self._zero_row_cache = [np.zeros_like(p) for p in self.strategy.current_parameters]
        return self._zero_row_cache

    def _dispatch(self, cid: int) -> bool:
        """Hand ``cid`` the current version and run its fit now; the delta
        is delivered on the simulated clock after ``fit_time_s ×
        fit_delay_factor``. False when the fit failed (its delta is dropped:
        the SIGKILL-mid-fit shape)."""
        version = self.version
        ptr = self.transport.put(f"async-bcast-v{version}-c{cid}", self.meta,
                                 self.strategy.current_parameters)
        self.runtime.set_broadcast_params(ptr)
        self.transport.free(ptr)
        ins = FitIns(
            server_round=version + 1,
            cids=[cid],
            params=None,
            local_steps=self.cfg.fl.local_steps,
            server_steps_cumulative=self.server_steps_cumulative,
            client_states=(
                {cid: self.client_states[cid]} if cid in self.client_states else {}
            ),
            config=dict(self.cfg.fl.fit_config),
        )
        res = self.runtime.fit(ins, cid)
        nid = self._client_node_id(cid)
        if res.error:
            self.liveness.observe_miss(nid)
            self.dropped_total += 1
            telemetry.emit_event(
                EVENT_COLLECTIVE_STRAGGLER, round=version + 1, cid=cid,
                reason="fit_error", detail=res.error[:200],
            )
            telemetry.emit_event(EVENT_ASYNC_DROP, cid=cid, base_version=version,
                                 reason="fit_error")
            warnings.warn(
                f"async v{version}: cid {cid} fit failed "
                f"({res.error.splitlines()[0][:120]}) — its delta is dropped; "
                "the version clock keeps advancing on survivors",
                stacklevel=2,
            )
            return False
        self.liveness.observe_alive(nid)
        if res.client_state:
            self.client_states[res.cid] = res.client_state
        _, arrays = self.transport.get(res.params)
        self.transport.free(res.params)
        factor = float(res.metrics.get(CLIENT_FIT_DELAY_FACTOR, 1.0))
        finish = self.sim_time + self.fit_time_s * factor
        self._inflight[self._seq] = (cid, arrays, res.n_samples, version)
        heapq.heappush(self._heap, (finish, self._seq))
        self._seq += 1
        return True

    # -- arrivals ------------------------------------------------------------
    def _pop_burst(self) -> list[tuple[int, list[np.ndarray], int, int]]:
        """Every delivery sharing the earliest finish time (ties pop in
        dispatch order). Advances the simulated clock."""
        t0, _ = self._heap[0]
        burst = []
        while self._heap and self._heap[0][0] == t0:
            _, seq = heapq.heappop(self._heap)
            burst.append(self._inflight.pop(seq))
        self.sim_time = t0
        return burst

    def _admit(self, cid: int, arrays: list[np.ndarray], n_samples: int,
               base_version: int) -> bool:
        """Staleness-check one delivered delta into the buffer. True when
        the client is re-dispatched (buffered, or rejected with the fresh
        version), False on a liveness drop."""
        nid = self._client_node_id(cid)
        h = self.liveness.nodes.get(nid)
        if h is not None and h.state != LIVE:
            self.dropped_total += 1
            telemetry.emit_event(EVENT_ASYNC_DROP, cid=cid, base_version=base_version,
                                 reason="liveness")
            return False
        staleness = self.version - base_version
        if staleness > self.max_staleness:
            # rejected: the re-dispatch hands the client the CURRENT params
            self.rejected_total += 1
            telemetry.emit_event(
                EVENT_ASYNC_REJECT, cid=cid, staleness=staleness,
                max_staleness=self.max_staleness, version=self.version,
            )
            return True
        self.buffer.append(_Arrival(cid, arrays, n_samples, staleness))
        return True

    # -- folds -----------------------------------------------------------------
    def _fold_weights(self, entries: list[_Arrival]) -> np.ndarray:
        return discounted_fold_weights([e.n_samples for e in entries],
                                       [e.staleness for e in entries],
                                       self.staleness_policy, self.staleness_power)

    def _stack_padded(self, rows: list[list[np.ndarray]], w: np.ndarray):
        """Rows and weights zero-padded to the full client axis, on the full
        mesh (see :meth:`_zero_row`)."""
        n_total = self.cfg.fl.n_total_clients
        pad = n_total - len(rows)
        rows = rows + [self._zero_row()] * pad
        w_padded = np.concatenate([w, np.zeros(pad, w.dtype)])
        return self._stack_local(rows, self.mesh, n_total), w_padded

    def _wire_bytes(self, entries: list[_Arrival]) -> float:
        return float(modeled_cross_slice_bytes(
            [int(np.prod(r.shape, dtype=np.int64)) for r in entries[0].arrays], len(entries),
            replica=mesh_replica(self.mesh), quantization=self.quantization,
            block=self.q8_block,
        ))

    def _fold_one(self, entries: list[_Arrival]) -> None:
        """Fold one complete buffer into the device plane (or the host
        strategy) and advance the version by one. A fold that raises rolls
        back to the per-version snapshot: the clock holds, the run goes on."""
        v_next = self.version + 1
        n_distinct = len({e.cid for e in entries})
        w = self._fold_weights(entries)
        discounts = staleness_discount([e.staleness for e in entries],
                                       self.staleness_policy, self.staleness_power)
        crash_point("pre-exchange", v_next, self.runtime.node_id)
        t_agg = time.monotonic()
        snap = self.strategy.snapshot()
        plane_snap = self.device_plane.snapshot() if self.device_plane is not None else None
        try:
            stacked, w_local = self._stack_padded([e.arrays for e in entries], w)
            if self.device_plane is not None:
                epoch = self.device_plane.current_epoch()
                crash_point("mid-exchange", v_next, self.runtime.node_id)
                metrics = self.device_plane.run_round(
                    stacked, w_local, lr=self.strategy.effective_lr(n_distinct), epoch=epoch,
                )
                crash_point("pre-update", v_next, self.runtime.node_id)
                self.strategy.current_parameters = self.device_plane.params_host()
                self.strategy.restore_optimizer_state(self.device_plane.state_host(),
                                                      t=self.device_plane.t)
                self.strategy.server_round = v_next
                metrics[OPT_SHARD_FRAC] = self.device_plane.shard_fraction()
                metrics[OPT_ALLGATHER_TIME] = self.device_plane.last_allgather_s
            else:
                crash_point("mid-exchange", v_next, self.runtime.node_id)
                avg_dev, total_dev = hierarchical_weighted_average(
                    stacked, w_local, self.mesh, quantization=self.quantization,
                    block=self.q8_block, return_total=True,
                )
                crash_point("pre-update", v_next, self.runtime.node_id)
                avg = [a.detach().to("cpu").numpy().copy() for a in avg_dev]
                total = float(total_dev)
                # int32 weights = the all-fresh buffer: keep the sync path's
                # int total, so N_SAMPLES stays the same bits
                n_samples = (int(round(total)) if np.issubdtype(w.dtype, np.integer)
                             else total)
                metrics = self._apply_average_host(v_next, avg, n_samples, n_distinct)
        except Exception as e:  # noqa: BLE001 — a torn fold must not abort
            self.strategy.restore(snap)
            if self.device_plane is not None:
                self.device_plane.abandon()
                self.device_plane.restore(plane_snap)
            self.folds_failed_total += 1
            warnings.warn(
                f"async v{v_next}: fold failed ({type(e).__name__}: {e}) — "
                "rolled back to the pre-fold version; buffer entries dropped, "
                "the clock holds",
                stacklevel=2,
            )
            self.history.record(v_next, {ROUND_FAILED: 1.0})
            return
        metrics[COLLECTIVE_AGG_TIME] = time.monotonic() - t_agg
        metrics[COLLECTIVE_WIRE_BYTES] = self._wire_bytes(entries)
        self._advance(entries, discounts, metrics)

    def _fold_grouped(self, buffers: list[list[_Arrival]]) -> None:
        """An arrival burst's B complete buffers through ONE grouped
        exchange: every entry lands weighted in its own buffer's slot, one
        reduction computes all B discounted averages, then the B strategy
        updates apply in order (the averages do not depend on the params,
        so this is the sequential fold). Host-optimizer path only."""
        n_total = self.cfg.fl.n_total_clients
        B = len(buffers)
        flat = [e for entries in buffers for e in entries]
        w = np.concatenate([self._fold_weights(entries).astype(np.float32)
                            for entries in buffers])
        onehot = np.zeros((n_total, B), np.float32)
        i = 0
        for b, entries in enumerate(buffers):
            onehot[i:i + len(entries), b] = 1.0
            i += len(entries)
        t_agg = time.monotonic()
        stacked, w_local = self._stack_padded([e.arrays for e in flat], w)
        with absorb_compiles("async/grouped"):
            leaves, totals = grouped_weighted_average(
                stacked, w_local, onehot, self.mesh,
                quantization=self.quantization, block=self.q8_block,
            )
            leaves = [leaf.detach().to("cpu").numpy() for leaf in leaves]
            totals = totals.detach().to("cpu").numpy()
        agg_s = (time.monotonic() - t_agg) / B
        for b, entries in enumerate(buffers):
            v_next = self.version + 1
            snap = self.strategy.snapshot()
            try:
                metrics = self._apply_average_host(
                    v_next, [leaf[b].copy() for leaf in leaves], float(totals[b]),
                    len({e.cid for e in entries}),
                )
            except Exception as e:  # noqa: BLE001 — same stance as _fold_one
                self.strategy.restore(snap)
                self.folds_failed_total += 1
                warnings.warn(
                    f"async v{v_next}: grouped fold slot {b} failed "
                    f"({type(e).__name__}: {e}) — rolled back, clock holds",
                    stacklevel=2,
                )
                self.history.record(v_next, {ROUND_FAILED: 1.0})
                continue
            metrics[COLLECTIVE_AGG_TIME] = agg_s
            metrics[COLLECTIVE_WIRE_BYTES] = self._wire_bytes(entries)
            discounts = staleness_discount([e.staleness for e in entries],
                                           self.staleness_policy, self.staleness_power)
            self._advance(entries, discounts, metrics)

    def _advance(self, entries: list[_Arrival], discounts: np.ndarray, metrics: dict) -> None:
        """Commit one version advance: clock, step counter, KPIs, event."""
        self.version += 1
        self.server_steps_cumulative += self.cfg.fl.local_steps
        stale = [e.staleness for e in entries]
        metrics[ASYNC_VERSION] = float(self.version)
        metrics[ASYNC_ARRIVALS] = float(len(entries))
        metrics[ASYNC_STALENESS_MEAN] = float(np.mean(stale))
        metrics[ASYNC_STALENESS_MAX] = float(np.max(stale))
        metrics[ASYNC_DISCOUNT_MEAN] = float(np.mean(discounts))
        metrics[ASYNC_BUFFER_FILL] = float(len(self.buffer))
        metrics[ASYNC_SIM_TIME] = float(self.sim_time)
        metrics[ASYNC_REJECTED] = float(self.rejected_total)
        metrics[ASYNC_DROPPED] = float(self.dropped_total)
        metrics[ASYNC_STALLS] = float(self.stalls_total)
        metrics[STEPS_CUMULATIVE] = float(self.server_steps_cumulative)
        self.aggregation_paths[self.version] = "async"
        telemetry.emit_event(
            EVENT_ASYNC_VERSION, version=self.version, arrivals=len(entries),
            staleness_max=int(np.max(stale)), sim_time=round(self.sim_time, 6),
        )
        self.history.record(self.version, metrics)

    def _drain_folds(self, target: int) -> int:
        """Fold every complete buffer the arrivals allow, grouped when a
        burst completed several at once. Returns the versions advanced; 0
        with a full but undiverse buffer is a STALL (counted, evented)."""
        ready: list[list[_Arrival]] = []
        while len(self.buffer) >= self.K and self.version + len(ready) < target:
            head = self.buffer[:self.K]
            cids = [e.cid for e in head]
            if len(set(cids)) < self.min_arrivals:
                # a fast client can fill the head alone while a distinct
                # contributor sits deeper: promote the earliest such entry
                # over the head's last duplicate before declaring a stall
                deeper = next((j for j in range(self.K, len(self.buffer))
                               if self.buffer[j].cid not in set(cids)), None)
                if deeper is not None:
                    dup = max(i for i in range(self.K) if cids.index(cids[i]) != i)
                    self.buffer[dup], self.buffer[deeper] = self.buffer[deeper], self.buffer[dup]
                    continue
                self.stalls_total += 1
                telemetry.emit_event(
                    EVENT_ASYNC_STALL, buffered=len(self.buffer), distinct=len(set(cids)),
                    min_arrivals=self.min_arrivals, version=self.version,
                )
                break
            ready.append(head)
            del self.buffer[:self.K]
        if not ready:
            return 0
        v0 = self.version
        if (len(ready) > 1 and self.device_plane is None
                and len(ready) * self.K <= self.cfg.fl.n_total_clients):
            self._fold_grouped(ready)
        else:
            for entries in ready:
                self._fold_one(entries)
        return self.version - v0

    # -- the event loop --------------------------------------------------------
    def run_versions(self, n_versions: int | None = None, ckpt_mgr=None, ckpt_every: int = 1,
                     eval_every: int | None = None) -> History:
        """Drive the discrete-event loop until ``n_versions`` advances (or
        every client is dead or dry: the clock holds and the run returns).
        ``ckpt_mgr`` streams a version-tagged checkpoint every
        ``ckpt_every`` advances (the manifest-last round objects the
        hot-swap watcher consumes)."""
        ar = self.cfg.photon.async_rounds
        target = int(n_versions if n_versions is not None
                     else (ar.n_versions or self.cfg.fl.n_rounds))
        eval_every = eval_every if eval_every is not None else self.cfg.fl.eval_interval_rounds
        if eval_every:
            self.evaluate_round(0)
        last_ckpt = self.version
        last_eval = 0
        for cid in self.process_cids:
            self._dispatch(cid)
        while self.version < target:
            if not self._heap:
                warnings.warn(
                    f"async: no deltas in flight at v{self.version}/"
                    f"{target} (all clients dead or dropped) — the version "
                    "clock holds; run returns without aborting",
                    stacklevel=2,
                )
                break
            redispatch: list[int] = []
            for cid, arrays, n_samples, base_version in self._pop_burst():
                if self._admit(cid, arrays, n_samples, base_version):
                    redispatch.append(cid)
            stalls_before = self.stalls_total
            advanced = self._drain_folds(target)
            if self.stalls_total > stalls_before:
                # min-arrivals is unreachable when every delta that can still
                # land comes from fewer distinct clients than the gate wants:
                # hold the clock and stop feeding the heap (never an abort)
                reachable = ({e.cid for e in self.buffer}
                             | {v[0] for v in self._inflight.values()}
                             | set(redispatch))
                if len(reachable) < self.min_arrivals:
                    warnings.warn(
                        f"async: version clock stalled at v{self.version} — "
                        f"{len(reachable)} distinct client(s) can still "
                        f"contribute but min_arrivals={self.min_arrivals}; "
                        "holding the clock and returning (never an abort)",
                        stacklevel=2,
                    )
                    redispatch = []
            if advanced and ckpt_mgr is not None and self.version - last_ckpt >= ckpt_every:
                self.save_checkpoint(ckpt_mgr, self.version)
                last_ckpt = self.version
            if advanced and eval_every:
                v = (self.version // eval_every) * eval_every
                if v > last_eval:
                    self.evaluate_round(v)
                    last_eval = v
            if self.version < target:
                for cid in redispatch:
                    self._dispatch(cid)
            ap = telemetry.autopilot_active()
            if ap is not None:
                # the reject-rate rule reduces over these context deltas
                ap.tick("async", rejected_total=self.rejected_total, version=self.version)
            steady_point("async/event")
        return self.history

    def run(self, n_rounds: int | None = None) -> History:
        """The sync runner's entry point: versions are the round count."""
        return self.run_versions(n_rounds)

    # -- checkpoint bridge -------------------------------------------------------
    def control_state_for_checkpoint(self) -> dict:
        """Version-tagged control state: the async clock and its ladder
        counters ride every streamed checkpoint's server_state."""
        out = super().control_state_for_checkpoint()
        out["async_version"] = int(self.version)
        out["async_rejected_total"] = int(self.rejected_total)
        out["async_dropped_total"] = int(self.dropped_total)
        out["async_stalls_total"] = int(self.stalls_total)
        return out

    def load_server_state(self, parameters, state=None, control=None) -> None:
        super().load_server_state(parameters, state, control)
        if control:
            self.version = int(control.get("async_version", self.version))
            self.rejected_total = int(control.get("async_rejected_total", self.rejected_total))
            self.dropped_total = int(control.get("async_dropped_total", self.dropped_total))
            self.stalls_total = int(control.get("async_stalls_total", self.stalls_total))
        # in-flight deltas and the buffer never survive a restart: clients
        # re-dispatch from the restored version
        self._heap.clear()
        self._inflight.clear()
        self.buffer.clear()
        self._zero_row_cache = None
