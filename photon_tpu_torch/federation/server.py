"""ServerApp: the federated round loop (the port of
``photon_tpu/federation/server.py``).

- client sampling by ``random.Random(sample_seed)``, fast-forwarded on
  resume, so both packages sample the same cids in every round;
- sliding-window scheduling: one outstanding cid per node, refilled as
  replies arrive; a failed or timed-out cid is retried once, and more
  failures than ``accept_failures_cnt`` raise
  :class:`TooManyFailuresError` unless ``ignore_failed_rounds``; a node
  whose request timed out is quarantined until its stale reply drains,
  and a node that died and came back (a multiprocess respawn, a TCP
  re-HELLO) gets the round's broadcast again and is readmitted;
- a liveness sweep before each round's broadcast (``membership.py``);
- streaming aggregation: client results are fetched, folded into the
  running average and freed one at a time; with a wire codec they stay
  compressed until the fold decodes them against the round's broadcast;
- round checkpoints (in the background when ``async_checkpoint``),
  resume with negative indexing, GC, cross-run import; client-state and
  ``server_steps_cumulative`` bookkeeping; the JAX package's metric names;
- the ``photon.chaos`` injector installed for the process under the scope
  ``server`` (its crash faults neutered under the in-process driver,
  whose nodes are this process);
- with ``photon.telemetry`` on: a ``server/round`` span over each round's
  phase spans, the nodes' piggybacked spans and events merged in, the
  events written through to ``{dir}/events-{run}.jsonl``, one merged
  Perfetto trace ``{dir}/trace-{run}.json`` at the end of the run, typed
  round-phase histograms, the device-memory and kernel-build samples and
  the NaN sentinel at each round boundary, ``/metrics``, ``/statusz`` and
  ``POST /debug/profile`` on ``prom_port``, and a ``torch.profiler``
  capture over the first ``profile_rounds`` rounds;
- each round's end is the retrace sentinel's ``server/round`` steady point
  (``analysis/runtime.py``; one ``None`` check when none is installed).
"""

from __future__ import annotations

import pathlib
import random
import time
import uuid as uuid_mod
import warnings
from collections import deque
from typing import Callable, Iterator

import numpy as np

from photon_tpu_torch import chaos, telemetry
from photon_tpu_torch.analysis.runtime import steady_point
from photon_tpu_torch.checkpoint.server import ServerCheckpointManager
from photon_tpu_torch.codec.params import ParamsMetadata
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.configs import EvaluateRoundConfig, FitRoundConfig
from photon_tpu_torch.federation.driver import Driver
from photon_tpu_torch.federation.membership import (
    LivenessTracker,
    hello_backoff_total,
    iter_new_nodes,
)
from photon_tpu_torch.federation.messages import (
    Ack,
    Broadcast,
    EvaluateIns,
    EvaluateRes,
    FitIns,
    FitRes,
    Query,
)
from photon_tpu_torch.federation.transport import ParamTransport
from photon_tpu_torch.metrics.history import History
from photon_tpu_torch.strategy import dispatch_strategy
from photon_tpu_torch.strategy.base import ClientResult
from photon_tpu_torch.strategy.metrics import GradientNoiseScale
from photon_tpu_torch.utils.hostpool import HostPool
from photon_tpu_torch.utils.profiling import (
    BROADCAST_POST_TIME,
    BROADCAST_PRE_TIME,
    CHECKPOINT_TIME,
    CKPT_ASYNC_WRITE_S,
    CKPT_BARRIER_WAIT_S,
    CLIENT_PSEUDO_GRAD_NORM,
    COMPILES_TOTAL,
    EVAL_ROUND_FAILED,
    EVAL_ROUND_SPAN,
    EVAL_ROUND_TIME,
    FIT_ROUND_TIME,
    HBM_BYTES_IN_USE,
    HBM_PEAK_BYTES,
    PSEUDO_GRAD_NORM,
    ROUND_FAILED,
    ROUND_SPAN,
    ROUND_TIME,
    SAMPLE_CLIENTS_SPAN,
    STEPS_CUMULATIVE,
)


class TooManyFailuresError(RuntimeError):
    """The round's failure budget was exceeded."""


def centralized_warm_start(store, run_uuid: str) -> tuple[ParamsMetadata, list[np.ndarray]]:
    """Initial global params from another run's latest centralized
    checkpoint."""
    from photon_tpu_torch.centralized import CENTRAL_CID
    from photon_tpu_torch.checkpoint.client import ClientCheckpointManager

    mgr = ClientCheckpointManager(store, run_uuid)
    steps = mgr.steps(CENTRAL_CID)
    if not steps:
        raise FileNotFoundError(f"run {run_uuid!r} has no centralized checkpoints")
    return mgr.load_params_only(CENTRAL_CID, steps[-1])


class ServerApp:
    def __init__(
        self,
        cfg: Config,
        driver: Driver,
        transport: ParamTransport,
        ckpt_mgr: ServerCheckpointManager | None = None,
        history: History | None = None,
        initial_params: tuple[ParamsMetadata, list[np.ndarray]] | None = None,
    ) -> None:
        cfg.refuse_param_dtype_in_round()
        self.cfg = cfg
        self.driver = driver
        self.transport = transport
        self.ckpt_mgr = ckpt_mgr
        self.history = history or History()
        self.strategy = dispatch_strategy(cfg.fl)
        # one bounded pool (photon.host_threads) for the codec's per-layer
        # work, the aggregation fold and its one-client decode-ahead
        self.host_pool = HostPool(cfg.photon.host_threads)
        transport.host_pool = self.host_pool
        self.strategy.host_pool = self.host_pool
        if transport.codec is not None:
            # compressed fit results reach the strategy undecoded; the fold
            # decodes one client at a time against the reference that
            # broadcast_parameters pins each round
            codec = transport.codec
            self.strategy.payload_decoder = lambda p: codec.decode(p, pool=self.host_pool)
        self._wire_snapshot = transport.stats.snapshot()
        # a misspelled per-round knob fails here, not in every client
        FitRoundConfig.from_dict(cfg.fl.fit_config)
        EvaluateRoundConfig.from_dict(cfg.fl.eval_config)
        self.gns = GradientNoiseScale()
        mem = cfg.photon.membership
        self.membership = LivenessTracker(
            suspect_after_misses=mem.suspect_after_misses,
            dead_after_misses=mem.dead_after_misses,
            ping_timeout_s=mem.ping_timeout_s,
        )
        # the injector is process-global; a config with chaos off clears
        # whatever a previous config left installed
        crash_fn = None
        if cfg.photon.chaos.enabled and cfg.photon.chaos.crash_phase:
            from photon_tpu_torch.federation.driver import InProcessDriver

            if isinstance(driver, InProcessDriver):
                # in-process nodes are this process: a real crash would end
                # the run with no budget or restart to absorb it
                warnings.warn(
                    "chaos.crash_phase with the in-process driver would kill "
                    "the server itself — crash injection disabled (use the "
                    "multiprocess or TCP driver for kill scenarios)",
                    stacklevel=2,
                )
                crash_fn = lambda code: None  # noqa: E731
        chaos.install(cfg.photon.chaos, scope="server", crash_fn=crash_fn)
        # the server's tracer holds the merged timeline: its own phase spans
        # and the nodes' spans shipped back on their replies. Events write
        # through at once (they must survive a crash); the trace is written
        # at the end of the run. A config with telemetry off clears what a
        # previous config left installed
        tel = cfg.photon.telemetry
        self.telemetry_dir = tel.dir or str(pathlib.Path(cfg.photon.save_path) / "telemetry")
        telemetry.install(
            tel, scope="server",
            events_path=(str(pathlib.Path(self.telemetry_dir) / f"events-{cfg.run_uuid}.jsonl")
                         if tel.enabled else None),
            profile_dir=self.telemetry_dir,
        )
        self._prom = None
        self.server_steps_cumulative = 0
        self.client_states: dict[int, dict] = {}
        self.start_round = 1
        self._rng = random.Random(cfg.fl.sample_seed)
        self._rounds_sampled = 0
        self._last_broadcast: Broadcast | None = None

        if initial_params is None:
            from photon_tpu_torch.codec.params import params_to_ndarrays
            from photon_tpu_torch.models.mpt import init_params

            initial_params = params_to_ndarrays(init_params(cfg.model, seed=cfg.seed))
        self.metadata, params = initial_params
        if cfg.fl.aggregate_momenta:
            # payloads become [params | m1 | m2], the momenta averaged like
            # the params (zero momenta at init)
            from photon_tpu_torch.train.param_ops import extend_with_momenta, has_momenta

            if not has_momenta(self.metadata):
                self.metadata, params = extend_with_momenta(self.metadata, params)
        self.strategy.initialize(params)

    # ------------------------------------------------------------------
    # resume / checkpoint
    # ------------------------------------------------------------------
    def try_resume(self) -> int | None:
        """Restore from ``photon.resume_round`` if set; returns the round."""
        if self.ckpt_mgr is None or self.cfg.photon.resume_round is None:
            return None
        rnd = self.ckpt_mgr.resolve_resume_round(self.cfg.photon.resume_round,
                                                 self.strategy.state_keys)
        # every object the strategy writes, the adaptive strategies' step
        # counter ``_t`` included (the JAX server reads the state keys only,
        # so its FedAdam/FedYogi restart bias correction on resume)
        metadata, params, strategy_state, server_state = self.ckpt_mgr.load_round(
            rnd, tuple(self.strategy.state_for_checkpoint()))
        self.metadata = metadata
        self.strategy.initialize(params, strategy_state)
        self.server_steps_cumulative = int(server_state.get("server_steps_cumulative", 0))
        self.client_states = {int(k): v for k, v in server_state.get("client_states", {}).items()}
        self.history = History.from_dict(server_state.get("history", {}))
        if "gns" in server_state:
            self.gns.load_state_dict(server_state["gns"])
        # replay the sampler so the cids match an uninterrupted run
        for _ in range(int(server_state.get("rounds_sampled", rnd))):
            self._sample_clients()
        self.start_round = rnd + 1
        return rnd

    def save_checkpoint(self, server_round: int) -> None:
        if self.ckpt_mgr is None:
            return
        assert self.strategy.current_parameters is not None
        # the control state is snapshotted now; the arrays go by reference
        # (strategies rebind, never write into them)
        server_state = {
            "server_steps_cumulative": self.server_steps_cumulative,
            "client_states": dict(self.client_states),
            "history": self.history.to_dict(),
            "rounds_sampled": self._rounds_sampled,
            "gns": self.gns.state_dict(),
            "run_uuid": self.cfg.run_uuid,
            "saved_at": time.time(),
        }
        if self.cfg.photon.async_checkpoint:
            self.ckpt_mgr.save_round_async(
                server_round, self.metadata, self.strategy.current_parameters,
                self.strategy.state_for_checkpoint(), server_state,
                cleanup_keep=(self.cfg.photon.keep_checkpoints, self.strategy.state_keys),
            )
            return
        self.ckpt_mgr.save_round(server_round, self.metadata, self.strategy.current_parameters,
                                 self.strategy.state_for_checkpoint(), server_state)
        self.ckpt_mgr.cleanup(self.cfg.photon.keep_checkpoints, self.strategy.state_keys)

    # ------------------------------------------------------------------
    # round mechanics
    # ------------------------------------------------------------------
    def _sample_clients(self) -> list[int]:
        self._rounds_sampled += 1
        return sorted(self._rng.sample(range(self.cfg.fl.n_total_clients),
                                       self.cfg.fl.n_clients_per_round))

    def broadcast_parameters(self, server_round: int) -> float:
        """Push the global params to every node; returns elapsed seconds."""
        t0 = time.monotonic()
        assert self.strategy.current_parameters is not None
        ptr = self.transport.put(f"bcast-r{server_round}-{uuid_mod.uuid4().hex[:8]}",
                                 self.metadata, self.strategy.current_parameters)
        # the broadcast is the round's delta base: compressed client
        # results (w_new − w_global) decode against these arrays
        self.transport.set_reference(self.strategy.current_parameters)
        msg = Broadcast(server_round, ptr)
        acks = self.driver.broadcast(msg, on_stale=self._free_stale_reply)
        for a in acks.values():
            self._ingest_result_telemetry(a)
        # a node dying at broadcast time is churn, not a failure: it leaves
        # the registry (TCP) or respawns without params (multiprocess), and
        # the window sends it the broadcast again when it is back
        bad = [nid for nid, a in acks.items() if not a.ok and "node died" not in (a.detail or "")]
        if bad:
            raise RuntimeError(f"broadcast failed on nodes {bad}: {[acks[n].detail for n in bad]}")
        # every node has copied the new payload: the previous one can go
        if self._last_broadcast is not None:
            self.transport.free(self._last_broadcast.params)
        self._last_broadcast = msg
        return time.monotonic() - t0

    def free_transport(self) -> None:
        """Release the live broadcast and any transport leftovers."""
        if self._last_broadcast is not None:
            self.transport.free(self._last_broadcast.params)
            self._last_broadcast = None
        self.transport.cleanup()
        self.host_pool.close()

    def _free_stale_reply(self, reply) -> None:
        """Free the payloads a late or stale reply carries, after merging its
        piggybacked telemetry (a quarantined node's late spans are the
        struggling-node evidence the timeline exists to show)."""
        for res in (reply if isinstance(reply, list) else [reply]):
            self._ingest_result_telemetry(res)
            ptr = getattr(res, "params", None)
            if ptr is not None:
                self.transport.free(ptr)

    def _membership_round_start(self, server_round: int) -> None:
        mem = self.cfg.photon.membership
        if mem.enabled and mem.ping_interval_rounds and server_round % mem.ping_interval_rounds == 0:
            self.membership.sweep(self.driver, on_stale=self._free_stale_reply)
        else:
            self.membership.register_present(self.driver.node_ids())

    def _membership_metrics(self) -> dict[str, float]:
        return self.membership.round_metrics(
            hello_backoff_s=hello_backoff_total(self.driver.hello_stats()))

    def _sliding_window(self, server_round: int, cids: list[int],
                        make_ins: Callable[[list[int]], object], timeout: float) -> Iterator[object]:
        """One outstanding cid per node; a failed or timed-out cid is
        retried once (on whichever node frees up first); results are
        yielded as they arrive."""
        queue: deque[int] = deque(cids)
        retried: set[int] = set()
        inflight: dict[int, tuple[str, int]] = {}
        free: deque[str] = deque(self.driver.node_ids())
        failures: list[tuple[int, str]] = []
        # nodes whose request timed out, by the abandoned message id: they
        # stay out of rotation until that stale reply drains (a node still
        # busy with it would time out the next cid too)
        suspect: dict[int, str] = {}
        # nodes written off after a whole extra window without the stale
        # reply: kept out of the rejoin scan until it finally drains
        wedged: set[str] = set()
        # message ids already consumed: a repeated reply carries the pointer
        # the fold is reading, so it is dropped, never freed
        consumed: set[int] = set()
        # the fold's decode-ahead worker advances this generator, so a refill
        # may be sent from a thread with an empty span stack: every send
        # carries the context of the thread that opened the window (the JAX
        # package sends those without one, and their node spans start
        # traces of their own)
        parent = telemetry.current_context()

        def send(nid: str, msg) -> int:
            with telemetry.attach(parent):
                return self.driver.send(nid, msg)

        def rejoin(nid: str) -> None:
            """A node without the round's params: send the broadcast again
            (its ack drains as a stale reply) before a cid lands there."""
            if self._last_broadcast is not None:
                send(nid, self._last_broadcast)

        while queue or inflight:
            # a node id no structure here tracks just (re)joined mid-round:
            # a re-HELLO after a crash, or a new registration
            tracked = set(free)
            tracked.update(n for n, _ in inflight.values())
            tracked.update(suspect.values())
            tracked.update(wedged)
            for nid in iter_new_nodes(self.driver.node_ids(), tracked):
                rejoin(nid)
                free.append(nid)
                if nid in self.membership.nodes:
                    # a known node came back; a new one is scale-up, not churn
                    self.membership.note_readmitted(nid)
                else:
                    self.membership.touch(nid)
            while queue and free:
                nid, cid = free.popleft(), queue.popleft()
                inflight[send(nid, make_ins([cid]))] = (nid, cid)
            if not inflight and not suspect:
                # every node died: the remaining cids can never run
                failures.extend((cid, "no live nodes") for cid in queue)
                queue.clear()
                break
            try:
                nid, mid, reply = self.driver.recv_any(timeout=timeout)
            except TimeoutError:
                live = set(self.driver.node_ids())
                for mid, (n, cid) in inflight.items():
                    if cid not in retried and live:
                        retried.add(cid)
                        queue.append(cid)
                    else:
                        failures.append((cid, f"timeout after {timeout}s on node {n}"))
                    if n in live:
                        suspect[mid] = n
                if not inflight and suspect:
                    # a pure drain-wait on quarantined nodes that stayed
                    # silent a whole extra window: stop waiting on them
                    wedged.update(suspect.values())
                    suspect.clear()
                inflight.clear()
                if not free and queue and not suspect:
                    failures.extend((cid, "no live nodes") for cid in queue)
                    queue.clear()
                continue
            if mid not in inflight:
                if mid in consumed:
                    continue  # a repeated delivery: the first copy owns the payload
                consumed.add(mid)
                self._free_stale_reply(reply)
                drained = suspect.pop(mid, None)
                if drained is None and nid in wedged:
                    wedged.discard(nid)  # a written-off node answered: it recovered
                    drained = nid
                if drained is not None and drained in self.driver.node_ids():
                    if any(isinstance(r, Ack) and "node died" in (r.detail or "")
                           for r in (reply if isinstance(reply, list) else [reply])):
                        # a re-HELLO's dead letter, not a late reply: the
                        # restarted process has no round params
                        rejoin(drained)
                        self.membership.note_readmitted(drained)
                    free.append(drained)
                continue
            _, cid = inflight.pop(mid)
            consumed.add(mid)
            replies = reply if isinstance(reply, list) else [reply]
            node_died = any(isinstance(r, Ack) and "node died" in (r.detail or "") for r in replies)
            if node_died and nid in self.driver.node_ids():
                # respawned under the same id (multiprocess) or re-HELLO'd
                # (TCP): no round params until the broadcast is sent again
                rejoin(nid)
                free.append(nid)
                self.membership.note_readmitted(nid)
            elif not node_died:
                free.append(nid)
            # else the node is gone (TCP evicted it): out of rotation
            for res in replies:
                err = res.detail if isinstance(res, Ack) else getattr(res, "error", None)
                if isinstance(res, Ack) or err:
                    if err and "no parameters" in err and nid in self.driver.node_ids():
                        # an externally restarted node came back under its
                        # old id without the round's broadcast
                        rejoin(nid)
                    if cid not in retried and self.driver.node_ids():
                        retried.add(cid)
                        queue.append(cid)
                    else:
                        failures.append((cid, err or "unknown"))
                    continue
                yield res

        if failures and len(failures) > self.cfg.fl.accept_failures_cnt:
            raise TooManyFailuresError(
                f"round {server_round}: {len(failures)} failures "
                f"(budget {self.cfg.fl.accept_failures_cnt}): {failures}")

    # ------------------------------------------------------------------
    # rounds
    # ------------------------------------------------------------------
    def fit_round(self, server_round: int) -> dict[str, float]:
        t_round = time.monotonic()
        with telemetry.span(SAMPLE_CLIENTS_SPAN, round=server_round):
            cids = self._sample_clients()
        local_steps = self.cfg.fl.local_steps

        def make_ins(cid_batch: list[int]) -> FitIns:
            return FitIns(
                server_round=server_round,
                cids=cid_batch,
                params=None,  # nodes use the round's broadcast
                local_steps=local_steps,
                server_steps_cumulative=self.server_steps_cumulative,
                client_states={c: self.client_states[c] for c in cid_batch
                               if c in self.client_states},
                config=dict(self.cfg.fl.fit_config),
            )

        per_client_sq: list[float] = []
        per_client_n: list[int] = []

        def results() -> Iterator[ClientResult]:
            for res in self._sliding_window(server_round, cids, make_ins,
                                            timeout=self.cfg.fl.fit_timeout_s):
                assert isinstance(res, FitRes)
                self._ingest_result_telemetry(res)
                # decode=False: a compressed payload stays compressed until
                # the streaming fold decodes it, one client at a time
                _, arrays = self.transport.get(res.params, decode=False)
                if res.client_state:
                    self.client_states[res.cid] = res.client_state
                g = res.metrics.get(CLIENT_PSEUDO_GRAD_NORM)
                if g is not None:
                    per_client_sq.append(float(g) ** 2)
                    per_client_n.append(res.n_samples)
                yield ClientResult(res.cid, arrays, res.n_samples, res.metrics)
                self.transport.free(res.params)

        t_fit = time.monotonic()
        # the same window as the fit_round_time KPI: scheduling, the fits
        # and the streaming fold
        with telemetry.span(FIT_ROUND_TIME, round=server_round, n_cids=len(cids)):
            _, metrics = self.strategy.aggregate_fit(server_round, results())
        metrics[FIT_ROUND_TIME] = time.monotonic() - t_fit
        agg_sq = metrics.get(PSEUDO_GRAD_NORM, 0.0) ** 2
        metrics.update(self.gns.update(per_client_sq, per_client_n, agg_sq, sum(per_client_n)))
        self.server_steps_cumulative += local_steps
        metrics[STEPS_CUMULATIVE] = float(self.server_steps_cumulative)
        metrics[ROUND_TIME] = time.monotonic() - t_round
        # bytes on the wire since the last fit round: each byte counted once
        metrics.update(self.transport.stats.metrics_since(self._wire_snapshot))
        self._wire_snapshot = self.transport.stats.snapshot()
        return metrics

    def evaluate_round(self, server_round: int) -> dict[str, float]:
        """Federated eval over every client, not a sample."""
        cids = list(range(self.cfg.fl.n_total_clients))

        def make_ins(cid_batch: list[int]) -> EvaluateIns:
            return EvaluateIns(server_round=server_round, cids=cid_batch, params=None,
                               max_batches=self.cfg.train.eval_batches,
                               config=dict(self.cfg.fl.eval_config))

        t0 = time.monotonic()
        results = []
        with telemetry.span(EVAL_ROUND_SPAN, round=server_round):
            for res in self._sliding_window(server_round, cids, make_ins,
                                            timeout=self.cfg.fl.eval_timeout_s):
                assert isinstance(res, EvaluateRes)
                self._ingest_result_telemetry(res)
                results.append((res.n_samples, res.loss, res.metrics))
        _, metrics = self.strategy.aggregate_evaluate(server_round, results)
        metrics[EVAL_ROUND_TIME] = time.monotonic() - t0
        return metrics

    @staticmethod
    def _ingest_result_telemetry(res) -> None:
        """Fold a reply's piggybacked spans and events (FitRes, EvaluateRes
        or Ack) into the merged timeline (a None check with telemetry off)."""
        telemetry.ingest(getattr(res, "spans", None), getattr(res, "events", None))

    def run(self, n_rounds: int | None = None) -> History:
        """The whole loop: resume or import, the round-0 checkpoint and
        eval, then the rounds."""
        cfg = self.cfg
        n_rounds = n_rounds if n_rounds is not None else cfg.fl.n_rounds
        resumed = self.try_resume()
        if resumed is None and self.ckpt_mgr is not None and cfg.photon.restore_run_uuid:
            self.ckpt_mgr.import_run(cfg.photon.restore_run_uuid, self.strategy.state_keys)
            self.cfg.photon.resume_round = -1
            resumed = self.try_resume()
        if resumed is None and self.ckpt_mgr is not None and cfg.photon.checkpoint:
            self.save_checkpoint(0)

        # /metrics, /statusz and POST /debug/profile over the live History
        # and the observatory (photon.telemetry.prom_port)
        tel = cfg.photon.telemetry
        if tel.enabled and tel.prom_port:
            from photon_tpu_torch.telemetry.prom import PromServer

            self._prom = PromServer(self.history, tel.prom_port,
                                    hub=telemetry.metrics_active(),
                                    health=telemetry.health_active(),
                                    profiler=telemetry.profiler_active())
            self._prom.start()
        # photon.telemetry.profile_rounds: a capture over the first N rounds
        prof = telemetry.profiler_active()
        if prof is not None and tel.profile_rounds > 0:
            from photon_tpu_torch.telemetry.introspect import ProfileBusyError

            try:
                prof.request(tel.profile_rounds, tag="startup")
            except ProfileBusyError:
                warnings.warn("telemetry.profile_rounds: a capture is already armed — "
                              "skipping the startup profile", stacklevel=2)

        if cfg.fl.eval_interval_rounds and self.start_round == 1:
            t_pre = self.broadcast_parameters(0)
            try:
                m = self.evaluate_round(0)
            except TooManyFailuresError:
                if not cfg.fl.ignore_failed_rounds:
                    raise
                m = {EVAL_ROUND_FAILED: 1.0}
            m[BROADCAST_PRE_TIME] = t_pre
            self.history.record(0, m)

        try:
            for rnd in range(self.start_round, n_rounds + 1):
                # a profile capture starts and stops at round starts (one
                # None check when nothing is armed)
                telemetry.profile_tick("server/round")
                # the umbrella span every phase span, and through
                # Envelope.trace every node's fit and eval span, parents to
                with telemetry.span(ROUND_SPAN, round=rnd):
                    self._one_round(cfg, rnd)
                # the retrace sentinel bills a kernel build in this round to
                # its boundary (one None check when none is installed)
                steady_point("server/round")
            telemetry.profile_tick("server/round")
        finally:
            # the last background write lands (and raises) before return;
            # the transport is freed whatever happens
            try:
                if self.ckpt_mgr is not None:
                    self.ckpt_mgr.wait_pending()
            finally:
                self.free_transport()
                try:
                    self.export_telemetry()
                except Exception:  # noqa: BLE001 — the trace never takes the run
                    # down (nor masks its real error): a full disk costs the
                    # timeline, not the History
                    warnings.warn("telemetry trace export failed", stacklevel=2)
        return self.history

    def export_telemetry(self) -> str | None:
        """Write the merged Perfetto/Chrome trace (server and ingested node
        spans, events as instant markers), stop the HTTP endpoint and flush
        a profile capture still running. Returns the trace path, or None
        with telemetry off. Idempotent."""
        if self._prom is not None:
            self._prom.close()
            self._prom = None
        prof = telemetry.profiler_active()
        if prof is not None:
            # a capture armed for more rounds than the run had still flushes
            prof.close()
        tr = telemetry.active()
        if tr is None:
            return None
        from photon_tpu_torch.telemetry.export import write_chrome_trace

        log = telemetry.events_active()
        path = pathlib.Path(self.telemetry_dir) / f"trace-{self.cfg.run_uuid}.json"
        return write_chrome_trace(
            path, tr.snapshot(), events=log.snapshot() if log is not None else None,
            metadata={"run_uuid": self.cfg.run_uuid, "dropped_spans": tr.dropped},
        )

    def _one_round(self, cfg: Config, rnd: int) -> None:
        if cfg.photon.refresh_period and rnd > 1 and (rnd - 1) % cfg.photon.refresh_period == 0:
            self.driver.broadcast(Query("refresh"), on_stale=self._free_stale_reply)
        self._membership_round_start(rnd)
        with telemetry.span(BROADCAST_PRE_TIME, round=rnd):
            t_pre = self.broadcast_parameters(rnd)
        try:
            metrics = self.fit_round(rnd)
        except TooManyFailuresError:
            if not cfg.fl.ignore_failed_rounds:
                raise
            failed = {ROUND_FAILED: 1.0}
            failed.update(self._membership_metrics())
            self._observe_round_health(rnd, failed)
            self.history.record(rnd, failed)
            return
        metrics[BROADCAST_PRE_TIME] = t_pre
        metrics.update(self._membership_metrics())

        if cfg.fl.eval_interval_rounds and rnd % cfg.fl.eval_interval_rounds == 0:
            with telemetry.span(BROADCAST_POST_TIME, round=rnd):
                t_post = self.broadcast_parameters(rnd)
            try:
                metrics.update(self.evaluate_round(rnd))
            except TooManyFailuresError:
                if not cfg.fl.ignore_failed_rounds:
                    raise
                metrics[EVAL_ROUND_FAILED] = 1.0
            metrics[BROADCAST_POST_TIME] = t_post

        if self.ckpt_mgr is not None and cfg.photon.checkpoint \
                and rnd % cfg.photon.checkpoint_interval == 0:
            t_ck = time.monotonic()
            # what the loop blocks on; the background write is a span of its
            # own (server/ckpt_async_write_s) overlapping the next round
            with telemetry.span(CHECKPOINT_TIME, round=rnd):
                self.save_checkpoint(rnd)
            # what the loop was blocked on: snapshot + enqueue (+ the wait
            # for the previous round's write, reported on its own)
            metrics[CHECKPOINT_TIME] = time.monotonic() - t_ck
            metrics[CKPT_ASYNC_WRITE_S] = float(self.ckpt_mgr.last_async_write_s)
            if cfg.photon.async_checkpoint:
                metrics[CKPT_BARRIER_WAIT_S] = float(self.ckpt_mgr.last_barrier_wait_s)
        self._observe_round_health(rnd, metrics)
        self.history.record(rnd, metrics)

    def _observe_round_health(self, rnd: int, metrics: dict) -> None:
        """The observatory at the round boundary: round-phase timings into
        typed histograms, device memory and the kernel-build count sampled
        into the metrics and the hub, then the NaN/Inf sentinel and the
        memory-growth watcher. One None check per plane with telemetry
        off."""
        hub = telemetry.metrics_active()
        if hub is not None:
            from photon_tpu_torch.telemetry.introspect import sample_device_plane

            for key in (ROUND_TIME, FIT_ROUND_TIME, BROADCAST_PRE_TIME, CHECKPOINT_TIME):
                v = metrics.get(key)
                if v is not None:
                    hub.histogram(key).observe(float(v))
            sample_device_plane(metrics, hub, hbm_key=HBM_BYTES_IN_USE,
                                peak_key=HBM_PEAK_BYTES, compiles_key=COMPILES_TOTAL)
        health = telemetry.health_active()
        if health is not None:
            health.check_round_metrics(rnd, metrics)
            hbm = metrics.get(HBM_BYTES_IN_USE)
            if hbm is not None:
                health.note_hbm_sample(hbm)
