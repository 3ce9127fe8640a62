"""ServerApp: the federated round loop (the port of
``photon_tpu/federation/server.py``, without its telemetry, chaos,
Prometheus endpoint and retrace sentinel, none of which is ported).

- client sampling by ``random.Random(sample_seed)``, fast-forwarded on
  resume, so both packages sample the same cids in every round;
- sliding-window scheduling: one outstanding cid per node, refilled as
  replies arrive; a failed cid is retried once, and more failures than
  ``accept_failures_cnt`` raise :class:`TooManyFailuresError` unless
  ``ignore_failed_rounds``;
- streaming aggregation: client results are fetched, folded into the
  running average and freed one at a time;
- round checkpoints (in the background when ``async_checkpoint``),
  resume with negative indexing, GC, cross-run import; client-state and
  ``server_steps_cumulative`` bookkeeping; the JAX package's metric names.
"""

from __future__ import annotations

import random
import time
import uuid as uuid_mod
from collections import deque
from typing import Callable, Iterator

import numpy as np

from photon_tpu_torch.checkpoint.server import ServerCheckpointManager
from photon_tpu_torch.codec.params import ParamsMetadata
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.federation.configs import EvaluateRoundConfig, FitRoundConfig
from photon_tpu_torch.federation.driver import Driver
from photon_tpu_torch.federation.membership import LivenessTracker, hello_backoff_total
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
    EVAL_ROUND_FAILED,
    EVAL_ROUND_TIME,
    FIT_ROUND_TIME,
    PSEUDO_GRAD_NORM,
    ROUND_FAILED,
    ROUND_TIME,
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
        self.cfg = cfg
        self.driver = driver
        self.transport = transport
        self.ckpt_mgr = ckpt_mgr
        self.history = history or History()
        self.strategy = dispatch_strategy(cfg.fl)
        # one bounded pool (photon.host_threads) for the aggregation fold
        self.host_pool = HostPool(cfg.photon.host_threads)
        self.strategy.host_pool = self.host_pool
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
        msg = Broadcast(server_round, ptr)
        acks = self.driver.broadcast(msg, on_stale=self._free_stale_reply)
        bad = [nid for nid, a in acks.items() if not a.ok]
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
        """Free the payloads a late or stale reply carries."""
        for res in (reply if isinstance(reply, list) else [reply]):
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
        yielded as they arrive. The JAX package's quarantine of timed-out
        nodes and its readmission of restarted ones serve the multiprocess
        and TCP drivers, which are not ported."""
        queue: deque[int] = deque(cids)
        retried: set[int] = set()
        inflight: dict[int, tuple[str, int]] = {}
        free: deque[str] = deque(self.driver.node_ids())
        failures: list[tuple[int, str]] = []

        def retry_or_fail(cid: int, why: str) -> None:
            if cid not in retried:
                retried.add(cid)
                queue.append(cid)
            else:
                failures.append((cid, why))

        while queue or inflight:
            while queue and free:
                nid, cid = free.popleft(), queue.popleft()
                inflight[self.driver.send(nid, make_ins([cid]))] = (nid, cid)
            if not inflight:
                failures.extend((cid, "no live nodes") for cid in queue)
                break
            try:
                nid, mid, reply = self.driver.recv_any(timeout=timeout)
            except TimeoutError:
                for n, cid in inflight.values():
                    retry_or_fail(cid, f"timeout after {timeout}s on node {n}")
                inflight.clear()
                continue
            if mid not in inflight:
                self._free_stale_reply(reply)
                continue
            _, cid = inflight.pop(mid)
            free.append(nid)
            for res in (reply if isinstance(reply, list) else [reply]):
                err = res.detail if isinstance(res, Ack) else getattr(res, "error", None)
                if isinstance(res, Ack) or err:
                    retry_or_fail(cid, err or "unknown")
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
                _, arrays = self.transport.get(res.params)
                if res.client_state:
                    self.client_states[res.cid] = res.client_state
                g = res.metrics.get(CLIENT_PSEUDO_GRAD_NORM)
                if g is not None:
                    per_client_sq.append(float(g) ** 2)
                    per_client_n.append(res.n_samples)
                yield ClientResult(res.cid, arrays, res.n_samples, res.metrics)
                self.transport.free(res.params)

        t_fit = time.monotonic()
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
        for res in self._sliding_window(server_round, cids, make_ins,
                                        timeout=self.cfg.fl.eval_timeout_s):
            assert isinstance(res, EvaluateRes)
            results.append((res.n_samples, res.loss, res.metrics))
        _, metrics = self.strategy.aggregate_evaluate(server_round, results)
        metrics[EVAL_ROUND_TIME] = time.monotonic() - t0
        return metrics

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
                self._one_round(cfg, rnd)
        finally:
            # the last background write lands (and raises) before return;
            # the transport is freed whatever happens
            try:
                if self.ckpt_mgr is not None:
                    self.ckpt_mgr.wait_pending()
            finally:
                self.free_transport()
        return self.history

    def _one_round(self, cfg: Config, rnd: int) -> None:
        if cfg.photon.refresh_period and rnd > 1 and (rnd - 1) % cfg.photon.refresh_period == 0:
            self.driver.broadcast(Query("refresh"), on_stale=self._free_stale_reply)
        self._membership_round_start(rnd)
        t_pre = self.broadcast_parameters(rnd)
        try:
            metrics = self.fit_round(rnd)
        except TooManyFailuresError:
            if not cfg.fl.ignore_failed_rounds:
                raise
            failed = {ROUND_FAILED: 1.0}
            failed.update(self._membership_metrics())
            self.history.record(rnd, failed)
            return
        metrics[BROADCAST_PRE_TIME] = t_pre
        metrics.update(self._membership_metrics())

        if cfg.fl.eval_interval_rounds and rnd % cfg.fl.eval_interval_rounds == 0:
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
            self.save_checkpoint(rnd)
            # what the loop was blocked on: snapshot + enqueue (+ the wait
            # for the previous round's write, reported on its own)
            metrics[CHECKPOINT_TIME] = time.monotonic() - t_ck
            metrics[CKPT_ASYNC_WRITE_S] = float(self.ckpt_mgr.last_async_write_s)
            if cfg.photon.async_checkpoint:
                metrics[CKPT_BARRIER_WAIT_S] = float(self.ckpt_mgr.last_barrier_wait_s)
        self.history.record(rnd, metrics)
