"""Federated rounds over collectives (the port of
``photon_tpu/federation/collective_round.py``).

Consumer of ``photon.comm_stack.collective``: where the driver topology
moves every client's parameters through a pointer plane (shm, objstore)
and averages on the server host, the processes of one
``torch.distributed`` job aggregate over a ``(clients, replica)`` mesh
(``parallel/collective_agg.py``), optionally int8-quantized on the
cross-client leg (``comm_stack.collective_quantization``), with the
server optimizer on the device when ``collective_device_optimizer`` is
on. The averaged result doubles as the next round's broadcast.

Topology: multi-controller. Every process runs this same loop over its
own clients; there is no server process. Each controller holds a replica
of the strategy and applies the same deterministic update to the
exchanged average, so all replicas march in lockstep.

**Elastic rounds.** A straggler/degradation ladder keeps a client failure
from being fatal:

1. **Stage deadlines.** Every collective stage (the handshake, stack,
   exchange, update) gets an absolute deadline from
   ``comm_stack.collective_stage_timeout_s`` on an injectable clock (0:
   no deadline). A collective that never completes cannot be cancelled
   from Python, so each stage's process group also gets a timeout no
   longer than the deadline, and the group of a failed attempt is never
   used again: the retry builds a new one.
2. **Gang reconfiguration.** A failed client fit, or a
   :class:`~photon_tpu_torch.federation.membership.LivenessTracker`
   live→suspect/dead edge, drops the participant from the round's cohort;
   the runner takes the survivors' rows of the mesh (a process group
   built with ``use_local_synchronization=True``, so a dead process need
   not join it) and re-runs the fold, the FedAvg weights renormalized
   over the surviving counts by construction. A missed deadline fails the
   attempt; the retry runs over the then-current surviving cohort,
   bounded by the retry budget. Reconfiguration is round-scoped: every
   round starts from the full cohort again.
3. **Quorum and host fallback.** Below ``comm_stack.collective_quorum``
   (surviving fraction of ``fl.n_total_clients``), or once the retry
   budget is spent, the round degrades to the host ``aggregate_inplace``
   fold over the deltas that landed (bit for bit), recorded as a degraded
   round, never an aborted run.

Cohort agreement: a controller computes the cohort from its own
observations; every controller of one gang must observe the same cohort
to stay in lockstep (feed every tracker from a shared control plane). A
divergent cohort wedges the exchange, which the stage deadline turns into
a local host fallback.

Client training reuses ``ClientRuntime`` end to end, so data order and
numerics match the driver path.

Launch (one line per process; a process trains on ``--device``, by
default the card ``cuda:{process_id % cards}``):

    python -m photon_tpu_torch.federation.collective_round \\
        --coordinator host0:1234 --num-processes 2 --process-id {0,1} \\
        --config run/config.yaml
"""

from __future__ import annotations

import threading
import time
import warnings
from datetime import timedelta
from typing import Callable, Sequence

import numpy as np
import torch

from photon_tpu_torch import telemetry
from photon_tpu_torch.analysis.runtime import absorb_compiles, steady_point
from photon_tpu_torch.chaos import crash_point
from photon_tpu_torch.codec.params import params_to_ndarrays
from photon_tpu_torch.compression.quantize import COLLECTIVE_QUANTIZATIONS, DEFAULT_BLOCK
from photon_tpu_torch.config.schema import Config
from photon_tpu_torch.device import require_device
from photon_tpu_torch.federation.client_runtime import ClientRuntime
from photon_tpu_torch.federation.membership import LIVE, LivenessTracker
from photon_tpu_torch.federation.messages import FitIns
from photon_tpu_torch.federation.transport import ParamTransport
from photon_tpu_torch.metrics.history import History
from photon_tpu_torch.parallel.collective_agg import (
    ClientMesh,
    DeviceAggregationPlane,
    group_backend,
    hierarchical_weighted_average,
    make_hierarchical_mesh,
    mesh_replica,
    modeled_cross_slice_bytes,
)
from photon_tpu_torch.parallel.mesh import single_device_mesh
from photon_tpu_torch.strategy import dispatch_strategy
from photon_tpu_torch.utils.profiling import (
    ADAPTER_COHORTS,
    ADAPTER_COHORTS_DEGRADED,
    ADAPTER_WIRE_BYTES,
    AUTOPILOT_KNOB_QUANT_LEVEL,
    AUTOPILOT_KNOB_STAGE_TIMEOUT_S,
    COLLECTIVE_AGG_TIME,
    COLLECTIVE_DEGRADED_ROUNDS,
    COLLECTIVE_EXCHANGE_TIME,
    COLLECTIVE_RECONFIG_TIME,
    COLLECTIVE_STACK_TIME,
    COLLECTIVE_STRAGGLER_FRAC,
    COLLECTIVE_STRAGGLERS,
    COLLECTIVE_UPDATE_TIME,
    COLLECTIVE_WIRE_BYTES,
    COMPILES_TOTAL,
    EVAL_LOSS,
    EVAL_SAMPLES,
    EVENT_ADAPTER_COHORT_DEGRADED,
    EVENT_COLLECTIVE_DEGRADED,
    EVENT_COLLECTIVE_RECONFIG,
    EVENT_COLLECTIVE_STRAGGLER,
    FIT_ROUND_TIME,
    HBM_BYTES_IN_USE,
    HBM_PEAK_BYTES,
    LAYOUT_EST_STEP_S,
    LAYOUT_SEARCH_TIME,
    OPT_ALLGATHER_TIME,
    OPT_SHARD_FRAC,
    ROUND_FAILED,
    ROUND_TIME,
    STEPS_CUMULATIVE,
)


class StageDeadlineError(RuntimeError):
    """A collective stage missed its absolute deadline
    (``comm_stack.collective_stage_timeout_s``). The stage's work may still
    be running on its daemon worker thread (a wedged collective cannot be
    cancelled from Python), but the round moves on through the
    reconfiguration ladder instead of wedging with it."""

    def __init__(self, stage: str, waited_s: float) -> None:
        super().__init__(
            f"collective stage {stage!r} missed its deadline "
            f"(waited {waited_s:.3f}s)"
        )
        self.stage = stage
        self.waited_s = waited_s


def partition_cids(n_total_clients: int, num_processes: int, process_id: int) -> list[int]:
    """Contiguous, process-ordered cid partition: mesh row ``i`` belongs to
    the process that owns cid ``i``."""
    per = n_total_clients // num_processes
    rem = n_total_clients % num_processes
    start = process_id * per + min(process_id, rem)
    count = per + (1 if process_id < rem else 0)
    return list(range(start, start + count))


def _world() -> tuple[int, int]:
    """(process count, this process's rank) of the ``torch.distributed``
    job, (1, 0) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class CollectiveFedRunner:
    """Multi-controller federated loop: local fits → collective average →
    replica strategy update, every round, on every process.

    Each process trains its clients on its one ``device`` (default: the
    card, ``cuda:{rank % cards}``; processes that share a card time-slice
    it). ``mesh`` overrides the default mesh of
    :meth:`_default_mesh`; an explicit mesh may repeat a device."""

    def __init__(self, cfg: Config, process_cids: Sequence[int], mesh: ClientMesh | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 liveness: LivenessTracker | None = None,
                 device: str | torch.device | None = None) -> None:
        if not cfg.photon.comm_stack.collective:
            raise ValueError("CollectiveFedRunner requires photon.comm_stack.collective=true")
        cfg.refuse_param_dtype_in_round("the collective plane")
        if cfg.fl.n_clients_per_round != cfg.fl.n_total_clients:
            # the lockstep exchange is full participation by construction;
            # a sampled subset is the driver topology's feature
            raise ValueError(
                f"collective mode trains ALL clients every round; "
                f"n_clients_per_round={cfg.fl.n_clients_per_round} != "
                f"n_total_clients={cfg.fl.n_total_clients} (use the driver "
                "topology for client sampling)"
            )
        self.cfg = cfg
        self.process_cids = list(process_cids)
        self._local_cids = frozenset(self.process_cids)
        if not self.process_cids:
            raise ValueError(
                "this process owns no clients — launch with num_processes <= "
                "n_total_clients so every controller contributes rows"
            )
        self.n_processes, self.process_index = _world()
        if device is None:
            device = require_device(None)
            if torch.device(device).type == "cuda":
                device = f"cuda:{self.process_index % torch.cuda.device_count()}"
        self.device = torch.device(require_device(device))
        cs = cfg.photon.comm_stack
        self.quantization = cs.collective_quantization
        self.q8_block = cs.collective_q8_block or DEFAULT_BLOCK
        #: injectable clock: every stage deadline is an absolute time on it
        self.clock = clock
        self.stage_timeout_s = float(cs.collective_stage_timeout_s)
        self.quorum = float(cs.collective_quorum)
        self.retry_budget = int(cs.collective_retry_budget)
        # per-cohort LoRA: the trainer-side knobs come from photon.adapters
        # before any Trainer or model is built
        self._adapters_enabled = bool(cfg.photon.adapters.enabled)
        if self._adapters_enabled:
            from photon_tpu_torch.adapters.federated import configure_adapter_training

            configure_adapter_training(cfg)
        mem = cfg.photon.membership
        #: per-client liveness (pseudo node id ``client{cid}``), fed by fit
        #: outcomes here and by whatever shared control plane is wired in;
        #: a client whose state is not LIVE leaves the round's cohort
        self.liveness = liveness if liveness is not None else LivenessTracker(
            suspect_after_misses=mem.suspect_after_misses,
            dead_after_misses=mem.dead_after_misses,
            ping_timeout_s=mem.ping_timeout_s,
            clock=clock,
        )
        self.stragglers_total = 0
        self.degraded_rounds_total = 0
        self.reconfigs_total = 0
        #: round → the aggregation path that produced it ("collective" |
        #: "collective_reconfigured" | "host_fallback" | "failed")
        self.aggregation_paths: dict[int, str] = {}
        self._cohort_meshes: dict[tuple[int, ...], ClientMesh] = {}
        #: deadline-abandoned stage workers that may still be running
        self._abandoned_workers: list[threading.Thread] = []
        #: process groups of failed attempts: never used again
        self._abandoned_groups: list = []
        #: the cross-process backend ("nccl" when every process drives a
        #: card of its own, else "gloo"; None in one process)
        self.backend = None
        if self.n_processes > 1:
            self.backend = group_backend(self.device)
        self.mesh = mesh if mesh is not None else self._default_mesh()
        if self.mesh.rank != self.process_index:
            raise ValueError(
                f"the mesh is process {self.mesh.rank}'s, this is process "
                f"{self.process_index}"
            )
        # inline transport: params never leave this process except through
        # the exchange
        self.transport = ParamTransport("inline")
        self.runtime = ClientRuntime(cfg, self.transport,
                                     node_id=f"collective{self.process_index}",
                                     device=self.device,
                                     mesh=single_device_mesh(self.device))
        self.strategy = dispatch_strategy(cfg.fl)
        from photon_tpu_torch.models.mpt import init_params

        self.meta, initial = params_to_ndarrays(init_params(cfg.model, seed=cfg.seed))
        if cfg.fl.aggregate_momenta:
            # payloads become [params|m1|m2] as in the driver topology; the
            # exchange averages the momenta sections like any other arrays
            from photon_tpu_torch.train.param_ops import extend_with_momenta, has_momenta

            if not has_momenta(self.meta):
                self.meta, initial = extend_with_momenta(self.meta, initial)
        self.strategy.initialize(initial)
        # adapter mode: the base is frozen for the whole run and broadcast
        # per cohort with that cohort's adapter; the per-cohort server
        # optimizers live on the host (adapter payloads are tiny)
        self.adapter_plane = None
        if self._adapters_enabled:
            from photon_tpu_torch.adapters.federated import AdapterTrainPlane
            from photon_tpu_torch.adapters.lora import split_adapter

            base_meta, base_arrays, _, _ = split_adapter(self.meta, initial)
            self.adapter_plane = AdapterTrainPlane(cfg, base_meta, base_arrays)
        # second-moment rows must leave the server >= 0 (clients sqrt
        # them); q8 noise breaks that for idle elements, so both optimizer
        # paths clamp them on the q8 policy only (see collective_agg)
        from photon_tpu_torch.train.param_ops import M2_PREFIX

        self._nonneg_rows = tuple(
            i for i, n in enumerate(self.meta.names) if n.startswith(M2_PREFIX)
        )
        self.device_plane = (
            DeviceAggregationPlane(self.mesh, self.strategy, quantization=self.quantization,
                                   block=self.q8_block, nonneg_rows=self._nonneg_rows,
                                   sharded=cs.collective_zero1)
            if cs.collective_device_optimizer else None
        )
        # the layout autotuner's probe (parallel/autotune.py): the legal
        # layouts of one client slice (collective_replica ranks) ranked by
        # the cost model, its search time and estimate in every round's
        # metrics; a slice with no legal layout only warns (the plane does
        # not consume the layout)
        self._layout_metrics: dict[str, float] = {}
        if cfg.photon.mesh_autotune:
            from photon_tpu_torch.parallel.autotune import autotune_layout

            t0 = time.monotonic()
            try:
                best = autotune_layout(cfg.model, n_devices=max(1, cs.collective_replica),
                                       global_batch_size=cfg.train.global_batch_size)
                self._layout_metrics = {LAYOUT_SEARCH_TIME: time.monotonic() - t0,
                                        LAYOUT_EST_STEP_S: float(best.est_step_s)}
            except ValueError as e:
                warnings.warn(f"layout auto-tune probe skipped: {e}", stacklevel=2)
        self.history = History()
        self.server_steps_cumulative = 0
        # per-client control state (sample/step counters), as the driver
        # topology's ServerApp keeps it: rides FitIns so a fresh loader
        # fast-forwards, and rides the checkpoint
        self.client_states: dict[int, dict] = {}
        # the SLO autopilot's knobs: the stage deadline and the
        # cross-client quantization level, through the checked setters
        ap = telemetry.autopilot_active()
        if ap is not None:
            ap.register_knob(
                AUTOPILOT_KNOB_STAGE_TIMEOUT_S,
                lambda: self.stage_timeout_s,
                self.set_stage_timeout_s,
            )
            ap.register_knob(
                AUTOPILOT_KNOB_QUANT_LEVEL,
                lambda: self.quantization,
                self.set_quantization,
                levels=COLLECTIVE_QUANTIZATIONS,
            )
        self._warmup_collective()

    # -- runtime-mutable knobs -------------------------------------------
    def set_stage_timeout_s(self, timeout_s: float) -> None:
        """The autopilot tightens the stage deadline when the straggler
        fraction's p90 breaches. Loud reject, never a silent clamp: 0 would
        restore wedge-forever semantics mid-run."""
        t = float(timeout_s)
        if not np.isfinite(t) or t <= 0.0:
            raise ValueError(
                f"set_stage_timeout_s needs a finite timeout > 0, got "
                f"{timeout_s!r}"
            )
        self.stage_timeout_s = t

    def set_quantization(self, quantization: str) -> None:
        """Quantization escalation (``off`` → ``q8``) when the wire bytes
        trend up. The device plane holds the codec, so the switch rebuilds
        it from the host strategy replica (the checkpoint authority, synced
        after every round)."""
        if quantization not in COLLECTIVE_QUANTIZATIONS:
            raise ValueError(
                f"unknown collective quantization {quantization!r}, "
                f"expected one of {COLLECTIVE_QUANTIZATIONS}"
            )
        if quantization == self.quantization:
            return
        self.quantization = quantization
        if self.device_plane is not None:
            cs = self.cfg.photon.comm_stack
            with absorb_compiles("collective/requantize"):
                self.device_plane = DeviceAggregationPlane(
                    self.mesh, self.strategy, quantization=self.quantization,
                    block=self.q8_block, nonneg_rows=self._nonneg_rows,
                    sharded=cs.collective_zero1,
                )

    # -- process groups ----------------------------------------------------
    def _group_timeout(self) -> timedelta | None:
        return timedelta(seconds=self.stage_timeout_s) if self.stage_timeout_s > 0 else None

    def _bind_group(self, mesh: ClientMesh) -> None:
        """Give ``mesh`` a process group over the processes owning its rows
        (a collective among them alone), unless one process owns them all
        or the mesh has a live group."""
        if len(mesh.processes) == 1 or mesh.group is not None:
            return
        import torch.distributed as dist

        mesh.group = dist.new_group(mesh.processes, timeout=self._group_timeout(),
                                    backend=self.backend, use_local_synchronization=True)
        mesh.backend = self.backend

    def _abandon_group(self, mesh: ClientMesh) -> None:
        """A stage on ``mesh`` failed: its group may hold a wedged
        collective, so it is set aside (not destroyed) and never used
        again; the next attempt binds a new one."""
        if mesh.group is not None:
            self._abandoned_groups.append(mesh.group)
            mesh.group = None

    def _warmup_collective(self) -> None:
        """Establish the cross-process group BEFORE the first round's
        fits: every controller constructs the runner near the same time,
        so a tiny average here rendezvouses while everyone is at the same
        line."""
        def _probe():
            self._bind_group(self.mesh)
            avg = hierarchical_weighted_average(
                [[torch.ones(1) for _ in self.mesh.local_rows]],
                [1] * len(self.mesh.local_rows), self.mesh)
            float(avg[0][0])

        # the handshake is a stage like any other: a controller that never
        # shows up must not wedge construction forever
        self._run_stage("handshake", _probe, self._stage_deadline())

    def _default_mesh(self) -> ClientMesh:
        """The ``(clients, replica)`` mesh of :func:`partition_cids`: row i
        lives on the process that owns cid i; this process's rows take
        ``collective_replica`` device slots each from its own device on
        (its card and the next ones; on the CPU, the host again). A process
        with fewer cards than slots is refused."""
        n_total = self.cfg.fl.n_total_clients
        replica = self.cfg.photon.comm_stack.collective_replica
        owners = []
        for p in range(self.n_processes):
            owners.extend([p] * len(partition_cids(n_total, self.n_processes, p)))
        want = len(self.process_cids) * replica
        if self.device.type == "cpu":
            local = [torch.device("cpu")] * want
        else:
            have = torch.cuda.device_count()
            first = self.device.index or 0
            if have - first < want:
                raise ValueError(
                    f"process {self.process_index} owns {want} device slots "
                    f"({replica} per client) but only {have - first} devices — "
                    "rebalance clients, lower collective_replica, or add devices"
                )
            local = [torch.device("cuda", first + i) for i in range(want)]
        devices, it = [], iter(local)
        for cid in range(n_total):
            for _ in range(replica):
                devices.append(next(it) if owners[cid] == self.process_index else None)
        return make_hierarchical_mesh(n_total, replica, devices, owners=owners,
                                      rank=self.process_index, group=None,
                                      backend=self.backend)

    # -- stage deadlines -------------------------------------------------
    def _stage_deadline(self) -> float | None:
        """Absolute deadline for one collective stage on the injected
        clock, or None when deadlines are off."""
        if self.stage_timeout_s <= 0:
            return None
        return self.clock() + self.stage_timeout_s

    def _run_stage(self, stage: str, fn: Callable[[], object], deadline: float | None):
        """Run one collective stage under its absolute deadline.

        With a deadline the body runs on a named daemon worker thread and
        the caller waits at most the remaining budget; on a miss the worker
        is abandoned and :class:`StageDeadlineError` routes the round into
        the reconfiguration ladder. The deadline is judged on the injected
        clock; the join waits real time in short slices."""
        if deadline is None:
            return fn()
        start = self.clock()
        if deadline - start <= 0:
            raise StageDeadlineError(stage, 0.0)
        result: dict[str, object] = {}

        def _target() -> None:
            try:
                result["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — re-raised by the caller
                result["error"] = e

        th = threading.Thread(target=_target, name=f"collective-{stage}", daemon=True)
        th.start()
        while th.is_alive():
            remaining = deadline - self.clock()
            if remaining <= 0:
                # the worker may still be building a kernel library whose
                # build lands later: tracked so the round end absorbs it
                self._abandoned_workers.append(th)
                raise StageDeadlineError(stage, self.clock() - start)
            th.join(timeout=min(remaining, 0.05))
        if "error" in result:
            raise result["error"]  # type: ignore[misc]
        return result.get("value")

    # -- cohorts -----------------------------------------------------------
    @staticmethod
    def _client_node_id(cid: int) -> str:
        return f"client{cid}"

    #: bound on cached survivor-cohort meshes (each may hold a process
    #: group); the least recently used is evicted and its group released
    MAX_COHORT_MESHES = 32

    def _cohort_mesh(self, cohort: tuple[int, ...]) -> ClientMesh:
        """``(clients, replica)`` mesh over the cohort's rows of the full
        mesh, cached per cohort (bounded LRU). Its group is bound by the
        attempt's stack stage, under the deadline."""
        if len(cohort) == self.cfg.fl.n_total_clients:
            return self.mesh
        mesh = self._cohort_meshes.get(cohort)
        if mesh is None:
            while len(self._cohort_meshes) >= self.MAX_COHORT_MESHES:
                old = next(iter(self._cohort_meshes))
                self._cohort_meshes.pop(old).close()
            grid = self.mesh.grid
            sub = list(grid[list(cohort), :].reshape(-1))
            mesh = make_hierarchical_mesh(
                len(cohort), mesh_replica(self.mesh), sub,
                owners=[self.mesh.owners[c] for c in cohort],
                rank=self.process_index, group=None, backend=self.backend)
        else:
            del self._cohort_meshes[cohort]  # re-insert: LRU recency order
        self._cohort_meshes[cohort] = mesh
        return mesh

    def _surviving_cohort(self, landed: dict[int, tuple[list[np.ndarray], int]]
                          ) -> tuple[int, ...]:
        """The global surviving cohort as this controller observes it: every
        cid except our own clients whose fits failed and any cid whose
        liveness state is not LIVE (a mid-round edge excludes a client even
        if its result arrived)."""
        out = []
        for cid in range(self.cfg.fl.n_total_clients):
            if cid in self._local_cids and cid not in landed:
                continue  # we watched this client's fit fail
            h = self.liveness.nodes.get(self._client_node_id(cid))
            if h is None or h.state == LIVE:
                out.append(cid)
        return tuple(out)

    # ----------------------------------------------------------------------
    def _stack_local(self, rows: list[list[np.ndarray]], mesh: ClientMesh | None = None,
                     n_global: int | None = None) -> list[list[torch.Tensor]]:
        """Per leaf: this process's rows (ascending cid) as tensors on their
        rows' devices of ``mesh`` (the full mesh by default)."""
        mesh = mesh if mesh is not None else self.mesh
        n_global = n_global if n_global is not None else self.cfg.fl.n_total_clients
        if len(mesh.local_rows) != len(rows) or mesh.shape["clients"] != n_global:
            raise ValueError(
                f"{len(rows)} local rows of {n_global} for a mesh of "
                f"{mesh.shape['clients']} rows, {len(mesh.local_rows)} of them local"
            )
        devs = [torch.device(mesh.grid[c, 0]) for c in mesh.local_rows]
        return [[torch.from_numpy(np.asarray(r[li])).to(d) for r, d in zip(rows, devs)]
                for li in range(len(rows[0]))]

    def run_round(self, server_round: int) -> dict[str, float]:
        if self.adapter_plane is not None:
            return self._run_round_adapters(server_round)
        t_round = time.monotonic()
        cfg = self.cfg

        # "broadcast": every controller already holds the replica params
        ptr = self.transport.put(
            f"collective-bcast-r{server_round}", self.meta, self.strategy.current_parameters
        )
        self.runtime.set_broadcast_params(ptr)

        # as in the driver topology, fit_round_time spans the fits and the
        # aggregation
        t_fit = time.monotonic()
        landed: dict[int, tuple[list[np.ndarray], int]] = {}
        for cid in self.process_cids:
            ins = FitIns(
                server_round=server_round,
                cids=[cid],
                params=None,
                local_steps=cfg.fl.local_steps,
                server_steps_cumulative=self.server_steps_cumulative,
                client_states=(
                    {cid: self.client_states[cid]} if cid in self.client_states else {}
                ),
                config=dict(cfg.fl.fit_config),
            )
            res = self.runtime.fit(ins, cid)
            nid = self._client_node_id(cid)
            if res.error:
                # a failed client is a straggler dropped from THIS round's
                # cohort, re-attempted (and readmitted) next round
                self.liveness.observe_miss(nid)
                telemetry.emit_event(
                    EVENT_COLLECTIVE_STRAGGLER, round=server_round, cid=cid,
                    reason="fit_error", detail=res.error[:200],
                )
                warnings.warn(
                    f"collective round {server_round}: cid {cid} failed "
                    f"({res.error.splitlines()[0][:120]}) — dropped from the "
                    "round's cohort",
                    stacklevel=2,
                )
                continue
            self.liveness.observe_alive(nid)
            if res.client_state:
                self.client_states[res.cid] = res.client_state
            _, arrays = self.transport.get(res.params)
            landed[cid] = (arrays, res.n_samples)
            self.transport.free(res.params)
        self.transport.free(ptr)

        crash_point("pre-exchange", server_round, self.runtime.node_id)

        t_agg = time.monotonic()
        metrics, path, stragglers, reconfig_s = self._aggregate_elastic(server_round, landed)
        if metrics is None:
            # nothing landed: the round is recorded failed (params and the
            # step counter unchanged) and the run continues
            warnings.warn(
                f"collective round {server_round}: no client deltas landed — "
                "round recorded failed, parameters unchanged",
                stacklevel=2,
            )
            metrics = {
                ROUND_FAILED: 1.0,
                COLLECTIVE_STACK_TIME: 0.0,
                COLLECTIVE_EXCHANGE_TIME: 0.0,
                COLLECTIVE_UPDATE_TIME: 0.0,
                COLLECTIVE_WIRE_BYTES: 0.0,
            }
        else:
            self.server_steps_cumulative += cfg.fl.local_steps
        if self.device_plane is not None and path in ("collective_reconfigured", "host_fallback"):
            # the round ran off the device plane: push the host result back
            # so the device state re-enters lockstep next round
            with absorb_compiles("collective/reseed"):
                self.device_plane.reseed_from(self.strategy)
        return self._finish_round(server_round, metrics, path, stragglers, reconfig_s,
                                  t_agg, t_fit, t_round)

    def _finish_round(self, server_round: int, metrics: dict, path: str, stragglers: int,
                      reconfig_s: float, t_agg: float, t_fit: float, t_round: float) -> dict:
        """The round's ladder KPIs, health hooks, History and steady point
        (shared by the global and the adapter rounds)."""
        metrics[COLLECTIVE_STRAGGLERS] = float(stragglers)
        metrics[COLLECTIVE_DEGRADED_ROUNDS] = 1.0 if path == "host_fallback" else 0.0
        metrics[COLLECTIVE_RECONFIG_TIME] = reconfig_s
        metrics[COLLECTIVE_AGG_TIME] = time.monotonic() - t_agg
        metrics[FIT_ROUND_TIME] = time.monotonic() - t_fit
        metrics[STEPS_CUMULATIVE] = float(self.server_steps_cumulative)
        metrics[ROUND_TIME] = time.monotonic() - t_round
        metrics.update(self._layout_metrics)
        self.stragglers_total += stragglers
        if path == "host_fallback":
            self.degraded_rounds_total += 1
        self.aggregation_paths[server_round] = path
        self._observe_collective_health(server_round, metrics, path, stragglers)
        self.history.record(server_round, metrics)
        if self._abandoned_workers:
            # a deadline-abandoned worker may load a kernel library whenever
            # it gets there: forgive this round's interval rather than bill
            # a correct degraded round as a retrace
            with absorb_compiles("collective/abandoned"):
                pass
            self._abandoned_workers = [t for t in self._abandoned_workers if t.is_alive()]
        steady_point("collective/round")
        return metrics

    def _observe_collective_health(self, server_round: int, metrics: dict, path: str,
                                   stragglers: int) -> None:
        """Observatory hooks at the round boundary: stage timings into
        histograms, modeled wire bytes into a counter, device memory and
        builds sampled, then the health watchers and the autopilot's
        ``collective`` tick. One None check per plane when off."""
        hub = telemetry.metrics_active()
        if hub is not None:
            from photon_tpu_torch.telemetry.introspect import sample_device_plane

            for key in (COLLECTIVE_STACK_TIME, COLLECTIVE_EXCHANGE_TIME,
                        COLLECTIVE_UPDATE_TIME, COLLECTIVE_AGG_TIME, ROUND_TIME):
                v = metrics.get(key)
                if v is not None:
                    hub.histogram(key).observe(float(v))
            wire = metrics.get(COLLECTIVE_WIRE_BYTES)
            if wire:
                hub.counter(COLLECTIVE_WIRE_BYTES).inc(float(wire))
            # the autopilot's straggler-deadline rule reduces p90 over this
            # gauge's window
            hub.gauge(COLLECTIVE_STRAGGLER_FRAC).set(
                stragglers / max(1, self.cfg.fl.n_total_clients)
            )
            sample_device_plane(metrics, hub, hbm_key=HBM_BYTES_IN_USE,
                                peak_key=HBM_PEAK_BYTES, compiles_key=COMPILES_TOTAL)
        health = telemetry.health_active()
        if health is not None:
            health.check_round_metrics(server_round, metrics)
            health.check_collective_round(
                server_round,
                stragglers=stragglers,
                n_total=self.cfg.fl.n_total_clients,
                degraded=(path == "host_fallback"),
                failed=bool(metrics.get(ROUND_FAILED)),
            )
            hbm = metrics.get(HBM_BYTES_IN_USE)
            if hbm is not None:
                health.note_hbm_sample(hbm)
        ap = telemetry.autopilot_active()
        if ap is not None:
            ap.tick("collective")

    # -- the straggler/degradation ladder --------------------------------
    def _ladder(self, server_round: int, landed: dict, attempt: Callable, fallback: Callable,
                snapshot: Callable, restore: Callable, what: str
                ) -> tuple[dict[str, float] | None, str, int, float]:
        """Aggregate over whoever survived: collective → (reconfigured)
        collective → host fallback. Returns ``(metrics | None, path,
        stragglers, reconfig_seconds)``; ``None`` metrics = nothing
        landed."""
        n_total = self.cfg.fl.n_total_clients
        # liveness-excluded clients whose deltas DID land are stragglers too
        for cid in sorted(set(landed) - set(self._surviving_cohort(landed))):
            telemetry.emit_event(
                EVENT_COLLECTIVE_STRAGGLER, round=server_round, cid=cid, reason="liveness",
            )
        attempts = 0
        reconfig_s = 0.0
        degraded_reason = None
        while True:
            cohort = self._surviving_cohort(landed)
            if not cohort or not any(cid in landed for cid in cohort):
                # no local deltas: nothing to fold here (and nothing to
                # contribute to a gang its peers will also tear down)
                return None, "failed", n_total - len(cohort), reconfig_s
            if len(cohort) < self.quorum * n_total:
                degraded_reason = (
                    f"below quorum: {len(cohort)}/{n_total} surviving < "
                    f"{self.quorum}"
                )
                break
            if attempts > self.retry_budget:
                degraded_reason = (
                    f"retry budget exhausted ({self.retry_budget} reconfig "
                    "attempts)"
                )
                break
            t0 = time.monotonic()
            # rollback point: an attempt can fail AFTER it committed (the
            # exchange landed, the update stage missed its deadline)
            snap = snapshot()
            mesh = self._cohort_mesh(cohort)
            try:
                if len(cohort) < n_total:
                    # a survivors cohort's first round may build what it
                    # needs: budgeted against the retrace sentinel
                    with absorb_compiles("collective/reconfig"):
                        metrics = attempt(server_round, cohort, landed)
                    path = "collective_reconfigured"
                else:
                    metrics = attempt(server_round, cohort, landed)
                    path = "collective"
                return metrics, path, n_total - len(cohort), reconfig_s
            except StageDeadlineError as e:
                reason, stage = str(e), e.stage
            except Exception as e:  # noqa: BLE001 — a torn gang surfaces as
                # a distributed-runtime error as often as a hang; both take
                # the same bounded ladder
                reason, stage = f"{type(e).__name__}: {e}", "exchange"
            self._abandon_group(mesh)
            restore(snap)
            attempts += 1
            reconfig_s += time.monotonic() - t0
            self.reconfigs_total += 1
            telemetry.emit_event(
                EVENT_COLLECTIVE_RECONFIG, round=server_round, attempt=attempts,
                stage=stage, cohort=len(cohort), reason=reason[:200],
            )
            warnings.warn(
                f"{what} round {server_round}: attempt {attempts} failed "
                f"at stage {stage!r} ({reason.splitlines()[0][:160]}) — "
                f"reconfiguring ({self.retry_budget - attempts + 1} retries "
                "left before host fallback)",
                stacklevel=3,
            )
        # degrade over the cohort the loop just validated
        telemetry.emit_event(
            EVENT_COLLECTIVE_DEGRADED, round=server_round, cohort=len(cohort),
            reason=degraded_reason,
        )
        warnings.warn(
            f"{what} round {server_round}: degrading to the "
            f"{'host-plane' if what == 'collective' else 'per-cohort host'} "
            f"fold over {len(cohort)}/{n_total} clients ({degraded_reason})",
            stacklevel=3,
        )
        metrics = fallback(server_round, cohort, landed)
        return metrics, "host_fallback", n_total - len(cohort), reconfig_s

    def _aggregate_elastic(self, server_round: int,
                           landed: dict[int, tuple[list[np.ndarray], int]]
                           ) -> tuple[dict[str, float] | None, str, int, float]:
        plane = self.device_plane

        def snapshot():
            return plane.snapshot() if plane is not None else None

        def restore(snap):
            if plane is not None:
                # an abandoned attempt may still be running on its worker:
                # its late commit must not tear the plane, and whatever it
                # did commit rolls back
                plane.abandon()
                plane.restore(snap)

        return self._ladder(server_round, landed, self._collective_attempt,
                            self._host_fallback, snapshot, restore, "collective")

    def _collective_attempt(self, server_round: int, cohort: tuple[int, ...],
                            landed: dict[int, tuple[list[np.ndarray], int]]) -> dict[str, float]:
        """One aggregation attempt over ``cohort``, each stage under its
        deadline. Full cohort + device optimizer → the device plane. A
        partial cohort → the (optionally quantized) average over the
        survivors' mesh, FedAvg weights renormalized by construction, then
        the host strategy update (the device plane is reseeded after)."""
        n_total = self.cfg.fl.n_total_clients
        full = len(cohort) == n_total
        mesh = self._cohort_mesh(cohort)
        local_cids = [cid for cid in cohort if cid in landed]
        rows = [landed[cid][0] for cid in local_cids]
        ns = [landed[cid][1] for cid in local_cids]

        with telemetry.span(COLLECTIVE_STACK_TIME):
            t_stage = time.monotonic()

            def _stack():
                self._bind_group(mesh)
                return self._stack_local(rows, mesh, len(cohort))

            stacked = self._run_stage("stack", _stack, self._stage_deadline())
            ns_local = np.asarray(ns, np.int32)
            stack_s = time.monotonic() - t_stage

        if self.device_plane is not None and full:
            with telemetry.span(COLLECTIVE_EXCHANGE_TIME):
                t_stage = time.monotonic()
                # epoch captured HERE (caller thread), so an abandon issued
                # while the worker ramps up is not missed
                epoch = self.device_plane.current_epoch()
                plane = self.device_plane

                def _exchange():
                    crash_point("mid-exchange", server_round, self.runtime.node_id)
                    return plane.run_round(stacked, ns_local,
                                           lr=self.strategy.effective_lr(n_total), epoch=epoch)

                metrics = self._run_stage("exchange", _exchange, self._stage_deadline())
                exchange_s = time.monotonic() - t_stage
            crash_point("pre-update", server_round, self.runtime.node_id)
            with telemetry.span(COLLECTIVE_UPDATE_TIME):
                t_stage = time.monotonic()

                # the worker only FETCHES; the host mirror changes on the
                # caller's thread after the stage returns, so an abandoned
                # worker never mutates the strategy under a retry
                def _fetch():
                    return plane.params_host(), plane.state_host(), plane.t

                params_host, state_host, t = self._run_stage("update", _fetch,
                                                             self._stage_deadline())
                self.strategy.current_parameters = params_host
                self.strategy.restore_optimizer_state(state_host, t=t)
                self.strategy.server_round = server_round
                update_s = time.monotonic() - t_stage
            # ZeRO-1: how much of the server state a rank holds, and what
            # the post-update gather in the fetch cost
            metrics[OPT_SHARD_FRAC] = plane.shard_fraction()
            metrics[OPT_ALLGATHER_TIME] = plane.last_allgather_s
        else:
            # host-optimizer path (and every partial-cohort attempt): the
            # exchange carries the average; the strategy updates on the host
            with telemetry.span(COLLECTIVE_EXCHANGE_TIME):
                t_stage = time.monotonic()

                def _exchange():
                    crash_point("mid-exchange", server_round, self.runtime.node_id)
                    avg_dev, total_dev = hierarchical_weighted_average(
                        stacked, ns_local, mesh, quantization=self.quantization,
                        block=self.q8_block, return_total=True,
                    )
                    if avg_dev and avg_dev[0].device.type == "cuda":
                        # wait for the device here, so exchange time means
                        # the same on both optimizer paths
                        torch.cuda.synchronize(avg_dev[0].device)
                    return avg_dev, total_dev

                avg_dev, total_dev = self._run_stage("exchange", _exchange,
                                                     self._stage_deadline())
                exchange_s = time.monotonic() - t_stage
            crash_point("pre-update", server_round, self.runtime.node_id)
            with telemetry.span(COLLECTIVE_UPDATE_TIME):
                t_stage = time.monotonic()

                # the worker fetches only; the numpy update runs on the
                # caller's thread
                def _fetch():
                    avg = [a.detach().to("cpu").numpy().copy() for a in avg_dev]
                    return avg, int(round(float(total_dev)))

                avg, n_samples = self._run_stage("update", _fetch, self._stage_deadline())
                metrics = self._apply_average_host(server_round, avg, n_samples, len(cohort))
                update_s = time.monotonic() - t_stage

        metrics[COLLECTIVE_STACK_TIME] = stack_s
        metrics[COLLECTIVE_EXCHANGE_TIME] = exchange_s
        metrics[COLLECTIVE_UPDATE_TIME] = update_s
        metrics[COLLECTIVE_WIRE_BYTES] = float(modeled_cross_slice_bytes(
            [int(np.prod(r.shape, dtype=np.int64)) for r in rows[0]], len(cohort),
            replica=mesh_replica(mesh), quantization=self.quantization, block=self.q8_block,
        ))
        return metrics

    def _apply_average_host(self, server_round: int, avg: list[np.ndarray], n_samples: int,
                            n_clients: int) -> dict[str, float]:
        """Host half of the non-device paths: the strategy update on the
        averaged payload, with the q8 policy's second-moment clamp."""
        metrics = self.strategy.apply_average(server_round, avg, n_samples, n_clients)
        if self.quantization == "q8":
            # apply_average returns fresh arrays, so in place is safe
            for i in self._nonneg_rows:
                p = self.strategy.current_parameters[i]
                np.maximum(p, 0.0, out=p)
        return metrics

    def _host_fallback(self, server_round: int, cohort: tuple[int, ...],
                       landed: dict[int, tuple[list[np.ndarray], int]]) -> dict[str, float]:
        """The degradation floor: the host streaming fold over the deltas
        that landed, bit for bit ``aggregate_inplace`` over them. No
        collective, so a torn gang cannot wedge it; with several
        controllers each folds its LOCAL survivors."""
        from photon_tpu_torch.strategy.aggregation import aggregate_inplace

        with telemetry.span(COLLECTIVE_EXCHANGE_TIME, degraded=True):
            t0 = time.monotonic()
            avg, n_samples = aggregate_inplace(landed[cid] for cid in cohort if cid in landed)
            fold_s = time.monotonic() - t0
        with telemetry.span(COLLECTIVE_UPDATE_TIME, degraded=True):
            t1 = time.monotonic()
            metrics = self._apply_average_host(server_round, avg, n_samples, len(cohort))
            update_s = time.monotonic() - t1
        metrics[COLLECTIVE_STACK_TIME] = 0.0
        metrics[COLLECTIVE_EXCHANGE_TIME] = fold_s
        metrics[COLLECTIVE_UPDATE_TIME] = update_s
        metrics[COLLECTIVE_WIRE_BYTES] = 0.0  # nothing crossed a client boundary
        return metrics

    # -- per-cohort adapter rounds ----------------------------------------
    def _cohort_broadcast_ptrs(self, tag: str, server_round: int) -> dict:
        """One merged (base + cohort adapter) payload per cohort this
        process serves, keyed by cohort name (None = the identity adapter
        of cohortless cids)."""
        plane = self.adapter_plane
        ptrs: dict = {}
        for cid in self.process_cids:
            name = plane.cohort_of.get(cid)
            if name not in ptrs:
                meta_c, arrays_c = plane.broadcast_payload(cid)
                ptrs[name] = self.transport.put(
                    f"adapter-{tag}-r{server_round}-{name or '__base__'}", meta_c, arrays_c,
                )
        return ptrs

    def _run_round_adapters(self, server_round: int) -> dict[str, float]:
        """One personalization round: per-cohort broadcast → adapter fits on
        the frozen base → every cohort's reduction in ONE grouped exchange →
        per-cohort server updates, under the same elastic ladder."""
        t_round = time.monotonic()
        cfg = self.cfg
        plane = self.adapter_plane
        ptrs = self._cohort_broadcast_ptrs("bcast", server_round)

        t_fit = time.monotonic()
        landed: dict[int, tuple[list[np.ndarray], int]] = {}
        for cid in self.process_cids:
            ins = FitIns(
                server_round=server_round,
                cids=[cid],
                params=ptrs[plane.cohort_of.get(cid)],
                local_steps=cfg.fl.local_steps,
                server_steps_cumulative=self.server_steps_cumulative,
                client_states=(
                    {cid: self.client_states[cid]} if cid in self.client_states else {}
                ),
                config=dict(cfg.fl.fit_config),
            )
            res = self.runtime.fit(ins, cid)
            nid = self._client_node_id(cid)
            if res.error:
                self.liveness.observe_miss(nid)
                telemetry.emit_event(
                    EVENT_COLLECTIVE_STRAGGLER, round=server_round, cid=cid,
                    reason="fit_error", detail=res.error[:200],
                )
                warnings.warn(
                    f"adapter round {server_round}: cid {cid} failed "
                    f"({res.error.splitlines()[0][:120]}) — dropped from the "
                    "round's cohort",
                    stacklevel=2,
                )
                continue
            self.liveness.observe_alive(nid)
            if res.client_state:
                self.client_states[res.cid] = res.client_state
            meta, arrays = self.transport.get(res.params)
            # only the adapter rows reach the exchange: the base is frozen
            landed[cid] = (plane.extract_adapter(meta, arrays), res.n_samples)
            self.transport.free(res.params)
        for ptr in ptrs.values():
            self.transport.free(ptr)

        crash_point("pre-exchange", server_round, self.runtime.node_id)

        t_agg = time.monotonic()
        metrics, path, stragglers, reconfig_s = self._aggregate_elastic_adapters(
            server_round, landed
        )
        if metrics is None:
            warnings.warn(
                f"adapter round {server_round}: no client deltas landed — "
                "round recorded failed, every cohort's adapter unchanged",
                stacklevel=2,
            )
            metrics = {
                ROUND_FAILED: 1.0,
                COLLECTIVE_STACK_TIME: 0.0,
                COLLECTIVE_EXCHANGE_TIME: 0.0,
                COLLECTIVE_UPDATE_TIME: 0.0,
                COLLECTIVE_WIRE_BYTES: 0.0,
                ADAPTER_WIRE_BYTES: 0.0,
                ADAPTER_COHORTS: 0.0,
                ADAPTER_COHORTS_DEGRADED: float(plane.n_cohorts),
            }
        else:
            self.server_steps_cumulative += cfg.fl.local_steps
        return self._finish_round(server_round, metrics, path, stragglers, reconfig_s,
                                  t_agg, t_fit, t_round)

    def _aggregate_elastic_adapters(self, server_round: int,
                                    landed: dict[int, tuple[list[np.ndarray], int]]
                                    ) -> tuple[dict[str, float] | None, str, int, float]:
        """The ladder over the grouped exchange: the failure unit stays the
        client, the degradation unit is the cohort (a cohort whose members
        all died skips its update; the others proceed)."""
        st = self.adapter_plane.strategies
        return self._ladder(server_round, landed, self._grouped_attempt,
                            self._grouped_host_fallback, st.snapshot, st.restore, "adapter")

    def _grouped_attempt(self, server_round: int, cohort: tuple[int, ...],
                         landed: dict[int, tuple[list[np.ndarray], int]]) -> dict[str, float]:
        """One grouped attempt over ``cohort``: every client's adapter row
        weighted into its own cohort's slot, one exchange for all K
        cohorts, each stage under its deadline; the per-cohort updates run
        on the caller's thread after the fetch."""
        from photon_tpu_torch.parallel.collective_agg import grouped_weighted_average
        from photon_tpu_torch.strategy.grouped import cohort_onehot

        plane = self.adapter_plane
        mesh = self._cohort_mesh(cohort)
        local_cids = [cid for cid in cohort if cid in landed]
        rows = [landed[cid][0] for cid in local_cids]
        ns = np.asarray([landed[cid][1] for cid in local_cids], np.int32)
        onehot = cohort_onehot(local_cids, plane.cohort_of, plane.cohort_names)

        with telemetry.span(COLLECTIVE_STACK_TIME):
            t_stage = time.monotonic()

            def _stack():
                self._bind_group(mesh)
                return self._stack_local(rows, mesh, len(cohort))

            stacked = self._run_stage("stack", _stack, self._stage_deadline())
            stack_s = time.monotonic() - t_stage

        with telemetry.span(COLLECTIVE_EXCHANGE_TIME):
            t_stage = time.monotonic()

            def _exchange():
                crash_point("mid-exchange", server_round, self.runtime.node_id)
                return grouped_weighted_average(stacked, ns, onehot, mesh,
                                                quantization=self.quantization,
                                                block=self.q8_block)

            avgs, totals = self._run_stage("exchange", _exchange, self._stage_deadline())
            exchange_s = time.monotonic() - t_stage
        crash_point("pre-update", server_round, self.runtime.node_id)
        with telemetry.span(COLLECTIVE_UPDATE_TIME):
            t_stage = time.monotonic()

            def _fetch():
                return ([a.detach().to("cpu").numpy() for a in avgs],
                        totals.detach().to("cpu").numpy())

            avgs_host, totals_host = self._run_stage("update", _fetch, self._stage_deadline())
            counts: dict[str, int] = {n: 0 for n in plane.cohort_names}
            for cid in cohort:
                name = plane.cohort_of.get(cid)
                if name is not None:
                    counts[name] += 1
            folds = {}
            for name in plane.cohort_names:
                k = plane.strategies.index_of(name)
                n_samples = int(round(float(totals_host[k])))
                if n_samples > 0:
                    folds[name] = ([a[k].copy() for a in avgs_host], n_samples,
                                   max(counts[name], 1))
            metrics = self._apply_cohort_updates(server_round, cohort, folds)
            update_s = time.monotonic() - t_stage

        metrics[COLLECTIVE_STACK_TIME] = stack_s
        metrics[COLLECTIVE_EXCHANGE_TIME] = exchange_s
        metrics[COLLECTIVE_UPDATE_TIME] = update_s
        wire = float(modeled_cross_slice_bytes(
            plane.adapter_sizes(), len(cohort), replica=mesh_replica(mesh),
            quantization=self.quantization, block=self.q8_block,
        ))
        metrics[COLLECTIVE_WIRE_BYTES] = wire
        metrics[ADAPTER_WIRE_BYTES] = wire
        return metrics

    def _apply_cohort_updates(self, server_round: int, cohort: tuple[int, ...],
                              folds: dict[str, tuple[list[np.ndarray], int, int]]
                              ) -> dict[str, float]:
        """Per-cohort server-optimizer updates from ``{cohort: (avg, Σn,
        n_clients)}``. A cohort absent from ``folds`` had no surviving
        member: its adapter stays as it was (event and health alert, never
        the round)."""
        from photon_tpu_torch.utils.profiling import (
            EFFECTIVE_LR,
            N_CLIENTS,
            N_SAMPLES,
            PARAM_NORM,
            PSEUDO_GRAD_NORM,
        )

        plane = self.adapter_plane
        updated = 0
        total_samples = 0.0
        g2 = p2 = 0.0
        lr = 0.0
        for name in plane.cohort_names:
            fold = folds.get(name)
            if fold is None:
                self._note_cohort_degraded(server_round, name)
                continue
            avg_c, n_samples, n_clients = fold
            m = plane.strategies.apply_average(server_round, name, avg_c, n_samples, n_clients)
            updated += 1
            total_samples += m.get(N_SAMPLES, float(n_samples))
            g2 += m.get(PSEUDO_GRAD_NORM, 0.0) ** 2
            p2 += m.get(PARAM_NORM, 0.0) ** 2
            lr = m.get(EFFECTIVE_LR, lr)
        return {
            N_CLIENTS: float(len(cohort)),
            N_SAMPLES: total_samples,
            EFFECTIVE_LR: lr,
            # the l2 of the CONCATENATED pseudo-gradients / adapter params
            PSEUDO_GRAD_NORM: float(np.sqrt(g2)),
            PARAM_NORM: float(np.sqrt(p2)),
            ADAPTER_COHORTS: float(updated),
            ADAPTER_COHORTS_DEGRADED: float(plane.n_cohorts - updated),
        }

    def _note_cohort_degraded(self, server_round: int, name: str) -> None:
        telemetry.emit_event(
            EVENT_ADAPTER_COHORT_DEGRADED, round=server_round, cohort=name,
            reason="no surviving members",
        )
        warnings.warn(
            f"adapter round {server_round}: cohort {name!r} has no "
            "surviving members — its adapter is unchanged this round",
            stacklevel=3,
        )
        health = telemetry.health_active()
        if health is not None:
            health.note_cohort_degraded(round=server_round, cohort=name,
                                        reason="no surviving members")

    def _grouped_host_fallback(self, server_round: int, cohort: tuple[int, ...],
                               landed: dict[int, tuple[list[np.ndarray], int]]
                               ) -> dict[str, float]:
        """The adapter ladder's floor: ``grouped_host_fold`` (it IS
        ``aggregate_inplace`` per cohort, bit for bit)."""
        from photon_tpu_torch.strategy.grouped import grouped_host_fold

        plane = self.adapter_plane
        with telemetry.span(COLLECTIVE_EXCHANGE_TIME, degraded=True):
            t0 = time.monotonic()
            folds = grouped_host_fold({cid: landed[cid] for cid in cohort if cid in landed},
                                      plane.cohort_of)
            fold_s = time.monotonic() - t0
        with telemetry.span(COLLECTIVE_UPDATE_TIME, degraded=True):
            t1 = time.monotonic()
            metrics = self._apply_cohort_updates(server_round, cohort, folds)
            update_s = time.monotonic() - t1
        metrics[COLLECTIVE_STACK_TIME] = 0.0
        metrics[COLLECTIVE_EXCHANGE_TIME] = fold_s
        metrics[COLLECTIVE_UPDATE_TIME] = update_s
        metrics[COLLECTIVE_WIRE_BYTES] = 0.0
        metrics[ADAPTER_WIRE_BYTES] = 0.0
        return metrics

    # -- checkpoint bridge ---------------------------------------------------
    def state_for_checkpoint(self):
        """Strategy state ready to serialize: ``Strategy.state_for_checkpoint``
        (the device plane mirrors into the host strategy every round), or in
        adapter mode one ``adapter__{cohort}`` entry plus
        ``astate__{cohort}__{key}`` entries per state tensor list."""
        if self.adapter_plane is not None:
            from photon_tpu_torch.adapters.checkpoint import adapter_key, adapter_state_key

            st = self.adapter_plane.strategies
            adapters = st.adapters_for_checkpoint()
            opt = st.state_for_checkpoint()
            out = {}
            for name in st.names:
                out[adapter_key(name)] = adapters[name]
                for skey, tensors in opt[name].items():
                    out[adapter_state_key(name, skey)] = tensors
            return out
        return self.strategy.state_for_checkpoint()

    def checkpoint_state_keys(self) -> tuple[str, ...]:
        """The state keys round validity and resume check (the strategy's,
        or every per-cohort adapter and optimizer-state key)."""
        if self.adapter_plane is not None:
            from photon_tpu_torch.adapters.checkpoint import adapter_state_keys

            return adapter_state_keys(self.adapter_plane.cohort_names,
                                      self.adapter_plane.strategies.state_keys)
        return tuple(self.strategy.state_keys)

    def save_checkpoint(self, mgr, server_round: int) -> None:
        """Write this round through ``ServerCheckpointManager.save_round``
        (manifest last); adapter mode saves the frozen base as the params
        object and the adapters and their state as state objects."""
        if self.adapter_plane is not None:
            meta = self.adapter_plane.base_meta
            params = self.adapter_plane.base_arrays
        else:
            meta, params = self.meta, self.strategy.current_parameters
        mgr.save_round(
            server_round, meta, params,
            strategy_state=self.state_for_checkpoint(),
            server_state={"server_round": server_round, **self.control_state_for_checkpoint()},
        )

    def resume_from(self, mgr, resume_round: int = -1) -> int:
        """Resolve (checksum-verified), load and re-seed; returns the
        resumed round. Every object the strategy writes is read, the
        adaptive step counter ``_t`` included (JAX's runner reads the state
        keys only, so its FedAdam/FedYogi restart bias correction)."""
        keys = self.checkpoint_state_keys()
        rnd = mgr.resolve_resume_round(resume_round, keys)
        if self.adapter_plane is None:
            keys = tuple(self.strategy.state_for_checkpoint())
        _, params, state, server_state = mgr.load_round(rnd, keys)
        self.load_server_state(params, state, server_state)
        return rnd

    def control_state_for_checkpoint(self) -> dict:
        """The non-tensor control snapshot a resume needs beside the
        strategy state (``ServerApp.save_checkpoint``'s vocabulary);
        ``aggregation_paths`` records each round's lineage."""
        out = {
            "server_steps_cumulative": self.server_steps_cumulative,
            "client_states": dict(self.client_states),
            "aggregation_paths": {int(r): p for r, p in self.aggregation_paths.items()},
        }
        if self.adapter_plane is not None:
            # per-cohort adaptive step counters
            out["adapter_t"] = self.adapter_plane.strategies.t_counters()
        return out

    def load_server_state(self, parameters, state=None, control=None) -> None:
        """Resume: re-seed the strategy replica (and the device plane) from
        checkpointed parameters and optimizer state; the adaptive ``_t``
        rides ``state``. Adapter mode: ``parameters`` is the frozen base and
        ``state`` carries the ``adapter__*`` / ``astate__*`` entries."""
        if self.adapter_plane is not None:
            from photon_tpu_torch.adapters.checkpoint import adapter_key, adapter_state_key

            plane = self.adapter_plane
            plane.base_arrays = [np.asarray(p, np.float32) for p in parameters]
            state = state or {}
            adapters: dict[str, list[np.ndarray]] = {}
            opt: dict[str, dict[str, list[np.ndarray]]] = {}
            for name in plane.cohort_names:
                key = adapter_key(name)
                if key not in state:
                    raise ValueError(
                        f"checkpoint carries no adapter for cohort {name!r} "
                        f"(key {key!r}) — cohort map changed since the save?"
                    )
                adapters[name] = state[key]
                opt[name] = {
                    skey: state[adapter_state_key(name, skey)]
                    for skey in plane.strategies.state_keys
                    if adapter_state_key(name, skey) in state
                }
            t = {str(k): int(v)
                 for k, v in ((control or {}).get("adapter_t", {}) or {}).items()}
            plane.strategies.initialize(adapters, opt, t=t)
        else:
            self.strategy.initialize(parameters, state)
        if control:
            self.server_steps_cumulative = int(
                control.get("server_steps_cumulative", self.server_steps_cumulative)
            )
            self.client_states = {int(k): v for k, v in control.get("client_states", {}).items()}
            self.aggregation_paths = {
                int(k): str(v) for k, v in control.get("aggregation_paths", {}).items()
            }
        if self.device_plane is not None:
            self.device_plane = DeviceAggregationPlane(
                self.mesh, self.strategy, quantization=self.quantization,
                block=self.q8_block, nonneg_rows=self._nonneg_rows,
                sharded=self.cfg.photon.comm_stack.collective_zero1,
            )

    def evaluate_round(self, server_round: int) -> dict[str, float]:
        """Federated eval over the exchange: every controller scores its
        clients on the post-aggregation params, then the sample-weighted
        loss rides the same average as the fits."""
        from photon_tpu_torch.federation.messages import EvaluateIns

        eval_ptrs: dict = {}
        ptr = None
        if self.adapter_plane is not None:
            # every client scores its OWN cohort's (base + adapter) params
            eval_ptrs = self._cohort_broadcast_ptrs("eval", server_round)
        else:
            ptr = self.transport.put(f"collective-eval-r{server_round}", self.meta,
                                     self.strategy.current_parameters)
            self.runtime.set_broadcast_params(ptr)
        losses: list[float] = []
        ns: list[int] = []
        for cid in self.process_cids:
            ins = EvaluateIns(
                server_round=server_round, cids=[cid],
                params=(eval_ptrs[self.adapter_plane.cohort_of.get(cid)]
                        if self.adapter_plane is not None else None),
                config=dict(self.cfg.fl.eval_config),
            )
            res = self.runtime.evaluate(ins, cid)
            nid = self._client_node_id(cid)
            if res.error:
                # a failed eval client scores with ZERO weight: the full
                # mesh still runs and a zero-n row drops out exactly
                self.liveness.observe_miss(nid)
                telemetry.emit_event(
                    EVENT_COLLECTIVE_STRAGGLER, round=server_round, cid=cid,
                    reason="eval_error", detail=res.error[:200],
                )
                warnings.warn(
                    f"collective eval round {server_round}: cid {cid} failed "
                    f"({res.error.splitlines()[0][:120]}) — scored with zero "
                    "weight",
                    stacklevel=2,
                )
                losses.append(0.0)
                ns.append(0)
                continue
            self.liveness.observe_alive(nid)
            losses.append(float(res.loss))
            ns.append(res.n_samples)
        for p in eval_ptrs.values():
            self.transport.free(p)
        if ptr is not None:
            self.transport.free(ptr)

        # losses are [1]-vectors: eval always rides the fp32 exchange, under
        # the same stage deadline as a fit round's
        def _exchange():
            self._bind_group(self.mesh)
            rows = [[torch.tensor([l], dtype=torch.float32) for l in losses]]
            avg, total = hierarchical_weighted_average(rows, np.asarray(ns, np.int32),
                                                       self.mesh, return_total=True)
            return float(avg[0][0]), float(total)

        try:
            loss, total = self._run_stage("eval-exchange", _exchange, self._stage_deadline())
        except Exception as e:  # noqa: BLE001 — a torn gang: no retry budget
            # for eval, straight back to the local weighted mean
            self._abandon_group(self.mesh)
            warnings.warn(
                f"collective eval round {server_round}: exchange failed "
                f"({type(e).__name__}: {e}) — falling back to the local "
                "weighted mean",
                stacklevel=2,
            )
            local_n = int(sum(ns))
            loss = float(np.dot(losses, ns)) / local_n if local_n else 0.0
            total = float(local_n)
        if total == 0:
            warnings.warn(
                f"collective eval round {server_round}: no eval samples "
                "landed — eval skipped",
                stacklevel=2,
            )
            metrics = {EVAL_SAMPLES: 0.0}
            self.history.record(server_round, metrics)
            return metrics
        metrics = {EVAL_LOSS: loss, EVAL_SAMPLES: total}
        self.history.record(server_round, metrics)
        return metrics

    def run(self, n_rounds: int | None = None) -> History:
        n_rounds = n_rounds if n_rounds is not None else self.cfg.fl.n_rounds
        every = self.cfg.fl.eval_interval_rounds
        if every:
            # the round-0 baseline on the initial parameters, as the driver
            # topology records it
            self.evaluate_round(0)
        for rnd in range(1, n_rounds + 1):
            self.run_round(rnd)
            if every and rnd % every == 0:
                self.evaluate_round(rnd)
        return self.history


def main(argv: list[str] | None = None) -> None:
    import argparse
    import json

    import torch.distributed as dist

    ap = argparse.ArgumentParser(
        prog="photon_tpu_torch.federation.collective_round",
        description="multi-controller federated rounds over torch.distributed collectives",
    )
    ap.add_argument("--coordinator", required=True, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--config", required=True, help="resolved config YAML")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="this process's device (default: the card cuda:{process_id %% cards}; "
                         "'cpu' runs the plain path with gloo)")
    args = ap.parse_args(argv)

    cfg = Config.from_yaml(args.config)
    cfg.photon.comm_stack.collective = True
    cfg.validate()
    if args.num_processes > 1:
        # process 0 hosts the rendezvous store; the default group carries
        # the handshake, the cohort groups the exchange
        dist.init_process_group(
            "gloo", init_method=f"tcp://{args.coordinator}",
            world_size=args.num_processes, rank=args.process_id,
        )
    from photon_tpu_torch import chaos

    chaos.install(cfg.photon.chaos, scope=f"collective{args.process_id}")
    try:
        cids = partition_cids(cfg.fl.n_total_clients, args.num_processes, args.process_id)
        runner = CollectiveFedRunner(cfg, cids, device=args.device)
        history = runner.run(args.rounds)
        out = {"rounds": args.rounds or cfg.fl.n_rounds, "process_id": args.process_id,
               "backend": runner.backend, "staged_legs": sorted(runner.mesh.staged_legs),
               "paths": {str(k): v for k, v in runner.aggregation_paths.items()}}
        for key in ("server/round_time", "server/pseudo_grad_norm", "server/steps_cumulative"):
            latest = history.latest(key)
            if latest is not None:
                out[key] = latest
        print(json.dumps(out), flush=True)
    finally:
        chaos.uninstall()
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
