"""The seeded fault injector and its process-global installation (the
port of ``photon_tpu/chaos/injector.py``).

Determinism: an injector's schedule is a pure function of
``(ChaosConfig.seed, scope)`` and the order of the hook calls in its
process. ``scope`` is the node id (or ``"server"``), so a run across
processes replays the same faults in each process although the processes
interleave differently from run to run. The stream is Python's
``random.Random`` seeded as the JAX package seeds it, and every plan draws
in the JAX package's order, so one seed and scope give the same plans in
both packages.

Hook sites call :func:`active` (a module-global read) and do nothing when
it returns ``None``.
"""

from __future__ import annotations

import dataclasses
import os
import random
import zlib
from typing import Callable

from photon_tpu_torch import telemetry
from photon_tpu_torch.utils.profiling import CHAOS_EVENT_PREFIX

# fit-handling phases (node processes) and the collective round's phases
# (accepted by the schema; the collective round is not ported yet)
_PHASES = (
    "pre-fit", "mid-fit", "pre-reply",
    "pre-exchange", "mid-exchange", "pre-update",
)


@dataclasses.dataclass
class TcpFaultPlan:
    """One envelope send's fate (independent draws)."""

    drop: bool = False
    delay_s: float = 0.0
    duplicate: bool = False
    corrupt: bool = False


@dataclasses.dataclass
class StoreFaultPlan:
    """One object-store access's fate, a write's or a read's.

    On a write, ``partial``: the temp file lands but is never renamed into
    place (a torn upload); ``bitflip``: one payload bit flips before the
    otherwise atomic write. On a read, ``partial``: half the bytes come
    back; ``bitflip``: one bit of the returned bytes flips while the object
    at rest stays intact. Checksums must catch both directions.
    """

    delay_s: float = 0.0
    partial: bool = False
    bitflip: bool = False


def _scope_seed(seed: int, scope: str) -> int:
    return (int(seed) ^ zlib.crc32(scope.encode())) & 0x7FFFFFFF


class FaultInjector:
    """Draws fault plans from a seeded stream; one instance per process.

    ``crash_fn`` is injectable for tests; the default ``os._exit(137)``
    cannot be caught from Python: no ``finally``, no atexit, as with a
    SIGKILL.
    """

    def __init__(self, cfg, scope: str = "", crash_fn: Callable[[int], None] | None = None) -> None:
        self.cfg = cfg
        self.scope = scope
        self.rng = random.Random(_scope_seed(cfg.seed, scope))
        self.crash_fn = crash_fn or (lambda code: os._exit(code))
        #: how often each plan fired
        self.counts: dict[str, int] = {
            "tcp_drop": 0, "tcp_delay": 0, "tcp_duplicate": 0, "tcp_corrupt": 0,
            "store_slow": 0, "store_partial": 0, "store_bitflip": 0,
            "store_read_slow": 0, "store_read_partial": 0,
            "store_read_bitflip": 0, "crash": 0, "nan_delta": 0,
            "replica_kill": 0, "fit_delay": 0,
            "serve_stall": 0, "hbm_ramp": 0,
        }
        # corrupting store faults (partial, bitflip; reads and writes)
        # fired, bounded by cfg.store_fault_max (0 = unlimited)
        self._store_faults = 0

    def _fired(self, kind: str, **attrs) -> None:
        """Count a fired fault and emit its ``chaos/<kind>`` telemetry event
        with trace correlation, so the event log places it in the span it
        hit (a None check with telemetry off)."""
        self.counts[kind] += 1
        telemetry.emit_event(CHAOS_EVENT_PREFIX + kind, scope=self.scope, **attrs)

    # -- TCP control plane ----------------------------------------------
    def tcp_plan(self) -> TcpFaultPlan:
        c = self.cfg
        plan = TcpFaultPlan()
        if c.tcp_drop_p and self.rng.random() < c.tcp_drop_p:
            plan.drop = True
            self._fired("tcp_drop")
            return plan  # a dropped frame is not also delayed or repeated
        if c.tcp_delay_p and self.rng.random() < c.tcp_delay_p:
            plan.delay_s = self.rng.uniform(0.0, c.tcp_delay_max_s)
            self._fired("tcp_delay", delay_s=plan.delay_s)
        if c.tcp_duplicate_p and self.rng.random() < c.tcp_duplicate_p:
            plan.duplicate = True
            self._fired("tcp_duplicate")
        if c.tcp_corrupt_p and self.rng.random() < c.tcp_corrupt_p:
            plan.corrupt = True
            self._fired("tcp_corrupt")
        return plan

    def corrupt_bytes(self, data: bytes) -> bytes:
        """Flip one bit at a seeded offset (never a no-op)."""
        if not data:
            return data
        buf = bytearray(data)
        i = self.rng.randrange(len(buf))
        buf[i] ^= 1 << self.rng.randrange(8)
        return bytes(buf)

    # -- object store ----------------------------------------------------
    def _store_capped(self) -> bool:
        mx = int(getattr(self.cfg, "store_fault_max", 0))
        return mx > 0 and self._store_faults >= mx

    def _store_plan(self, prefix: str) -> StoreFaultPlan:
        """One store access's fate; ``prefix`` keys the counters
        (``store_`` for writes, ``store_read_`` for reads). The
        ``store_fault_max`` cap gates the corrupting faults only: a delay
        neither spends the budget nor is blocked by it."""
        c = self.cfg
        plan = StoreFaultPlan()
        if c.store_slow_p and self.rng.random() < c.store_slow_p:
            plan.delay_s = self.rng.uniform(0.0, c.store_slow_max_s)
            self._fired(f"{prefix}slow", delay_s=plan.delay_s)
        if self._store_capped():
            return plan
        if c.store_partial_p and self.rng.random() < c.store_partial_p:
            plan.partial = True
            self._fired(f"{prefix}partial")
        elif c.store_bitflip_p and self.rng.random() < c.store_bitflip_p:
            plan.bitflip = True
            self._fired(f"{prefix}bitflip")
        if plan.partial or plan.bitflip:
            self._store_faults += 1
        return plan

    def store_plan(self) -> StoreFaultPlan:
        """One store write's fate (``FileStore.put``)."""
        return self._store_plan("store_")

    def store_read_plan(self) -> StoreFaultPlan:
        """One store read's fate (``FileStore.get``, and so
        ``get_to_file``): the write side's knobs, its own counters."""
        return self._store_plan("store_read_")

    # -- numeric poison ----------------------------------------------------
    def nan_delta_plan(self, server_round: int, cid: int) -> bool:
        """Whether this client's shipped fit result gets a NaN:
        ``nan_delta_round`` matches and ``nan_delta_cid`` is -1 or this cid.
        No draw: the poison lands at exactly one round."""
        c = self.cfg
        r = int(getattr(c, "nan_delta_round", 0))
        if not r or server_round != r:
            return False
        want = int(getattr(c, "nan_delta_cid", -1))
        if want >= 0 and cid != want:
            return False
        self._fired("nan_delta", server_round=server_round, cid=cid)
        return True

    # -- per-client fit slowdown -------------------------------------------
    def fit_delay_plan(self, cid: int) -> float:
        """This client's fit slowdown factor (>= 1.0; 1.0 = none).

        A pure function of ``(seed, scope, cid)``, not of the hook order:
        ``fit_delay_cid`` >= 0 gives that one client the full factor; -1
        gives every client a seeded factor in [1, factor] from a stream of
        its own.
        """
        c = self.cfg
        factor = float(getattr(c, "fit_delay_factor", 0.0) or 0.0)
        if factor <= 1.0:
            return 1.0
        want = int(getattr(c, "fit_delay_cid", -1))
        if want >= 0:
            if cid != want:
                return 1.0
            f = factor
        else:
            rng = random.Random(_scope_seed(c.seed, f"{self.scope}/fit_delay/{cid}"))
            f = 1.0 + (factor - 1.0) * rng.random()
        self._fired("fit_delay", cid=cid, factor=round(f, 4))
        return f

    # -- serving -----------------------------------------------------------
    def serve_stall_plan(self, tokens: int) -> float:
        """Seconds to stall this scheduler step: ``serve_stall_per_token_s``
        times the tokens the step carried (chunk and emissions). No draw."""
        c = self.cfg
        per = float(getattr(c, "serve_stall_per_token_s", 0.0) or 0.0)
        if per <= 0.0 or tokens <= 0:
            return 0.0
        delay = per * tokens
        self._fired("serve_stall", tokens=int(tokens), delay_s=round(delay, 6))
        return delay

    def hbm_ramp_plan(self) -> float:
        """The n-th serving device-memory sample's inflation,
        ``serve_hbm_ramp_frac * n`` (0.0 = off): strictly monotone growth
        for the health plane's memory watcher."""
        c = self.cfg
        frac = float(getattr(c, "serve_hbm_ramp_frac", 0.0) or 0.0)
        if frac <= 0.0:
            return 0.0
        n = self.counts["hbm_ramp"] + 1
        self._fired("hbm_ramp", sample=n)
        return frac * n

    def replica_kill_plan(self, requests_routed: int,
                          live_replicas: list[str]) -> str | None:
        """The replica to kill now, or None. Fires once, when the router's
        placement count reaches ``replica_kill_after_requests``;
        ``replica_kill_id`` names the victim, else the seeded stream picks
        one of ``live_replicas`` (sorted, so the caller's order does not
        matter)."""
        c = self.cfg
        n = int(getattr(c, "replica_kill_after_requests", 0))
        if not n or self.counts["replica_kill"] or requests_routed < n:
            return None
        want = str(getattr(c, "replica_kill_id", ""))
        if want:
            victim = want if want in live_replicas else None
        else:
            victim = self.rng.choice(sorted(live_replicas)) if live_replicas else None
        if victim is None:
            return None
        self._fired("replica_kill", replica=victim, requests_routed=requests_routed)
        return victim

    # -- node crash ----------------------------------------------------------
    def maybe_crash(self, phase: str, server_round: int = 0, node_id: str = "") -> None:
        c = self.cfg
        if not c.crash_phase or c.crash_phase != phase:
            return
        if c.crash_round and server_round != c.crash_round:
            return
        if c.crash_node_id and node_id and node_id != c.crash_node_id:
            return
        if c.crash_marker:
            # the marker outlives the killed process: a restarted node with
            # the same config sees it and stays up, so the crash happens
            # exactly once
            try:
                fd = os.open(c.crash_marker, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return
            except OSError:
                return  # an unreachable marker path: no crash
            os.close(fd)
        self._fired("crash", phase=phase, server_round=server_round, node_id=node_id)
        self.crash_fn(137)


# -- process-global installation ----------------------------------------

_INJECTOR: FaultInjector | None = None


def install(cfg, scope: str = "", crash_fn: Callable[[int], None] | None = None) -> FaultInjector | None:
    """Install (or clear) the process-global injector from a ChaosConfig.
    ``cfg=None`` or ``cfg.enabled=False`` uninstalls, so a config with
    chaos off always leaves a clean process."""
    global _INJECTOR
    if cfg is None or not getattr(cfg, "enabled", False):
        _INJECTOR = None
        return None
    _INJECTOR = FaultInjector(cfg, scope=scope, crash_fn=crash_fn)
    return _INJECTOR


def uninstall() -> None:
    global _INJECTOR
    _INJECTOR = None


def active() -> FaultInjector | None:
    """The installed injector, or None: the one check every hook makes."""
    return _INJECTOR


def crash_point(phase: str, server_round: int = 0, node_id: str = "") -> None:
    """A crash hook site (a no-op unless an injector is installed)."""
    inj = _INJECTOR
    if inj is not None:
        inj.maybe_crash(phase, server_round, node_id)


def validate_chaos_config(cfg) -> None:
    """The schema's checks of ``photon.chaos`` (the JAX package's texts)."""
    for name in (
        "tcp_drop_p", "tcp_delay_p", "tcp_duplicate_p", "tcp_corrupt_p",
        "store_slow_p", "store_partial_p", "store_bitflip_p",
    ):
        v = getattr(cfg, name)
        if not 0.0 <= v <= 1.0:
            raise ValueError(f"chaos.{name} must be in [0, 1], got {v}")
    if cfg.tcp_delay_max_s < 0 or cfg.store_slow_max_s < 0:
        raise ValueError("chaos delay bounds must be >= 0")
    if cfg.crash_phase and cfg.crash_phase not in _PHASES:
        raise ValueError(
            f"chaos.crash_phase must be one of {_PHASES} or '', got {cfg.crash_phase!r}"
        )
    if cfg.crash_round < 0:
        raise ValueError(f"chaos.crash_round must be >= 0, got {cfg.crash_round}")
    if cfg.nan_delta_round < 0:
        raise ValueError(
            f"chaos.nan_delta_round must be >= 0 (0 = off), got {cfg.nan_delta_round}"
        )
    if cfg.store_fault_max < 0:
        raise ValueError(
            f"chaos.store_fault_max must be >= 0 (0 = unlimited), got {cfg.store_fault_max}"
        )
    if cfg.replica_kill_after_requests < 0:
        raise ValueError(
            f"chaos.replica_kill_after_requests must be >= 0 (0 = off), got "
            f"{cfg.replica_kill_after_requests}"
        )
    fd = float(cfg.fit_delay_factor)
    if fd != 0.0 and fd < 1.0:
        raise ValueError(
            f"chaos.fit_delay_factor must be 0 (off) or >= 1 (a slowdown), got {fd}"
        )
    if cfg.fit_delay_cid < -1:
        raise ValueError(
            f"chaos.fit_delay_cid must be >= -1 (-1 = seeded per-client), got {cfg.fit_delay_cid}"
        )
    if cfg.serve_stall_per_token_s < 0.0:
        raise ValueError(
            f"chaos.serve_stall_per_token_s must be >= 0 (0 = off), got "
            f"{cfg.serve_stall_per_token_s}"
        )
    if cfg.serve_hbm_ramp_frac < 0.0:
        raise ValueError(
            f"chaos.serve_hbm_ramp_frac must be >= 0 (0 = off), got {cfg.serve_hbm_ramp_frac}"
        )
