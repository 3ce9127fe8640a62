"""Dynamic invariant detectors: lock-order recorder + retrace sentinel (the
port of ``photon_tpu/analysis/runtime.py``).

They catch what only execution can: an actual lock-order inversion between
the scheduler loop, the router's poll thread, the fleet agent's restart
thread, the autopilot and the telemetry plane; and an actual kernel build
inside a steady-state round or serving tick.

Installation discipline is the chaos/telemetry one: a module global that is
``None`` by default, hook sites that read it once and do nothing when it is
``None``. Both detectors are OFF unless a caller installs them: the
disabled cost is one ``None`` check at the :func:`steady_point` hook sites
and in ``ops/_build.load``; for the lock recorder it is zero before any
install (``threading.Lock`` is only patched while installed) and one
``None`` check per acquire on wrapper locks that survive an uninstall.

**Lock-order recorder** — :func:`install_lock_order` replaces the
``threading.Lock`` / ``threading.RLock`` factories with wrappers that note,
per thread, which locks are held when another is acquired. Edges accumulate
in a global acquisition graph keyed by each lock's allocation site;
:meth:`LockOrderRecorder.check` fails on any cycle — i.e. two threads that
*could* deadlock, even if this run's interleaving happened to dodge it.
Only locks created while installed are tracked (install the recorder before
constructing the objects under test). Pure Python: the JAX package's
semantics unchanged.

**Retrace sentinel** — the port's runtime compile is a kernel library that
``photon_tpu_torch/ops/_build.py::load`` builds or loads for the first time
in the process (the count ``telemetry.introspect.compile_count`` reads);
:func:`install_retrace_sentinel` hangs the sentinel on that loader's
``on_load`` listener. After :meth:`RetraceSentinel.mark_steady`, any such
load is a violation: :func:`steady_point` hook sites in the server round
loop (``server/round``) and the serve scheduler (``serve/tick``) bill it
to the iteration that loaded, and :meth:`RetraceSentinel.check` raises.
This is the machine-checked form of "a warm engine builds nothing on
admission".
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Iterator

__all__ = [
    "LockOrderRecorder",
    "LockOrderViolation",
    "RetraceSentinel",
    "RetraceViolation",
    "absorb_compiles",
    "install_lock_order",
    "install_retrace_sentinel",
    "lock_order_active",
    "lock_order_guard",
    "retrace_active",
    "retrace_guard",
    "steady_point",
    "uninstall_lock_order",
    "uninstall_retrace_sentinel",
]


class LockOrderViolation(AssertionError):
    """A cycle in the lock-acquisition graph (potential deadlock)."""


class RetraceViolation(AssertionError):
    """A steady-state iteration compiled (retrace / cache miss)."""


# ---------------------------------------------------------------------------
# lock-order recorder
# ---------------------------------------------------------------------------


#: frames never credited as an allocation site: this module, and the stdlib
#: wrappers that allocate locks on their callers' behalf. Without the skip,
#: EVERY default ``threading.Condition()``'s internal RLock would be born at
#: the same threading.py line — unrelated components would collapse to one
#: graph node and alias into false-positive "cycles".
_SKIP_BASENAMES = frozenset(
    {__file__.rsplit("/", 1)[-1], "threading.py", "queue.py"}
)


def _alloc_site() -> str:
    """file:line of the frame that called the lock factory (first frame
    outside this module and the stdlib lock wrappers) — the stable identity
    of a lock *class*: every ``SocketConn`` allocates its ``_wlock`` at the
    same line, so one edge per code-level ordering rather than per
    instance."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename.rsplit("/", 1)[-1] in _SKIP_BASENAMES:
        f = f.f_back
    if f is None:  # whole stack is lock plumbing (e.g. bare Thread internals)
        return "<stdlib>"
    return f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno}"


class _TrackedLock:
    """Wrapper around a real Lock/RLock that reports acquire/release order.

    Implements the full lock protocol plus the private Condition hooks
    (``_release_save``/``_acquire_restore``/``_is_owned``) so
    ``threading.Condition`` built on a tracked RLock — the
    ContinuousBatcher's ``self._work`` shape — records its wait/notify
    release-reacquire pairs too.

    Wrappers outlive :func:`uninstall_lock_order` (whoever allocated them
    keeps holding them), so they report to the module-global recorder, not
    a captured one: after uninstall every acquire/release degrades to one
    ``None`` check instead of feeding a dead recorder's graph forever.
    """

    __slots__ = ("_inner", "site")

    def __init__(self, inner, site: str) -> None:
        self._inner = inner
        self.site = site

    def acquire(self, *args, **kwargs):
        # the wrapper forwards its caller's acquire; the caller scopes it
        got = self._inner.acquire(*args, **kwargs)  # photon-lint: ignore[concurrency/bare-acquire]
        rec = _LOCK_RECORDER
        if got and rec is not None:
            rec._note_acquire(self)
        return got

    def release(self) -> None:
        rec = _LOCK_RECORDER
        if rec is not None:
            rec._note_release(self)
        self._inner.release()

    def __enter__(self) -> bool:
        return self.acquire()  # photon-lint: ignore[concurrency/bare-acquire] -- `with` releases

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:  # pragma: no cover — fork safety
        self._inner._at_fork_reinit()


class _TrackedRLock(_TrackedLock):
    """RLock wrapper. The Condition protocol methods live ONLY here: a
    plain-Lock wrapper must NOT define them, or ``threading.Condition``
    binds them and hits the C Lock's missing ``_is_owned`` at notify time
    instead of using its own generic fallback."""

    __slots__ = ()

    def _release_save(self):
        rec = _LOCK_RECORDER
        if rec is not None:
            rec._note_release(self)
        return self._inner._release_save()

    def _acquire_restore(self, state) -> None:
        self._inner._acquire_restore(state)
        rec = _LOCK_RECORDER
        if rec is not None:
            rec._note_acquire(self)

    def _is_owned(self) -> bool:
        return self._inner._is_owned()


class LockOrderRecorder:
    """Global acquisition graph over tracked locks, per-thread held stacks.

    Edge ``A -> B`` means "some thread held A while acquiring B". A cycle
    means two code paths take the same locks in opposite orders — the
    classic deadlock precondition — regardless of whether this run's
    timing actually wedged.
    """

    def __init__(self, orig_lock, orig_rlock) -> None:
        self._orig_lock = orig_lock
        self._orig_rlock = orig_rlock
        # the graph's own guard must be a REAL lock: a tracked one would
        # recurse into _note_acquire forever
        self._glock = orig_lock()
        self._edges: dict[str, set] = {}
        self._tls = threading.local()
        self.n_locks = 0
        self.n_acquires = 0

    # -- factories installed over threading.Lock / threading.RLock --------
    def _make_lock(self) -> _TrackedLock:
        self.n_locks += 1
        return _TrackedLock(self._orig_lock(), _alloc_site())

    def _make_rlock(self) -> "_TrackedRLock":
        self.n_locks += 1
        return _TrackedRLock(self._orig_rlock(), _alloc_site())

    # -- bookkeeping -------------------------------------------------------
    def _held(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _note_acquire(self, lk: _TrackedLock) -> None:
        held = self._held()
        if held:
            with self._glock:
                self.n_acquires += 1
                for h in held:
                    if h.site != lk.site:
                        self._edges.setdefault(h.site, set()).add(lk.site)
        else:
            with self._glock:
                self.n_acquires += 1
        held.append(lk)

    def _note_release(self, lk: _TrackedLock) -> None:
        held = self._held()
        # remove the LAST occurrence: RLock re-entries release in LIFO order
        for i in range(len(held) - 1, -1, -1):
            if held[i] is lk:
                del held[i]
                return

    # -- verdicts ----------------------------------------------------------
    def edges(self) -> dict[str, frozenset]:
        with self._glock:
            return {k: frozenset(v) for k, v in self._edges.items()}

    def find_cycle(self) -> list[str] | None:
        """Any cycle in the acquisition graph, as the site path, or None."""
        edges = self.edges()
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in edges}
        parent: dict[str, str] = {}

        def dfs(n: str) -> list[str] | None:
            color[n] = GRAY
            for m in edges.get(n, ()):
                c = color.get(m, WHITE)
                if c == GRAY:  # back edge: walk parents to recover the loop
                    cyc = [m, n]
                    cur = n
                    while cur != m:
                        cur = parent[cur]
                        cyc.append(cur)
                    return cyc[::-1]
                if c == WHITE:
                    parent[m] = n
                    found = dfs(m)
                    if found:
                        return found
            color[n] = BLACK
            return None

        for n in list(edges):
            if color.get(n, 0) == WHITE:
                found = dfs(n)
                if found:
                    return found
        return None

    def check(self) -> None:
        """Raise :class:`LockOrderViolation` on any cycle."""
        cyc = self.find_cycle()
        if cyc:
            raise LockOrderViolation(
                "lock-order inversion (potential deadlock): "
                + " -> ".join(cyc)
                + f" — {self.n_locks} tracked locks, {self.n_acquires} nested acquires"
            )


_LOCK_RECORDER: LockOrderRecorder | None = None


def install_lock_order() -> LockOrderRecorder:
    """Patch the ``threading`` lock factories; only locks created while
    installed are tracked. Idempotent per process (re-install replaces)."""
    global _LOCK_RECORDER
    if _LOCK_RECORDER is not None:
        uninstall_lock_order()
    rec = LockOrderRecorder(threading.Lock, threading.RLock)
    threading.Lock = rec._make_lock
    threading.RLock = rec._make_rlock
    _LOCK_RECORDER = rec
    return rec


def uninstall_lock_order() -> None:
    """Restore the real factories (existing tracked locks keep working —
    they wrap real primitives)."""
    global _LOCK_RECORDER
    rec = _LOCK_RECORDER
    if rec is not None:
        threading.Lock = rec._orig_lock
        threading.RLock = rec._orig_rlock
    _LOCK_RECORDER = None


def lock_order_active() -> LockOrderRecorder | None:
    return _LOCK_RECORDER


# ---------------------------------------------------------------------------
# retrace sentinel
# ---------------------------------------------------------------------------


class RetraceSentinel:
    """Counts kernel builds; after :meth:`mark_steady`, any build is a
    violation attributable to the :func:`steady_point` interval it landed
    in."""

    def __init__(self) -> None:
        self.compiles = 0  # cumulative, warmup included
        self.steady = False
        self._mark = 0
        self._steady_after: int | None = None
        self._points_seen = 0
        self.violations: list[tuple[str, int]] = []  # (hook label, n compiles)
        #: steady-state compiles explicitly budgeted by :func:`absorb_compiles`
        #: (a legitimate reconfiguration build) — recorded for assertions,
        #: never billed as violations
        self.absorbed: list[tuple[str, int]] = []

    # the ``ops/_build.on_load`` listener: one call per library built or
    # loaded for the first time in this process
    def _on_load(self, source: str) -> None:
        self.compiles += 1

    def mark_steady(self) -> None:
        """Warmup is over: from here every compile is a retrace bug."""
        self.steady = True
        self._mark = self.compiles

    def mark_steady_after(self, n_points: int) -> None:
        """Auto-steady once ``n_points`` :func:`steady_point` hooks have
        fired — "the first N rounds/ticks are warmup, everything after
        must be compile-free"."""
        self._steady_after = int(n_points)

    def point(self, label: str) -> None:
        """Hook-site body (see :func:`steady_point`): bill compiles since
        the previous point to ``label``."""
        if not self.steady:
            if self._steady_after is not None:
                self._points_seen += 1
                if self._points_seen >= self._steady_after:
                    self.mark_steady()
            return
        self._bill(label)

    def _bill(self, label: str) -> None:
        n = self.compiles - self._mark
        if n:
            self.violations.append((label, n))
            self._mark = self.compiles

    def absorb(self, label: str) -> None:
        """Forgive compiles since the last bill/absorb point: they were
        expected. Recorded on :attr:`absorbed`, so a test can still pin how
        many were forgiven; anything that compiled since the previous point
        in the same interval is absorbed with it."""
        if not self.steady:
            return
        n = self.compiles - self._mark
        if n:
            self.absorbed.append((label, n))
            self._mark = self.compiles

    def check(self, label: str = "steady-state") -> None:
        """Raise :class:`RetraceViolation` if anything compiled since
        :meth:`mark_steady` (hook-attributed or not). Inert during warmup:
        a mid-warmup assertion must not advance :meth:`mark_steady_after`'s
        point budget — only real :func:`steady_point` hook sites do."""
        if self.steady:
            self._bill(label)
        if self.violations:
            detail = ", ".join(f"{lbl}: {n} compile(s)" for lbl, n in self.violations)
            raise RetraceViolation(
                f"steady-state retrace detected — {detail} (total compiles "
                f"this process: {self.compiles})"
            )


_SENTINEL: RetraceSentinel | None = None


def install_retrace_sentinel() -> RetraceSentinel:
    """Install a fresh sentinel on the kernel loader's listener (replacing
    an installed one)."""
    global _SENTINEL
    if _SENTINEL is not None:
        uninstall_retrace_sentinel()
    from photon_tpu_torch.ops import _build

    s = RetraceSentinel()
    _build.on_load = s._on_load
    _SENTINEL = s
    return s


def uninstall_retrace_sentinel() -> None:
    global _SENTINEL
    if _SENTINEL is not None:
        from photon_tpu_torch.ops import _build

        if _build.on_load == _SENTINEL._on_load:
            _build.on_load = None
    _SENTINEL = None


def retrace_active() -> RetraceSentinel | None:
    return _SENTINEL


def steady_point(label: str) -> None:
    """Product-loop hook site (server round loop, serve scheduler tick):
    one ``None`` check when no sentinel is installed — the same disabled
    cost contract as telemetry/chaos hooks."""
    s = _SENTINEL
    if s is not None:
        s.point(label)


@contextlib.contextmanager
def absorb_compiles(label: str) -> Iterator[None]:
    """Budgeted-compile region: compiles that land inside are expected
    (legitimate reconfiguration work) and are not billed as steady-state
    retrace violations. One ``None`` check when no sentinel is
    installed."""
    try:
        yield
    finally:
        s = _SENTINEL
        if s is not None:
            s.absorb(label)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def lock_order_guard() -> Iterator[LockOrderRecorder]:
    """Install the recorder for a block; on clean exit, fail on any cycle
    observed (uninstalls either way)."""
    rec = install_lock_order()
    try:
        yield rec
        rec.check()
    finally:
        uninstall_lock_order()


@contextlib.contextmanager
def retrace_guard(steady: bool = False) -> Iterator[RetraceSentinel]:
    """Install the sentinel for a block; callers run warmup, then
    ``mark_steady()`` (or pass ``steady=True`` when already warm). On clean
    exit, fail if a steady-state compile happened (uninstalls either way)."""
    s = install_retrace_sentinel()
    if steady:
        s.mark_steady()
    try:
        yield s
        if s.steady:
            s.check()
    finally:
        uninstall_retrace_sentinel()
