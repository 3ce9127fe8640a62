"""The photon-lint rule families, aimed at the port's invariants (the port
of ``photon_tpu/analysis/rules.py``):

- ``kpi-registry`` — metric/span/event names at record sites must be
  registry constants from ``photon_tpu_torch/utils/profiling.py``, never
  string literals (the runtime registry test only sees names actually
  recorded; this catches dead/typo'd names statically);
- ``metric-discipline`` — the same for instrument and alert names at the
  metrics plane's call sites;
- ``hook-gating`` — results of ``telemetry.active()`` / ``chaos.active()``
  style lookups (``telemetry/__init__.py``, ``chaos/injector.py``) must be
  used behind a ``x is not None`` guard, so a disabled plane costs one
  ``None`` check;
- ``retrace-hazard`` — inside functions that ``torch.compile`` or
  ``torch.jit.script`` wraps: host syncs (``float(x)``, ``.item()``,
  ``np.asarray``), value-dependent branches on traced args, and ``self``
  mutation (each a graph break or a guard failure that recompiles);
- ``concurrency`` — ``.acquire()`` outside ``with``/try-finally, threads
  without a name or a joining owner, ``os._exit`` outside the port's
  ``chaos/``, swallowed exceptions;
- ``transport-discipline`` — raw ``pickle.loads`` / socket reads outside
  the CRC32-framed ``SocketConn`` of ``photon_tpu_torch/federation/tcp.py``.

All checkers are pure AST walks; heuristics err toward precision (flag what
is almost certainly a violation) because a lint that cries wolf gets
suppressed wholesale. The escape hatches — inline ``photon-lint: ignore``
and the baseline file — exist for the justified exceptions.
"""

from __future__ import annotations

import ast
from typing import Iterator

from photon_tpu_torch.analysis.core import FileContext, Finding, rule

# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------


def _terminal_name(node: ast.AST) -> str:
    """``torch.compile`` -> "compile", ``Thread`` -> "Thread", ``a.b.c()`` -> "c"."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover — unparse is total on parsed trees
        return "<expr>"


def _walk_skip_nested_defs(body: list[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/class defs
    (used when a check is scoped to exactly one function's own code)."""
    stack: list[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _functions(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ---------------------------------------------------------------------------
# 1. kpi-registry
# ---------------------------------------------------------------------------

#: method / function names whose first positional argument is a KPI, span,
#: or event name (the registry vocabulary)
_NAME_SITES = frozenset({"span", "add_span", "timed_add", "emit_event", "emit"})


def _name_arg_finding(ctx: FileContext, call: ast.Call, arg: ast.expr,
                      site: str, family: str = "kpi-registry") -> Finding | None:
    reg = ctx.registry
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        value = arg.value
        const = reg.values.get(value)
        if const is not None:
            return ctx.finding(
                f"{family}/stringly-name", arg,
                f"string literal {value!r} at {site} site: use "
                f"profiling.{const} so the registry stays the single source "
                "of truth",
            )
        if reg.is_registered(value):
            return None  # dynamic-pattern literal (rare, allowed)
        return ctx.finding(
            f"{family}/unregistered-name", arg,
            f"name {value!r} at {site} site is not exported by "
            "photon_tpu_torch/utils/profiling.py — add a registry constant (typo'd/dead names "
            "are invisible to the runtime registry test)",
        )
    if isinstance(arg, ast.JoinedStr):
        return ctx.finding(
            f"{family}/fstring-name", arg,
            f"f-string name at {site} site: build dynamic names from a "
            "registry prefix constant (PREFIX + suffix), not a literal",
        )
    if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Add):
        left = arg.left
        if isinstance(left, ast.Constant) and isinstance(left.value, str):
            return ctx.finding(
                f"{family}/fstring-name", arg,
                f"literal-prefixed concatenation at {site} site: the prefix "
                "must be a registry constant",
            )
    return None


@rule("kpi-registry", "metric/span/event names must come from the utils/profiling.py registry")
def check_kpi_registry(ctx: FileContext) -> Iterator[Finding]:
    if ctx.relpath.endswith("utils/profiling.py"):
        return  # the registry itself defines the vocabulary
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _terminal_name(node.func)
        # History.record(round, {name: value, ...}) — literal dict keys
        if fname == "record" and len(node.args) >= 2 and isinstance(node.args[1], ast.Dict):
            for key in node.args[1].keys:
                if key is None:
                    continue
                f = _name_arg_finding(ctx, node, key, "History.record")
                if f is not None:
                    yield f
            continue
        if fname in _NAME_SITES and node.args:
            f = _name_arg_finding(ctx, node, node.args[0], fname)
            if f is not None:
                yield f


# ---------------------------------------------------------------------------
# 1b. metric-discipline
# ---------------------------------------------------------------------------

#: call sites whose first positional argument names a typed instrument or
#: an alert kind (telemetry/metrics.py hub accessors, the telemetry.metric_*
#: hook helpers, HealthMonitor.alert). Same static-parse approach as
#: kpi-registry: names must be constants from utils/profiling.py, so a
#: typo'd instrument can't silently fork a Prometheus series and an alert
#: kind consumers filter on can't drift.
_METRIC_SITES = frozenset({
    "counter", "gauge", "histogram",
    "metric_inc", "metric_set", "metric_observe",
    "alert",
})


@rule("metric-discipline",
      "instrument/alert names at metrics-plane call sites must be registry constants")
def check_metric_discipline(ctx: FileContext) -> Iterator[Finding]:
    if ctx.relpath.endswith("utils/profiling.py"):
        return  # the registry itself defines the vocabulary
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = _terminal_name(node.func)
        if fname in _METRIC_SITES and node.args:
            f = _name_arg_finding(ctx, node, node.args[0], fname,
                                  family="metric-discipline")
            if f is not None:
                yield f


# ---------------------------------------------------------------------------
# 2. hook-gating
# ---------------------------------------------------------------------------

_ACTIVE_FNS = frozenset({
    "active", "events_active", "lock_order_active", "retrace_active",
    "metrics_active", "health_active", "profiler_active",
    "autopilot_active",
})


def _is_active_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and not node.args
        and not node.keywords
        and _terminal_name(node.func) in _ACTIVE_FNS
    )


def _guard_polarity(test: ast.AST, var: str) -> int:
    """+1 when ``test`` true PROVES ``var`` non-None (``x``,
    ``x is not None``, ``not (x is None)``, ``x is not None and P``);
    -1 when ``var`` being None GUARANTEES ``test`` true (``x is None``,
    ``not x``, ``x is None or P``) — i.e. test false proves non-None;
    0 when the test proves nothing (incl. ``x or fallback``: an Or can't
    prove the positive, an And can't prove the negative)."""
    neg = False
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        test, neg = test.operand, True
    if isinstance(test, ast.Name) and test.id == var:
        return -1 if neg else 1
    if (
        isinstance(test, ast.Compare)
        and isinstance(test.left, ast.Name)
        and test.left.id == var
        and len(test.ops) == 1
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
        and isinstance(test.ops[0], (ast.Is, ast.IsNot))
    ):
        pos = isinstance(test.ops[0], ast.IsNot)
        return (1 if pos else -1) * (-1 if neg else 1)
    if isinstance(test, ast.BoolOp) and not neg:
        polarities = [_guard_polarity(v, var) for v in test.values]
        # and: ALL operands true -> a +1 operand proves non-None
        if isinstance(test.op, ast.And) and any(p > 0 for p in polarities):
            return 1
        # or: var None makes a -1 operand true, hence the whole Or true
        if isinstance(test.op, ast.Or) and any(p < 0 for p in polarities):
            return -1
    return 0


def _end(node: ast.AST) -> int:
    return getattr(node, "end_lineno", None) or node.lineno


def _guarded_line_spans(scope: ast.AST, var: str) -> list:
    """(start, end) line spans where ``var`` is proven non-None. A guard
    must DOMINATE a use to protect it: positive tests protect their body
    (or the ``and`` operands after the guard), negative tests protect the
    else branch — and later lines only when their body diverts control
    (return/raise/continue/break, the early-return idiom). A fall-through
    ``if x is None: log(...)`` blesses nothing."""
    spans = []

    def body_span(stmts) -> None:
        if stmts:
            spans.append((stmts[0].lineno, max(_end(s) for s in stmts)))

    for node in ast.walk(scope):
        if isinstance(node, (ast.If, ast.While)):
            pol = _guard_polarity(node.test, var)
            if pol > 0:
                body_span(node.body)
            elif pol < 0:
                body_span(node.orelse)
                if node.body and isinstance(
                    node.body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
                ):
                    spans.append((_end(node) + 1, 1 << 31))
        elif isinstance(node, ast.IfExp):
            pol = _guard_polarity(node.test, var)
            branch = node.body if pol > 0 else node.orelse if pol < 0 else None
            if branch is not None:
                spans.append((branch.lineno, _end(branch)))
        elif isinstance(node, ast.Assert):
            if _guard_polarity(node.test, var) > 0:
                spans.append((node.lineno, 1 << 31))
        elif isinstance(node, ast.BoolOp):
            # short-circuit protection: ``x and x.f()`` runs x.f() only when
            # x is truthy; ``x is None or x.f()`` runs x.f() only when x is
            # NOT None. Operands after the deciding guard are protected.
            want = 1 if isinstance(node.op, ast.And) else -1
            for i, v in enumerate(node.values):
                if _guard_polarity(v, var) == want and i + 1 < len(node.values):
                    rest = node.values[i + 1 :]
                    spans.append((min(r.lineno for r in rest), max(_end(r) for r in rest)))
                    break
    return spans


@rule("hook-gating", "active()-style hook results must be used behind an `is not None` guard")
def check_hook_gating(ctx: FileContext) -> Iterator[Finding]:
    scopes: list[ast.AST] = [ctx.tree, *_functions(ctx.tree)]
    for scope in scopes:
        body = scope.body if hasattr(scope, "body") else []
        # assignments made directly in THIS scope (nested defs get their own
        # pass); guards/uses may live anywhere under it, closures included
        for stmt in _walk_skip_nested_defs(body):
            if not isinstance(stmt, ast.Assign) or not _is_active_call(stmt.value):
                continue
            targets = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            for var in targets:
                uses = [
                    n
                    for n in ast.walk(scope)
                    if isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == var
                    and n.lineno >= stmt.lineno
                ]
                spans = _guarded_line_spans(scope, var)
                exposed = [
                    n for n in uses
                    if not any(s <= n.lineno <= e for s, e in spans)
                ]
                if exposed:
                    yield ctx.finding(
                        "hook-gating/unguarded", exposed[0],
                        f"{var!r} (from {_unparse(stmt.value)}) is used outside "
                        "any dominating `is not None` guard — disabled hooks "
                        "must stay one None check",
                    )
    for node in ast.walk(ctx.tree):
        if (
            isinstance(node, ast.Attribute)
            and _is_active_call(node.value)
        ):
            yield ctx.finding(
                "hook-gating/chained-active", node,
                f"chained `{_terminal_name(node.value.func)}().{node.attr}` — "
                "the result can be None when the plane is disabled; bind it "
                "and guard",
            )


# ---------------------------------------------------------------------------
# 3. retrace-hazard
# ---------------------------------------------------------------------------

#: the wrappers whose functions are traced: dotted spellings (a bare
#: ``compile`` would match ``re.compile``)
_COMPILE_WRAPPERS = frozenset({"torch.compile", "torch.jit.script", "jit.script"})
#: attribute reads that are static under tracing — a Name underneath them
#: is NOT a traced-value use (x.shape[0], x.ndim, x.dtype ...)
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "device", "is_cuda",
                           "requires_grad", "layout"})
_HOST_SYNC_CASTS = frozenset({"float", "int", "bool", "complex"})
_HOST_SYNC_METHODS = frozenset({"item", "tolist", "numpy", "cpu"})
_NUMPY_MODULES = frozenset({"np", "numpy", "onp"})


def _is_compile_wrapper(node: ast.AST) -> bool:
    return _unparse(node) in _COMPILE_WRAPPERS


def _compiled_functions(tree: ast.AST) -> Iterator[tuple[ast.AST, frozenset]]:
    """Yield (function_def, traced_param_names) for every function the
    module compiles — by decorator (``@torch.compile``,
    ``@torch.compile(...)``, ``@partial(torch.compile, ...)``,
    ``@torch.jit.script``) or by a ``torch.compile(fn, ...)`` wrapping
    call. Every parameter but ``self``/``cls`` is traced (torch.compile has
    no static arguments: a Python value it branches on becomes a guard)."""
    defs_by_name: dict[str, list] = {}
    for fn in _functions(tree):
        defs_by_name.setdefault(fn.name, []).append(fn)

    def emit(fn):
        params = [a.arg for a in (*fn.args.posonlyargs, *fn.args.args, *fn.args.kwonlyargs)]
        return fn, frozenset(p for p in params if p not in ("self", "cls"))

    seen: set[int] = set()
    for fn in _functions(tree):
        for dec in fn.decorator_list:
            call = dec if isinstance(dec, ast.Call) else None
            target = call.func if call else dec
            if _is_compile_wrapper(target) or (
                _terminal_name(target) == "partial" and call and call.args
                and _is_compile_wrapper(call.args[0])
            ):
                seen.add(id(fn))
                yield emit(fn)
                break
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_compile_wrapper(node.func) and node.args):
            continue
        arg0 = node.args[0]
        if isinstance(arg0, ast.Name):
            for fn in defs_by_name.get(arg0.id, []):
                if id(fn) not in seen:
                    seen.add(id(fn))
                    yield emit(fn)


class _TracedRefWalker:
    """Does an expression read a traced value? Names under static attribute
    chains (``x.shape``...), ``len(x)``, ``isinstance`` and ``x is None``
    comparisons don't count — those are static under tracing."""

    def __init__(self, traced: frozenset):
        self.traced = traced

    def refs(self, node: ast.AST) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.traced
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            return False
        if isinstance(node, ast.Call):
            fname = _terminal_name(node.func)
            if fname in ("len", "isinstance", "getattr", "hasattr", "type"):
                return False
        if isinstance(node, ast.Compare):
            if any(isinstance(c, ast.Constant) and c.value is None for c in node.comparators):
                return False
        return any(self.refs(child) for child in ast.iter_child_nodes(node))


@rule("retrace-hazard",
      "no host syncs, value-branches, or self-mutation inside torch.compile'd code")
def check_retrace_hazard(ctx: FileContext) -> Iterator[Finding]:
    for fn, traced_params in _compiled_functions(ctx.tree):
        traced = set(traced_params)
        # one forward pass of simple assignment propagation: names derived
        # from traced values are traced too
        walker = _TracedRefWalker(frozenset())
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                walker.traced = frozenset(traced)
                if walker.refs(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            traced.add(t.id)
                        elif isinstance(t, (ast.Tuple, ast.List)):
                            traced.update(e.id for e in t.elts if isinstance(e, ast.Name))
        walker.traced = frozenset(traced)

        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                fname = _terminal_name(node.func)
                if (
                    isinstance(node.func, ast.Name)
                    and fname in _HOST_SYNC_CASTS
                    and node.args
                    and walker.refs(node.args[0])
                ):
                    yield ctx.finding(
                        "retrace-hazard/host-sync", node,
                        f"`{fname}()` on a traced value inside compiled "
                        f"`{fn.name}` — a Python-scalar cast forces a device "
                        "sync and a graph break on the hot path",
                    )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _HOST_SYNC_METHODS
                    and walker.refs(node.func.value)
                ):
                    yield ctx.finding(
                        "retrace-hazard/host-sync", node,
                        f"`.{node.func.attr}()` on a traced value inside "
                        f"compiled `{fn.name}` — implicit host sync",
                    )
                elif (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("asarray", "array")
                    and _terminal_name(node.func.value) in _NUMPY_MODULES
                    and node.args
                    and walker.refs(node.args[0])
                ):
                    yield ctx.finding(
                        "retrace-hazard/host-sync", node,
                        f"`{_unparse(node.func)}` on a traced value inside "
                        f"compiled `{fn.name}` — numpy materialization is a "
                        "host sync; use torch",
                    )
            elif isinstance(node, (ast.If, ast.While)) and walker.refs(node.test):
                yield ctx.finding(
                    "retrace-hazard/traced-branch", node,
                    f"branch on a traced value inside compiled `{fn.name}` "
                    "— use torch.where/torch.cond, or a Python value the "
                    "guard can hold (each new value recompiles)",
                )
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        yield ctx.finding(
                            "retrace-hazard/self-mutation", node,
                            f"assignment to `self.{t.attr}` inside compiled "
                            f"`{fn.name}` — compiled code over mutable "
                            "attributes captures stale values or recompiles "
                            "on every guard failure",
                        )


# ---------------------------------------------------------------------------
# 4. concurrency
# ---------------------------------------------------------------------------


def _enclosing_function_map(tree: ast.AST) -> dict[int, ast.AST]:
    """node id -> nearest enclosing function (or the module)."""
    out: dict[int, ast.AST] = {}

    def visit(scope: ast.AST, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            child_scope = (
                child if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope
            )
            out[id(child)] = child_scope
            visit(child_scope, child)

    out[id(tree)] = tree
    visit(tree, tree)
    return out


def _module_joins_threads(tree: ast.AST) -> bool:
    """True when some ``X.join(...)`` call's receiver is plausibly a thread:
    its spelling mentions "thread", or it matches an assignment target of a
    ``Thread(...)`` construction in this module. A bare ``attr == "join"``
    scan would be satisfied by any ``", ".join(parts)`` string join, turning
    the ownership rule into a no-op in every real module."""
    thread_targets: set = set()
    for n in ast.walk(tree):
        if (
            isinstance(n, ast.Assign)
            and isinstance(n.value, ast.Call)
            and _terminal_name(n.value.func) == "Thread"
        ):
            thread_targets.update(_unparse(t) for t in n.targets)
    for n in ast.walk(tree):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "join"
        ):
            recv = _unparse(n.func.value)
            if recv in thread_targets or "thread" in recv.lower():
                return True
    return False


@rule("concurrency",
      "scoped locks, owned threads, no os._exit outside chaos/, no swallowed exceptions")
def check_concurrency(ctx: FileContext) -> Iterator[Finding]:
    enclosing = _enclosing_function_map(ctx.tree)
    module_has_join = _module_joins_threads(ctx.tree)
    in_chaos = "/chaos/" in f"/{ctx.relpath}"
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "acquire":
                recv = _unparse(node.func.value)
                scope = enclosing.get(id(node), ctx.tree)
                released = any(
                    isinstance(n, ast.Try)
                    and any(
                        isinstance(s, ast.Expr)
                        and isinstance(s.value, ast.Call)
                        and isinstance(s.value.func, ast.Attribute)
                        and s.value.func.attr == "release"
                        and _unparse(s.value.func.value) == recv
                        for fs in n.finalbody
                        for s in ast.walk(fs)
                        if isinstance(s, ast.Expr)
                    )
                    for n in ast.walk(scope)
                )
                if not released:
                    yield ctx.finding(
                        "concurrency/bare-acquire", node,
                        f"`{recv}.acquire()` without `with` or a try/finally "
                        "release in the same function — an exception leaks "
                        "the lock and deadlocks the plane",
                    )
            elif attr == "_exit" and _terminal_name(node.func.value) == "os" and not in_chaos:
                yield ctx.finding(
                    "concurrency/os-exit", node,
                    "`os._exit` outside photon_tpu_torch/chaos/ — SIGKILL-equivalent "
                    "exits belong to the fault injector only",
                )
        if isinstance(node, ast.Call) and _terminal_name(node.func) == "Thread":
            kwargs = {kw.arg for kw in node.keywords}
            if "target" not in kwargs and not node.args:
                continue  # not a thread construction (e.g. subclass call)
            if "name" not in kwargs:
                yield ctx.finding(
                    "concurrency/unnamed-thread", node,
                    "thread constructed without name= — unnamed threads make "
                    "stack dumps and the lock-order recorder unreadable",
                )
            if "daemon" not in kwargs and not module_has_join:
                yield ctx.finding(
                    "concurrency/unowned-thread", node,
                    "thread has neither daemon= nor any joining owner in this "
                    "module — it will outlive shutdown silently",
                )
        if isinstance(node, ast.ExceptHandler):
            broad = node.type is None or (
                isinstance(node.type, ast.Name) and node.type.id in ("Exception", "BaseException")
            ) or (
                isinstance(node.type, ast.Tuple)
                and any(
                    isinstance(e, ast.Name) and e.id in ("Exception", "BaseException")
                    for e in node.type.elts
                )
            )
            body_is_pass = len(node.body) == 1 and isinstance(node.body[0], ast.Pass)
            if node.type is None:
                yield ctx.finding(
                    "concurrency/swallowed-exception", node,
                    "bare `except:` — catches SystemExit/KeyboardInterrupt and "
                    "hides scheduler/round-loop failures",
                )
            elif broad and body_is_pass:
                yield ctx.finding(
                    "concurrency/swallowed-exception", node,
                    "broad exception swallowed with `pass` — a dead round "
                    "loop/scheduler thread must fail loudly",
                )


# ---------------------------------------------------------------------------
# 5. transport-discipline
# ---------------------------------------------------------------------------

#: the CRC32-framed transport (``SocketConn``) — the only place raw pickle
#: deserialization and raw socket reads are allowed to live
_TRANSPORT_ALLOWED = ("photon_tpu_torch/federation/tcp.py",)


@rule("transport-discipline", "raw pickle/socket reads only inside the CRC32-framed SocketConn path")
def check_transport_discipline(ctx: FileContext) -> Iterator[Finding]:
    if ctx.relpath.endswith(_TRANSPORT_ALLOWED):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        attr = node.func.attr
        if attr in ("loads", "load") and _terminal_name(node.func.value) == "pickle":
            yield ctx.finding(
                "transport-discipline/raw-pickle", node,
                "raw pickle deserialization outside the CRC32-framed "
                "SocketConn path — unchecked bytes become arbitrary objects",
            )
        elif attr in ("recv", "recv_into", "recvfrom"):
            recv_name = _terminal_name(node.func.value)
            if "sock" in recv_name.lower():
                yield ctx.finding(
                    "transport-discipline/raw-socket-read", node,
                    "raw socket read outside SocketConn — all wire reads go "
                    "through the CRC32-framed path",
                )
