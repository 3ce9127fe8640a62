"""photon-lint's static half on the port (``photon_tpu_torch/analysis/``):
a counterpart of each static case of ``tests/test_analysis.py``, aimed at
the port.

Contract per rule family: (a) a seeded-violation fixture MUST be flagged,
(b) the idiomatic spelling of the same code MUST pass, and (c) the port's
tree MUST be clean (zero unsuppressed findings against its checked-in
baseline, no stale entry). The registry is the port's
``utils/profiling.py``, the hook sites the port's ``telemetry.active()``
and ``chaos.active()``, the transport allow-list the port's
``federation/tcp.py``, and ``retrace-hazard`` looks inside functions that
``torch.compile`` or ``torch.jit.script`` wraps (no port function is, so
its fixtures hold it). The engine imports nothing of the JAX package.
"""

import json
import pathlib
import textwrap

import pytest

import photon_tpu_torch
from photon_tpu_torch.analysis.cli import DEFAULT_BASELINE, main as lint_main
from photon_tpu_torch.analysis.core import (
    NameRegistry,
    analyze_paths,
    load_baseline,
    write_baseline,
)

pytestmark = pytest.mark.lint

PKG = pathlib.Path(photon_tpu_torch.__file__).resolve().parent


def _lint(tmp_path, src, select=None, name="snippet.py"):
    f = tmp_path / name
    f.write_text(textwrap.dedent(src))
    return analyze_paths([str(f)], baseline=None, select=select).unsuppressed


def _rules(findings):
    return {f.rule for f in findings}


# ---------------------------------------------------------------------------
# rule family 1: kpi-registry
# ---------------------------------------------------------------------------


def test_kpi_registry_flags_literals(tmp_path):
    found = _lint(
        tmp_path,
        """
        from photon_tpu_torch import telemetry

        def record_sites(history, tracer):
            history.record(1, {"server/round_time": 1.0})       # stringly
            history.record(1, {"server/definitely_a_typo": 1})  # unknown
            tracer.add_span("client/fit_time", 0.0, 1.0)        # stringly
            telemetry.emit_event(f"chaos/{1}")                  # f-string
        """,
        select=["kpi-registry"],
    )
    assert _rules(found) == {
        "kpi-registry/stringly-name",
        "kpi-registry/unregistered-name",
        "kpi-registry/fstring-name",
    }
    assert len(found) == 4


def test_kpi_registry_constants_pass(tmp_path):
    found = _lint(
        tmp_path,
        """
        from photon_tpu_torch import telemetry
        from photon_tpu_torch.utils.profiling import CHAOS_EVENT_PREFIX, ROUND_TIME

        def record_sites(history, tracer, kind, metrics):
            history.record(1, {ROUND_TIME: 1.0})
            history.record(1, metrics)             # dynamic dict: not static
            tracer.add_span(ROUND_TIME, 0.0, 1.0)
            telemetry.emit_event(CHAOS_EVENT_PREFIX + kind)
        """,
        select=["kpi-registry"],
    )
    assert found == []


def test_registry_parse_matches_runtime_registry():
    """The statically parsed constants agree with the port's live module
    — the lint and the runtime registry can never drift apart."""
    from photon_tpu_torch.utils import profiling

    reg = NameRegistry.parse(PKG / "utils" / "profiling.py")
    assert set(profiling.registered_metric_names()) <= set(reg.values)
    assert reg.dynamic_patterns == profiling.DYNAMIC_METRIC_PATTERNS
    assert reg.is_registered("server/round_time")
    assert reg.is_registered("server/anything_norm")  # dynamic family
    assert not reg.is_registered("server/not_a_metric")


# ---------------------------------------------------------------------------
# rule family 1b: metric-discipline
# ---------------------------------------------------------------------------


def test_metric_discipline_flags_literals(tmp_path):
    found = _lint(
        tmp_path,
        """
        from photon_tpu_torch import telemetry

        def sites(hub, health):
            hub.counter("serve/ttft_s")                    # stringly
            hub.histogram("serve/definitely_a_typo")       # unknown
            telemetry.metric_observe(f"serve/{1}_s", 0.1)  # f-string
            health.alert("alert/nonfinite", plane="federation")  # stringly
        """,
        select=["metric-discipline"],
    )
    assert _rules(found) == {
        "metric-discipline/stringly-name",
        "metric-discipline/unregistered-name",
        "metric-discipline/fstring-name",
    }
    assert len(found) == 4


def test_metric_discipline_constants_pass(tmp_path):
    found = _lint(
        tmp_path,
        """
        from photon_tpu_torch import telemetry
        from photon_tpu_torch.utils.profiling import (
            ALERT_NONFINITE, SERVE_TTFT_S, SPANS_DROPPED,
        )

        def sites(hub, health, name):
            hub.counter(SPANS_DROPPED).inc()
            hub.histogram(SERVE_TTFT_S).observe(0.1)
            hub.gauge(name)                      # dynamic name: not static
            telemetry.metric_observe(SERVE_TTFT_S, 0.1)
            telemetry.metric_inc(SPANS_DROPPED)
            health.alert(ALERT_NONFINITE, plane="federation")
        """,
        select=["metric-discipline"],
    )
    assert found == []


# ---------------------------------------------------------------------------
# rule family 2: hook-gating
# ---------------------------------------------------------------------------


def test_hook_gating_flags_unguarded_and_chained(tmp_path):
    found = _lint(
        tmp_path,
        """
        from photon_tpu_torch import chaos, telemetry

        def unguarded():
            tr = telemetry.active()
            tr.drain()

        def chained():
            return chaos.active().tcp_plan()

        def guard_too_late():
            tr2 = telemetry.active()
            tr2.drain()  # crashes when disabled: the guard below can't help
            if tr2 is not None:
                tr2.flush()

        def guard_falls_through():
            tr3 = telemetry.active()
            if tr3 is None:
                print("disabled")  # no return: tr3 is STILL None below
            tr3.drain()

        def or_is_not_a_guard(fallback):
            tr4 = telemetry.active()
            x = tr4 or fallback
            tr4.drain()
        """,
        select=["hook-gating"],
    )
    assert _rules(found) == {"hook-gating/unguarded", "hook-gating/chained-active"}
    assert sum(f.rule == "hook-gating/unguarded" for f in found) == 4


def test_hook_gating_guarded_passes(tmp_path):
    found = _lint(
        tmp_path,
        """
        from photon_tpu_torch import telemetry

        def early_return():
            tr = telemetry.active()
            if tr is None:
                return
            tr.drain()

        def closure_guard():
            tracer = telemetry.active()
            def worker():
                if tracer is not None:
                    tracer.drain()
            return worker

        def truthiness():
            log = telemetry.events_active()
            if log:
                log.drain()

        def compound_or_early_return():
            tr = telemetry.active()
            if tr is None or not tr.piggyback:
                return
            tr.drain()

        def and_shortcircuit():
            tr = telemetry.active()
            return tr and tr.drain()
        """,
        select=["hook-gating"],
    )
    assert found == []


# ---------------------------------------------------------------------------
# rule family 3: retrace-hazard
# ---------------------------------------------------------------------------


def test_retrace_hazard_flags_syncs_branches_mutation(tmp_path):
    found = _lint(
        tmp_path,
        """
        import numpy as np
        import torch

        @torch.compile
        def step(x, y):
            if x > 0:                      # traced branch
                y = float(x)               # scalar cast
            z = np.asarray(y)              # numpy materialization
            return z.item()                # host sync

        class Engine:
            @torch.compile(dynamic=False)
            def step(self, tokens):
                self.cache = tokens        # self mutation under trace
                return tokens
        """,
        select=["retrace-hazard"],
    )
    assert _rules(found) == {
        "retrace-hazard/traced-branch",
        "retrace-hazard/host-sync",
        "retrace-hazard/self-mutation",
    }
    assert sum(f.rule.endswith("host-sync") for f in found) == 3


def test_retrace_hazard_static_and_shape_uses_pass(tmp_path):
    found = _lint(
        tmp_path,
        """
        import re
        from functools import partial

        import torch

        @partial(torch.compile, fullgraph=True)
        def bucketed(x):
            if x.shape[0] > 4:              # shape read: static under trace
                x = x * 2
            if x.dtype == torch.bfloat16:   # dtype read: static
                x = x.float()
            if x is None:                   # None check: static
                return torch.zeros(())
            return int(x.shape[0]) + x.sum()

        def wrapped(state, batch):
            return torch.where(batch > 0, state, batch).sum()

        step = torch.compile(wrapped, mode="reduce-overhead")

        def pattern(x):                     # re.compile is no compiler
            return float(x)

        matcher = re.compile(pattern)
        """,
        select=["retrace-hazard"],
    )
    assert found == []


def test_retrace_hazard_sees_jit_wrapping_call(tmp_path):
    found = _lint(
        tmp_path,
        """
        import torch

        def step_fn(state, tok):
            return state, float(tok)

        _step = torch.compile(step_fn)

        @torch.jit.script
        def scripted(x):
            return x.item()
        """,
        select=["retrace-hazard"],
    )
    assert _rules(found) == {"retrace-hazard/host-sync"}


# ---------------------------------------------------------------------------
# rule family 4: concurrency
# ---------------------------------------------------------------------------


def test_concurrency_fixture(tmp_path):
    found = _lint(
        tmp_path,
        """
        import os
        import threading

        def bare(lock):
            lock.acquire()
            lock.release()

        def fire_and_forget():
            threading.Thread(target=print).start()

        def swallow():
            try:
                pass
            except:
                pass
            try:
                pass
            except Exception:
                pass
            os._exit(3)
        """,
        select=["concurrency"],
    )
    assert _rules(found) == {
        "concurrency/bare-acquire",
        "concurrency/unnamed-thread",
        "concurrency/unowned-thread",
        "concurrency/swallowed-exception",
        "concurrency/os-exit",
    }


def test_concurrency_idiomatic_passes(tmp_path):
    found = _lint(
        tmp_path,
        """
        import threading

        def scoped(lock):
            with lock:
                pass

        def try_finally(lock):
            lock.acquire(timeout=1)
            try:
                pass
            finally:
                lock.release()

        class Owner:
            def start(self):
                self._thread = threading.Thread(
                    target=print, name="owned", daemon=True
                )
                self._thread.start()

            def close(self):
                self._thread.join(timeout=5)

        def narrow():
            try:
                pass
            except OSError:
                pass  # typed-narrow swallow is allowed
        """,
        select=["concurrency"],
    )
    assert found == []


# ---------------------------------------------------------------------------
# rule family 5: transport-discipline
# ---------------------------------------------------------------------------


def test_transport_discipline_fixture(tmp_path):
    found = _lint(
        tmp_path,
        """
        import pickle

        def raw_wire(sock):
            data = sock.recv(4096)
            return pickle.loads(data)
        """,
        select=["transport-discipline"],
    )
    assert _rules(found) == {
        "transport-discipline/raw-pickle",
        "transport-discipline/raw-socket-read",
    }


def test_transport_discipline_framed_conn_passes(tmp_path):
    found = _lint(
        tmp_path,
        """
        def framed(conn):
            return conn.recv()  # SocketConn/Connection: the framed path
        """,
        select=["transport-discipline"],
    )
    assert found == []


# ---------------------------------------------------------------------------
# suppression + baseline + CLI
# ---------------------------------------------------------------------------


def test_inline_suppression_same_and_next_line(tmp_path):
    found = _lint(
        tmp_path,
        """
        import os

        def a():
            os._exit(1)  # photon-lint: ignore[concurrency/os-exit]

        def b():
            # photon-lint: ignore[concurrency]
            os._exit(2)

        def c():
            os._exit(3)  # no suppression: still flagged
        """,
        select=["concurrency"],
    )
    assert len(found) == 1 and found[0].rule == "concurrency/os-exit"
    assert found[0].snippet.startswith("os._exit(3)")


def test_baseline_roundtrip_and_staleness(tmp_path):
    bad = tmp_path / "mod.py"
    bad.write_text("import os\nos._exit(1)\n")
    base = tmp_path / "baseline.json"
    rep = analyze_paths([str(bad)], baseline=None)
    assert len(rep.unsuppressed) == 1
    write_baseline(base, rep.unsuppressed)
    entries = load_baseline(base)
    assert len(entries) == 1 and entries[0].rule == "concurrency/os-exit"

    rep2 = analyze_paths([str(bad)], baseline=base)
    assert rep2.ok and not rep2.stale_baseline
    assert sum(1 for f in rep2.findings if f.baselined) == 1

    # the offending line changes -> the entry is STALE and the (new)
    # finding is unsuppressed again: baselines can't mask fresh violations
    bad.write_text("import os\nos._exit(2)\n")
    rep3 = analyze_paths([str(bad)], baseline=base)
    assert not rep3.ok
    assert [e.fingerprint for e in rep3.stale_baseline] == [entries[0].fingerprint]


def test_partial_scan_keeps_unscanned_baseline_entries(tmp_path):
    """Scanning a subset of the tree must neither report unscanned files'
    baseline entries as stale nor delete them on --write-baseline."""
    a = tmp_path / "a.py"
    a.write_text("import os\nos._exit(1)\n")
    b = tmp_path / "b.py"
    b.write_text("import os\nos._exit(2)\n")
    base = tmp_path / "baseline.json"
    rep_all = analyze_paths([str(a), str(b)], baseline=None)
    write_baseline(base, rep_all.unsuppressed, scanned_paths=rep_all.scanned_paths)
    n_all = len(load_baseline(base))
    assert n_all == 2

    # partial scan: b.py's entry is invisible, NOT stale
    rep_a = analyze_paths([str(a)], baseline=base)
    assert rep_a.ok and not rep_a.stale_baseline

    # partial --write-baseline path: b.py's entry survives the rewrite
    write_baseline(
        base,
        [f for f in rep_a.findings if not f.suppressed],
        scanned_paths=rep_a.scanned_paths,
    )
    assert len(load_baseline(base)) == n_all

    # a genuinely stale entry in a SCANNED file still fails
    a.write_text("x = 1\n")
    rep_fixed = analyze_paths([str(a)], baseline=base)
    assert not rep_fixed.ok and len(rep_fixed.stale_baseline) == 1


def test_string_join_is_not_thread_ownership(tmp_path):
    """A `", ".join(parts)` must not satisfy the unowned-thread rule; a
    join on a Thread-assigned name or *thread*-named attribute must."""
    found = _lint(
        tmp_path,
        """
        import threading

        def fire_and_forget(parts):
            threading.Thread(target=print, name="t").start()
            return ", ".join(parts)
        """,
        select=["concurrency"],
    )
    assert _rules(found) == {"concurrency/unowned-thread"}

    found = _lint(
        tmp_path,
        """
        import threading

        def owned():
            t = threading.Thread(target=print, name="t")
            t.start()
            t.join()
        """,
        select=["concurrency"],
    )
    assert found == []


def test_partially_fixed_count_entry_goes_stale(tmp_path):
    """Fixing ONE of two identical baselined lines must surface the entry
    as stale — leftover count budget would otherwise silently baseline the
    NEXT identical violation with no human re-justifying it."""
    mod = tmp_path / "mod.py"
    mod.write_text("import os\nos._exit(1)\nos._exit(1)\n")
    base = tmp_path / "baseline.json"
    rep = analyze_paths([str(mod)], baseline=None)
    write_baseline(base, rep.unsuppressed)
    assert load_baseline(base)[0].count == 2
    assert analyze_paths([str(mod)], baseline=base).ok

    mod.write_text("import os\nos._exit(1)\n")  # one of the two fixed
    rep2 = analyze_paths([str(mod)], baseline=base)
    assert not rep2.ok and len(rep2.stale_baseline) == 1


def test_suppression_syntax_in_string_is_inert(tmp_path):
    """Docs QUOTING the ignore syntax inside a string literal must not
    suppress anything — only real comment tokens register suppressions.
    Both stringly spellings that fooled the line-regex scanner: a string
    ending on the comment-shaped line (next-line form) and a string on the
    violating line itself (same-line form)."""
    found = _lint(
        tmp_path,
        '''
        import os

        DOC = """
        # photon-lint: ignore[concurrency]"""
        os._exit(1)

        s = "# photon-lint: ignore[concurrency]"; os._exit(2)
        ''',
        select=["concurrency"],
    )
    assert _rules(found) == {"concurrency/os-exit"} and len(found) == 2


def test_select_scan_keeps_unselected_baseline_entries(tmp_path):
    """A --select run can only judge entries of the selected families: it
    must neither report other families' entries as stale nor delete them
    on --write-baseline."""
    mod = tmp_path / "mod.py"
    mod.write_text(
        "import os, pickle\n"
        "def f(data):\n"
        "    os._exit(1)\n"
        "    return pickle.loads(data)\n"
    )
    base = tmp_path / "baseline.json"
    rep = analyze_paths([str(mod)], baseline=None)
    write_baseline(base, rep.unsuppressed)
    assert {e.rule.split("/", 1)[0] for e in load_baseline(base)} == {
        "concurrency", "transport-discipline",
    }

    rep_sel = analyze_paths([str(mod)], baseline=base, select=["concurrency"])
    assert rep_sel.ok and not rep_sel.stale_baseline

    write_baseline(
        base,
        [f for f in rep_sel.findings if not f.suppressed],
        scanned_paths=rep_sel.scanned_paths,
        selected_families=frozenset(["concurrency"]),
    )
    assert {e.rule.split("/", 1)[0] for e in load_baseline(base)} == {
        "concurrency", "transport-discipline",
    }


def test_overlapping_paths_scan_each_file_once(tmp_path):
    """dir + file-inside-dir must not double-scan: duplicate findings blow
    the baseline's per-fingerprint count budget (FAIL on a clean tree) and
    inflate counts on --write-baseline."""
    mod = tmp_path / "mod.py"
    mod.write_text("import os\nos._exit(1)\n")
    base = tmp_path / "baseline.json"
    rep = analyze_paths([str(mod)], baseline=None)
    write_baseline(base, rep.unsuppressed)

    rep2 = analyze_paths([str(tmp_path), str(mod)], baseline=base)
    assert rep2.n_files == 1
    assert rep2.ok, [f.format() for f in rep2.unsuppressed]
    assert load_baseline(base)[0].count == 1


def test_cli_missing_or_empty_paths_are_usage_errors(tmp_path):
    assert lint_main([str(tmp_path / "no_such_dir")]) == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert lint_main([str(empty), "--no-baseline"]) == 2


def test_checked_in_baseline_is_justified():
    entries = load_baseline(DEFAULT_BASELINE)
    assert entries, "baseline file missing"
    for e in entries:
        assert e.justification and "TODO" not in e.justification, e.path


def test_cli_exit_codes(tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nos._exit(1)\n")
    good = tmp_path / "good.py"
    good.write_text("x = 1\n")
    assert lint_main([str(bad), "--no-baseline"]) == 1
    assert lint_main([str(good), "--no-baseline"]) == 0
    assert lint_main(["--list-rules"]) == 0
    assert lint_main([str(bad), "--no-baseline", "--json"]) == 1
    out = capsys.readouterr().out
    payload = json.loads(out[out.index("{"):])
    assert payload["findings"][0]["rule"] == "concurrency/os-exit"


def test_current_tree_is_clean():
    """THE acceptance gate: zero unsuppressed findings on photon_tpu_torch/
    against the checked-in baseline, and no stale baseline entries."""
    rep = analyze_paths([str(PKG)], baseline=DEFAULT_BASELINE)
    assert rep.unsuppressed == [], "\n".join(f.format() for f in rep.unsuppressed)
    assert rep.stale_baseline == [], [e.path for e in rep.stale_baseline]
    assert rep.n_files > 100  # the walk actually covered the tree


def test_engine_imports_no_jax_package():
    """``photon_tpu_torch/analysis/`` imports nothing of ``photon_tpu``
    or JAX, and the lazy package entry points resolve to the port's."""
    import ast

    import photon_tpu_torch.analysis as pkg

    for path in (PKG / "analysis").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("photon_tpu", "jax", "flax"), (path, n)
    assert pkg.analyze_paths([str(PKG / "analysis" / "core.py")], baseline=None).n_files == 1
    assert pkg.main(["--list-rules"]) == 0
