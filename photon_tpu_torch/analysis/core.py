"""The photon-lint engine: findings, rule registry, suppression, baseline
(the port of ``photon_tpu/analysis/core.py``).

Deliberately stdlib-only and import-free with respect to the code it scans:
everything is derived from source text + ``ast``, including the KPI-name
registry (parsed out of ``photon_tpu_torch/utils/profiling.py``
statically), so the linter runs in a second without importing torch, and a
typo'd metric name is caught without executing a single record site.

Vocabulary:

- a **rule family** is one registered checker (``kpi-registry``,
  ``concurrency``, ...); each finding carries a full rule id of the form
  ``family/check`` (``concurrency/bare-acquire``) so suppressions can be
  scoped to either the family or the exact check;
- a ``# photon-lint: ignore[rule]`` comment suppresses findings of that
  rule (family or full id, comma-separated list allowed) on its own line —
  or, when the line holds nothing else, on the following line;
- the **baseline** is a checked-in JSON file of fingerprinted findings that
  are deliberate and justified (one line each); baselined findings don't
  fail the run, *stale* baseline entries (fixed code, lingering entry) are
  reported so the file can't rot.

Fingerprints hash ``rule | relpath | normalized source line`` — stable
under line-number drift, invalidated the moment the offending line itself
changes, which is exactly when a human should re-justify it.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import hashlib
import json
import pathlib
import re
import tokenize
from typing import Callable, Iterable, Iterator

# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Finding:
    rule: str  # full id: "family/check"
    path: str  # repo-relative posix path when under the repo, else as given
    line: int
    col: int
    message: str
    snippet: str = ""  # stripped source line (fingerprint input)
    suppressed: bool = False  # hit a photon-lint: ignore comment
    baselined: bool = False  # matched a baseline entry

    @property
    def family(self) -> str:
        return self.rule.split("/", 1)[0]

    def fingerprint(self) -> str:
        raw = f"{self.rule}|{self.path}|{self.snippet}".encode()
        return hashlib.sha1(raw).hexdigest()[:16]

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}] {self.message}"


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------

#: family -> (description, checker). Checkers take a FileContext and yield
#: Findings; registration happens at import of photon_tpu_torch.analysis.rules.
RULES: dict[str, tuple[str, Callable[["FileContext"], Iterable[Finding]]]] = {}


def rule(family: str, description: str):
    """Decorator registering a rule-family checker."""

    def deco(fn):
        if family in RULES:
            raise ValueError(f"duplicate rule family {family!r}")
        RULES[family] = (description, fn)
        return fn

    return deco


# ---------------------------------------------------------------------------
# static KPI/event-name registry (parsed, never imported)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class NameRegistry:
    """The string constants ``utils/profiling.py`` exports, statically.

    ``constants`` maps CONST_NAME -> value for every module-level
    ``NAME = "literal"`` assignment; ``dynamic_patterns`` mirrors
    ``DYNAMIC_METRIC_PATTERNS``. ``values`` is the reverse lookup used to
    tell "stringly spelling of a registered name" (use the constant) apart
    from "name the registry has never heard of" (typo / dead metric).
    """

    constants: dict[str, str] = dataclasses.field(default_factory=dict)
    dynamic_patterns: tuple[str, ...] = ()

    @functools.cached_property
    def values(self) -> dict[str, str]:
        # hit 1-2x per name site across the scan — cache the reverse map
        return {v: k for k, v in self.constants.items()}

    def is_registered(self, name: str) -> bool:
        if name in self.values:
            return True
        return any(re.fullmatch(p, name) for p in self.dynamic_patterns)

    @classmethod
    def parse(cls, profiling_path: pathlib.Path) -> "NameRegistry":
        try:
            tree = ast.parse(profiling_path.read_text())
        except (OSError, SyntaxError):
            return cls()
        consts: dict[str, str] = {}
        patterns: tuple[str, ...] = ()
        for node in tree.body:
            # plain and annotated assignments both declare constants
            # (DYNAMIC_METRIC_PATTERNS carries a type annotation)
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt, value = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                tgt, value = node.target, node.value
            else:
                continue
            if not isinstance(tgt, ast.Name):
                continue
            if tgt.id == "DYNAMIC_METRIC_PATTERNS":
                if isinstance(value, ast.Tuple):
                    patterns = tuple(
                        el.value
                        for el in value.elts
                        if isinstance(el, ast.Constant) and isinstance(el.value, str)
                    )
                continue
            if (
                tgt.id.isupper()
                and isinstance(value, ast.Constant)
                and isinstance(value.value, str)
            ):
                consts[tgt.id] = value.value
        return cls(constants=consts, dynamic_patterns=patterns)


def _default_profiling_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent / "utils" / "profiling.py"


# ---------------------------------------------------------------------------
# per-file context handed to rule checkers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FileContext:
    path: pathlib.Path  # absolute
    relpath: str  # repo-relative posix (fingerprint + path-scoped rules)
    tree: ast.AST
    lines: list[str]
    registry: NameRegistry

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule_id: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            rule=rule_id,
            path=self.relpath,
            line=line,
            col=col,
            message=message,
            snippet=self.line_text(line),
        )


# ---------------------------------------------------------------------------
# suppression comments
# ---------------------------------------------------------------------------

_IGNORE_RE = re.compile(r"#\s*photon-lint:\s*ignore\[([^\]]+)\]")


def suppressions(lines: list[str]) -> dict[int, frozenset]:
    """Map line number -> rule ids suppressed there.

    A trailing comment covers its own line; a comment-only line covers the
    NEXT line too (for statements that don't fit an inline comment).
    ``ignore[*]`` suppresses every rule on the line.

    Only real COMMENT tokens count: a docstring *quoting* the syntax (this
    module's own does) must not register a suppression, so the source is
    tokenized rather than regex-scanned line by line.
    """
    out: dict[int, set] = {}
    it = iter(line + "\n" for line in lines)
    try:
        tokens = list(tokenize.generate_tokens(lambda: next(it, "")))
    except Exception:  # pragma: no cover — caller already ast.parse'd the file
        tokens = []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _IGNORE_RE.search(tok.string)
        if not m:
            continue
        i = tok.start[0]
        ids = {t.strip() for t in m.group(1).split(",") if t.strip()}
        out.setdefault(i, set()).update(ids)
        # comment-only line: nothing but whitespace before the comment
        if 1 <= i <= len(lines) and not lines[i - 1][: tok.start[1]].strip():
            out.setdefault(i + 1, set()).update(ids)
    return {k: frozenset(v) for k, v in out.items()}


def _is_suppressed(f: Finding, supp: dict[int, frozenset]) -> bool:
    ids = supp.get(f.line)
    if not ids:
        return False
    return "*" in ids or f.rule in ids or f.family in ids


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BaselineEntry:
    rule: str
    path: str
    fingerprint: str
    justification: str
    count: int = 1  # identical lines share a fingerprint; cover up to N

    def to_dict(self) -> dict:
        d = {
            "rule": self.rule,
            "path": self.path,
            "fingerprint": self.fingerprint,
            "justification": self.justification,
        }
        if self.count != 1:
            d["count"] = self.count
        return d


def load_baseline(path: pathlib.Path) -> list[BaselineEntry]:
    try:
        raw = json.loads(path.read_text())
    except FileNotFoundError:
        return []
    entries = []
    for d in raw.get("findings", []):
        entries.append(
            BaselineEntry(
                rule=d["rule"],
                path=d["path"],
                fingerprint=d["fingerprint"],
                justification=d.get("justification", ""),
                count=int(d.get("count", 1)),
            )
        )
    return entries


def write_baseline(
    path: pathlib.Path,
    findings: list[Finding],
    scanned_paths: frozenset | None = None,
    selected_families: frozenset | None = None,
) -> None:
    """Snapshot every finding as a baseline entry needing a justification
    (the human fills those in before committing). Justifications already
    present in the file being overwritten are preserved by fingerprint —
    regenerating must never destroy a hand-written rationale. Existing
    entries the run could not have re-found are carried over untouched:
    files outside ``scanned_paths`` (partial scan) and rule families
    outside ``selected_families`` (``--select`` run) — a narrowed
    ``--write-baseline`` must not delete justified entries it never
    looked for."""
    old_entries = load_baseline(path)
    existing = {e.fingerprint: e.justification for e in old_entries}
    by_fp: dict[str, BaselineEntry] = {}
    for e in old_entries:
        unscanned = scanned_paths is not None and e.path not in scanned_paths
        unselected = (
            selected_families is not None
            and e.rule.split("/", 1)[0] not in selected_families
        )
        if unscanned or unselected:
            by_fp[e.fingerprint] = e
    for f in findings:
        fp = f.fingerprint()
        if fp in by_fp:
            by_fp[fp].count += 1
        else:
            by_fp[fp] = BaselineEntry(
                rule=f.rule,
                path=f.path,
                fingerprint=fp,
                justification=existing.get(fp, "TODO: justify or fix"),
            )
    doc = {
        "comment": (
            "photon-lint baseline: deliberate findings, one-line justification "
            "each. Regenerate with --write-baseline; entries go stale (and FAIL "
            "the run) the moment the offending line changes."
        ),
        "findings": [e.to_dict() for e in sorted(by_fp.values(), key=lambda e: (e.path, e.rule))],
    }
    path.write_text(json.dumps(doc, indent=2) + "\n")


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Report:
    findings: list[Finding]  # everything, flags set
    stale_baseline: list[BaselineEntry]
    n_files: int
    scanned_paths: frozenset = frozenset()  # relpaths actually analyzed

    @property
    def unsuppressed(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed and not f.baselined]

    @property
    def ok(self) -> bool:
        # stale entries fail the run too: a baseline whose justified line
        # is gone must be pruned, or the file rots into a dead allowlist
        return not self.unsuppressed and not self.stale_baseline


def _repo_root() -> pathlib.Path:
    # photon_tpu_torch/analysis/core.py -> the directory HOLDING the package
    return pathlib.Path(__file__).resolve().parent.parent.parent


def iter_py_files(paths: Iterable[str]) -> Iterator[pathlib.Path]:
    """Yield each .py file once, even when the input paths overlap — a
    double-scanned file would double its findings, blowing the baseline's
    per-fingerprint count budget (spurious FAIL on a clean tree) and
    inflating counts on --write-baseline."""
    seen: set = set()
    for p in paths:
        path = pathlib.Path(p)
        if path.is_dir():
            candidates: Iterable[pathlib.Path] = sorted(path.rglob("*.py"))
        elif path.suffix == ".py":
            candidates = [path]
        else:
            continue
        for c in candidates:
            r = c.resolve()
            if r not in seen:
                seen.add(r)
                yield c


def _relpath(path: pathlib.Path, root: pathlib.Path) -> str:
    try:
        return path.resolve().relative_to(root).as_posix()
    except ValueError:
        return path.as_posix()


def analyze_file(
    path: pathlib.Path,
    registry: NameRegistry,
    select: frozenset | None = None,
    root: pathlib.Path | None = None,
) -> list[Finding]:
    root = root or _repo_root()
    rel = _relpath(path, root)
    try:
        src = path.read_text()
    except (OSError, UnicodeDecodeError) as e:
        return [Finding("engine/unreadable", rel, 1, 0, f"cannot read: {e}")]
    lines = src.splitlines()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [
            Finding(
                "engine/parse-error", rel, e.lineno or 1, e.offset or 0,
                f"syntax error: {e.msg}", snippet="",
            )
        ]
    ctx = FileContext(path=path, relpath=rel, tree=tree, lines=lines, registry=registry)
    supp = suppressions(lines)
    out: list[Finding] = []
    for family, (_desc, checker) in RULES.items():
        if select is not None and family not in select:
            continue
        for f in checker(ctx):
            f.suppressed = _is_suppressed(f, supp)
            out.append(f)
    return out


def analyze_paths(
    paths: Iterable[str],
    baseline: pathlib.Path | None = None,
    select: Iterable[str] | None = None,
    registry_path: pathlib.Path | None = None,
) -> Report:
    """Run every registered rule over ``paths`` (files or directories).

    ``baseline=None`` skips baseline matching entirely (tests run fixtures
    raw); pass a path — existing or not — to apply one.
    """
    import photon_tpu_torch.analysis.rules  # noqa: F401 — registration side effect

    registry = NameRegistry.parse(registry_path or _default_profiling_path())
    sel = frozenset(select) if select is not None else None
    root = _repo_root()
    findings: list[Finding] = []
    n_files = 0
    scanned: set = set()
    for path in iter_py_files(paths):
        n_files += 1
        scanned.add(_relpath(path, root))
        findings.extend(analyze_file(path, registry, select=sel, root=root))

    stale: list[BaselineEntry] = []
    if baseline is not None:
        entries = load_baseline(baseline)
        budget = {e.fingerprint: e.count for e in entries}
        for f in findings:
            if f.suppressed:
                continue
            fp = f.fingerprint()
            if budget.get(fp, 0) > 0:
                budget[fp] -= 1
                f.baselined = True
        # an entry is stale when any of its count budget went unused — a
        # partially-fixed count>1 entry must resurface for re-justification,
        # or its leftover budget would silently baseline the NEXT identical
        # violation. Staleness is only decidable for entries this run could
        # have re-found: the file must have been scanned AND the entry's
        # rule family selected — a partial scan or --select run must not
        # report entries it never looked for as stale.
        stale = [
            e for e in entries
            if e.path in scanned
            and (sel is None or e.rule.split("/", 1)[0] in sel)
            and budget.get(e.fingerprint, 0) > 0
        ]
    return Report(
        findings=findings, stale_baseline=stale, n_files=n_files,
        scanned_paths=frozenset(scanned),
    )
