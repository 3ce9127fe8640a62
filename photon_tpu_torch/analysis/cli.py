"""photon-lint CLI: ``python -m photon_tpu_torch.analysis [paths...]``.

Exit codes: 0 = no unsuppressed findings, 1 = findings, 2 = usage error.
With no paths it scans ``photon_tpu_torch/`` against ``baseline.json``
beside this file. ``chip_smoke.py`` runs it as its preflight, so a rule
regression fails the smoke before a kernel is built.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

DEFAULT_BASELINE = pathlib.Path(__file__).resolve().parent / "baseline.json"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m photon_tpu_torch.analysis",
        description="photon-lint: AST rules for photon-tpu's invariants",
    )
    ap.add_argument(
        "paths", nargs="*",
        help="files/directories to scan (default: the photon_tpu_torch package)",
    )
    ap.add_argument(
        "--baseline", default=str(DEFAULT_BASELINE),
        help="baseline JSON of deliberate findings (default: %(default)s)",
    )
    ap.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline file (report everything)",
    )
    ap.add_argument(
        "--write-baseline", action="store_true",
        help="snapshot current unsuppressed findings into the baseline file "
             "(then fill in the justifications)",
    )
    ap.add_argument(
        "--select", default=None,
        help="comma-separated rule families to run (default: all)",
    )
    ap.add_argument("--list-rules", action="store_true", help="print the rule catalogue")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    args = ap.parse_args(argv)

    from photon_tpu_torch.analysis import rules as _rules  # noqa: F401 — registers
    from photon_tpu_torch.analysis.core import RULES, analyze_paths, write_baseline

    if args.list_rules:
        for family, (desc, _fn) in sorted(RULES.items()):
            print(f"{family:22s} {desc}")
        return 0

    paths = args.paths or [str(pathlib.Path(__file__).resolve().parent.parent)]
    missing = [p for p in paths if not pathlib.Path(p).exists()]
    if missing:
        print(f"no such path(s): {missing}", file=sys.stderr)
        return 2
    select = args.select.split(",") if args.select else None
    if select:
        unknown = set(select) - set(RULES)
        if unknown:
            print(f"unknown rule families: {sorted(unknown)}", file=sys.stderr)
            return 2
    baseline = None if args.no_baseline else pathlib.Path(args.baseline)
    report = analyze_paths(paths, baseline=baseline, select=select)
    if report.n_files == 0:
        # "OK — 0 files" is how a mistyped CI path passes green forever
        print(f"no python files found under {paths}", file=sys.stderr)
        return 2

    if args.write_baseline:
        # snapshot from the UN-baselined view: already-baselined findings
        # must re-land in the file (their justifications are preserved by
        # fingerprint), not silently vanish from it. scanned_paths keeps a
        # partial scan from deleting entries for files it never visited.
        to_write = [f for f in report.findings if not f.suppressed]
        write_baseline(
            pathlib.Path(args.baseline), to_write,
            scanned_paths=report.scanned_paths,
            selected_families=frozenset(select) if select else None,
        )
        print(
            f"baseline written: {len(to_write)} finding(s) -> "
            f"{args.baseline} (fill in the justifications)"
        )
        return 0

    if args.json:
        print(
            json.dumps(
                {
                    "files": report.n_files,
                    "findings": [
                        {
                            "rule": f.rule,
                            "path": f.path,
                            "line": f.line,
                            "col": f.col,
                            "message": f.message,
                            "fingerprint": f.fingerprint(),
                        }
                        for f in report.unsuppressed
                    ],
                    "stale_baseline": [e.to_dict() for e in report.stale_baseline],
                },
                indent=2,
            )
        )
    else:
        for f in report.unsuppressed:
            print(f.format())
        for e in report.stale_baseline:
            print(
                f"stale baseline entry: [{e.rule}] {e.path} ({e.fingerprint}) — "
                "the code it justified has changed; remove or re-justify "
                "(stale entries FAIL the run)",
                file=sys.stderr,
            )
        n_base = sum(1 for f in report.findings if f.baselined)
        n_supp = sum(1 for f in report.findings if f.suppressed)
        verdict = "OK" if report.ok else "FAIL"
        print(
            f"photon-lint: {verdict} — {report.n_files} files, "
            f"{len(report.unsuppressed)} finding(s), {n_base} baselined, "
            f"{n_supp} suppressed, {len(report.stale_baseline)} stale "
            "baseline entr(y/ies)"
        )
    return 0 if report.ok else 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
