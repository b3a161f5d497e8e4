"""CLI: ``python -m repro_torch.analysis [paths...] [--check] [--device D]
[--write-baseline]``.

Modes
-----
default           AST lint (layer 1) over src/repro_torch (or explicit
                  paths), suppressions applied from the baseline file.
--check           lint + the dispatch-level checks (layer 2) — the CI gate.
                  They run on ``--device`` (default ``cuda``); without a
                  card and without ``--device cpu`` the call exits 2 (no
                  fallback to the CPU).
--write-baseline  lint, then (re)write the baseline from what it found;
                  edit the generated ``reason`` fields before committing.
--rules           print the rule table and exit.

Exit codes: 0 clean, 1 findings, 2 bad invocation / internal error.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.lint import lint_paths
from repro_torch.analysis.rules import ALL_RULES


def _print_rules() -> None:
    width = max(len(r.NAME) for r in ALL_RULES)
    for r in ALL_RULES:
        print(f"{r.NAME:<{width}}  {r.DESCRIPTION}")
        print(f"{'':<{width}}  scope: {', '.join(r.SCOPE)}")
        print(f"{'':<{width}}  reference: {getattr(r, 'REFERENCE_NAME', r.NAME)}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="PyTorch/CUDA static analysis: precision, host-sync, "
                    "retrace, RNG, and tensor-branch lints plus "
                    "dispatch-level hot-path checks.")
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: src/repro_torch)")
    parser.add_argument("--check", action="store_true",
                        help="also run the dispatch-level checks (CI gate)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where --check runs its probes (default: "
                             "%(default)s; no fallback)")
    parser.add_argument("--baseline", default=baseline_mod.DEFAULT_BASELINE,
                        help="suppression file (default: %(default)s)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report every finding, ignoring suppressions")
    parser.add_argument("--write-baseline", action="store_true",
                        help="write the current findings to the baseline")
    parser.add_argument("--rules", action="store_true",
                        help="list the lint rules and exit")
    args = parser.parse_args(argv)

    if args.rules:
        _print_rules()
        return 0

    try:
        findings = lint_paths(args.paths or None)
    except (OSError, SyntaxError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline:
        entries = baseline_mod.from_findings(findings)
        baseline_mod.dump(entries, args.baseline)
        print(f"wrote {len(entries)} suppression(s) to {args.baseline} — "
              "fill in the reason fields")
        return 0

    try:
        entries = [] if args.no_baseline else baseline_mod.load(args.baseline)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.check:
        from repro_torch.analysis import dispatch_check
        try:
            findings = findings + dispatch_check.run_all(device=args.device)
        except dispatch_check.NoDevice as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        except Exception as exc:  # a crashed probe is itself a failure
            print(f"error: dispatch-level checks crashed: {exc!r}",
                  file=sys.stderr)
            return 2
    new, suppressed, stale = baseline_mod.partition(findings, entries)
    if not args.check:      # the dispatch-level entries match only under --check
        stale = [e for e in stale if e["rule"] != "trace-check"]

    for f in new:
        print(f.render())
    for e in stale:
        print(f"warning: stale baseline entry (nothing matches): "
              f"[{e['rule']}] {e['path']}: {e['line_content']!r}",
              file=sys.stderr)
    n_sup = len(suppressed)
    tail = f" ({n_sup} suppressed by baseline)" if n_sup else ""
    if new:
        print(f"\n{len(new)} finding(s){tail}")
        return 1
    print(f"clean{tail}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
