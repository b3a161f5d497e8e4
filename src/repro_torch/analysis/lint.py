"""Layer 1: discover files, run the AST rules, apply suppressions.

Inline suppression syntax (on the flagged line or the line directly above):

    kz = risky_einsum(...)   # lint: disable=precision-accumulate

Multiple rules: ``# lint: disable=rule-a,rule-b``.  Repo-wide exceptions
with a justification belong in ``analysis/baseline.toml`` instead
(see repro_torch.analysis.baseline).

Besides the reference's Python files, the default scan reads
``chip_smoke.py`` (for precision-accumulate's TF32 sub-check) and the CUDA
sources under ``src/repro_torch/csrc`` (its mma / tf32 text scan).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterable, Sequence

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import ALL_RULES

# default scan roots, repo-relative; benchmarks/examples are host-side
# scripts with no hot paths
DEFAULT_ROOTS = ("src/repro_torch",)
# read by the default scan too, by the rules whose FILE_SCOPE names them
EXTRA_ROOTS = ("chip_smoke.py",)
CUDA_SUFFIXES = (".cu", ".cuh")

_DISABLE_RE = re.compile(r"#\s*lint:\s*disable=([\w,\- ]+)")


def repo_root(start: str | None = None) -> str:
    """Nearest ancestor containing a .git dir (or cwd as fallback)."""
    cur = os.path.abspath(start or os.getcwd())
    while True:
        if os.path.isdir(os.path.join(cur, ".git")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start or os.getcwd())
        cur = parent


def iter_python_files(roots: Iterable[str], base: str,
                      suffixes: tuple[str, ...] = (".py",)) -> list[str]:
    out: list[str] = []
    for root in roots:
        abs_root = os.path.join(base, root)
        if os.path.isfile(abs_root):
            out.append(abs_root)
            continue
        for dirpath, dirnames, filenames in os.walk(abs_root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            out.extend(os.path.join(dirpath, f)
                       for f in sorted(filenames) if f.endswith(suffixes))
    return out


def _disabled_rules(lines: list[str], lineno: int) -> set[str]:
    rules: set[str] = set()
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _DISABLE_RE.search(lines[ln - 1])
            if m:
                rules.update(r.strip() for r in m.group(1).split(","))
    return rules


def _applies(rule, rel_path: str, scope_attr: str, explicit: bool) -> bool:
    scope = getattr(rule, scope_attr, None)
    if scope is None:
        return False
    return explicit or any(rel_path.startswith(p) for p in scope)


def lint_file(abs_path: str, rel_path: str,
              explicit: bool = False) -> list[Finding]:
    """Run every applicable rule on one file."""
    with open(abs_path, encoding="utf-8") as fh:
        src = fh.read()
    lines = src.splitlines()
    findings: list[Finding] = []
    if rel_path.endswith(CUDA_SUFFIXES):
        for rule in ALL_RULES:
            if _applies(rule, rel_path, "CUDA_SCOPE", explicit):
                findings.extend(rule.check_cuda(rel_path, lines))
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        return findings
    try:
        tree = ast.parse(src, filename=rel_path)
    except SyntaxError as exc:
        return [Finding(rule="parse-error", path=rel_path,
                        line=exc.lineno or 0,
                        message=f"file does not parse: {exc.msg}",
                        line_content="")]
    for rule in ALL_RULES:
        attr = "FILE_SCOPE" if hasattr(rule, "FILE_SCOPE") else "SCOPE"
        if not _applies(rule, rel_path, attr, explicit):
            continue
        for f in rule.check(rel_path, tree, lines):
            if f.rule in _disabled_rules(lines, f.line):
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def lint_paths(paths: Sequence[str] | None = None,
               base: str | None = None) -> list[Finding]:
    """Lint explicit ``paths`` (all rules) or the default roots (scoped)."""
    base = base or repo_root()
    explicit = bool(paths)
    roots = paths or DEFAULT_ROOTS + EXTRA_ROOTS
    findings: list[Finding] = []
    for abs_path in iter_python_files(roots, base, (".py",) + CUDA_SUFFIXES):
        rel = os.path.relpath(abs_path, base).replace(os.sep, "/")
        findings.extend(lint_file(abs_path, rel, explicit=explicit))
    return findings
