"""Baseline (suppression) file: pre-existing, justified findings.

``analysis/baseline.toml`` pins the set of findings that predate the
analyzer or are deliberate; the CI gate then fails only on NEW violations.
Every entry must carry a ``reason`` — an unjustified suppression is itself
an error.  Entries match on (rule, path, stripped source line), NOT line
numbers, so unrelated edits above a suppressed site don't invalidate it.

The container's Python (3.10) has no ``tomllib`` and the repo adds no
dependencies, so this module reads/writes the small TOML subset the file
uses: ``[[suppress]]`` table arrays of string keys.
"""
from __future__ import annotations

import os

from repro_torch.analysis.findings import Finding

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.toml")


def _unquote(raw: str, path: str, lineno: int) -> str:
    raw = raw.strip()
    if len(raw) < 2 or raw[0] != '"' or raw[-1] != '"':
        raise ValueError(f"{path}:{lineno}: expected a quoted string, "
                         f"got {raw!r}")
    out, i, body = [], 0, raw[1:-1]
    while i < len(body):
        ch = body[i]
        if ch == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(
                nxt, nxt))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _quote(s: str) -> str:
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def load(path: str = DEFAULT_BASELINE) -> list[dict]:
    """Parse the [[suppress]] entries (TOML subset; see module docstring)."""
    if not os.path.exists(path):
        return []
    entries: list[dict] = []
    current: dict | None = None
    with open(path, encoding="utf-8") as fh:
        for lineno, raw in enumerate(fh, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            if line == "[[suppress]]":
                current = {}
                entries.append(current)
            elif "=" in line and current is not None:
                key, _, val = line.partition("=")
                current[key.strip()] = _unquote(val, path, lineno)
            else:
                raise ValueError(
                    f"{path}:{lineno}: unsupported baseline syntax {line!r} "
                    "(only [[suppress]] tables of string keys)")
    for i, e in enumerate(entries):
        for req in ("rule", "path", "line_content", "reason"):
            if not e.get(req):
                raise ValueError(
                    f"{path}: suppress entry #{i + 1} is missing {req!r} — "
                    "every suppression needs a justification")
    return entries


def dump(entries: list[dict], path: str = DEFAULT_BASELINE) -> None:
    lines = [
        "# repro_torch.analysis baseline — pre-existing, JUSTIFIED findings.",
        "# The CI gate (python -m repro_torch.analysis --check) fails only on",
        "# findings absent from this file.  Match key: (rule, path,",
        "# stripped source line); every entry must state a reason.",
        "",
    ]
    for e in entries:
        lines.append("[[suppress]]")
        for key in ("rule", "path", "line_content", "reason"):
            lines.append(f"{key} = {_quote(e.get(key, ''))}")
        lines.append("")
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("\n".join(lines))


def partition(findings: list[Finding], entries: list[dict]
              ) -> tuple[list[Finding], list[Finding], list[dict]]:
    """Split findings into (new, suppressed); also return stale entries
    that matched nothing (fixed code whose suppression should be dropped)."""
    new: list[Finding] = []
    suppressed: list[Finding] = []
    hit = [False] * len(entries)
    for f in findings:
        match = None
        for i, e in enumerate(entries):
            if (e["rule"] == f.rule and e["path"] == f.path
                    and e["line_content"] == f.line_content):
                match = i
                break
        if match is None:
            new.append(f)
        else:
            hit[match] = True
            suppressed.append(f)
    stale = [e for i, e in enumerate(entries) if not hit[i]]
    return new, suppressed, stale


def from_findings(findings: list[Finding],
                  reason: str = "TODO: justify or fix") -> list[dict]:
    entries, seen = [], set()
    for f in findings:
        key = (f.rule, f.path, f.line_content)
        if key in seen:
            continue
        seen.add(key)
        entries.append(dict(rule=f.rule, path=f.path,
                            line_content=f.line_content, reason=reason))
    return entries
