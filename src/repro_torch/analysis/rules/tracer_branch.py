"""python-branch-on-tensor: no Python control flow on tensor values on the
hot set.

Twin of the reference's ``python-branch-on-tracer`` (``repro.analysis.rules
.tracer_branch``).  In jax an ``if`` on a traced value fails at trace time
or bakes one branch into the compiled program.  In eager torch it is not an
error: ``if t:`` / ``while t:`` / ``assert t`` is an implicit ``bool(t)``,
one host sync per call, and under a CUDA-graph capture the branch taken
while capturing is frozen into the graph — every replay takes it, whatever
the data says.  The same hazard the reference names; use ``torch.where`` /
masked arithmetic so both outcomes stay on the device.

Tests that are Python values are exempt: ``is None`` / ``is not None``,
``isinstance(...)``, ``.shape`` / ``.ndim`` / ``.dtype`` / ``.device``
probes, ``.size()`` / ``.dim()`` / ``.numel()``, and parameters that are
Python scalars (or config objects) by annotation.  The rule looks inside
the port's hot set (``rules._common.hot_regions``) instead of traced
bodies.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import _common

NAME = "python-branch-on-tensor"
REFERENCE_NAME = "python-branch-on-tracer"
DESCRIPTION = "Python if/while/assert on a tensor value on a hot path"
SCOPE = ("src/repro_torch",)


def _is_static_test(test: ast.AST) -> bool:
    """Tests that are Python values whatever the tensors hold."""
    if isinstance(test, ast.Compare):
        ops_static = all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)
        none_side = any(isinstance(c, ast.Constant) and c.value is None
                        for c in [test.left] + test.comparators)
        if ops_static and none_side:
            return True
    if (isinstance(test, ast.Call)
            and _common.attr_name(test.func) in ("isinstance", "hasattr",
                                                 "callable", "len")):
        return True
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _is_static_test(test.operand)
    if isinstance(test, ast.BoolOp):
        return all(_is_static_test(v) for v in test.values)
    return _common.is_static_expr(test)


def _tensor_name_in_test(test: ast.AST, tensorish: set[str]) -> str | None:
    """A tensorish name (or torch call) used outside a static probe."""
    if _is_static_test(test):
        return None
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            hit = _tensor_name_in_test(v, tensorish)
            if hit:
                return hit
        return None
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _tensor_name_in_test(test.operand, tensorish)
    if isinstance(test, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in test.ops):
        return None
    return _common.derives_from(test, tensorish)


def check(path: str, tree: ast.AST, lines: list[str]) -> list[Finding]:
    findings = []
    seen: set[int] = set()
    for region, scope in _common.hot_regions(path, tree):
        tensorish = _common.tensorish_names(scope)
        for node in ast.walk(region):
            if isinstance(node, (ast.If, ast.While)):
                test, kind = node.test, ("while" if isinstance(node, ast.While)
                                         else "if")
            elif isinstance(node, ast.Assert):
                test, kind = node.test, "assert"
            elif isinstance(node, ast.IfExp):
                test, kind = node.test, "conditional expression"
            else:
                continue
            name = _tensor_name_in_test(test, tensorish)
            if name is None or test.lineno in seen:
                continue
            seen.add(test.lineno)
            findings.append(Finding(
                rule=NAME, path=path, line=test.lineno,
                message=(f"Python {kind} on {name!r}, which may hold a tensor — "
                         "an implicit bool() syncs with the card on every call "
                         "and a CUDA-graph capture freezes the branch it saw; "
                         "use torch.where / masked arithmetic"),
                line_content=lines[test.lineno - 1].strip(),
            ))
    return findings
