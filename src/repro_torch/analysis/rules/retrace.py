"""retrace-knob: one compile per sweep — in the port, proven at layer 2.

The reference's rule (``repro.analysis.rules.retrace``) flags a Python
scalar handed to a jitted callable: a grid like ``[1, 2.0, 4]`` mixes
weak-int and weak-float signatures and recompiles mid-sweep, so the
reference threads knobs as ``jnp.asarray(v, jnp.float32)``.

Eager torch has no trace cache: a literal knob recompiles nothing, so the
call-site idiom the reference lints has no hazard here and this ``check``
reports nothing.  What the rule guards — one compile per sweep — becomes,
in the port, "one factorization per C-grid" and "one graph capture per
bucket", and both are proven on the running program by the dispatch layer:
``dispatch_check.check_recompile_engine`` (a warm 4-point ``train_grid``
compresses once and factorizes once) and ``dispatch_check.check_serve_path``
(eight queue occupancies over two buckets: two scorer signatures, and on
the card two CUDA-graph captures).  The rule stays registered so the rule
table and ``# lint: disable=`` names match the reference's.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding

NAME = "retrace-knob"
DESCRIPTION = ("one compile per sweep: proven at the dispatch layer "
               "(check_recompile_engine, check_serve_path); no AST check")
SCOPE = ("src/repro_torch",)


def check(path: str, tree: ast.AST, lines: list[str]) -> list[Finding]:
    return []
