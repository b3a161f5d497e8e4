"""precision-accumulate: hot-path contractions must accumulate in f32.

Twin of the reference's rule (``repro.analysis.rules.precision``), which
asks every ``jnp.einsum`` / ``matmul`` / ``dot`` on the hot paths (core/,
kernels/, models/) for ``preferred_element_type``, so that a bf16-stored
operand cannot accumulate in bf16 and drift the ADMM inner solves (the
bf16-vs-f32 storage contract, ~3e-3 rel; bf16 accumulation ~1e-1).

Torch has no ``preferred_element_type``.  Its spellings of the same intent:

  * an operand cast to f32 (``.float()``, ``.to(torch.float32)``,
    ``.to(dtype=torch.float32)``): the product is then f32 by dtype;
  * ``out_dtype=torch.float32`` (``torch.mm`` / ``bmm`` on the card).

Flagged calls: ``torch.einsum`` / ``matmul`` / ``mm`` / ``bmm`` / ``baddbmm``
/ ``addmm`` / ``tensordot`` / ``F.linear``, and the same methods on a
tensor.  Unlike the reference, a result cast afterwards (``(a @ b).float()``)
is NOT an exemption: a bf16 product in torch is already rounded to bf16
when ``.float()`` runs, whereas ``preferred_element_type`` keeps the f32
accumulator.  The bare ``@`` stays out of scope, as in the reference: the
dispatch layer (``dispatch_check.dtype_downcasts``) sees every ``aten.mm``
on the real hot paths, whatever the spelling.

Two sub-checks under the same name (CUDA products without f32
accumulation, or with TF32 allowed):

  (a) in ``src/repro_torch`` and ``chip_smoke.py``: any assignment that
      turns TF32 on (``allow_tf32 = True``,
      ``set_float32_matmul_precision("high" | "medium")``,
      ``fp32_precision = "tf32"``) — TF32 rounds f32 operands to 10 bits;
  (b) in ``src/repro_torch/csrc`` (``check_cuda``, a text scan): ``mma`` /
      ``wgmma`` instructions whose accumulator is not ``.f32``, and any
      ``tf32`` operand type.  The reference lints its Pallas kernel bodies
      (``pl`` / ``plgpu`` / ``pltpu`` roots); the twins' CUDA sources get
      the same guard.
"""
from __future__ import annotations

import ast
import re

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import _common

NAME = "precision-accumulate"
DESCRIPTION = ("contraction without f32 accumulation on a hot path, TF32 "
               "allowed, or a CUDA mma without an f32 accumulator")
SCOPE = ("src/repro_torch/core", "src/repro_torch/kernels",
         "src/repro_torch/models")
# files the rule reads at all: sub-check (a) covers the whole package and
# the chip script, (b) the CUDA sources
FILE_SCOPE = ("src/repro_torch", "chip_smoke.py")
CUDA_SCOPE = ("src/repro_torch/csrc",)

_ACC_FUNCS = {"einsum", "matmul", "mm", "bmm", "baddbmm", "addmm",
              "tensordot", "linear"}
# host namespaces: numpy / math products have no bf16-accumulation hazard
_HOST_ROOTS = {"np", "numpy", "math", "scipy", "sp"}
_F32_NAMES = {"float32", "float"}


def _is_f32_dtype(node: ast.AST) -> bool:
    """torch.float32 / torch.float / "float32"."""
    if isinstance(node, ast.Constant):
        return node.value == "float32"
    return (isinstance(node, ast.Attribute) and node.attr in _F32_NAMES
            and _common.root_name(node) == "torch")


def is_f32_cast(node: ast.AST) -> bool:
    """``t.float()`` / ``t.to(torch.float32)`` / ``t.to(dtype=torch.float32)``
    / ``t.to(device, torch.float32)`` / ``t.type(torch.float32)``."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return False
    attr = node.func.attr
    if attr in ("float", "double") and not node.args:
        return True
    if attr in ("to", "type"):
        return (any(_is_f32_dtype(a) for a in node.args)
                or any(k.arg == "dtype" and _is_f32_dtype(k.value)
                       for k in node.keywords))
    return False


def _is_acc_call(node: ast.Call) -> bool:
    name = _common.attr_name(node.func)
    if name not in _ACC_FUNCS:
        return False
    if isinstance(node.func, ast.Name):        # from torch import einsum
        return name != "linear"
    root = _common.root_name(node.func)
    if root in _HOST_ROOTS:
        return False
    if name == "linear":                       # F.linear / torch.nn.functional
        return root in ("F", "torch", "nn")
    return True                                # torch.X(...) or t.X(...)


def _operands(node: ast.Call) -> list[ast.AST]:
    ops = list(node.args)
    if isinstance(node.func, ast.Attribute) and \
            _common.root_name(node.func) not in _common.TENSOR_ROOTS:
        ops.append(node.func.value)            # the receiver of t.mm(u)
    return ops


def _contractions(path: str, tree: ast.AST, lines: list[str]) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _is_acc_call(node)):
            continue
        if any(k.arg == "out_dtype" and _is_f32_dtype(k.value)
               for k in node.keywords):
            continue
        if any(_common.contains(op, is_f32_cast) for op in _operands(node)):
            continue
        fn = _common.attr_name(node.func)
        findings.append(Finding(
            rule=NAME, path=path, line=node.lineno,
            message=(f"{fn} without f32 accumulation — cast an operand to f32 "
                     "(.float()) or pass out_dtype=torch.float32, so bf16 "
                     "operands cannot accumulate in bf16 (a cast of the result "
                     "comes too late: the product is already rounded)"),
            line_content=lines[node.lineno - 1].strip(),
        ))
    return findings


def _tf32(path: str, tree: ast.AST, lines: list[str]) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        bad = None
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                attr = _common.attr_name(tgt) if isinstance(tgt, ast.Attribute) else None
                val = node.value
                if attr == "allow_tf32" and not (
                        isinstance(val, ast.Constant) and val.value is False):
                    bad = f"{attr} = {ast.unparse(val)}"
                elif attr == "fp32_precision" and isinstance(val, ast.Constant) \
                        and val.value == "tf32":
                    bad = 'fp32_precision = "tf32"'
        elif isinstance(node, ast.Call) and \
                _common.attr_name(node.func) == "set_float32_matmul_precision":
            arg = node.args[0] if node.args else None
            if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                bad = f"set_float32_matmul_precision({ast.unparse(arg) if arg else ''})"
        if bad is not None:
            findings.append(Finding(
                rule=NAME, path=path, line=node.lineno,
                message=(f"{bad} allows TF32 — f32 products then round their "
                         "operands to 10 mantissa bits; keep TF32 off (the "
                         "port's f32 products run in full f32)"),
                line_content=lines[node.lineno - 1].strip(),
            ))
    return findings


def _in(path: str, prefixes: tuple[str, ...]) -> bool:
    return any(path.startswith(p) for p in prefixes)


def check(path: str, tree: ast.AST, lines: list[str]) -> list[Finding]:
    findings = _tf32(path, tree, lines)
    # contractions: core/kernels/models, or any file named explicitly
    if _in(path, SCOPE) or not _in(path, FILE_SCOPE):
        findings += _contractions(path, tree, lines)
    return findings


# ----------------------------------------------------------------------- #
# (b) the CUDA sources                                                     #
# ----------------------------------------------------------------------- #
_MMA_RE = re.compile(
    r"\b(?:wgmma\.mma_async|mma)\.sync\.aligned\.(m\d+n\d+k\d+)((?:\.\w+)+)")
_TF32_RE = re.compile(r"\btf32\b", re.IGNORECASE)
_ACC_OK = {"f32", "f64", "s32"}
_LAYOUTS = {"row", "col"}


def _code_part(line: str) -> str:
    return line.split("//", 1)[0]


def check_cuda(path: str, lines: list[str]) -> list[Finding]:
    findings = []
    for lineno, raw in enumerate(lines, 1):
        code = _code_part(raw)
        bad = None
        for m in _MMA_RE.finditer(code):
            types = [t for t in m.group(2).split(".") if t and t not in _LAYOUTS]
            if types and types[0] not in _ACC_OK:
                bad = f"{m.group(0)} accumulates in {types[0]}"
        if bad is None and _TF32_RE.search(code):
            bad = "a tf32 operand type"
        if bad is None and re.search(r"wmma::accumulator[^>]*\b(half|__half|"
                                     r"__nv_bfloat16)\b", code):
            bad = "a wmma accumulator fragment in half precision"
        if bad is not None:
            findings.append(Finding(
                rule=NAME, path=path, line=lineno,
                message=(f"{bad} — the port's tensor-core products accumulate "
                         "in f32 (.f32 accumulator) on bf16 operands, never "
                         "tf32"),
                line_content=raw.strip(),
            ))
    return findings
