"""host-sync-in-hot-path: no implicit host round-trips on the hot set.

Twin of the reference's ``host-sync-in-traced`` (``repro.analysis.rules
.host_sync``).  There a sync inside a traced body breaks tracing or forces
a device→host copy per call.  Eager torch traces nothing, so the rule looks
inside the port's hot set (``rules._common.hot_regions``: autograd
Functions, module ``forward``s, CUDA-graph capture bodies and
``HOT_FUNCTIONS``), where any of

  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``int/float/bool(t)`` of a tensor, ``torch.cuda.synchronize()``,
  ``np.asarray/np.array(t)``,

and every op whose output shape depends on the data (``nonzero``,
``masked_select``, ``unique``, ``bincount``, ``argwhere``, one-argument
``torch.where``, ``repeat_interleave`` with tensor repeats and no
``output_size``, boolean-mask indexing) waits for the card: the host stalls
once per call, and a CUDA-graph capture of the region fails.

Differences from the reference: the torch spellings above replace
``jax.device_get`` / ``.block_until_ready()``; the data-dependent-shape ops
are new (in jax they cannot trace at all); and a cast is flagged only when
its argument may hold a tensor (``rules._common.tensorish_names``): a
parameter annotated as a Python scalar or a config object, and
shape / ``len`` / dtype probes, are exempt.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import _common

NAME = "host-sync-in-hot-path"
REFERENCE_NAME = "host-sync-in-traced"
DESCRIPTION = ("host synchronization reachable on a hot path (autograd "
               "Function, forward, CUDA-graph capture, HOT_FUNCTIONS)")
SCOPE = ("src/repro_torch",)

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CASTS = {"float", "int", "bool", "complex"}
_NP_SYNC_FUNCS = {"asarray", "array"}
_DATA_SHAPE_OPS = {"nonzero", "masked_select", "unique", "unique_consecutive",
                   "bincount", "argwhere"}
# torch.linalg functions that read their LAPACK info back to the host and
# raise on failure; their ``_ex`` twins return it on the device
_CHECKED_LINALG = {"cholesky", "inv", "solve", "lu_factor"}
_MASK_OPS = {"logical_and", "logical_or", "logical_not", "logical_xor",
             "isnan", "isinf", "isfinite", "eq", "ne", "lt", "le", "gt", "ge"}


def _is_cpu_target(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call) and _common.attr_name(node.func) == "device"
            and bool(node.args) and _is_cpu_target(node.args[0]))


def _is_mask_expr(node: ast.AST, masks: set[str]) -> bool:
    """A boolean tensor, syntactically: a comparison, ``~t``, a logical op,
    or a local assigned from one."""
    if isinstance(node, ast.Compare):
        return not _common.is_static_expr(node)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
        return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, (ast.BitAnd, ast.BitOr)):
        return _is_mask_expr(node.left, masks) or _is_mask_expr(node.right, masks)
    if isinstance(node, ast.Call) and _common.attr_name(node.func) in _MASK_OPS:
        return True
    return isinstance(node, ast.Name) and node.id in masks


def _mask_names(scope: ast.AST) -> set[str]:
    masks: set[str] = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and _is_mask_expr(node.value, masks):
            for tgt in node.targets:
                masks.update(_common.target_names(tgt))
    return masks


def _call_sync(node: ast.Call, tensorish: set[str]) -> str | None:
    name = _common.attr_name(node.func)
    method = isinstance(node.func, ast.Attribute)
    if method and name in _SYNC_METHODS:
        return f".{name}()"
    if method and name == "to" and (
            any(_is_cpu_target(a) for a in node.args)
            or any(k.arg == "device" and _is_cpu_target(k.value)
                   for k in node.keywords)):
        return '.to("cpu")'
    if name in _CHECKED_LINALG and "linalg" in _common.dotted_parts(node.func):
        return (f"torch.linalg.{name}() (it reads its info back to raise on "
                f"failure; linalg.{name}_ex returns it on the device)")
    if name == "synchronize" and "cuda" in _common.dotted_parts(node.func):
        return "torch.cuda.synchronize()"
    if isinstance(node.func, ast.Name) and name in _SYNC_CASTS:
        if node.args and _common.derives_from(node.args[0], tensorish):
            return f"{name}()"
        return None
    if name in _NP_SYNC_FUNCS and _common.root_name(node.func) in ("np", "numpy"):
        if node.args and _common.derives_from(node.args[0], tensorish):
            return f"np.{name}()"
        return None
    if name in _DATA_SHAPE_OPS and (method or _common.root_name(node.func)
                                    in _common.TENSOR_ROOTS):
        return f"{name}() (its output shape depends on the data)"
    if name == "where" and _common.root_name(node.func) == "torch" \
            and len(node.args) == 1 and not node.keywords:
        return "torch.where(cond) (its output shape depends on the data)"
    if name == "repeat_interleave" and not any(
            k.arg == "output_size" for k in node.keywords):
        reps = node.args[0 if method else 1] if len(node.args) > (0 if method else 1) \
            else next((k.value for k in node.keywords if k.arg == "repeats"), None)
        if reps is not None and _common.derives_from(reps, tensorish):
            return ("repeat_interleave() with tensor repeats and no output_size "
                    "(its output shape depends on the data)")
    return None


def find_syncs(region: ast.AST, scope: ast.AST) -> list[tuple[int, str]]:
    """(line, what) of each host sync in ``region``."""
    tensorish = _common.tensorish_names(scope)
    masks = _mask_names(scope)
    out = []
    for node in ast.walk(region):
        bad = None
        if isinstance(node, ast.Call):
            bad = _call_sync(node, tensorish)
        elif isinstance(node, ast.Subscript) and _is_mask_expr(node.slice, masks):
            bad = "boolean-mask indexing (its output shape depends on the data)"
        if bad is not None:
            out.append((node.lineno, bad))
    return out


def check(path: str, tree: ast.AST, lines: list[str]) -> list[Finding]:
    findings = []
    seen_lines: set[int] = set()
    for region, scope in _common.hot_regions(path, tree):
        for lineno, bad in find_syncs(region, scope):
            if lineno in seen_lines:
                continue
            seen_lines.add(lineno)
            findings.append(Finding(
                rule=NAME, path=path, line=lineno,
                message=(f"{bad} on a hot path — the host waits for the card "
                         "here on every call, and a CUDA-graph capture of the "
                         "region fails; keep the value on the device (torch "
                         "ops, a static output_size) or hoist the host work "
                         "out of the hot region"),
                line_content=lines[lineno - 1].strip(),
            ))
    return findings
