"""Shared AST helpers for the lint rules, and the port's hot set.

Everything here is deliberately module-local and syntactic: the rules never
import the code under analysis, so the lint runs in milliseconds and cannot
be broken by import-time side effects.  The dispatch-level layer
(repro_torch.analysis.dispatch_check) is where whole-program facts are
checked.

The reference's rules look inside *traced* bodies: functions handed to
``jax.jit`` / ``lax.scan`` / ``shard_map`` (``repro.analysis.rules._common
.traced_functions``).  Eager torch traces nothing, so the port's rules look
inside its **hot set** instead (``hot_regions``):

  (i)   ``forward`` / ``backward`` of every ``torch.autograd.Function``
        subclass and ``forward`` of every ``nn.Module`` subclass;
  (ii)  the body of every ``with torch.cuda.graph(...)`` block, and the
        module-local functions called there (the reference's one-hop rule);
  (iii) ``HOT_FUNCTIONS``: the port's counterpart of every function the
        reference traces (its layer 2's targets, each kernel's launcher, and
        the twins of what ``traced_functions`` finds over ``src/repro``).
"""
from __future__ import annotations

import ast

# (iii): (repo-relative path, qualified name).  tests/test_torch_analysis.py
# holds this against the reference's traced_functions over src/repro.
HOT_FUNCTIONS: frozenset[tuple[str, str]] = frozenset({
    # the reference layer 2's targets (jaxpr_check.py)
    ("src/repro_torch/core/hss.py", "HSSMatrix.matmat"),
    ("src/repro_torch/core/factorization.py", "HSSFactorization.solve_mat"),
    ("src/repro_torch/core/factorization.py", "hss_solve_mat"),
    ("src/repro_torch/core/factorization.py", "factorize"),
    ("src/repro_torch/core/admm.py", "admm_boxqp"),
    ("src/repro_torch/core/svm.py", "compute_bias_batched"),
    ("src/repro_torch/core/compression.py", "_stream_leaf_batch"),
    ("src/repro_torch/core/compression.py", "_stream_level_batch"),
    ("src/repro_torch/core/compression.py", "_stream_root_batch"),
    ("src/repro_torch/serve/engine.py", "batched_scores"),
    ("src/repro_torch/core/kernelfn.py", "kernel_matvec_streamed"),
    ("src/repro_torch/core/krr.py", "krr_solve"),
    ("src/repro_torch/core/lanczos.py", "top_eigenpairs"),
    # jax.jit-wrapped by the reference's launch/serve.py:61-62, and what
    # runs inside them
    ("src/repro_torch/models/transformer.py", "Model.prefill"),
    ("src/repro_torch/models/transformer.py", "Model.decode_step"),
    ("src/repro_torch/models/layers.py", "moe_block"),
    # each kernel's launcher
    ("src/repro_torch/kernels/gaussian/ops.py", "gaussian_block"),
    ("src/repro_torch/kernels/compress/ops.py", "batched_assemble_id"),
    ("src/repro_torch/kernels/compress/laplacian.py", "laplacian_block"),
    ("src/repro_torch/kernels/admm_update/ops.py", "fused_zmu_update"),
    ("src/repro_torch/kernels/attention/ops.py", "flash_attention"),
    ("src/repro_torch/kernels/ssd/ops.py", "ssd_forward"),
    # twins of the rest of the reference's traced functions
    ("src/repro_torch/core/idqr.py", "cpqr_select"),
    ("src/repro_torch/core/idqr.py", "interp_decomp"),
    ("src/repro_torch/core/idqr.py", "interp_decomp_ranked"),
    ("src/repro_torch/core/distributed.py", "admm_train_distributed.run"),
    ("src/repro_torch/core/distributed.py", "admm_train_multiclass_distributed.run"),
    ("src/repro_torch/train/grad_compress.py", "make_compressed_allreduce.reduce_fn"),
    # the port's counterparts of traced bodies whose names differ (the
    # reference's vmapped ``one`` / ``_leaf_stage`` / ``_level`` / scan
    # ``step`` / ``body`` / ``chunk_loss`` / ``acc_step`` / ``tick``)
    ("src/repro_torch/core/factorization.py", "_leaf_factors"),
    ("src/repro_torch/core/factorization.py", "_level_factors"),
    ("src/repro_torch/core/compression.py", "_batched_kernel_block"),
    ("src/repro_torch/core/compression.py", "_batched_row_id"),
    ("src/repro_torch/core/idqr.py", "finish_interp"),
    ("src/repro_torch/core/lanczos.py", "lanczos"),
    ("src/repro_torch/core/tasks.py", "compute_bias_svr_batched"),
    ("src/repro_torch/core/tasks.py", "compute_rho_oneclass_batched"),
    ("src/repro_torch/kernels/ssd/ref.py", "ssd_chunked_ref"),
    ("src/repro_torch/models/layers.py", "attention_block"),
    ("src/repro_torch/models/layers.py", "attention_decode"),
    ("src/repro_torch/models/layers.py", "_moe_local_chunk"),
    ("src/repro_torch/models/ssm.py", "ssm_block"),
    ("src/repro_torch/models/ssm.py", "ssm_decode_step"),
    ("src/repro_torch/models/transformer.py", "Model.backbone"),
    ("src/repro_torch/models/transformer.py", "Model._chunk_loss"),
    ("src/repro_torch/models/transformer.py", "Model.loss_fn"),
    ("src/repro_torch/train/step.py", "make_train_step.grads_of"),
    ("src/repro_torch/dist/pipeline.py", "pipeline_forward"),
})

# the two class families of (i), by the trailing name of a base class
_FUNCTION_BASES = {"Function"}          # torch.autograd.Function
_MODULE_BASES = {"Module"}              # nn.Module / torch.nn.Module


def attr_name(node: ast.AST) -> str | None:
    """Trailing name of a Name / dotted Attribute: torch.linalg.inv -> "inv"."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def root_name(node: ast.AST) -> str | None:
    """Leading name of a dotted chain: torch.linalg.inv -> "torch"."""
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def dotted_parts(node: ast.AST) -> tuple[str, ...]:
    """All names of a dotted chain: torch.cuda.graph -> ("torch", "cuda", "graph")."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return tuple(reversed(parts))


def qualnames(tree: ast.AST) -> dict[int, str]:
    """id(def) -> dotted qualified name ("Model.prefill", "outer.inner")."""
    out: dict[int, str] = {}

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{prefix}{child.name}"
                if not isinstance(child, ast.ClassDef):
                    out[id(child)] = name
                visit(child, name + ".")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def build_parent_map(tree: ast.AST) -> dict[int, ast.AST]:
    parents: dict[int, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    return parents


def contains(node: ast.AST, pred) -> bool:
    return any(pred(n) for n in ast.walk(node))


# --------------------------------------------------------------------- #
# the hot set                                                            #
# --------------------------------------------------------------------- #
def _bases(cls: ast.ClassDef) -> set[str]:
    return {attr_name(b) for b in cls.bases} - {None}


def _is_cuda_graph_ctx(expr: ast.AST) -> bool:
    """``torch.cuda.graph(...)`` (or a bare ``graph(...)`` imported from it)."""
    if not isinstance(expr, ast.Call):
        return False
    parts = dotted_parts(expr.func)
    return bool(parts) and parts[-1] == "graph" and (
        "cuda" in parts or len(parts) == 1)


def hot_regions(path: str, tree: ast.AST) -> list[tuple[ast.AST, ast.AST]]:
    """(region, scope) pairs of the hot set in one module: ``region`` is a
    function or a ``with torch.cuda.graph`` block, ``scope`` the function
    whose parameters and assignments say which names hold tensors.  Kept on
    the tree: both hot-set rules ask for it."""
    cached = getattr(tree, "_hot_regions", None)
    if cached is not None and cached[0] == path:
        return cached[1]
    names = qualnames(tree)
    defs_by_name: dict[str, list[ast.AST]] = {}
    hot: list[tuple[ast.AST, ast.AST]] = []
    graphs: list[ast.AST] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)
            if (path, names.get(id(node))) in HOT_FUNCTIONS:
                hot.append((node, node))
        elif isinstance(node, ast.ClassDef):
            bases = _bases(node)
            wanted = ({"forward", "backward"} if bases & _FUNCTION_BASES
                      else {"forward"} if bases & _MODULE_BASES else set())
            hot.extend((item, item) for item in node.body
                       if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                       and item.name in wanted)
        elif isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_cuda_graph_ctx(it.context_expr) for it in node.items):
            graphs.append(node)
    if graphs:
        parents = build_parent_map(tree)
        for node in graphs:
            hot.append((node, enclosing_function(node, parents) or node))
            for sub in ast.walk(node):          # one module-local hop
                if isinstance(sub, ast.Call):
                    for fn in defs_by_name.get(attr_name(sub.func) or "", []):
                        hot.append((fn, fn))
    seen: set[int] = set()
    out = []
    for region, scope in hot:
        if id(region) not in seen:
            seen.add(id(region))
            out.append((region, scope))
    tree._hot_regions = (path, out)
    return out


def enclosing_function(node: ast.AST, parents: dict) -> ast.AST | None:
    cur = parents.get(id(node))
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        cur = parents.get(id(cur))
    return cur


# --------------------------------------------------------------------- #
# which names hold tensors                                               #
# --------------------------------------------------------------------- #
# attributes / zero-argument methods whose results are Python values
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad", "is_leaf", "names"}
STATIC_METHODS = {"size", "dim", "numel", "element_size", "is_floating_point",
                  "is_complex", "is_contiguous", "stride", "get_device",
                  "data_ptr", "nelement"}
STATIC_CALLS = {"len", "min", "max", "tuple", "list", "set", "dict", "range",
                "enumerate", "zip", "sorted", "isinstance", "hasattr",
                "getattr", "prod", "str", "repr", "type", "callable", "id"}
# annotations that make a parameter a Python value (exempt by annotation)
_SCALAR_ANNOTATIONS = {"int", "float", "bool", "str", "complex", "None",
                       "Optional", "Union", "tuple", "Tuple", "Sequence",
                       "Literal", "list", "List", "Iterable"}
# attributes of a tensor that are tensors
TENSOR_ATTRS = {"T", "mT", "H", "mH", "real", "imag", "grad", "data"}
# methods that reduce a tensor to a (0-d) tensor, whatever their receiver
TENSOR_REDUCTIONS = {"any", "all", "sum", "mean", "amax", "amin", "norm",
                     "prod", "count_nonzero", "argmax", "argmin"}
# roots of calls whose results are tensors
TENSOR_ROOTS = {"torch", "F", "nn"}
_UNTYPED_OBJECTS = {"self", "cls", "ctx"}


def is_static_expr(node: ast.AST) -> bool:
    """Conservatively true when an expression is a Python value, never a
    tensor: literals, .shape/.ndim/.dtype/.device probes, .size()/.dim()/
    .numel(), len()/min()/tuple() and other structural builtins, and
    arithmetic / comparison chains thereof."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        return node.attr in STATIC_ATTRS or (
            isinstance(node.value, ast.Attribute) and is_static_expr(node.value))
    if isinstance(node, ast.Subscript):
        return is_static_expr(node.value)
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(is_static_expr(e) for e in node.elts)
    if isinstance(node, ast.Call):
        name = attr_name(node.func) or ""
        if name in STATIC_METHODS or name.startswith("is_"):
            return True            # t.size(0), torch.is_grad_enabled()
        return isinstance(node.func, ast.Name) and node.func.id in STATIC_CALLS
    if isinstance(node, ast.BinOp):
        return is_static_expr(node.left) and is_static_expr(node.right)
    if isinstance(node, ast.UnaryOp):
        return is_static_expr(node.operand)
    if isinstance(node, ast.Compare):
        return all(is_static_expr(v) for v in [node.left] + node.comparators) \
            or all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops)
    return False


def _annotation_is_scalar(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    names = {n.id for n in ast.walk(ann) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(ann) if isinstance(n, ast.Attribute)}
    consts = [n for n in ast.walk(ann) if isinstance(n, ast.Constant)]
    return bool(names or consts) and names <= _SCALAR_ANNOTATIONS


def _annotation_is_object(ann: ast.AST | None) -> bool:
    """A class other than a tensor or a container: attribute reads on it are
    taken for Python values (a config, a spec, a dataclass of settings)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    names = {attr_name(n) for n in ast.walk(ann)
             if isinstance(n, (ast.Name, ast.Attribute))} - {None}
    return not (names & {"Tensor", "dict", "Dict", "Mapping", "Any", "object"}) \
        and not names <= _SCALAR_ANNOTATIONS


def _all_args(fn: ast.AST) -> list[ast.arg]:
    a = fn.args
    out = a.posonlyargs + a.args + a.kwonlyargs
    return out + [x for x in (a.vararg, a.kwarg) if x is not None]


def target_names(tgt: ast.AST) -> list[str]:
    if isinstance(tgt, ast.Name):
        return [tgt.id]
    if isinstance(tgt, (ast.Tuple, ast.List)):
        return [n for e in tgt.elts for n in target_names(e)]
    if isinstance(tgt, ast.Starred):
        return target_names(tgt.value)
    return []


def _scope_params(scope: ast.AST) -> set[str]:
    """Parameters that may hold tensors: unannotated ones and those
    annotated as a tensor or a container; not ``self``/``ctx``, not Python
    scalars, not other classes (configs, specs)."""
    if not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        return set()
    out = set()
    for a in _all_args(scope):
        ann = getattr(a, "annotation", None)
        if a.arg in _UNTYPED_OBJECTS or _annotation_is_scalar(ann) \
                or _annotation_is_object(ann):
            continue
        out.add(a.arg)
    return out


def derives_from(expr: ast.AST, tensorish: set[str]) -> str | None:
    """The name (or call) through which ``expr`` may hold a tensor, if any:
    a tensorish name used outside a static probe, or a torch call."""
    if is_static_expr(expr):
        return None
    if isinstance(expr, ast.Name):
        return expr.id if expr.id in tensorish else None
    if isinstance(expr, ast.Call):
        if root_name(expr.func) in TENSOR_ROOTS:
            return ".".join(dotted_parts(expr.func)) or "torch call"
        if isinstance(expr.func, ast.Attribute) and expr.func.attr in TENSOR_REDUCTIONS:
            return f".{expr.func.attr}()"         # (a != 0).any(), m.sum()
        parts = ([expr.func.value] if isinstance(expr.func, ast.Attribute)
                 else [])                         # t.float(), t.view() ...
        for sub in parts + list(expr.args) + [k.value for k in expr.keywords]:
            hit = derives_from(sub, tensorish)    # f(t) -> a tensor
            if hit:
                return hit
        return None
    if isinstance(expr, ast.Attribute):
        # t.T is a tensor; cfg.n_heads, hss.cut and the like are taken for
        # Python values (attributes of objects, not of tensors)
        return derives_from(expr.value, tensorish) if expr.attr in TENSOR_ATTRS \
            else None
    if isinstance(expr, (ast.Lambda, ast.FunctionDef)):
        return None
    for child in ast.iter_child_nodes(expr):
        if isinstance(child, ast.expr):
            hit = derives_from(child, tensorish)
            if hit:
                return hit
    return None


def tensorish_names(scope: ast.AST) -> set[str]:
    """Parameters that may hold tensors (``_scope_params``) plus locals
    assigned from torch calls or from expressions through such a name;
    structurally static values (``b, s, d = q.shape``; ``n = x.size(0)``)
    stay Python values."""
    names = _scope_params(scope)
    changed = True
    while changed:               # fixpoint over straight-line derivations
        changed = False
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                    and node.value is not None:
                targets, value = [node.target], node.value
            elif isinstance(node, (ast.For, ast.comprehension)):
                targets, value = [node.target], node.iter
            elif isinstance(node, ast.withitem) and node.optional_vars is not None:
                targets, value = [node.optional_vars], node.context_expr
            else:
                continue
            if derives_from(value, names) is None:
                continue
            for tgt in targets:
                for name in target_names(tgt):
                    if name not in names:
                        names.add(name)
                        changed = True
    return names
