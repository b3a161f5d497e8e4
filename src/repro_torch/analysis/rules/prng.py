"""rng-discipline: every random draw names its generator, and one seed
feeds one generator.

Twin of the reference's ``prng-key-reuse`` (``repro.analysis.rules.prng``):
a reused ``PRNGKey`` makes "independent" samples identical, so proxy-point
sampling and synthetic data silently correlate.  Torch and numpy have no
keys; the port's convention is explicit generators (random vectors as
arguments, each draw from a ``torch.Generator`` or a
``np.random.default_rng`` the caller seeds).  The rule flags

  * a draw from global RNG state: ``torch.rand*`` / ``randn*`` /
    ``randint*`` / ``randperm`` / ``normal`` / ``bernoulli`` /
    ``multinomial`` / ``poisson``, or an in-place ``.normal_()`` /
    ``.uniform_()`` / ``.bernoulli_()`` / ``.random_()`` /
    ``.exponential_()``, without ``generator=``; and any
    ``np.random.<fn>`` other than ``default_rng`` / ``Generator`` and the
    bit generators (the legacy global state);
  * the reuse that correlates samples: two generators built from the same
    seed expression in one scope (``torch.Generator().manual_seed(s)``,
    ``np.random.default_rng(s)``), both drawn from — flagged at the second
    one's first draw.

Scope-local and order-approximate, as the reference's analysis is.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules import _common

NAME = "rng-discipline"
REFERENCE_NAME = "prng-key-reuse"
DESCRIPTION = ("random draw from global RNG state, or two generators from "
               "one seed")
SCOPE = ("src/repro_torch",)

_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "normal", "bernoulli",
                "multinomial", "poisson"}
_INPLACE_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                  "exponential_", "cauchy_", "geometric_", "log_normal_"}
_NP_EXPLICIT = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
                "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937"}


def _global_draw(node: ast.Call) -> str | None:
    name = _common.attr_name(node.func)
    has_gen = any(k.arg == "generator" for k in node.keywords)
    parts = _common.dotted_parts(node.func)
    if parts[:2] in (("np", "random"), ("numpy", "random")) and len(parts) == 3:
        return None if name in _NP_EXPLICIT else f"np.random.{name}"
    if has_gen:
        return None
    if name in _TORCH_DRAWS and parts and parts[0] == "torch":
        return f"torch.{name}"
    if name in _INPLACE_DRAWS and isinstance(node.func, ast.Attribute):
        return f".{name}()"
    return None


def _seed_of(value: ast.AST) -> str | None:
    """The seed expression a generator is built from, as a source string."""
    if not isinstance(value, ast.Call):
        return None
    name = _common.attr_name(value.func)
    if name == "default_rng" and value.args:
        return ast.unparse(value.args[0])
    if name == "manual_seed" and value.args and isinstance(value.func, ast.Attribute):
        inner = value.func.value                   # torch.Generator(...).manual_seed(s)
        if isinstance(inner, ast.Call) and _common.attr_name(inner.func) == "Generator":
            return ast.unparse(value.args[0])
    return None


def _drawn_from(node: ast.Call, name: str) -> bool:
    """``generator=name`` in a call, or a method of ``name`` (rng.normal)."""
    if any(k.arg == "generator" and isinstance(k.value, ast.Name)
           and k.value.id == name for k in node.keywords):
        return True
    return (isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == name
            and node.func.attr not in ("manual_seed", "seed", "get_state",
                                       "set_state", "initial_seed"))


def _own_nodes(scope: ast.AST):
    """Nodes of a scope, not of the functions or classes nested in it."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        yield node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(node))


def _reused_seeds(scope: ast.AST) -> list[tuple[int, str, str]]:
    """(line, generator, seed) of the first draw from each generator whose
    seed expression another generator of the scope was built from."""
    seeds: dict[str, tuple[str, int]] = {}
    for node in _own_nodes(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            seed = _seed_of(node.value)
            if seed is not None:
                seeds.setdefault(node.targets[0].id, (seed, node.lineno))
    by_seed: dict[str, list[str]] = {}
    for name, (seed, _) in sorted(seeds.items(), key=lambda kv: kv[1][1]):
        by_seed.setdefault(seed, []).append(name)
    first_draw: dict[str, int] = {}
    for node in _own_nodes(scope):
        if isinstance(node, ast.Call):
            for name in seeds:
                if _drawn_from(node, name):
                    first_draw[name] = min(first_draw.get(name, node.lineno),
                                           node.lineno)
    out = []
    for seed, names in by_seed.items():
        drawn = sorted((first_draw[n], n) for n in names if n in first_draw)
        for line, name in drawn[1:]:
            out.append((line, name, seed))
    return out


def check(path: str, tree: ast.AST, lines: list[str]) -> list[Finding]:
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        bad = _global_draw(node)
        if bad is None:
            continue
        findings.append(Finding(
            rule=NAME, path=path, line=node.lineno,
            message=(f"{bad} draws from global RNG state — pass a seeded "
                     "generator (generator=torch.Generator(...).manual_seed(s), "
                     "np.random.default_rng(s)) so draws are reproducible and "
                     "independent of call order"),
            line_content=lines[node.lineno - 1].strip(),
        ))
    if not any("default_rng" in ln or "manual_seed" in ln for ln in lines):
        return findings                  # no generator is built from a seed here
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for scope in scopes:
        for line, name, seed in _reused_seeds(scope):
            findings.append(Finding(
                rule=NAME, path=path, line=line,
                message=(f"generator {name!r} is built from seed {seed!r}, as "
                         "another generator of this scope is — their draws are "
                         "identical, not independent; derive distinct seeds "
                         "or draw both from one generator"),
                line_content=lines[line - 1].strip(),
            ))
    return findings
