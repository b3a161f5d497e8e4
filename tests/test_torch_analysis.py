"""repro_torch.analysis against repro.analysis on the CPU.

* the device-free parts (``Finding``, the baseline TOML subset, the
  ``# lint: disable=`` syntax, ``repo_root``, the CLI's exit codes) behave as
  the reference's do, byte for byte;
* each active rule catches exactly the ``# VIOLATION`` lines of its seeded
  torch fixture (``tests/torch_analysis_fixtures/``), and the clean fixture
  gives none;
* ``HOT_FUNCTIONS`` covers the port's twin of every function the
  reference's ``traced_functions`` finds over ``src/repro``;
* the tree lints clean modulo the baseline; ``dispatch_check.run_all`` on
  the CPU (every probe, the mesh check on 2 gloo ranks) finds nothing
  outside the baseline, no baseline entry is stale, and ``python -m
  repro_torch.analysis --check --device cpu`` exits 0 on those findings;
  the package imports and lints with jax and ``repro`` blocked;
* the walkers flag seeded bf16-output and ``.item()`` probes, as the
  reference's flag their jax twins;
* what the checks found is fixed: the factorization's ``_ex`` linalg gives
  the reference's NaN where a Cholesky fails, ``kernel_matvec_streamed``
  takes bf16 as the reference does, and a small serve and train step
  through the entry points leave no tensor to the garbage collector.

``run_all`` (on a thread) and two subprocesses (the tree's lint with jax
and ``repro`` blocked, the garbage probe) start when the module's first
test runs and are read by later tests, so that they run beside the rest of
the file.
"""
from __future__ import annotations

import ast
import functools
import json
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import baseline as ref_baseline
from repro.analysis import jaxpr_check
from repro.analysis import lint as ref_lint
from repro.analysis.__main__ import main as ref_main
from repro.analysis.findings import Finding as RefFinding
from repro.analysis.rules import _common as ref_common
from repro_torch.analysis import baseline as port_baseline
from repro_torch.analysis import dispatch_check
from repro_torch.analysis import __main__ as port_cli
from repro_torch.analysis import lint as port_lint
from repro_torch.analysis.findings import Finding as PortFinding
from repro_torch.analysis.rules import ALL_RULES, _common
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
port_main = port_cli.main
FIXTURES = os.path.join(ROOT, "tests", "torch_analysis_fixtures")
REF_FIXTURES = os.path.join(ROOT, "tests", "analysis_fixtures")
SUBPROCESS_TIMEOUT = 120

# with jax and repro blocked: every module of the analysis package imported,
# and the lint of the tree (the CLI's default roots), its findings printed
_LINT = textwrap.dedent("""
    import dataclasses, json, sys
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    from repro_torch.analysis import __main__, dispatch_check, lint
    from repro_torch.analysis.rules import ALL_RULES
    assert __main__.main(["--rules"]) == 0 and len(ALL_RULES) == 5
    print("LINT " + json.dumps([dataclasses.astuple(f) for f in lint.lint_paths()]))
""")

# a small serve, and two small train steps with a failure drill (a step that
# fails and resumes from its checkpoint, as chip_smoke.py's [train] runs),
# through the entry points with the collector off; then one collection that
# keeps what it finds
_GARBAGE = textwrap.dedent("""
    import gc, json, shutil, sys, tempfile
    import torch
    from repro_torch.launch import serve, train
    assert "torch._dynamo" not in sys.modules
    ckpt = tempfile.mkdtemp()
    out = {}
    for tag, call in (
            ("serve", lambda: serve.serve_lm(serve.parser().parse_args(
                ["--arch", "zamba2-1.2b", "--preset", "tiny", "--device", "cpu",
                 "--gen", "2", "--batch", "1", "--prompt-len", "16"]))),
            ("train", lambda: train.main(
                ["--task", "lm", "--arch", "zamba2-1.2b", "--preset", "tiny",
                 "--steps", "2", "--device", "cpu", "--batch", "1", "--seq", "32",
                 "--ckpt-dir", ckpt, "--ckpt-every", "1", "--fail-at", "1"]))):
        gc.collect()
        gc.disable()
        gc.set_debug(gc.DEBUG_SAVEALL)
        res = call()
        del res
        gc.collect()
        out[tag] = [list(t.shape) for t in gc.garbage if isinstance(t, torch.Tensor)]
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    shutil.rmtree(ckpt)
    print("GARBAGE " + json.dumps(out))
""")


def _env() -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    env.pop("PYTHONHASHSEED", None)
    return env


@pytest.fixture(scope="module", autouse=True)
def background():
    """Start ``run_all`` on a thread and the two subprocesses as the module's
    first test begins."""
    procs = {name: subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                    text=True)
             for name, code in (("lint", _LINT), ("garbage", _GARBAGE))}
    box: dict = {}

    def run():
        try:
            box["findings"] = dispatch_check.run_all(device="cpu", mesh_world=2)
        except BaseException as e:        # re-raised by the reading test
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()
    yield dict(procs=procs, run_all=(th, box), out={})
    th.join()
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _run_all_findings(background) -> list:
    th, box = background["run_all"]
    th.join(SUBPROCESS_TIMEOUT)
    assert not th.is_alive(), "run_all did not finish"
    if "error" in box:
        raise box["error"]
    return box["findings"]


def _finish(background, name: str) -> tuple[int, str, str]:
    """A subprocess's (exit code, stdout, stderr), read once."""
    got = background["out"]
    if name not in got:
        proc = background["procs"][name]
        out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT)
        got[name] = (proc.returncode, out, err)
    return got[name]


@pytest.fixture(scope="module")
def tree_lint(background) -> list:
    """The lint of the tree (the CLI's default roots), from the subprocess
    that imports the package with jax and repro blocked."""
    code, out, err = _finish(background, "lint")
    assert code == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("LINT "))
    return [PortFinding(*f) for f in json.loads(line[len("LINT "):])]


# --------------------------------------------------------------------- #
# the device-free parts, against the reference                           #
# --------------------------------------------------------------------- #
FINDINGS = [
    ("precision-accumulate", "src/x.py", 12, "einsum without f32", "y = a @ b"),
    ("trace-check", "<trace:factorize>", 0, "host sync", "aten.mm: x"),
    ("rng-discipline", "src/y.py", 3, 'quote " and \\ slash', ""),
]


@pytest.mark.parametrize("fields", FINDINGS)
def test_finding_render_matches_reference(fields):
    assert PortFinding(*fields).render() == RefFinding(*fields).render()


def _entries():
    return [dict(rule="r-1", path="src/a.py", line_content='x = "q" \\ 1',
                 reason="a reason\twith a tab"),
            dict(rule="r-2", path="<trace:e>", line_content="aten.mm: y", reason="why")]


def test_baseline_dump_and_load_match_reference_both_ways(tmp_path):
    port_file, ref_file = tmp_path / "port.toml", tmp_path / "ref.toml"
    port_baseline.dump(_entries(), str(port_file))
    ref_baseline.dump(_entries(), str(ref_file))
    port_text, ref_text = port_file.read_text(), ref_file.read_text()
    # byte for byte, but for the package named in the header
    assert port_text == ref_text.replace("repro.analysis", "repro_torch.analysis")
    assert port_baseline.load(str(ref_file)) == ref_baseline.load(str(ref_file)) == _entries()
    assert ref_baseline.load(str(port_file)) == port_baseline.load(str(port_file)) == _entries()


@pytest.mark.parametrize("text", [
    "[[suppress]]\nrule = \"r\"\npath = \"p\"\nline_content = \"l\"\n",   # no reason
    "[[suppress]]\nrule = 'r'\n",                                         # bad quote
    "rule = \"r\"\n[table]\n",                                           # unsupported
])
def test_baseline_load_errors_match_reference(tmp_path, text):
    path = tmp_path / "bad.toml"
    path.write_text(text)
    errs = []
    for mod in (port_baseline, ref_baseline):
        with pytest.raises(ValueError) as exc:
            mod.load(str(path))
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


def test_baseline_partition_and_from_findings_match_reference():
    fields = [("r-1", "src/a.py", 3, "m", 'x = "q" \\ 1'), ("r-1", "src/a.py", 9, "m", "z"),
              ("r-2", "<trace:e>", 0, "m", "aten.mm: y"), ("r-2", "<trace:e>", 0, "m2", "aten.mm: y")]
    entries = _entries() + [dict(rule="r-3", path="p", line_content="c", reason="stale")]
    got = port_baseline.partition([PortFinding(*f) for f in fields], entries)
    want = ref_baseline.partition([RefFinding(*f) for f in fields], entries)
    for g, w in zip(got[:2], want[:2]):
        assert [dataclass_fields(f) for f in g] == [dataclass_fields(f) for f in w]
    assert got[2] == want[2] == entries[2:]
    assert port_baseline.from_findings([PortFinding(*f) for f in fields], "why") == \
        ref_baseline.from_findings([RefFinding(*f) for f in fields], "why")


def dataclass_fields(f) -> tuple:
    return (f.rule, f.path, f.line, f.message, f.line_content)


@pytest.mark.parametrize("lines,lineno", [
    (["a = 1  # lint: disable=precision-accumulate"], 1),
    (["# lint: disable=rule-a, rule-b", "x = y"], 2),
    (["#lint:disable=rule-a,rule-b", "x", "y"], 3),
    (["x = 1", "y = 2"], 2),
])
def test_disabled_rules_match_reference(lines, lineno):
    assert port_lint._disabled_rules(lines, lineno) == ref_lint._disabled_rules(lines, lineno)


def test_repo_root_matches_reference():
    assert port_lint.repo_root(FIXTURES) == ref_lint.repo_root(FIXTURES)


# --------------------------------------------------------------------- #
# layer 1: each rule catches its seeded fixture, exactly                 #
# --------------------------------------------------------------------- #
def _fixture(name: str):
    rel = f"tests/torch_analysis_fixtures/{name}"
    findings = port_lint.lint_file(os.path.join(ROOT, rel), rel, explicit=True)
    with open(os.path.join(ROOT, rel), encoding="utf-8") as fh:
        expected = {i for i, line in enumerate(fh, 1) if "VIOLATION" in line
                    and ("# VIOLATION" in line or "// VIOLATION" in line)}
    return findings, expected


@pytest.mark.parametrize("name,rule", [
    ("precision_bad.py", "precision-accumulate"),
    ("mma_bad.cu", "precision-accumulate"),
    ("host_sync_bad.py", "host-sync-in-hot-path"),
    ("tracer_branch_bad.py", "python-branch-on-tensor"),
    ("prng_bad.py", "rng-discipline"),
])
def test_rule_catches_seeded_fixture(name, rule):
    findings, expected = _fixture(name)
    assert expected, f"{name} has no VIOLATION markers"
    assert {f.line for f in findings} == expected, [f.render() for f in findings]
    assert all(f.rule == rule for f in findings), [f.rule for f in findings]


def test_clean_fixture_has_no_findings():
    findings, _ = _fixture("clean.py")
    assert findings == [], [f.render() for f in findings]


def test_rule_table_names_the_reference_rules(capsys):
    ref_names = {"precision-accumulate", "host-sync-in-traced", "retrace-knob",
                 "prng-key-reuse", "python-branch-on-tracer"}
    assert {getattr(r, "REFERENCE_NAME", r.NAME) for r in ALL_RULES} == ref_names
    assert port_main(["--rules"]) == 0
    out = capsys.readouterr().out
    assert all(name in out for name in ref_names)
    assert all(r.SCOPE[0].startswith("src/repro_torch") for r in ALL_RULES)


# --------------------------------------------------------------------- #
# the hot set against the reference's traced functions                   #
# --------------------------------------------------------------------- #
@functools.cache
def _defs(path: str) -> dict:
    """qualified name -> def of every function of a module."""
    with open(os.path.join(ROOT, path), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    names = _common.qualnames(tree)
    return {names[id(fn)]: fn for fn in ast.walk(tree)
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))}


def test_hot_functions_cover_the_references_traced_functions():
    hot = {}
    for path, qual in _common.HOT_FUNCTIONS:
        hot.setdefault(path, set()).add(qual.rsplit(".", 1)[-1])
    missing, checked = [], 0
    for abs_path in ref_lint.iter_python_files(["src/repro"], ROOT):
        rel = os.path.relpath(abs_path, ROOT).replace(os.sep, "/")
        with open(abs_path, encoding="utf-8") as fh:
            traced = ref_common.traced_functions(ast.parse(fh.read()))
        twin = rel.replace("src/repro/", "src/repro_torch/", 1)
        if not os.path.exists(os.path.join(ROOT, twin)):
            continue
        port_names = {q.rsplit(".", 1)[-1] for q in _defs(twin)}
        for fn in traced:
            if isinstance(fn, ast.Lambda) or fn.name not in port_names:
                continue
            checked += 1
            if fn.name not in hot.get(twin, set()):
                missing.append((twin, fn.name))
    assert checked >= 8 and not missing, missing


def test_hot_functions_name_existing_defs():
    stale = [(p, q) for p, q in _common.HOT_FUNCTIONS if q not in _defs(p)]
    assert not stale, stale


# --------------------------------------------------------------------- #
# the tree, the CLI and layer 2                                          #
# --------------------------------------------------------------------- #
def test_cli_exit_codes_match_reference(tmp_path, capsys):
    bad_toml = tmp_path / "bad.toml"
    bad_toml.write_text("[table]\n")
    cases = [
        ([os.path.join(FIXTURES, "clean.py")], [os.path.join(REF_FIXTURES, "clean.py")], 0),
        ([os.path.join(FIXTURES, "prng_bad.py")],
         [os.path.join(REF_FIXTURES, "viol_prng.py")], 1),
        ([os.path.join(FIXTURES, "clean.py"), "--baseline", str(bad_toml)],
         [os.path.join(REF_FIXTURES, "clean.py"), "--baseline", str(bad_toml)], 2),
        (["--rules"], ["--rules"], 0),
    ]
    for port_argv, ref_argv, code in cases:
        assert port_main(port_argv) == code == ref_main(ref_argv), port_argv
    for main in (port_main, ref_main):
        with pytest.raises(SystemExit) as exc:
            main(["--no-such-flag"])
        assert exc.value.code == 2
    capsys.readouterr()


def test_cli_write_baseline_suppresses_what_it_wrote(tmp_path, capsys):
    bad = os.path.join(FIXTURES, "precision_bad.py")
    path = str(tmp_path / "baseline.toml")
    assert port_main([bad, "--write-baseline", "--baseline", path]) == 0
    assert port_main([bad, "--baseline", path]) == 0
    assert "10 suppressed" in capsys.readouterr().out


def test_check_without_a_card_exits_2(capsys):
    assert not torch.cuda.is_available()
    assert port_main([os.path.join(FIXTURES, "clean.py"), "--check"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_package_imports_neither_jax_nor_repro():
    pkg = os.path.join(ROOT, "src", "repro_torch", "analysis")
    for abs_path in port_lint.iter_python_files([pkg], ROOT):
        with open(abs_path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (abs_path, m)


# --------------------------------------------------------------------- #
# layer 2's walkers against the reference's                             #
# --------------------------------------------------------------------- #
def _walk(fn) -> list[dispatch_check.OpRecord]:
    rec = dispatch_check.Recorder()
    with rec:
        fn()
    return rec.ops


def test_downcast_walker_flags_a_bf16_product_as_the_reference_does():
    a = torch.ones((8, 8), dtype=torch.bfloat16)
    assert dispatch_check.dtype_downcasts(_walk(lambda: a @ a))
    assert dispatch_check.dtype_downcasts(_walk(lambda: torch.einsum("ij,jk->ik", a, a)))
    assert not dispatch_check.dtype_downcasts(_walk(lambda: a.float() @ a.float()))
    aj = jnp.zeros((8, 8), jnp.bfloat16)
    assert jaxpr_check.dtype_downcasts(jax.make_jaxpr(lambda x: x @ x)(aj))
    assert not jaxpr_check.dtype_downcasts(jax.make_jaxpr(
        lambda x: jax.lax.dot(x, x, preferred_element_type=jnp.float32))(aj))


def test_sync_walker_flags_item_as_the_reference_flags_a_callback():
    x = torch.arange(6.0)
    assert dispatch_check.host_syncs(_walk(lambda: x.sum().item()))
    assert dispatch_check.host_syncs(_walk(lambda: x[x > 2]))
    assert dispatch_check.host_syncs(_walk(lambda: torch.linalg.cholesky(torch.eye(3))))
    assert not dispatch_check.host_syncs(_walk(lambda: torch.where(x > 2, x, 0.0)))
    assert not dispatch_check.host_syncs(_walk(lambda: torch.linalg.cholesky_ex(torch.eye(3))))
    xj = jnp.zeros(3)
    assert jaxpr_check.host_callbacks(jax.make_jaxpr(lambda v: jax.pure_callback(
        lambda u: u, jax.ShapeDtypeStruct(v.shape, v.dtype), v))(xj))
    assert not jaxpr_check.host_callbacks(jax.make_jaxpr(lambda v: v * 2)(xj))


def test_probe_reports_through_findings():
    out: list = []
    a = torch.ones((4, 4), dtype=torch.bfloat16)
    dispatch_check.probe("seeded", lambda: (a @ a).sum().item(), torch.device("cpu"), out)
    assert {f.path for f in out} == {"<trace:seeded>"}
    assert len(out) == 2 and all(f.line_content for f in out)


# --------------------------------------------------------------------- #
# the fixes, against the reference                                       #
# --------------------------------------------------------------------- #
def test_leaf_factors_give_the_references_nan_where_cholesky_fails():
    from repro.core import factorization as ref_fac
    from repro_torch.core import factorization as port_fac

    r = np.random.default_rng(3)
    m, k = 6, 2
    a = r.normal(size=(3, m, m)).astype(np.float32)
    d = np.einsum("bij,bkj->bik", a, a) + m * np.eye(m, dtype=np.float32)
    d[1] -= 4 * m * np.eye(m, dtype=np.float32)          # block 1 indefinite
    u = r.normal(size=(3, m, k)).astype(np.float32)
    want = [np.asarray(t) for t in jax.jit(ref_fac._leaf_factors)(jnp.asarray(d),
                                                                  jnp.asarray(u))]
    got = [t.numpy() for t in port_fac._leaf_factors(torch.from_numpy(d), torch.from_numpy(u))]
    for g, w in zip(got, want):
        assert np.array_equal(np.isnan(g), np.isnan(w))
        assert np.isnan(w[1]).all() and not np.isnan(w[[0, 2]]).any()
        np.testing.assert_allclose(g[[0, 2]], w[[0, 2]], rtol=1e-4, atol=1e-5)


def test_streamed_matvec_takes_bf16_as_the_reference_does():
    from repro.core.kernelfn import KernelSpec as RefSpec
    from repro.core.kernelfn import kernel_matvec_streamed as ref_mv
    from repro_torch.core.kernelfn import KernelSpec, kernel_matvec_streamed

    r = np.random.default_rng(5)
    xr, xc = r.normal(size=(40, 4)), r.normal(size=(64, 4))
    v = r.normal(size=(64, 3))
    bf = [torch.tensor(a, dtype=torch.bfloat16) for a in (xr, xc, v)]
    got = kernel_matvec_streamed(KernelSpec("gaussian", 1.0), *bf, block=16)
    want = np.asarray(ref_mv(RefSpec(h=1.0), *(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                                                 for t in bf), block=16))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    # each K entry may round to the neighbouring bf16 value (its f32 distance
    # differs by ulps): 2^-8 of |K| <= 1, times the coefficients
    bar = 2.0 ** -8 * np.abs(bf[2].float().numpy()).sum(0) + 1e-5
    assert (np.abs(got.numpy() - want) <= bar).all()


def test_tree_lints_clean_modulo_baseline(tree_lint, monkeypatch, capsys):
    new, _, _ = port_baseline.partition(tree_lint, port_baseline.load())
    assert not new, [f.render() for f in new]
    # python -m repro_torch.analysis on the tree: exit 0
    monkeypatch.setattr(port_cli, "lint_paths", lambda paths=None: list(tree_lint))
    assert port_main([]) == 0
    assert capsys.readouterr().out.startswith("clean")


def test_serve_and_train_leave_no_tensor_to_the_collector(background):
    code, out, err = _finish(background, "garbage")
    assert code == 0, err[-3000:]
    line = next(ln for ln in out.splitlines() if ln.startswith("GARBAGE "))
    assert json.loads(line[len("GARBAGE "):]) == {"serve": [], "train": []}


def test_run_all_on_cpu_is_clean_modulo_baseline(background, tree_lint, monkeypatch,
                                                 capsys):
    trace = _run_all_findings(background)
    new, suppressed, stale = port_baseline.partition(tree_lint + trace,
                                                     port_baseline.load())
    assert not new, [f.render() for f in new]
    assert not stale, stale
    assert {f.path for f in trace} >= {"<trace:mesh:fac>"}    # the mesh check ran
    # the CLI's --check on the same findings: exit 0, no stale warning
    monkeypatch.setattr(dispatch_check, "run_all", lambda device, **kw: list(trace))
    monkeypatch.setattr(port_cli, "lint_paths", lambda paths=None: list(tree_lint))
    assert port_main(["--check", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert out.out.startswith("clean") and "stale baseline entry" not in out.err


def test_package_imports_and_lints_with_jax_and_repro_blocked(tree_lint):
    assert all(f.path.startswith(("src/repro_torch/", "chip_smoke.py")) for f in tree_lint)
