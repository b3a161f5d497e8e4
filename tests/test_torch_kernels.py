"""The port's kernel modules against the JAX package, on the CPU.

Here every wrapper runs its plain PyTorch version (the tensors lie on the
CPU); the CUDA kernels themselves are held against those plain versions on
the card by ``chip_smoke.py``.  The JAX side runs its Pallas kernels in
interpret mode, as its own tests do, and its XLA twins.  Both sides work in
f32 with the same numpy inputs; matmuls run at "highest" precision.
"""
import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import idqr as jidqr
from repro.core.kernelfn import gaussian_block_xla, laplacian_block_xla
from repro.kernels.admm_update import ops as jaops
from repro.kernels.compress import laplacian as jlops
from repro.kernels.compress import ops as jcops
from repro.kernels.gaussian import ops as jgops
from repro_torch.kernels import _build
from repro_torch.kernels.admm_update import kernel as akern, ops as aops
from repro_torch.kernels.attention import kernel as attn_kern
from repro_torch.kernels.ssd import kernel as ssd_kern
from repro_torch.core import idqr, kernelfn as tkfn
from repro_torch.kernels.compress import kernel as ckern, laplacian as lops, ops as cops
from repro_torch.kernels.compress import ref as cref, verify
from repro_torch.kernels.gaussian import kernel as gkern, ops as gops
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

torch.set_float32_matmul_precision("highest")

REPO = pathlib.Path(__file__).resolve().parents[1]
ODD_SHAPES = [(1, 3, 2), (255, 129, 5), (300, 7, 11)]


def _pair(ma, mb, f, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(ma, f)).astype(dtype),
            rng.normal(size=(mb, f)).astype(dtype))


# ---------------------------------------------------------------- K1 ---- #
@pytest.mark.parametrize("ma,mb,f", ODD_SHAPES)
@pytest.mark.parametrize("h", [0.7, 3.0])
def test_gaussian_matches_xla_and_pallas_odd_shapes(ma, mb, f, h):
    """Same tolerance as the JAX package's own Pallas-vs-XLA parity test:
    f32 sums of 2-11 terms in another order, K in [0, 1]."""
    a, b = _pair(ma, mb, f, 1000 * ma + mb)
    out = gops.gaussian_block(torch.as_tensor(a), torch.as_tensor(b), h).numpy()
    xla = np.asarray(gaussian_block_xla(jnp.asarray(a), jnp.asarray(b), h))
    pallas = np.asarray(jgops.gaussian_block(jnp.asarray(a), jnp.asarray(b), h,
                                             interpret=True))
    assert out.shape == (ma, mb) and out.dtype == np.float32
    np.testing.assert_allclose(out, xla, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-6)


def test_gaussian_batched_equals_per_block():
    """The batched (B, ·, f) call is one block per batch entry."""
    rng = np.random.default_rng(5)
    xa = torch.as_tensor(rng.normal(size=(3, 17, 4)).astype(np.float32))
    xb = torch.as_tensor(rng.normal(size=(3, 9, 4)).astype(np.float32))
    out = gops.gaussian_block(xa, xb, 1.2)
    for i in range(3):
        torch.testing.assert_close(out[i], gops.gaussian_block(xa[i], xb[i], 1.2),
                                   rtol=0, atol=0)


def test_gaussian_bf16_stores_bf16_from_f32_math():
    """bf16 in, bf16 out; distances in f32, so the only error is the final
    bf16 rounding of K in [0, 1] (half an ulp at 1 is 2^-9)."""
    a, b = _pair(64, 40, 8, 0)
    a16 = torch.as_tensor(a).to(torch.bfloat16)
    b16 = torch.as_tensor(b).to(torch.bfloat16)
    out = gops.gaussian_block(a16, b16, 1.0)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(gaussian_block_xla(jnp.asarray(a16.float().numpy()),
                                        jnp.asarray(b16.float().numpy()), 1.0))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=2 ** -8)


# ---------------------------------------------------------------- K2 ---- #
@pytest.mark.parametrize("b,m,s,f,k", [
    (3, 50, 37, 5, 12),     # odd everything
    (1, 7, 3, 2, 3),        # tiny, k > s
    (4, 129, 65, 11, 16),   # crosses the TPU's 128-lane boundary
])
def test_assemble_id_matches_pallas_and_idqr(b, m, s, f, k):
    """Plain version + finish_interp against the fused Pallas kernel
    (interpret) and against idqr.row_interp_decomp of the XLA block: pivots
    exactly equal (greedy CPQR is deterministic on non-degenerate blocks),
    interpolation matrices to 1e-5 of their largest entry (f32 reorderings
    through k Gram-Schmidt steps and one triangular solve)."""
    rng = np.random.default_rng(b * m + s + k)
    xc = rng.normal(size=(b, m, f)).astype(np.float32)
    xp = rng.normal(size=(b, s, f)).astype(np.float32)
    h = 1.3
    piv, pmat, ranks = cops.batched_assemble_id(
        torch.as_tensor(xc), torch.as_tensor(xp), k, h=h, rtol=1e-5)
    piv, pmat = piv.numpy(), pmat.numpy()
    assert piv.shape == (b, k) and pmat.shape == (b, m, k)
    assert ranks.tolist() == [k] * b
    jpiv, jp, _ = jcops.batched_assemble_id(
        jnp.asarray(xc), jnp.asarray(xp), k, kernel_name="gaussian", h=h,
        rtol=1e-5, adaptive=False, interpret=True)
    np.testing.assert_array_equal(piv, np.asarray(jpiv))
    scale = max(1.0, float(np.abs(np.asarray(jp)).max()))
    np.testing.assert_allclose(pmat, np.asarray(jp), rtol=0, atol=1e-5 * scale)
    for i in range(b):
        blk = gaussian_block_xla(jnp.asarray(xc[i]), jnp.asarray(xp[i]), h)
        rpiv, rp = jidqr.row_interp_decomp(blk, k)
        np.testing.assert_array_equal(piv[i], np.asarray(rpiv))
        np.testing.assert_allclose(pmat[i], np.asarray(rp), rtol=0, atol=1e-5 * scale)


def test_assemble_id_cmask_matches_pallas():
    """Dead candidates (cmask = 0) are zero rows of the sampled block: never
    pivots while live ones remain, same pivots as the Pallas kernel."""
    rng = np.random.default_rng(11)
    b, m, s, f, k = 2, 30, 20, 4, 6
    xc = rng.normal(size=(b, m, f)).astype(np.float32)
    xp = rng.normal(size=(b, s, f)).astype(np.float32)
    cmask = np.repeat((np.arange(m) < 20).astype(np.float32)[None], b, axis=0)
    piv, pmat, _ = cops.batched_assemble_id(
        torch.as_tensor(xc), torch.as_tensor(xp), k, h=1.0, rtol=1e-5,
        cmask=torch.as_tensor(cmask))
    jpiv, jp, _ = jcops.batched_assemble_id(
        jnp.asarray(xc), jnp.asarray(xp), k, kernel_name="gaussian", h=1.0,
        rtol=1e-5, adaptive=False, cmask=jnp.asarray(cmask), interpret=True)
    assert int(piv.max()) < 20
    np.testing.assert_array_equal(piv.numpy(), np.asarray(jpiv))
    np.testing.assert_allclose(pmat.numpy(), np.asarray(jp), rtol=0, atol=1e-5)


# ---------------------------------------------------------------- K4 ---- #
@pytest.mark.parametrize("ma,mb,f", ODD_SHAPES)
@pytest.mark.parametrize("h", [0.7, 3.0])
def test_laplacian_matches_xla_and_pallas_odd_shapes(ma, mb, f, h):
    """The tolerance of the JAX package's own laplacian parity test: f32
    L1 sums in another order (16-wide chunks in the XLA twin), and 1/h
    multiplied against divided by (an ulp of the exponent)."""
    a, b = _pair(ma, mb, f, 7 * ma + mb)
    out = lops.laplacian_block(torch.as_tensor(a), torch.as_tensor(b), h).numpy()
    xla = np.asarray(laplacian_block_xla(jnp.asarray(a), jnp.asarray(b), h))
    pallas = np.asarray(jlops.laplacian_block(jnp.asarray(a), jnp.asarray(b), h,
                                              interpret=True))
    assert out.shape == (ma, mb) and out.dtype == np.float32
    np.testing.assert_allclose(out, xla, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-6)


def test_laplacian_bf16_accumulates_in_f32_as_the_pallas_kernel():
    """bf16 in, bf16 out, against the reference's Pallas kernel (which
    upcasts to f32), not its XLA twin (which sums bf16 inputs in bf16).
    The L1 sums agree to f32 rounding, so the two bf16 outputs differ by at
    most one bf16 rounding step of K in (0, 1]: 2^-8."""
    a, b = _pair(96, 40, 8, 3)
    a16 = torch.as_tensor(a).to(torch.bfloat16)
    b16 = torch.as_tensor(b).to(torch.bfloat16)
    out = lops.laplacian_block(a16, b16, 2.0)
    assert out.dtype == torch.bfloat16
    pallas = jlops.laplacian_block(jnp.asarray(a, jnp.bfloat16),
                                   jnp.asarray(b, jnp.bfloat16), 2.0, interpret=True)
    assert pallas.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(pallas, np.float32),
                               rtol=0, atol=2 ** -8)


def test_laplacian_batched_and_kernel_block_dispatch():
    """The batched (B, ·, f) call is one block per batch entry, and
    kernel_block sends a laplacian spec to it."""
    rng = np.random.default_rng(6)
    xa = torch.as_tensor(rng.normal(size=(3, 17, 4)).astype(np.float32))
    xb = torch.as_tensor(rng.normal(size=(3, 9, 4)).astype(np.float32))
    out = tkfn.kernel_block(tkfn.KernelSpec("laplacian", 1.7), xa, xb)
    for i in range(3):
        torch.testing.assert_close(out[i], lops.laplacian_block(xa[i], xb[i], 1.7),
                                   rtol=0, atol=0)
    gauss = tkfn.kernel_block(tkfn.KernelSpec("gaussian", 1.7), xa, xb)
    assert not torch.allclose(out, gauss)


# ------------------------------------------------- K2, laplacian branch ---- #
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("b,m,s,f,k", [(3, 50, 37, 5, 12), (2, 64, 48, 8, 16)])
def test_assemble_id_laplacian_matches_pallas(adaptive, b, m, s, f, k):
    """The plain laplacian branch + finish_interp against the Pallas kernel
    (interpret), with dead candidates: ranks equal, live pivots (slot <
    rank; all k at fixed rank) equal, P to 1e-5 of its largest entry.  The
    pivots past a node's rank are chosen among residual columns at f32
    noise level, so two implementations may pick different ones there;
    they carry no skeleton (their P columns are 0)."""
    rng = np.random.default_rng(b * m + s + k + adaptive)
    # Adaptive: candidates and proxies in two clusters (spread 0.3) a unit
    # apart in every feature — the far field, where the laplacian kernel is
    # nearly separable and the crude tolerance truncates the rank.  Fixed
    # rank: one spread-1 cloud, where all k directions stand well above the
    # f32 noise that a near-singular solve would amplify.
    spread, offset = (0.3, 1.0) if adaptive else (1.0, 0.0)
    xc = (spread * rng.normal(size=(b, m, f))).astype(np.float32)
    xp = (spread * rng.normal(size=(b, s, f)) + offset).astype(np.float32)
    cmask = np.ones((b, m), np.float32)
    cmask[0, m - m // 3:] = 0.0          # node 0: its last third is dead
    cmask[-1, ::5] = 0.0                 # last node: scattered dead slots
    h, rtol = 2.0, 1e-2 if adaptive else 1e-5
    piv, pmat, ranks = cops.batched_assemble_id(
        torch.as_tensor(xc), torch.as_tensor(xp), k, h=h, rtol=rtol,
        kernel_name="laplacian", adaptive=adaptive, cmask=torch.as_tensor(cmask))
    jpiv, jp, jranks = jcops.batched_assemble_id(
        jnp.asarray(xc), jnp.asarray(xp), k, kernel_name="laplacian", h=h,
        rtol=rtol, adaptive=adaptive, cmask=jnp.asarray(cmask), interpret=True)
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jranks))
    live = np.arange(k)[None, :] < ranks.numpy()[:, None]
    np.testing.assert_array_equal(piv.numpy()[live], np.asarray(jpiv)[live])
    if adaptive:
        assert int(ranks.min()) < k        # the tolerance truncates here
    scale = max(1.0, float(np.abs(np.asarray(jp)).max()))
    np.testing.assert_allclose(pmat.numpy(), np.asarray(jp), rtol=0, atol=1e-5 * scale)
    assert not np.isin(piv[0].numpy(), np.arange(m - m // 3, m)).any()


# ---------------------------------------------------------------- K3 ---- #
@pytest.mark.parametrize("kernel_name,h,rtol", [
    ("gaussian", 1.0, None), ("gaussian", 1.0, 1e-4), ("laplacian", 2.0, 1e-2)])
def test_compare_row_ids_tells_rounding_ties_from_wrong_pivots(kernel_name, h, rtol):
    """``verify.compare_row_ids``, which holds K2 against its plain version
    on the card.  Mirrored data (candidates ±c, proxies ±p) make every
    candidate tie exactly with its mirror image: the mirrored run (pivots
    mapped to their mirrors, R's columns with them) differs on every node
    from the first step, and each difference must read as a tie with an
    equally good skeleton, and the mirrored run as a greedy pivoted QR.  The
    plain version under another summation order (proxy rows permuted) must
    read the same.  A pivot swapped for the weakest candidate must not."""
    b, m2, s2, f, k = 4, 40, 24, 2, 12
    rng = np.random.default_rng(5)
    c = torch.as_tensor(rng.normal(size=(b, m2, f)).astype(np.float32))
    p = torch.as_tensor(rng.normal(size=(b, s2, f)).astype(np.float32))
    xc, xp = torch.cat([c, -c], 1), torch.cat([p, -p], 1)
    cmask = torch.ones(xc.shape[:2])
    piv, r = cref.fused_assemble_id_ref(xc, xp, cmask, k, h, kernel_name)
    twin = torch.cat([torch.arange(m2, 2 * m2), torch.arange(m2)])
    rep = verify.compare_row_ids(xc, xp, cmask, h, kernel_name, rtol,
                                 twin[piv.long()].to(torch.int32), r[:, :, twin], piv, r)
    assert rep["mismatches"] == b and rep["untied"] == 0
    assert rep["off_greedy"] == 0 and rep["worst_ratio"] <= 1 + 1e-6
    perm = torch.as_tensor(rng.permutation(2 * s2))
    piv_p, r_p = cref.fused_assemble_id_ref(xc, xp[:, perm].contiguous(), cmask, k, h,
                                            kernel_name)
    rep = verify.compare_row_ids(xc, xp, cmask, h, kernel_name, rtol, piv_p, r_p, piv, r)
    assert rep["untied"] == 0 and rep["off_greedy"] == 0 and rep["r_err"] <= 1e-5
    wrong = piv.clone()
    weakest = cref._assemble(xc[1:2], xp[1:2], h, kernel_name)[0].norm(dim=1).argmin()
    wrong[1, 0] = int(weakest)
    rep = verify.compare_row_ids(xc, xp, cmask, h, kernel_name, rtol, wrong, r, piv, r)
    assert rep["mismatches"] == 1 and rep["untied"] == 1 and rep["off_greedy"] == 1


def test_compare_row_ids_widens_ties_by_the_assembly_error_on_dense_nodes():
    """Dense 2-feature nodes (candidates in a 0.1 box at |x| ~ 6, h 1, as a
    leaf of 10^6 uniform points sits): the f32 norm expansion of the plain
    version errs by ~eps·|x|² an entry, and its pivots leave the f64 greedy
    ones beyond the deflation-only error bars on some nodes (measured 9 of
    200).  With each column's assembly error in its bars none does, and a
    pivot swapped for the weakest candidate still reads as wrong."""
    rng = np.random.default_rng(0)
    b, m, s, k, h = 200, 256, 64, 32, 1.0
    ang = rng.uniform(0, 2 * np.pi, b)
    centre = 6.0 * np.stack([np.cos(ang), np.sin(ang)], 1)[:, None, :]
    xc = torch.as_tensor((centre + rng.uniform(-0.05, 0.05, (b, m, 2))).astype(np.float32))
    xp = torch.as_tensor(np.concatenate(
        [centre + rng.uniform(-0.15, 0.15, (b, s // 2, 2)),
         rng.uniform(-7.0, 7.0, (b, s // 2, 2))], 1).astype(np.float32))
    cmask = torch.ones(b, m)
    piv, r = cref.fused_assemble_id_ref(xc, xp, cmask, k, h, "gaussian")
    a64 = torch.exp(-torch.cdist(xp.double(), xc.double()) ** 2 / (2 * h * h))
    p64, q64 = idqr.cpqr_select(a64, k)
    exact = (p64, (q64.transpose(1, 2) @ a64).float())
    rep = verify.compare_row_ids(xc, xp, cmask, h, "gaussian", 1e-2, piv, r, *exact)
    assert rep["untied"] > 0 and rep["off_greedy"] > 0
    assert rep["untied_asm"] == 0 and rep["off_greedy_asm"] == 0
    wrong = exact[0].clone()
    wrong[1, 0] = int(a64[1].norm(dim=0).argmin())
    rep = verify.compare_row_ids(xc, xp, cmask, h, "gaussian", 1e-2, wrong, exact[1], *exact)
    assert rep["mismatches"] == 1 and rep["untied_asm"] == 1 and rep["off_greedy_asm"] == 1


@pytest.mark.parametrize("n", [128, 1000, 4097])
@pytest.mark.parametrize("beta", [1.0, 100.0, 1e4])
def test_zmu_update_matches_pallas(n, beta):
    """The plain version divides by beta, the Pallas kernel multiplies by
    1/beta: z to 1e-6 (it is O(1)), μ⁺ relative to its size."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=n).astype(np.float32)
    mu = (beta * rng.normal(size=n)).astype(np.float32)
    c = (np.abs(rng.normal(size=n)) + 0.1).astype(np.float32)
    z, mu_new = aops.fused_zmu_update(*(torch.as_tensor(a) for a in (x, mu, c)), beta)
    jz, jmu = jaops.fused_zmu_update(*(jnp.asarray(a) for a in (x, mu, c)), beta,
                                     interpret=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mu_new.numpy(), np.asarray(jmu), rtol=1e-5,
                               atol=1e-6 * beta)


# ----------------------------------------------- launch and build rules ---- #
@pytest.mark.parametrize("launch", [
    lambda t: gkern.gaussian_block_cuda(t[None], t[None], 1.0),
    lambda t: ckern.fused_assemble_id_cuda(t[None], t[None], torch.ones(1, 4), 2, 1.0),
    lambda t: ckern.fused_assemble_id_cuda(t[None], t[None], torch.ones(1, 4), 2, 1.0,
                                           "laplacian"),
    lambda t: akern.fused_zmu_update_cuda(t[:, 0].contiguous(), t[:, 0].contiguous(),
                                          t[:, 0].contiguous(), 1.0),
    lambda t: lops.laplacian_block_cuda(t[None], t[None], 1.0),
    lambda t: attn_kern.flash_attention_cuda(t[None, None], t[None, None], t[None, None]),
    lambda t: ssd_kern.ssd_chunk_cuda(t[None, :, None], t[None, :, :1], t[0, :1],
                                      t[None, :, None], t[None, :, None], t[0, :1], 4),
], ids=["gaussian_block", "fused_assemble_id", "fused_assemble_id_laplacian",
        "zmu_update", "laplacian_block", "flash_attention", "ssd_chunk"])
def test_kernel_launchers_refuse_cpu_tensors(launch):
    """A launcher takes CUDA tensors only: on anything else it raises before
    building or launching, and its launch count does not move."""
    before = dict(_build.launch_counts)
    with pytest.raises(ValueError):
        launch(torch.zeros(4, 3))
    assert _build.launch_counts == before


def test_every_kernel_source_exists_and_builds_into_ignored_dir():
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file(), name
    rel = _build.BUILD_DIR.relative_to(REPO)
    ignored = (REPO / ".gitignore").read_text().split()
    assert f"{rel.parts[0]}/" in ignored


def test_port_imports_neither_jax_nor_repro():
    """src/repro_torch stands alone: no module imports jax or repro."""
    offenders = []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.name}: {n}" for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not offenders, offenders
