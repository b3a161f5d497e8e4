"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``: without a card every test here skips.  On a GPU machine
with nvcc, from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only, so it runs where jax is absent.
Tolerances are those of ``chip_smoke.py``, with their reasons there.
"""
import ctypes
import math
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import idqr
from repro_torch.kernels import _build, pairwise
from repro_torch.kernels.admm_update import ops as aops, ref as aref
from repro_torch.kernels.attention import kernel as attn_kern, ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.ssd import kernel as ssd_kern, ops as ssd_ops, ref as ssd_ref
from repro_torch.kernels.compress import kernel as ckern, laplacian as lops, ref as cref
from repro_torch.kernels.gaussian import kernel as gkern, ops as gops, ref as gref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dev, seed):
    return torch.randn(shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.parametrize("b,ma,mb,f", [
    (1, 3, 2, 2), (3, 255, 129, 5), (2, 300, 7, 11),
    (70_000, 5, 3, 8),          # batch above 65535: still one launch (a call is one)
])
def test_gaussian_block_kernel_matches_plain(dev, b, ma, mb, f):
    xa, xb = _randn((b, ma, f), dev, 0), _randn((b, mb, f), dev, 1)
    before = _build.launch_counts["gaussian_block"]
    out = gops.gaussian_block(xa, xb, 0.9)
    assert _build.launch_counts["gaussian_block"] == before + 1
    assert out.shape == (b, ma, mb)
    assert (out - gref.gaussian_block_ref(xa, xb, 0.9)).abs().max().item() <= 2e-5


@pytest.mark.parametrize("b,m,s,f,k", [(5, 64, 48, 8, 12), (3, 100, 37, 3, 8)])
def test_fused_assemble_id_kernel_matches_plain(dev, b, m, s, f, k):
    xc, xp = _randn((b, m, f), dev, 2), _randn((b, s, f), dev, 3)
    cmask = torch.ones((b, m), device=dev)
    cmask[0, m // 2:] = 0.0
    piv, r = ckern.fused_assemble_id_cuda(xc, xp, cmask, k, 1.0)
    piv_ref, r_ref = cref.fused_assemble_id_ref(xc, xp, cmask, k, 1.0)
    assert torch.equal(piv, piv_ref)
    assert (r - r_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,m,s,f,k", [(4, 64, 48, 8, 12), (3, 100, 37, 3, 8)])
def test_fused_assemble_id_laplacian_with_dead_slots(dev, b, m, s, f, k):
    """K2's laplacian branch with dead candidates on two nodes."""
    xc, xp = _randn((b, m, f), dev, 6), _randn((b, s, f), dev, 7)
    cmask = torch.ones((b, m), device=dev)
    cmask[0, m // 3:] = 0.0
    cmask[-1, ::4] = 0.0
    piv, r = ckern.fused_assemble_id_cuda(xc, xp, cmask, k, 2.0, "laplacian")
    piv_ref, r_ref = cref.fused_assemble_id_ref(xc, xp, cmask, k, 2.0, "laplacian")
    assert torch.equal(piv, piv_ref)
    assert (r - r_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_fused_assemble_id_each_cluster_size(dev, cluster, kind):
    """K2 with each cluster size forced, dead candidates on one node: the
    same pivots and R as the plain version whichever CTA owns a column."""
    b, m, s, f, k = 5, 64, 48, 8, 12
    xc, xp = _randn((b, m, f), dev, 12), _randn((b, s, f), dev, 13)
    cmask = torch.ones((b, m), device=dev)
    cmask[1, ::3] = 0.0
    piv, r = ckern.fused_assemble_id_cuda(xc, xp, cmask, k, 1.5, kind, cluster=cluster)
    piv_ref, r_ref = cref.fused_assemble_id_ref(xc, xp, cmask, k, 1.5, kind)
    assert torch.equal(piv, piv_ref)
    assert (r - r_ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_fused_assemble_id_exact_tie_takes_the_lowest_index(dev, cluster):
    """Three identical candidate columns (5, 40, 63: in different CTAs for
    C >= 2) made the largest of each block: the first pivot is 5 on every
    node, as jnp.argmax breaks ties."""
    b, m, s, f, k = 4, 64, 48, 3, 8
    xc = 3.0 * _randn((b, m, f), dev, 14)
    xp = _randn((b, s, f), dev, 15)
    norms = cref._assemble(xc, xp, 1.0, "gaussian").square().sum(-1)     # (b, m)
    best = norms.argmax(1)
    top = xc[torch.arange(b, device=dev), best].clone()
    xc[torch.arange(b, device=dev), best] = 100.0        # its own column falls to 0
    for j in (5, 40, 63):
        xc[:, j] = top
    cmask = torch.ones((b, m), device=dev)
    piv, r = ckern.fused_assemble_id_cuda(xc, xp, cmask, k, 1.0, cluster=cluster)
    piv_ref, _ = cref.fused_assemble_id_ref(xc, xp, cmask, k, 1.0)
    assert piv[:, 0].tolist() == [5] * b
    assert torch.equal(piv, piv_ref)


def test_fused_assemble_id_plans_fit_the_card(dev):
    """At the K2 shapes of the three paths and each cluster size that the
    planner allows, the kernel's shared-memory count is the planner's, the
    card holds such a cluster (cudaOccupancyMaxActiveClusters), and one CTA
    a node runs as many CTAs an SM as the planner counts (ckern.ctas_per_sm)."""
    d = torch.cuda.current_device()
    for b, m, s, k in ((4096, 256, 64, 32), (2048, 64, 96, 32), (4096, 256, 192, 64),
                       (2048, 128, 256, 64), (2, 128, 256, 64)):
        for c, tpc, rreg in ckern.feasible(m, s, k, b):
            assert ckern.kernel_smem_bytes(m, s, k, c, tpc, rreg) == ckern.smem_bytes(
                m, s, k, c, tpc, rreg)
            n_sm = torch.cuda.get_device_properties(d).multi_processor_count
            for kind in ("gaussian", "laplacian"):
                active = ckern.max_active_clusters(m, s, k, c, tpc, rreg, d, kind)
                assert active >= 1, (m, s, k, c)
                if c == 1:
                    assert active >= ckern.ctas_per_sm(m, s, k, c, tpc, rreg) * n_sm, (
                        m, s, k, active)


@pytest.mark.parametrize("f", [2, 8])
def test_fused_assemble_id_at_the_accurate_leaf(dev, f):
    """The accurate preset's leaf (m=256, s=192, k=64), whose residual and
    Q (255 KB) fit no single CTA's shared memory: one CTA a node keeps 32
    rows of the residual in registers, clusters of 2, 4 and 8 keep it all in
    shared memory; no global scratch either way.  At each cluster size, as
    the adaptive build uses it: ranks at rtol 1e-4
    equal, pivots equal on the live slots (slot < rank) and R equal on the
    live rows.  With two features, as the accurate path's circles have, the
    rank of these blocks is ~45-53 of 64: past it |R_ii| is at f32 noise and
    the pivots are chosen by rounding; they are dead slots, which the build
    zeroes.  With eight features every slot is live."""
    b, m, s, k, rtol = 6, 256, 192, 64, 1e-4
    assert ckern.plan(4096, m, s, k) == (1, 2, ckern.REG_ROWS)
    assert ckern.kernel_smem_bytes(m, s, k, 1, 2, ckern.REG_ROWS) == ckern.smem_bytes(
        m, s, k, 1, 2, ckern.REG_ROWS) == 220_864
    xc, xp = _randn((b, m, f), dev, 8), _randn((b, s, f), dev, 9)
    cmask = torch.ones((b, m), device=dev)
    piv_ref, r_ref = cref.fused_assemble_id_ref(xc, xp, cmask, k, 1.0)
    _, rank_ref = idqr.finish_interp(piv_ref, r_ref, rtol, keep_identity=False)
    for c, _, _ in ckern.feasible(m, s, k, 4096):
        piv, r = ckern.fused_assemble_id_cuda(xc, xp, cmask, k, 1.0, cluster=c)
        _, rank = idqr.finish_interp(piv, r, rtol, keep_identity=False)
        assert torch.equal(rank, rank_ref)
        assert int(rank.min()) >= (16 if f == 2 else k)
        live = torch.arange(k, device=dev)[None, :] < rank[:, None]
        assert torch.equal(piv[live], piv_ref[live])
        assert (r - r_ref)[live].abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,ma,mb,f,dtype", [
    (1, 3, 2, 2, torch.float32), (3, 255, 129, 5, torch.float32),
    (2, 300, 7, 11, torch.float32), (2, 96, 40, 8, torch.bfloat16),
    (70_000, 5, 3, 8, torch.float32),     # batch above 65535: one launch
])
def test_laplacian_block_kernel_matches_plain(dev, b, ma, mb, f, dtype):
    """K4 against its plain version: the same L1 sums in the same order, so
    only exp's last bits differ (bf16: one rounding step of K, 2^-8)."""
    xa = _randn((b, ma, f), dev, 10).to(dtype)
    xb = _randn((b, mb, f), dev, 11).to(dtype)
    before = _build.launch_counts["laplacian_block"]
    out = lops.laplacian_block(xa, xb, 1.3)
    assert _build.launch_counts["laplacian_block"] == before + 1
    assert out.shape == (b, ma, mb) and out.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2 ** -8
    err = (out.float() - cref.laplacian_block_ref(xa, xb, 1.3).float()).abs().max().item()
    assert err <= tol


# Each plan of the pairwise block forced at ragged shapes: Ma in {1, 2, 3,
# 15, 16, 17}, Mb off a multiple of 4 (and of 8), F in {1, 2, 5, 8, 11, 33},
# and batches above 65535 (one launch each).
_PLAN_CASES = [
    ("skinny", 3, 1, 1030, 1), ("skinny", 2, 2, 2049, 5),
    ("skinny", 1, 3, 1027, 8), ("skinny", 2, 15, 1500, 11),
    ("skinny", 1, 16, 1024, 33), ("skinny", 70_000, 2, 6, 8),
    ("packed", 3, 1, 7, 2), ("packed", 5, 17, 30, 5),
    ("packed", 4, 16, 64, 8), ("packed", 2, 32, 32, 11),
    ("packed", 3, 15, 33, 33), ("packed", 70_000, 5, 3, 8),
    ("wide", 1, 3, 2, 2), ("wide", 3, 255, 129, 5),
    ("wide", 2, 300, 7, 11), ("wide", 2, 17, 1027, 33),
    ("wide", 70_000, 5, 3, 8), ("wide", 2, 70, 136, 1),
    ("wide", 3, 255, 136, 5), ("wide", 2, 65, 264, 8),
    ("wide", 1, 16, 1024, 33), ("wide", 70_000, 5, 8, 2),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
@pytest.mark.parametrize("family,b,ma,mb,f", _PLAN_CASES)
def test_pairwise_each_plan_matches_plain(dev, family, b, ma, mb, f, kind, dtype):
    """K1 and K4 on each plan forced, against the plain version at the
    tolerances of chip_smoke.py (bf16: one rounding step of K, 2^-8); one
    launch counted a call."""
    xa = _randn((b, ma, f), dev, 20).to(dtype)
    xb = _randn((b, mb, f), dev, 21).to(dtype)
    launch, ref_fn, name = ((gkern.gaussian_block_cuda, gref.gaussian_block_ref, "gaussian_block")
                            if kind == "gaussian" else
                            (lops.laplacian_block_cuda, cref.laplacian_block_ref,
                             "laplacian_block"))
    assert pairwise.plan_for(xa, xb, family=family).family == family
    before = _build.launch_counts[name]
    out = launch(xa, xb, 1.3, family=family)
    assert _build.launch_counts[name] == before + 1
    assert out.shape == (b, ma, mb) and out.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2 ** -8
    assert (out.float() - ref_fn(xa, xb, 1.3).float()).abs().max().item() <= tol


@pytest.mark.parametrize("kind", ["gaussian", "laplacian"])
def test_pairwise_skinny_unaligned_support(dev, kind):
    """A support whose data pointer is off 16 bytes (a view at offset 1):
    the skinny plan drops its vector loads and agrees all the same."""
    buf = _randn((1 + 4099 * 8,), dev, 22)
    xb = buf[1:].view(1, 4099, 8)
    xa = _randn((1, 3, 8), dev, 23)
    p = pairwise.plan_for(xa, xb)
    assert p.family == "skinny" and not p.vec_load
    launch, ref_fn = ((gkern.gaussian_block_cuda, gref.gaussian_block_ref)
                      if kind == "gaussian" else (lops.laplacian_block_cuda,
                                                  cref.laplacian_block_ref))
    err = (launch(xa, xb, 0.7) - ref_fn(xa, xb, 0.7)).abs().max().item()
    assert err <= 2e-5


def test_pairwise_wide_at_a_misaligned_mb(dev):
    """Output rows off 16 bytes (Mb 130 in f32, 132 in bf16): the wide
    kernel stores every tile element by element and agrees with the plain
    version; a forced family that cannot take the shape raises before
    launching."""
    for mb, dtype in ((130, torch.float32), (132, torch.bfloat16)):
        xa = _randn((2, 70, 8), dev, 24).to(dtype)
        xb = _randn((2, mb, 8), dev, 25).to(dtype)
        assert pairwise.plan_for(xa, xb).family == "wide"
        out = gkern.gaussian_block_cuda(xa, xb, 1.0)
        tol = 2e-5 if dtype == torch.float32 else 2 ** -8
        err = (out.float() - gref.gaussian_block_ref(xa, xb, 1.0).float()).abs().max().item()
        assert err <= tol
        before = dict(_build.launch_counts)
        with pytest.raises(ValueError):
            gkern.gaussian_block_cuda(xa, xb, 1.0, family="skinny")
        assert _build.launch_counts == before


def test_pairwise_plans_smem_is_the_kernels_count(dev):
    """At the paths' shapes and each family that takes them, the planner's
    shared memory is the kernels' own count, within the card's limit."""
    limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for b, ma, mb, f in ((1, 2048, 2 ** 20, 8), (4096, 256, 256, 8), (2048, 32, 32, 8),
                         (1, 2, 2 ** 20, 8), (1, 128, 2 ** 20, 8), (16, 32, 32, 8),
                         (2048, 64, 64, 2), (3, 17, 1030, 33)):
        for dtype in (torch.float32, torch.bfloat16):
            for family in pairwise.FAMILIES:
                try:
                    p = pairwise.plan(b, ma, mb, f, dtype, family=family)
                except ValueError:
                    continue
                for name in ("gaussian_block", "laplacian_block"):
                    assert pairwise.kernel_smem_bytes(name, dtype.itemsize, p, ma, mb, f) \
                        == p.smem <= limit, (name, b, ma, mb, f, dtype, p)


def test_pairwise_skinny_launch_in_a_cuda_graph(dev):
    """A skinny launch (the serving loop's 2-row tick) captured in a CUDA
    graph and replayed on new queries equals the plain version.  The
    wrapper counts its one launch while capturing (the serving engine moves
    that count onto its replays)."""
    xb = _randn((1, 5000, 8), dev, 26)
    xa = _randn((1, 2, 8), dev, 27)
    assert pairwise.plan_for(xa, xb).family == "skinny"
    gops.gaussian_block(xa, xb, 1.1)                  # warm-up: the build, eager
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = _build.launch_counts["gaussian_block"]
    with torch.cuda.graph(graph):
        out = gops.gaussian_block(xa, xb, 1.1)
    counted = _build.launch_counts["gaussian_block"] - before
    assert counted == 1                               # the wrapper ran once while capturing
    for seed in (28, 29):
        xa.copy_(_randn((1, 2, 8), dev, seed))
        graph.replay()
        torch.cuda.synchronize()
        assert (out - gref.gaussian_block_ref(xa, xb, 1.1)).abs().max().item() <= 2e-5


def test_zmu_update_kernel_matches_plain(dev):
    n = 4097
    x, mu = _randn((n,), dev, 4), 1e4 * _randn((n,), dev, 5)
    c = torch.full((n,), 1.0, device=dev)
    z, mu_new = aops.fused_zmu_update(x, mu, c, 1e4)
    z_ref, mu_ref = aref.fused_zmu_update_ref(x, mu, c, 1e4)
    assert (z - z_ref).abs().max().item() <= 1e-5
    assert (mu_new - mu_ref).abs().max().item() <= 1e-5 * mu_ref.abs().max().item()


@pytest.mark.parametrize("b,h,kvh,s,d,dtype,opts", [
    (1, 2, 2, 100, 64, torch.float32, dict(causal=True)),            # S off the tile
    (2, 4, 1, 70, 80, torch.float32, dict(causal=False)),            # D 80, MQA
    (1, 4, 2, 130, 128, torch.bfloat16, dict(causal=True, window=33)),
    (1, 2, 1, 96, 256, torch.bfloat16, dict(causal=True, softcap=50.0, window=40)),
    (2, 2, 1, 77, 256, torch.float32, dict(causal=True, prefix_len=20)),
    (1, 3, 3, 65, 32, torch.float32, dict(causal=True, window=16, prefix_len=9)),
])
def test_flash_attention_kernel_matches_plain(dev, b, h, kvh, s, d, dtype, opts):
    """K5 against its plain version.  f32: the same f32 products summed in
    another order (5e-5 of the largest output); bf16: both round one f32
    result to bf16, at most one bf16 step (2^-8 relative) apart."""
    q = _randn((b, h, s, d), dev, 20).to(dtype)
    k = _randn((b, kvh, s, d), dev, 21).to(dtype)
    v = _randn((b, kvh, s, d), dev, 22).to(dtype)
    before = _build.launch_counts["flash_attention"]
    out = attn_ops.flash_attention(q, k, v, **opts)
    assert _build.launch_counts["flash_attention"] == before + 1
    assert out.shape == (b, h, s, d) and out.dtype == dtype
    ref = attn_ref.attention_ref(q, k, v, **opts).float()
    tol = (5e-5 if dtype == torch.float32 else 2 ** -8) * max(1.0, ref.abs().max().item())
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.parametrize("opts", [
    dict(causal=True),                                   # GQA, S off the tile
    dict(causal=True, window=33, prefix_len=20),         # window + prefix
    dict(causal=True, softcap=50.0, window=40),          # softcap
    dict(causal=False),
], ids=["gqa", "window-prefix", "softcap", "full"])
@pytest.mark.parametrize("d", attn_kern.HEAD_DIMS)
def test_flash_attention_bf16_tensor_cores_every_head_dim(dev, d, opts):
    """The tensor-core kernel at every D of HEAD_DIMS: ragged S (not a
    multiple of the 64-row or 64/32-key tiles), 4 query heads on 2 kv heads,
    within one bf16 step (2^-8) of the largest output of the plain version."""
    b, h, kvh, s = 2, 4, 2, 130
    q = _randn((b, h, s, d), dev, 26).to(torch.bfloat16)
    k = _randn((b, kvh, s, d), dev, 27).to(torch.bfloat16)
    v = _randn((b, kvh, s, d), dev, 28).to(torch.bfloat16)
    out = attn_ops.flash_attention(q, k, v, **opts)
    ref = attn_ref.attention_ref(q, k, v, **opts).float()
    assert out.shape == (b, h, s, d) and out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() <= 2 ** -8 * max(1.0, ref.abs().max().item())


def test_flash_attention_takes_the_models_transposed_views(dev):
    """The model passes (B, S, heads, D) projections as transposed views."""
    q = _randn((2, 50, 4, 64), dev, 23)
    k = _randn((2, 50, 2, 64), dev, 24)
    v = _randn((2, 50, 2, 64), dev, 25)
    out = attn_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    ref = attn_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert out.transpose(1, 2).is_contiguous()
    assert (out - ref).abs().max().item() <= 5e-5 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("d", attn_kern.HEAD_DIMS)
def test_flash_attention_bf16_takes_the_models_transposed_views(dev, d):
    """The tensor-core kernel reads the model's transposed (B, S, heads, D)
    views in place through its tensor maps, at every D."""
    q = _randn((2, 50, 4, d), dev, 23).to(torch.bfloat16)
    k = _randn((2, 50, 2, d), dev, 24).to(torch.bfloat16)
    v = _randn((2, 50, 2, d), dev, 25).to(torch.bfloat16)
    out = attn_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    ref = attn_ref.attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2)).float()
    assert out.transpose(1, 2).is_contiguous()
    assert (out.float() - ref).abs().max().item() <= 2 ** -8 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,state", [
    (1, 64, 2, 64, 1, 64, 64, True),         # one chunk
    (2, 256, 4, 64, 2, 64, 128, True),       # two chunks, G = 2
    (1, 384, 2, 64, 1, 128, 128, False),     # mamba2-780m's N = 128
    (2, 96, 6, 40, 3, 16, 32, True),         # ragged P and N
])
def test_ssd_chunk_kernel_matches_plain(dev, b, s, h, p, g, n, chunk, state):
    """K6 against its plain version, y and the final state: the same f32
    products summed in another order (1e-4 of the largest value)."""
    gen = torch.Generator(device=dev).manual_seed(30)
    x = torch.randn((b, s, h, p), device=dev, generator=gen)
    dt = torch.rand((b, s, h), device=dev, generator=gen) * 0.1 + 0.01
    a = -torch.rand((h,), device=dev, generator=gen) - 0.1
    bm = torch.randn((b, s, g, n), device=dev, generator=gen) * 0.3
    cm = torch.randn((b, s, g, n), device=dev, generator=gen) * 0.3
    d = torch.randn((h,), device=dev, generator=gen) * 0.1
    before = _build.launch_counts["ssd_chunk"]
    out = ssd_ops.ssd_forward(x, dt, a, bm, cm, d, chunk=chunk, return_state=state)
    assert _build.launch_counts["ssd_chunk"] == before + 1
    y_ref, h_ref = ssd_ref.ssd_chunked_ref(x, dt, a, bm, cm, d, chunk)
    y = out[0] if state else out
    assert (y - y_ref).abs().max().item() <= 1e-4 * max(1.0, y_ref.abs().max().item())
    if state:
        assert out[1].shape == (b, h, n, p)
        assert (out[1] - h_ref).abs().max().item() <= 1e-4 * max(1.0, h_ref.abs().max().item())


K6_SHAPES = [
    (1, 64, 2, 64, 1, 64, 64, True),         # one chunk
    (2, 256, 4, 64, 2, 64, 128, True),       # two chunks, G = 2
    (1, 384, 2, 64, 1, 128, 128, False),     # mamba2-780m's N = 128
    (2, 96, 6, 40, 3, 16, 32, True),         # ragged P and N
]


def _ssd_bf16(dev, b, s, h, p, g, n, views):
    """The f32 test's inputs with x, B and C rounded to bf16; with ``views``
    as strided slices of one (B, S, HP + 2GN) tensor, as the model's xBC."""
    gen = torch.Generator(device=dev).manual_seed(30)
    x = torch.randn((b, s, h, p), device=dev, generator=gen)
    dt = torch.rand((b, s, h), device=dev, generator=gen) * 0.1 + 0.01
    a = -torch.rand((h,), device=dev, generator=gen) - 0.1
    bm = torch.randn((b, s, g, n), device=dev, generator=gen) * 0.3
    cm = torch.randn((b, s, g, n), device=dev, generator=gen) * 0.3
    d = torch.randn((h,), device=dev, generator=gen) * 0.1
    if views:
        xbc = torch.cat([x.reshape(b, s, -1), bm.reshape(b, s, -1), cm.reshape(b, s, -1)],
                        dim=-1).to(torch.bfloat16)
        xv, bv, cv = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
        x, bm, cm = xv.reshape(b, s, h, p), bv.reshape(b, s, g, n), cv.reshape(b, s, g, n)
        assert not x.is_contiguous()
    else:
        x, bm, cm = (t.to(torch.bfloat16) for t in (x, bm, cm))
    return x, dt, a, bm, cm, d


def _check_ssd(args, chunk, state, n, p):
    before = _build.launch_counts["ssd_chunk"]
    out = ssd_ops.ssd_forward(*args, chunk=chunk, return_state=state)
    assert _build.launch_counts["ssd_chunk"] == before + 1
    y_ref, h_ref = ssd_ref.ssd_chunked_ref(*args, chunk)
    y = out[0] if state else out
    assert y.dtype == torch.float32
    assert (y - y_ref).abs().max().item() <= 1e-4 * max(1.0, y_ref.abs().max().item())
    if state:
        assert out[1].shape == (args[0].shape[0], args[0].shape[2], n, p)
        assert (out[1] - h_ref).abs().max().item() <= 1e-4 * max(1.0, h_ref.abs().max().item())


@pytest.mark.parametrize("views", [False, True], ids=["contiguous", "xbc-views"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk,state", K6_SHAPES)
def test_ssd_chunk_bf16_tensor_cores_match_plain(dev, b, s, h, p, g, n, chunk, state, views):
    """K6's bf16 entry (tensor cores, f32 factors split in two) against the
    plain version on the same bf16 values widened: within 1e-4, as f32."""
    _check_ssd(_ssd_bf16(dev, b, s, h, p, g, n, views), chunk, state, n, p)


@pytest.mark.parametrize("s,p,n,chunk", [
    (100, 64, 64, 50),     # a chunk that is no multiple of 16 (a short prompt)
    (64, 20, 12, 32),      # P and N in no whole 16-byte rows: the wrapper pads them
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_ragged_chunk_and_widths(dev, dtype, s, p, n, chunk):
    """Rows and keys past the chunk are zero-filled and masked; widths that
    are no multiple of 16 bytes are zero-padded by the wrapper."""
    args = _ssd_bf16(dev, 2, s, 4, p, 1, n, views=False)
    args = tuple(t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(args))
    _check_ssd(args, chunk, True, n, p)


def test_ssd_chunk_smem_plan_matches_the_launcher(dev):
    """kernels/ssd/kernel.py::smem_plan against the C launcher's own sizes."""
    fn = _build.function("ssd_chunk", "ssd_chunk_smem", [ctypes.c_int64] * 7 + [ctypes.c_void_p])
    out = (ctypes.c_int64 * 2)()
    for b, s, h, p, g, n, q, _ in K6_SHAPES + [(4, 1024, 64, 64, 1, 64, 128, True),
                                              (4, 1024, 48, 64, 1, 128, 128, True)]:
        for elem in (2, 4):
            ht = ssd_kern.head_tile(b, s // q, h, g)
            plan = ssd_kern.smem_plan(q, p, n, elem, ht)
            assert fn(elem, q, p, n, ht, plan.stages_state, plan.stages_scan,
                      ctypes.addressof(out)) == 0
            assert (out[0], out[1]) == (plan.state_bytes, plan.scan_bytes)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk,launches", [
    (2, 512, 4, 64, 2, 64, 256, 1),      # chunk 256: run at 128
    (1, 256, 2, 160, 1, 64, 128, 2),     # P 160: column slices 128 + 32
    (1, 256, 2, 128, 1, 128, 128, 1),    # Q 128 P 128 N 128: f32 runs at chunk 64
], ids=["chunk256", "p160", "q128-p128-n128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_shapes_beyond_one_launch(dev, dtype, b, s, h, p, g, n, chunk, launches):
    """Shapes one launch refuses (split_plan): sub-chunks and column slices,
    each slice one counted launch, against the plain version at the
    reference's own chunk (1e-4 of the largest value)."""
    args = _ssd_bf16(dev, b, s, h, p, g, n, views=False)
    args = tuple(t.to(dtype) if i in (0, 3, 4) else t for i, t in enumerate(args))
    before = _build.launch_counts["ssd_chunk"]
    y, hf = ssd_ops.ssd_forward(*args, chunk=chunk, return_state=True)
    assert _build.launch_counts["ssd_chunk"] == before + launches
    y_ref, h_ref = ssd_ref.ssd_chunked_ref(*args, chunk)
    assert y.shape == y_ref.shape and hf.shape == (b, h, n, p)
    assert (y - y_ref).abs().max().item() <= 1e-4 * max(1.0, y_ref.abs().max().item())
    assert (hf - h_ref).abs().max().item() <= 1e-4 * max(1.0, h_ref.abs().max().item())


def test_gaussian_scoring_block_times_coefficient_columns(dev):
    """K1's scoring block times a (d, 15) coefficient block (an OVO model's
    15 pair problems) against the plain block times the same columns."""
    xt, xs = _randn((2048, 8), dev, 40), _randn((5000, 8), dev, 41)
    z = _randn((5000, 15), dev, 42)
    before = _build.launch_counts["gaussian_block"]
    scores = gops.gaussian_block(xt, xs, 1.5) @ z
    assert _build.launch_counts["gaussian_block"] == before + 1
    ref = gref.gaussian_block_ref(xt, xs, 1.5) @ z
    assert (scores - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.parametrize("task", ["ovo", "svr"])
def test_task_engine_on_the_card_matches_the_cpu(dev, task):
    """A 2048-point OVO (4 classes) or ε-SVR engine, card against CPU:
    biases and scores to 1e-3 of the largest score, OVO's predicted labels
    equal on 99.5% (SVR's predictions are its scores)."""
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.data import synthetic

    if task == "ovo":
        data = synthetic.train_test("multiclass_blobs", 2048, 512, seed=3, n_classes=4)
        kw, knob = dict(spec=KernelSpec(h=1.5), strategy="ovo"), 1.0
    else:
        data = synthetic.train_test("noisy_sine", 2048, 512, seed=3, noise=0.1)
        kw, knob = dict(spec=KernelSpec(h=1.0), task="svr", svr_c=2.0), 0.1
    out = {}
    for where in ("cuda", "cpu"):
        eng = HSSSVMEngine(comp=CompressionParams.crude(), leaf_size=128,
                           admm=ADMMParams(max_it=10), device=where, **kw)
        eng.prepare(data[0], data[1])
        model, _ = eng.train(knob)
        out[where] = (model.biases.cpu(), model.decision_function(data[2]).cpu(),
                      model.predict(data[2]).cpu())
    scale = out["cpu"][1].abs().max().item()
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-3 * scale
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 1e-3 * scale
    if task == "ovo":
        assert (out["cuda"][2] == out["cpu"][2]).float().mean().item() >= 0.995


# --------------------------------------------------------------------- #
# the streamed build, its resume and the registry on the card            #
# --------------------------------------------------------------------- #
def _stream_problem(n=8192, f=8, leaf=256, seed=0):
    import numpy as np

    from repro_torch.core import tree as tree_mod

    x = np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)
    t = tree_mod.build_tree(x, leaf_size=leaf)
    return x[t.perm], t


def _k2_launches(fn):
    """Run ``fn`` and return its value with every K2 launch's (args, out)."""
    rec = []
    orig = ckern.fused_assemble_id_cuda

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        rec.append((args, out))
        return out

    ckern.fused_assemble_id_cuda = wrapped
    try:
        return fn(), rec
    finally:
        ckern.fused_assemble_id_cuda = orig


def test_streamed_build_against_resident_on_the_card(dev):
    """The leaf level of a 16-leaf-batch streamed build (K2 at B = 16, a
    cluster plan of its own) against the resident build's one launch on the
    same inputs, through verify.compare_row_ids: each differing node a
    rounding tie that stays a greedy pivoted QR, R within 1e-4 elsewhere;
    the two HSS matrices apply to within 1e-3 of |K̃v|."""
    from repro_torch.core import compression as C
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.kernels.compress import verify

    xp, t = _stream_problem()
    spec, params = KernelSpec(h=1.0), C.CompressionParams.crude()
    res, rec_res = _k2_launches(lambda: C.compress(xp, t, spec, params, device="cuda"))
    (st, _), rec_st = _k2_launches(lambda: C.compress_streamed(
        xp, t, spec, params, C.StreamParams(batch_leaves=16), device="cuda"))
    n_leaf_batches = t.n_leaves // 16
    leaf = rec_st[:n_leaf_batches]
    (xc, xpp, cm, k, h, kind), (piv_r, r_r) = rec_res[0]
    assert torch.equal(torch.cat([a[0] for a, _ in leaf]), xc)
    assert torch.equal(torch.cat([a[1] for a, _ in leaf]), xpp)
    piv_s = torch.cat([o[0] for _, o in leaf])
    r_s = torch.cat([o[1] for _, o in leaf])
    out = verify.compare_row_ids(xc, xpp, cm, h, kind, params.rtol, piv_s, r_s, piv_r, r_r)
    assert out["untied"] == 0 and out["off_greedy"] == 0, out
    assert out["mismatches"] <= 0.001 * out["nodes"] + 1 and out["r_err"] <= 1e-4, out
    v = _randn((t.n, 2), dev, 50)
    ref = res.matmat(v)
    assert (st.matmat(v) - ref).abs().max().item() <= 1e-3 * ref.abs().max().item()


def test_streamed_resume_bit_identical_on_the_card(dev, tmp_path):
    """K1 and K2 are deterministic run to run at one shape and plan, so a
    build resumed from its level checkpoint equals the uninterrupted one."""
    from repro_torch.core import compression as C
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.dist.fault import FailureInjector

    xp, t = _stream_problem()
    spec, params = KernelSpec(h=1.0), C.CompressionParams.crude()
    ref, _ = C.compress_streamed(xp, t, spec, params, C.StreamParams(batch_leaves=16),
                                 device="cuda")
    hss, stats = C.compress_streamed(
        xp, t, spec, params, C.StreamParams(batch_leaves=16, ckpt_dir=str(tmp_path)),
        on_level=FailureInjector(fail_at=(3,)).check, device="cuda")
    assert stats.restarts == 1 and stats.resumed_level == 3
    assert stats.device_peak_bytes is not None and stats.device_peak_bytes > 0
    for name in ("x", "d_leaf", "u_leaf", "skel_leaf", "leaf_ranks"):
        assert torch.equal(getattr(hss, name), getattr(ref, name)), name
    for name in ("transfers", "skels", "b_mats", "level_ranks"):
        assert all(torch.equal(a, b) for a, b in zip(getattr(hss, name), getattr(ref, name)))


def test_fused_assemble_id_at_the_streamed_leaf_batch(dev):
    """K2 at a 16-node streamed leaf batch (m 256, s 64, k 32): the plan
    keeps 16·C CTAs on at most half the SMs, and every feasible C gives the
    plain version's pivots and R."""
    b, m, s, f, k = 16, 256, 64, 8, 32
    props = torch.cuda.get_device_properties(torch.cuda.current_device())
    c, _, _ = ckern.plan(b, m, s, k, props.multi_processor_count,
                         props.shared_memory_per_block_optin)
    fits = [fc for fc, _, _ in ckern.feasible(m, s, k, b)]
    assert c == max([fc for fc in fits if b * fc <= props.multi_processor_count // 2]
                    or fits[:1])
    xc, xp = _randn((b, m, f), dev, 60), _randn((b, s, f), dev, 61)
    cmask = torch.ones((b, m), device=dev)
    piv_ref, r_ref = cref.fused_assemble_id_ref(xc, xp, cmask, k, 1.0)
    for cluster in fits:
        piv, r = ckern.fused_assemble_id_cuda(xc, xp, cmask, k, 1.0, cluster=cluster)
        assert torch.equal(piv, piv_ref), cluster
        assert (r - r_ref).abs().max().item() <= 1e-4, cluster


def test_registry_round_trip_card_to_cpu(dev, tmp_path):
    """A model trained on the card, saved, loaded on the CPU and on the
    card: arrays bit-equal, predictions equal."""
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.data import synthetic
    from repro_torch.serve import ModelRegistry

    xtr, ytr, xte, _ = synthetic.train_test("blobs", 2048, 512, seed=3, n_features=8, sep=1.6)
    eng = HSSSVMEngine(spec=KernelSpec(h=1.0), comp=CompressionParams.crude(), leaf_size=128,
                       admm=ADMMParams(max_it=10), device="cuda")
    model = eng.fit(xtr, ytr)
    reg = ModelRegistry(str(tmp_path))
    reg.save("m", model)
    for where in ("cpu", "cuda"):
        back, _ = reg.load("m", device=where)
        assert back.x_perm.device.type == where
        for name in ("x_perm", "z_y", "biases"):
            assert torch.equal(getattr(back, name).cpu(), getattr(model, name).cpu()), name
        assert torch.equal(back.predict(xte).cpu(), model.predict(xte).cpu()), where


def _serve_model(dev, task="ovo", d=4096, f=8, kernel="gaussian", seed=0):
    """A synthetic model (random coefficients, no training) on ``dev``."""
    from repro_torch import convert

    r = np.random.default_rng(seed)
    n_prob = 3 if task in ("ovr", "ovo") else 1
    return convert.engine_model_from_numpy(
        x_perm=r.normal(size=(d, f)).astype(np.float32),
        z_y=(0.3 * r.normal(size=(d, n_prob))).astype(np.float32),
        biases=(0.1 * r.normal(size=n_prob)).astype(np.float32),
        classes=np.arange(3.0) if n_prob == 3 else np.array([-1.0, 1.0]), h=1.3,
        kernel_name=kernel, beta=64.0, binary=task == "binary",
        strategy="ovo" if task == "ovo" else "ovr",
        pairs=np.array([[0, 1], [0, 2], [1, 2]]) if task == "ovo" else None, device=dev)


@pytest.mark.parametrize("kernel", ["gaussian", "laplacian"])
def test_serving_graph_replay_equals_the_eager_tick(dev, kernel):
    """The second tick of a shape replays the graph captured after the first
    (eager) one: its scores equal an eager run of the same padded chunk bit
    for bit, and the launch counts advance by the captured launches."""
    from repro_torch.serve import BatchPolicy, ServingEngine, batched_scores

    model = _serve_model(dev, kernel=kernel)
    eng = ServingEngine(policy=BatchPolicy(buckets=(16, 64)), device="cuda")
    mid = eng.add_model(model)
    name = "laplacian_block" if kernel == "laplacian" else "gaussian_block"
    xq = np.random.default_rng(1).normal(size=(50, 8)).astype(np.float32)
    before = _build.launch_counts[name]
    first, _ = eng.score(mid, xq)                    # eager, then captured
    assert _build.launch_counts[name] == before + 1
    assert eng.stats()["graph_captures"] == 1
    second, _ = eng.score(mid, xq)                   # replayed
    assert _build.launch_counts[name] == before + 2
    st = eng.stats()
    assert st["graph_replays"] == 1 and st["graph_captures"] == 1 and st["scorer_compiles"] == 1
    g = eng.model_group(mid)
    pad = np.concatenate([xq, np.zeros((14, 8), np.float32)])
    eager = batched_scores(torch.as_tensor(pad, device=dev), g.xs_dev, g.zy_dev,
                           g.biases_dev, spec=g.spec, block=64)[:50].cpu().numpy()
    assert np.array_equal(second, eager) and np.array_equal(first, eager)
    ref = model.decision_function(xq).cpu().numpy()
    assert np.abs(second - ref).max() <= 1e-5 * np.abs(ref).max()


def test_serving_bf16_scorer_products_come_back_f32(dev):
    """The bf16 Gaussian scorer multiplies bf16-rounded operands in f32: it
    matches the f64 evaluation of those operands to f32 rounding."""
    from repro_torch.serve import batched_scores

    model = _serve_model(dev, task="ovr")
    xq = _randn((64, 8), dev, 5)
    got = batched_scores(xq, model.x_perm, model.z_y, model.biases, spec=model.spec,
                         block=32, compute_dtype="bfloat16")
    assert got.dtype == torch.float32
    r = lambda t: t.to(torch.bfloat16).double()
    a, b, v = r(xq), r(model.x_perm), r(model.z_y)
    sq = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2 * a @ b.T).clamp(min=0)
    want = torch.exp(-sq / (2 * 1.3 ** 2)) @ v + model.biases.double()
    assert (got.double() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_serving_eviction_recaptures_and_scores_the_same(dev):
    """An evicted group drops its graphs with its tensors; re-uploaded, it
    captures again and scores as before."""
    from repro_torch.serve import BatchPolicy, ServingEngine

    eng = ServingEngine(policy=BatchPolicy(buckets=(32,)), max_resident=1, device="cuda")
    ia = eng.add_model(_serve_model(dev, task="binary", seed=1))
    ib = eng.add_model(_serve_model(dev, task="binary", seed=2))
    xq = np.random.default_rng(3).normal(size=(20, 8)).astype(np.float32)
    a1, _ = eng.score(ia, xq)
    a2, _ = eng.score(ia, xq)
    eng.score(ib, xq)                               # evicts a, and a's graph
    assert eng.model_group(ia).graphs == {} and eng.stats()["evictions"] == 1
    a3, _ = eng.score(ia, xq)                       # re-upload, recapture
    a4, _ = eng.score(ia, xq)                       # replay of the new graph
    st = eng.stats()
    assert (st["support_uploads"], st["graph_captures"], st["graph_replays"]) == (3, 3, 2)
    assert st["scorer_compiles"] == 1
    assert np.array_equal(a1, a2) and np.array_equal(a1, a3) and np.array_equal(a1, a4)


def test_serving_appended_columns_drop_the_groups_graphs(dev):
    """A model joining a group replaces its column block: the group's graphs
    go, and the next tick scores both models."""
    from repro_torch.serve import BatchPolicy, ServingEngine

    base = _serve_model(dev, task="ovr")
    eng = ServingEngine(policy=BatchPolicy(buckets=(32,)), device="cuda")
    i1 = eng.add_model(base)
    xq = np.random.default_rng(4).normal(size=(32, 8)).astype(np.float32)
    s1, _ = eng.score(i1, xq)
    assert len(eng.model_group(i1).graphs) == 1
    other = dataclasses.replace(base, z_y=2.0 * base.z_y)
    i2 = eng.add_model(other)
    assert eng.model_group(i1).graphs == {}
    t1, t2 = eng.submit(i1, xq), eng.submit(i2, xq)
    eng.flush()
    assert np.abs(t1.result(0)[0] - s1).max() <= 1e-6 * np.abs(s1).max()
    ref = other.decision_function(xq).cpu().numpy()
    assert np.abs(t2.result(0)[0] - ref).max() <= 1e-5 * np.abs(ref).max()
    assert eng.stats()["scorer_compiles"] == 2


def test_dense_baseline_on_the_card_matches_the_cpu(dev):
    """dense_admm_fit and nystrom_admm_fit at 1024 points: the card (K1,
    cuSOLVER) against the CPU (plain versions, LAPACK).  Nyström is held
    to 1e-3 (chip_smoke.py's BASE_NYSTROM_ATOL: its W^{-1/2} amplifies
    f32 rounding ~1e4-fold), the dense fit to 1e-4."""
    from repro_torch.core import baselines as pb
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.data import synthetic

    xtr, ytr, xte, _ = synthetic.train_test("circles", 1024, 256, seed=1, n_features=4,
                                            gap=0.8)
    spec = KernelSpec(h=1.0)
    lm = pb.nystrom_landmarks(1024, 256, seed=0)
    for fit, kw, tol in ((pb.dense_admm_fit, {}, 1e-4),
                         (pb.nystrom_admm_fit, dict(landmarks=lm), 1e-3)):
        res = {}
        for where in ("cpu", "cuda"):
            x, y = torch.as_tensor(xtr, device=where), torch.as_tensor(ytr, device=where)
            z, b = fit(x, y, spec, 1.0, 100.0, **kw)
            pred = pb.dense_predict(x, y, z, b, spec, torch.as_tensor(xte, device=where))
            res[where] = z.cpu(), float(b), pred.cpu()
        (zc, bc, pc), (zg, bg, pg) = res["cpu"], res["cuda"]
        assert (zc - zg).abs().max().item() <= tol and abs(bc - bg) <= tol, fit.__name__
        assert (pc == pg).float().mean().item() >= 0.99, fit.__name__


def test_serving_threaded_driver_captures_on_its_thread(dev):
    """The max-wait driver thread captures and replays the graphs; its
    ticks score as the caller's own ticks do."""
    from repro_torch.serve import BatchPolicy, ServingEngine

    model = _serve_model(dev, task="binary", seed=5)
    xq = [np.random.default_rng(s).normal(size=(3, 8)).astype(np.float32) for s in range(6)]
    sync = ServingEngine(policy=BatchPolicy(buckets=(8,)), device="cuda")
    want = [sync.score(sync.add_model(model, model_id="m"), q)[0] for q in xq[:1]]
    want += [sync.score("m", q)[0] for q in xq[1:]]
    eng = ServingEngine(policy=BatchPolicy(buckets=(8,), max_wait_ms=1.0), device="cuda")
    mid = eng.add_model(model)
    eng.start()
    try:
        got = [eng.submit(mid, q).result(timeout=30.0)[0] for q in xq]
    finally:
        eng.stop()
    assert not eng.running and eng.stats()["graph_captures"] == 1
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_moe_block_f32_on_the_card_matches_the_cpu(dev):
    """The f32 expert products with TF32 off, and the stable dispatch:
    granite's 40 experts top-8 at a reduced width, with a capacity that
    overflows (the card and the CPU drop the same choices)."""
    from repro_torch.models import layers

    d, e, ff = 64, 40, 32
    x = _randn((2, 96, d), dev, 60)
    p = layers.MoEParams(*(_randn(s, dev, 61 + i) * s[-2] ** -0.5 for i, s in enumerate(
        [(d, e), (e, d, ff), (e, d, ff), (e, ff, d)])))
    out, aux = layers.moe_block(x, p, 8, 0.5)
    cpu_out, cpu_aux = layers.moe_block(x.cpu(), layers.MoEParams(*(a.cpu() for a in p)), 8, 0.5)
    scale = cpu_out.abs().max().item()
    assert (out.cpu() - cpu_out).abs().max().item() <= 1e-5 * scale
    assert abs(aux.item() - cpu_aux.item()) <= 1e-5 * cpu_aux.item()


def test_gemma2_shaped_decode_step_on_the_card_matches_the_cpu(dev):
    """gemma2-9b's head layout (16 heads over 8 KV heads of dim 256, window
    on the even layer, softcaps) at 2 layers and a narrow width, f32: a
    prefill past the window (K5 on the card) and one decode step, card
    against CPU with the same weights."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model

    cfg = dataclasses.replace(get_config("gemma2-9b"), n_layers=2, d_model=512, d_ff=1024,
                              vocab=1024, window=64, compute_dtype="float32")
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab, (2, 97), generator=torch.Generator().manual_seed(1))
    logits = {}
    for where, model in (("cpu", cpu), ("cuda", card)):
        t = toks.to(model.device)
        before = _build.launch_counts["flash_attention"]
        _, cache = model.prefill({"tokens": t[:, :96]}, 97)
        assert _build.launch_counts["flash_attention"] - before == (2 if where == "cuda" else 0)
        logits[where] = model.decode_step(cache, t[:, 96:])[0].cpu()
    scale = logits["cpu"].abs().max().item()
    assert (logits["cuda"] - logits["cpu"]).abs().max().item() <= 1e-3 * scale


# --------------------------------------------------------------------- #
# training (slice 8)                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_autograd_launches_k5_and_takes_the_plain_gradient(dev, dtype):
    """Under autograd the forward is one K5 launch and the backward the
    plain version's gradient: the gradients equal autograd's through
    attention_ref on the same inputs (bf16: one bf16 step of the largest)."""
    q, k, v = (_randn((2, h, 128, 64), dev, 70 + i).to(dtype).requires_grad_()
               for i, h in enumerate((8, 2, 2)))
    g = _randn((2, 8, 128, 64), dev, 73).to(dtype)
    before = _build.launch_counts["flash_attention"]
    out = attn_ops.flash_attention(q, k, v, causal=True, window=32)
    assert _build.launch_counts["flash_attention"] == before + 1
    got = torch.autograd.grad(out, (q, k, v), g)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(attn_ref.attention_ref(qr, kr, vr, causal=True, window=32),
                               (qr, kr, vr), g)
    assert _build.launch_counts["flash_attention"] == before + 1
    for a, b in zip(got, want):
        scale = max(1.0, b.float().abs().max().item())
        tol = 1e-6 if dtype == torch.float32 else 2.0 ** (math.floor(math.log2(scale)) - 7)
        assert (a.float() - b.float()).abs().max().item() <= tol * scale


def test_ssd_autograd_launches_k6_and_takes_the_plain_gradient(dev):
    x, bm, cm = (_randn(s, dev, 80 + i) for i, s in enumerate(
        [(2, 256, 4, 64), (2, 256, 1, 64), (2, 256, 1, 64)]))
    dt = torch.rand((2, 256, 4), device=dev) * 0.1 + 1e-3
    a, d = -torch.linspace(1.0, 4.0, 4, device=dev), torch.ones(4, device=dev)
    leaves = [t.requires_grad_() for t in (x, dt, a, bm, cm, d)]
    before = _build.launch_counts["ssd_chunk"]
    y = ssd_ops.ssd_forward(*leaves, chunk=128)
    assert _build.launch_counts["ssd_chunk"] == before + 1
    got = torch.autograd.grad(y.square().sum(), leaves)
    plain = [t.detach().requires_grad_() for t in leaves]
    want = torch.autograd.grad(ssd_ref.ssd_chunked_ref(*plain, 128)[0].square().sum(), plain)
    for a_, b_ in zip(got, want):
        assert (a_ - b_).abs().max().item() <= 1e-4 * b_.abs().max().item()


def test_train_step_on_the_card_matches_the_cpu(dev):
    """zamba2's reduced config, f32: one make_train_step on the card against
    the CPU from the same weights (K5 and K6 in the forward and each
    recompute): loss, grad norm and every gradient leaf."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import batch_for_config, to_device
    from repro_torch.models.transformer import Model
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    cfg = get_config("zamba2-1.2b").reduced(compute_dtype="float32", n_layers=4)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    batch = batch_for_config(cfg, 2, 64, 0)
    mets, grads = {}, {}
    for where, model in (("cpu", cpu), ("cuda", card)):
        before = dict(_build.launch_counts)
        _, met = make_train_step(model)(optim.adamw_init(dict(model.named_parameters())),
                                        to_device(batch, model.device))
        mets[where] = {k: float(v) for k, v in met.items()}
        grads[where] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    assert _build.launch_counts["ssd_chunk"] - before["ssd_chunk"] == 2 * cfg.n_layers
    assert _build.launch_counts["flash_attention"] - before["flash_attention"] == 2 * 2
    assert mets["cuda"]["loss"] == pytest.approx(mets["cpu"]["loss"], rel=1e-5)
    assert mets["cuda"]["grad_norm"] == pytest.approx(mets["cpu"]["grad_norm"], rel=1e-4)
    for k, g in grads["cpu"].items():
        assert (grads["cuda"][k] - g).abs().max().item() <= 1e-3 * g.abs().max().item(), k


def test_moe_block_reads_nothing_back_and_repeats_on_the_card(dev):
    """granite's 40 experts top-8 in bf16: no host sync in the dispatch and
    the combine (set_sync_debug_mode "error"), and two calls bit-identical
    (no atomics in the combine)."""
    from repro_torch.models import layers

    d, e, ff = 128, 40, 64
    x = _randn((4, 256, d), dev, 90).to(torch.bfloat16)
    p = layers.MoEParams(*((_randn(s, dev, 91 + i) * s[-2] ** -0.5).to(torch.bfloat16)
                           for i, s in enumerate([(d, e), (e, d, ff), (e, d, ff), (e, ff, d)])))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [layers.moe_block(x, p, 8, 1.25) for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def _blobs_engine(dev, mesh=None, task="svm"):
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.data import synthetic

    xtr, ytr, xte, _ = synthetic.train_test("blobs", 8192, 512, seed=0, n_features=8, sep=1.6)
    eng = HSSSVMEngine(spec=KernelSpec(h=1.0), comp=CompressionParams(rank=32, n_near=32,
                                                                      n_far=32),
                       leaf_size=256, admm=ADMMParams(max_it=10), mesh=mesh, device=dev,
                       task=task)
    eng.prepare(xtr, ytr)
    model, (z, _) = eng.train(1.0)
    return eng, model, z, model.decision_function(xte)


def test_one_rank_nccl_mesh_engine_matches_the_single_device_engine(dev):
    """The node-split engine over a one-rank NCCL mesh (real NCCL calls on
    every gather and sum) against the local engine on the card: the same
    launches at the same batch sizes, so skeletons, factors, z and scores
    agree bit for bit."""
    from repro_torch.dist import api as dist_api

    local, _, z_ref, s_ref = _blobs_engine(dev)
    with dist_api.process_group_mesh("cuda") as mesh:
        eng, model, z, s = _blobs_engine(mesh.device, mesh)
        assert "nccl" in mesh.describe() and mesh.stats["all_gather_calls"] > 0
        assert eng.report.mesh_ranks == 1 and eng.hss.cut == eng.hss.levels
        for a, b in zip((eng.hss.skel_leaf, *eng.hss.skels),
                        (local.hss.skel_leaf, *local.hss.skels)):
            assert torch.equal(a, b)
        assert torch.equal(eng.fac.g_leaf, local.fac.g_leaf)
        assert torch.equal(eng.fac.root_lu, local.fac.root_lu)
        assert torch.equal(z, z_ref) and torch.equal(s, s_ref)
        assert torch.equal(model.gathered().z_y, model.z_y)
    assert not torch.distributed.is_initialized()
