"""K6's chunk-parallel design, checked on the CPU before it runs on a card.

``emulate`` repeats the arithmetic of ``csrc/ssd_chunk.cu`` in plain torch:
pass 1 (each chunk's own state), pass 2 (state passing) and pass 3 (the
chunk scan), with every f32 factor of a bf16 tensor-core product split as
hi = bf16(v), lo = bf16(v - hi) by ``.to(torch.bfloat16)``.  It is held
against the JAX package's ``ssd_batched_with_state`` (y and the final state)
within K6_RTOL = 1e-4 of max(1, max |ref|), the tolerance ``chip_smoke.py``
holds the kernel to: the splits keep ~2^-17 of each factor, and the state
carries that across chunks.  The main path never calls the emulation.

Also here: ``ssm_block`` hands a bf16 model's x, B and C to the scan unwidened
with bit-identical results on the CPU, and the kernel's shared-memory plan
fits an H100 block at every shape that ``chip_smoke.py`` and the card tests
run.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ref as jssd_ref
from repro_torch.configs.registry import get_config
from repro_torch.kernels.ssd import kernel as ssd_kern, ops as ssd_ops, ref as ssd_ref
from repro_torch.models import ssm
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

K6_RTOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]


def _split(v: torch.Tensor):
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def emulate(x, dt, a, b_mat, c_mat, d_vec, chunk, split=True):
    """The kernel's three passes on (B, S, H, P) / (B, S, G, N) inputs, f32.

    ``split``: the bf16 instantiation (tensor-core products with split f32
    factors); without it, the f32 instantiation (every product in f32)."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    nc = s // chunk
    grp = torch.arange(h) // (h // g)
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    bf = b_mat.float().reshape(bsz, nc, chunk, g, n)
    cf = c_mat.float().reshape(bsz, nc, chunk, g, n)
    dtc = dt.float().reshape(bsz, nc, chunk, h)
    la = torch.cumsum(dtc, dim=2) * a.float()                 # (B, nc, Q, H), per chunk
    la_q = la[:, :, -1]                                        # (B, nc, H)
    sp = _split if split else (lambda v: (v, torch.zeros_like(v)))

    # pass 1: s_c = Bᵀ (w ⊙ X), w = exp(la_Q - la) dt; B exact, w ⊙ X split
    w = torch.exp(la_q[:, :, None] - la) * dtc                 # (B, nc, Q, H)
    wx_hi, wx_lo = sp(w[..., None] * xf)                       # (B, nc, Q, H, P)
    bh = bf[:, :, :, grp]                                      # (B, nc, Q, H, N)
    s_c = (torch.einsum("bcjhn,bcjhp->bchnp", bh, wx_hi)
           + torch.einsum("bcjhn,bcjhp->bchnp", bh, wx_lo))

    # pass 2: the state entering each chunk, in f32; the final state
    state = torch.zeros((bsz, h, n, p))
    h_in = []
    for c in range(nc):
        h_in.append(state)
        state = torch.exp(la_q[:, c])[..., None, None] * state + s_c[:, c]
    h_in = torch.stack(h_in, dim=1)                            # (B, nc, H, N, P)

    # pass 3: G = C Bᵀ once per group; S' = G ⊙ exp(la_i - la_j)[i >= j] ⊙ dt_j
    gm = torch.einsum("bcign,bcjgn->bcgij", cf, bf)[:, :, grp]  # (B, nc, H, Q, Q)
    la_h = la.permute(0, 1, 3, 2)                              # (B, nc, H, Q)
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    gate = torch.where(tril, torch.exp(la_h[..., :, None] - la_h[..., None, :]),
                       torch.zeros(()))
    s_pr = gm * gate * dtc.permute(0, 1, 3, 2)[..., None, :]
    s_hi, s_lo = sp(s_pr)
    h_hi, h_lo = sp(h_in)
    ch = cf[:, :, :, grp]                                      # (B, nc, Q, H, N)
    y_state = (torch.einsum("bcihn,bchnp->bcihp", ch, h_hi)
               + torch.einsum("bcihn,bchnp->bcihp", ch, h_lo))
    y = torch.exp(la)[..., None] * y_state
    y = y + (torch.einsum("bchij,bcjhp->bcihp", s_hi, xf)
             + torch.einsum("bchij,bcjhp->bcihp", s_lo, xf))
    y = y + d_vec.float()[:, None] * xf
    return y.reshape(bsz, s, h, p), state


def _inputs(b, s, h, p, g, n, seed, bf16=True):
    """numpy inputs from a seed, x, B and C rounded to bf16 as a bf16 model
    hands them over; dt, a and D in f32 (chip_smoke.py's ranges)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.normal(size=(b, s, h, p)).astype(f)
    bm = (rng.normal(size=(b, s, g, n)) * 0.3).astype(f)
    cm = (rng.normal(size=(b, s, g, n)) * 0.3).astype(f)
    if bf16:
        x, bm, cm = (torch.from_numpy(t).to(torch.bfloat16).float().numpy() for t in (x, bm, cm))
    dt = (rng.random(size=(b, s, h)) * 0.1 + 0.001).astype(f)
    a = (-np.linspace(1.0, 16.0, h)).astype(f)
    d = np.ones(h, f)
    return x, dt, a, bm, cm, d


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


CASES = [
    # (b, s, h, p, g, n, chunk): a small ragged case (P and N not multiples
    # of 16, G 3) and one head of the zamba2 chunk over 4 chunks
    (2, 96, 6, 40, 3, 16, 32),
    (1, 512, 1, 64, 1, 64, 128),
]


@pytest.mark.parametrize("split", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", CASES, ids=["ragged", "zamba2-head"])
def test_emulated_passes_match_the_jax_reference(shape, split):
    b, s, h, p, g, n, q = shape
    args = _inputs(b, s, h, p, g, n, seed=7, bf16=split)
    y, h_fin = emulate(*map(torch.from_numpy, args), q, split=split)
    y_ref, h_ref = jssd_ref.ssd_batched_with_state(*map(jnp.asarray, args), chunk=q)
    assert _rel(y, y_ref) <= K6_RTOL
    assert _rel(h_fin, h_ref) <= K6_RTOL
    # and against the port's plain version, which the card holds the kernel to
    y_pt, h_pt = ssd_ref.ssd_chunked_ref(*map(torch.from_numpy, args), q)
    assert _rel(y, y_pt) <= K6_RTOL
    assert _rel(h_fin, h_pt) <= K6_RTOL


def test_emulated_split_error_is_far_inside_the_tolerance():
    """The splits' own error at the zamba2 head: the bf16 emulation against
    the f32 one on the same inputs stays ~50x below K6_RTOL, so the chip's
    tolerance has room for f32 sums in another order."""
    args = [torch.from_numpy(t) for t in _inputs(1, 512, 1, 64, 1, 64, seed=8)]
    y_b, h_b = emulate(*args, 128, split=True)
    y_f, h_f = emulate(*args, 128, split=False)
    assert _rel(y_b, y_f) <= K6_RTOL / 50
    assert _rel(h_b, h_f) <= K6_RTOL / 50


def _ssm_layer(seed=3):
    cfg = get_config("zamba2-1.2b").reduced(remat="none", ssd_chunk=16,
                                            compute_dtype="bfloat16")
    rng = np.random.default_rng(seed)
    d, di, gn, hh = cfg.d_model, cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * gn

    def t(*shape, scale=0.2):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    params = ssm.SSMParams(
        in_proj=t(d, 2 * di + 2 * gn + hh).to(torch.bfloat16),
        conv_w=t(cfg.ssm_conv, conv_dim).to(torch.bfloat16),
        conv_b=t(conv_dim).to(torch.bfloat16),
        a_log=t(hh, scale=0.5), d_skip=t(hh), dt_bias=t(hh), norm=t(di),
        out_proj=t(di, d).to(torch.bfloat16))
    x = t(2, 48, d, scale=0.5).to(torch.bfloat16)
    return cfg, params, x


@pytest.mark.parametrize("return_cache", [False, True])
def test_ssm_block_hands_bf16_views_to_the_scan_bit_identically(monkeypatch, return_cache):
    """A bf16 model's x, B and C reach the scan as bf16 views of xBC, and the
    CPU output equals, bit for bit, the call that widens them to contiguous
    f32 first (the plain version widens them itself)."""
    cfg, params, x = _ssm_layer()
    seen = []
    original = ssd_ops.ssd_forward

    def recording(xs, dt, a, b, c, d, **kw):
        seen.append((xs.dtype, b.dtype, c.dtype, xs.is_contiguous()))
        return original(xs, dt, a, b, c, d, **kw)

    monkeypatch.setattr(ssm.ssd_ops, "ssd_forward", recording)
    got = ssm.ssm_block(x, params, cfg, return_cache=return_cache)

    def widening(xs, dt, a, b, c, d, **kw):
        return original(xs.float().contiguous(), dt, a, b.float().contiguous(),
                        c.float().contiguous(), d, **kw)

    monkeypatch.setattr(ssm.ssd_ops, "ssd_forward", widening)
    want = ssm.ssm_block(x, params, cfg, return_cache=return_cache)
    assert seen == [(torch.bfloat16, torch.bfloat16, torch.bfloat16, False)]
    if return_cache:
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].state, want[1].state)
        assert torch.equal(got[1].conv, want[1].conv)
    else:
        assert torch.equal(got, want)


def test_ssm_block_f32_model_still_widens_to_contiguous(monkeypatch):
    cfg, params, x = _ssm_layer()
    cfg = cfg.reduced(compute_dtype="float32")
    params = ssm.SSMParams(*(t.float() for t in params))
    seen = []
    original = ssd_ops.ssd_forward

    def recording(xs, dt, a, b, c, d, **kw):
        seen.append((xs.dtype, xs.is_contiguous(), b.is_contiguous(), c.is_contiguous()))
        return original(xs, dt, a, b, c, d, **kw)

    monkeypatch.setattr(ssm.ssd_ops, "ssd_forward", recording)
    ssm.ssm_block(x.float(), params, cfg)
    assert seen == [(torch.float32, True, True, True)]


def _chip_smoke_k6_cases():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [(shape, dtype) for _, shape, _, dtype in mod.K6_CASES]


# tests/test_torch_cuda.py's K6 shapes: (b, s, h, p, g, n, chunk)
CARD_SHAPES = [(1, 64, 2, 64, 1, 64, 64), (2, 256, 4, 64, 2, 64, 128),
               (1, 384, 2, 64, 1, 128, 128), (2, 96, 6, 40, 3, 16, 32)]


@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bf16", "f32"])
def test_smem_plan_fits_every_shape_that_runs(elem_bytes):
    shapes = [s for s, _ in _chip_smoke_k6_cases()] + CARD_SHAPES
    assert len(shapes) >= 8
    for b, s, h, p, g, n, q in shapes:
        ht = ssd_kern.head_tile(b, s // q, h, g)
        assert 1 <= ht <= ssd_kern.MAX_HT and (h // g) % ht == 0
        plan = ssd_kern.smem_plan(q, p, n, elem_bytes, ht)
        assert plan.state_bytes <= ssd_kern.SMEM_LIMIT
        assert plan.scan_bytes <= ssd_kern.SMEM_LIMIT
        assert plan.stages_state == 2     # the X ring is double-buffered at every one


def test_smem_plan_at_the_paths_shapes():
    """The plan at Q 128, P 64: bf16 at N 64 takes one pass-3 stage, so two
    blocks share an SM (two stages, 133,120 B, would leave one); at N 128
    two stages, one block an SM."""
    assert ssd_kern.head_tile(4, 8, 64, 1) == 4      # zamba2 path: 512 blocks
    assert ssd_kern.head_tile(4, 8, 48, 1) == 4      # mamba2-780m: 384 blocks
    assert ssd_kern.smem_plan(128, 64, 64, 2, 4) == (2, 59_392, 1, 96_256)
    assert ssd_kern.blocks_per_sm(96_256) == 2 and ssd_kern.blocks_per_sm(133_120) == 1
    assert ssd_kern.smem_plan(128, 64, 128, 2, 4) == (2, 75_776, 2, 186_368)
    # f32: two stages at N 64; one at N 128, where B makes way for the ring
    assert ssd_kern.smem_plan(128, 64, 64, 4, 4) == (2, 108_544, 2, 190_464)
    assert ssd_kern.smem_plan(128, 64, 128, 4, 4) == (2, 141_312, 1, 188_416)


@pytest.mark.parametrize("args,ht", [
    ((1, 1, 2, 1), 1), ((2, 3, 6, 3), 1), ((1, 4, 64, 1), 1), ((4, 8, 64, 2), 4),
    ((64, 16, 64, 1), 8), ((4, 8, 48, 1), 4)])
def test_head_tile(args, ht):
    assert ssd_kern.head_tile(*args) == ht


def test_wrapper_refuses_cpu_tensors_and_mixed_types():
    args = [torch.from_numpy(t) for t in _inputs(1, 32, 2, 8, 1, 8, seed=0, bf16=False)]
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kern.ssd_chunk_cuda(*args, chunk=16)


# split_plan: (b, s, h, g, p, n, chunk, elem_bytes) -> (q, column slices)
@pytest.mark.parametrize("args,q,cols", [
    ((4, 1024, 64, 1, 64, 64, 128, 2), 128, ((0, 64),)),     # zamba2 path: unchanged
    ((2, 512, 4, 1, 64, 64, 256, 2), 128, ((0, 64),)),       # chunk 256 -> 128
    ((2, 512, 4, 1, 64, 64, 256, 4), 128, ((0, 64),)),
    ((1, 256, 2, 1, 160, 64, 128, 2), 128, ((0, 128), (128, 160))),   # P 160
    ((1, 256, 2, 1, 160, 64, 128, 4), 128, ((0, 128), (128, 160))),
    ((1, 256, 2, 1, 128, 128, 128, 4), 64, ((0, 128),)),     # f32 Q 128 P 128 N 128
    ((1, 256, 2, 1, 128, 128, 128, 2), 128, ((0, 128),)),    # ... fits in bf16
    ((1, 300, 2, 1, 64, 64, 300, 2), 100, ((0, 64),)),       # largest divisor <= 128
], ids=["zamba2", "chunk256-bf16", "chunk256-f32", "p160-bf16", "p160-f32",
        "f32-q128-p128-n128", "bf16-q128-p128-n128", "chunk300"])
def test_split_plan(args, q, cols):
    plan = ssd_kern.split_plan(*args)
    assert plan == (q, cols)
    b, s, h, g, p, n, chunk, elem = args
    assert chunk % plan.q == 0 and s % plan.q == 0
    sm = ssd_kern.smem_plan(plan.q, min(p, ssd_kern.MAX_P), n, elem,
                            ssd_kern.head_tile(b, s // plan.q, h, g))
    assert max(sm.state_bytes, sm.scan_bytes) <= ssd_kern.SMEM_LIMIT


def test_split_plan_refuses_a_state_too_wide_for_any_chunk():
    with pytest.raises(ValueError, match="state width N"):
        ssd_kern.split_plan(1, 64, 2, 1, 64, 4096, 64, 4)


def test_plain_version_is_chunk_and_column_invariant():
    """What split_plan relies on, in the plain version: chunk 256 against
    chunk 128, and P 160 against its two column slices (y and state, 1e-5
    of max(1, max |ref|))."""
    args = [torch.from_numpy(t) for t in _inputs(2, 512, 4, 64, 2, 32, seed=3, bf16=False)]
    y256, h256 = ssd_ref.ssd_chunked_ref(*args, 256)
    y128, h128 = ssd_ref.ssd_chunked_ref(*args, 128)
    assert _rel(y256, y128) <= 1e-5 and _rel(h256, h128) <= 1e-5
    args = [torch.from_numpy(t) for t in _inputs(1, 256, 2, 160, 1, 64, seed=4, bf16=False)]
    y, hf = ssd_ref.ssd_chunked_ref(*args, 128)
    parts = [ssd_ref.ssd_chunked_ref(args[0][..., c0:c1], *args[1:], 128)
             for c0, c1 in ssd_kern.split_plan(1, 256, 2, 1, 160, 64, 128, 4).cols]
    assert _rel(torch.cat([p[0] for p in parts], -1), y) <= 1e-5
    assert _rel(torch.cat([p[1] for p in parts], -1), hf) <= 1e-5
