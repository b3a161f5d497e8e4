"""Launcher of ``csrc/ssd_chunk.cu`` (CUDA tensors only).

One launch runs the chunk-parallel scan as three CUDA kernels on the
current stream (chunk states, state passing, chunk scan) and counts one
launch of ``ssd_chunk``.  A call launches once per head-dim slice of at most
``MAX_P`` columns, at a sub-chunk that fits one block (``split_plan``).  The
plans below (split, head tile, ring stages, shared memory) are plain Python,
held by the CPU tests; the C launcher recomputes the same shared-memory
sizes, which its ``ssd_chunk_smem`` reports to the card tests.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_P = 128              # head dims up to 4 column groups of 32
MAX_Q = 128              # chunk lengths up to 8 row tiles of 16
MAX_HT = 8               # heads a block of passes 1 and 3 walks (one warp scans each)
NW = 8                   # warps a block of passes 1 and 3
SMEM_LIMIT = 232_448     # shared memory one block may take on an H100
SM_SMEM = 233_472        # shared memory of one SM (228 KB); the runtime keeps 1 KB a block
_MAX_GRID_X = 2 ** 31 - 1
SM_COUNT = 132           # streaming multiprocessors of an H100 SXM
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int64] * 19 + [ctypes.c_void_p]


class SmemPlan(NamedTuple):
    stages_state: int    # ring stages of pass 1 (ssd_chunk_state_kernel)
    state_bytes: int
    stages_scan: int     # ring stages of pass 3 (ssd_chunk_scan_kernel)
    scan_bytes: int


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes that one SM's shared memory holds."""
    return SM_SMEM // (smem + 1024)


def smem_plan(q: int, p: int, n: int, elem_bytes: int, ht: int) -> SmemPlan:
    """Shared memory of one block of passes 1 and 3, in bytes, with two ring
    stages where they fit and one where they do not; pass 3 also takes one
    where that puts twice the blocks on an SM (bf16 at N 64), since its
    memory streams gain more from a second block than from a second stage.

    Tiles pad Q, N and P to 16; a row is 8 bf16 (4 f32) longer.  Pass 1: B
    (Q, N), dt and la/w of the ``ht`` heads (f32), and X (Q, P) per stage.
    Pass 3: C (Q, N), G = C·Bᵀ as the lower-triangular 16 x 16 tiles (f32),
    dt and la, for f32 one 16 x 20 S' scratch tile a warp, and a region that
    holds B while G is built and then the stages, each X and h_in (bf16: hi
    and lo; f32: one).
    """
    pad = 8 if elem_bytes == 2 else 4
    q16, n16, p16 = _r16(q), _r16(n), _r16(p)
    sn, sp, rt = n16 + pad, p16 + pad, q16 // 16
    tile_n = q16 * sn * elem_bytes
    tile_x = q16 * sp * elem_bytes
    tile_h = (2 if elem_bytes == 2 else 1) * n16 * sp * elem_bytes
    ladt = 2 * ht * q16 * 4
    g = rt * (rt + 1) // 2 * 256 * 4
    scratch = NW * 16 * 20 * 4 if elem_bytes == 4 else 0

    def state(st):
        return tile_n + ladt + st * tile_x

    def scan(st):
        return tile_n + g + ladt + scratch + max(tile_n, st * (tile_x + tile_h))

    st1 = 2 if state(2) <= SMEM_LIMIT else 1
    st3 = 2 if scan(2) <= SMEM_LIMIT else 1
    if st3 == 2 and blocks_per_sm(scan(1)) > blocks_per_sm(scan(2)):
        st3 = 1
    return SmemPlan(st1, state(st1), st3, scan(st3))


def head_tile(batch: int, chunks: int, heads: int, groups: int,
              sms: int = SM_COUNT) -> int:
    """Heads a block of passes 1 and 3 walks: the largest divisor of the heads
    per group, at most ``MAX_HT``, that still gives two blocks for every SM
    (C·Bᵀ is built once per block, so larger tiles share it more); 1 where
    none does."""
    hpg = heads // groups
    for d in range(min(MAX_HT, hpg), 0, -1):
        if hpg % d == 0 and batch * chunks * (heads // d) >= 2 * sms:
            return d
    return 1


def _views_ok(t: torch.Tensor, per16: int) -> bool:
    """Last dim contiguous, 16-byte aligned base and row strides."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per16 == 0 for st in t.stride()[:-1]))


class SplitPlan(NamedTuple):
    q: int                         # the chunk each launch runs
    cols: tuple[tuple[int, int], ...]   # the head-dim slices [c0, c1), one launch each


def split_plan(bsz: int, s: int, h: int, g: int, p: int, n: int, chunk: int,
               elem_bytes: int, sms: int = SM_COUNT) -> SplitPlan:
    """How ``ssd_chunk_cuda`` runs a shape beyond one launch's limits.

    The scan's result does not depend on the chunk length (up to rounding),
    and each column of y and of the state depends only on its own column of
    x.  So a chunk above ``MAX_Q``, or one whose plan exceeds ``SMEM_LIMIT``,
    runs at the largest divisor of ``chunk`` that fits both (it divides S
    too), and a head dim above ``MAX_P`` runs as column slices of at most
    ``MAX_P`` (starts at multiples of 128 keep each slice's rows 16-byte
    aligned).  Raises ValueError where even a chunk of 1 does not fit (only
    a very large state width N).
    """
    cols = tuple((c0, min(c0 + MAX_P, p)) for c0 in range(0, p, MAX_P))
    pw = min(p, MAX_P)
    for q in range(min(chunk, MAX_Q), 0, -1):
        if chunk % q:
            continue
        plan = smem_plan(q, pw, n, elem_bytes, head_tile(bsz, s // q, h, g, sms))
        if max(plan.state_bytes, plan.scan_bytes) <= SMEM_LIMIT:
            return SplitPlan(q, cols)
    raise ValueError(f"state width N {n} (P {pw}, {elem_bytes}-byte operands) needs "
                     f"more than {SMEM_LIMIT} B of shared memory at every chunk")


def ssd_chunk_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                   b_mat: torch.Tensor, c_mat: torch.Tensor, d_vec: torch.Tensor,
                   chunk: int, return_state: bool = False):
    """x (B, S, H, P), b_mat/c_mat (B, S, G, N), all f32 or all bf16 (the
    model's compute type, read in place: views with the last dimension
    contiguous); dt (B, S, H), a (H,) and d_vec (H,) f32; one CUDA device.
    Returns y (B, S, H, P) f32 and, with ``return_state``, the final states
    (B, H, N, P) f32.  Any chunk that divides S and any head dim run: the
    launches follow ``split_plan``, one counted launch per column slice."""
    args = (x, dt, a, b_mat, c_mat, d_vec)
    if not all(t.is_cuda for t in args) or len({t.device for t in args}) != 1:
        raise ValueError("ssd_chunk_cuda needs every input on one CUDA device")
    ops = (x, b_mat, c_mat)
    if len({t.dtype for t in ops}) != 1 or x.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != torch.float32 for t in (dt, a, d_vec)):
        raise ValueError("ssd_chunk_cuda takes x, B and C all f32 or all bf16 and dt, a, D "
                         "in f32, got " + "/".join(str(t.dtype) for t in args))
    if x.dim() != 4 or b_mat.dim() != 4 or b_mat.shape != c_mat.shape:
        raise ValueError(f"shapes {tuple(x.shape)}, {tuple(b_mat.shape)}, "
                         f"{tuple(c_mat.shape)} are not (B, S, H, P), (B, S, G, N) x2")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if dt.shape != (bsz, s, h) or a.shape != (h,) or d_vec.shape != (h,) \
            or b_mat.shape[:2] != (bsz, s):
        raise ValueError(f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, d {tuple(d_vec.shape)} "
                         f"do not fit x {tuple(x.shape)} and B {tuple(b_mat.shape)}")
    if g == 0 or h % g:
        raise ValueError(f"{h} heads are not a multiple of {g} groups")
    if chunk < 1 or s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of a chunk {chunk} >= 1")
    if p < 1 or n < 1:
        raise ValueError(f"head dim {p} or state {n} < 1")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = split_plan(bsz, s, h, g, p, n, chunk, x.element_size(), sms)
    if len(plan.cols) == 1:
        return _launch(x, dt, a, b_mat, c_mat, d_vec, plan.q, return_state, sms)
    outs = [_launch(x[..., c0:c1], dt, a, b_mat, c_mat, d_vec, plan.q, return_state, sms)
            for c0, c1 in plan.cols]
    if not return_state:
        return torch.cat(outs, dim=-1)
    return torch.cat([o[0] for o in outs], dim=-1), torch.cat([o[1] for o in outs], dim=-1)


def _launch(x, dt, a, b_mat, c_mat, d_vec, chunk, return_state, sms):
    """One counted launch of K6 on a shape ``split_plan`` admits."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    elem = x.element_size()
    per16 = 16 // elem
    nc = s // chunk
    ht = head_tile(bsz, nc, h, g, sms)
    if bsz * h * max(nc, n) > _MAX_GRID_X:
        raise ValueError(f"B {bsz}, H {h}, {nc} chunks, N {n} exceed the launch grid")
    plan = smem_plan(chunk, p, n, elem, ht)
    y = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    h_fin = (torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
             if return_state else None)
    if x.numel() == 0:
        if h_fin is not None:
            h_fin.zero_()
        return (y, h_fin) if return_state else y
    # 16-byte rows: P and N in whole 16-byte chunks, zero-padded where they
    # are not (no model has such a width; the padded rows add nothing).
    pp, nn = -(-p // per16) * per16, -(-n // per16) * per16
    if pp != p:
        x = F.pad(x, (0, pp - p))
    if nn != n:
        b_mat, c_mat = F.pad(b_mat, (0, nn - n)), F.pad(c_mat, (0, nn - n))
    x, b_mat, c_mat = (t if _views_ok(t, per16) else t.contiguous() for t in (x, b_mat, c_mat))
    dt, a, d_vec = dt.contiguous(), a.contiguous(), d_vec.contiguous()
    y_k = y if pp == p else torch.empty((bsz, s, h, pp), dtype=torch.float32, device=x.device)
    h_k = h_fin if nn == n and pp == p else (
        torch.empty((bsz, h, nn, pp), dtype=torch.float32, device=x.device)
        if return_state else None)
    states = torch.empty((bsz, nc, h, nn, pp), dtype=torch.float32, device=x.device)
    laq = torch.empty((bsz, nc, h), dtype=torch.float32, device=x.device)
    symbol = "ssd_chunk_bf16" if elem == 2 else "ssd_chunk_f32"
    fn = _build.function("ssd_chunk", symbol, _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
                        c_mat.data_ptr(), d_vec.data_ptr(), y_k.data_ptr(),
                        0 if h_k is None else h_k.data_ptr(), states.data_ptr(),
                        laq.data_ptr(), bsz, s, h, g, pp, nn, chunk, ht,
                        plan.stages_state, plan.stages_scan, *x.stride()[:3],
                        *b_mat.stride()[:3], *c_mat.stride()[:3], stream), "ssd_chunk")
    _build.launch_counts["ssd_chunk"] += 1
    if y_k is not y:
        y.copy_(y_k[..., :p])
    if h_k is not None and h_k is not h_fin:
        h_fin.copy_(h_k[:, :, :n, :p])
    return (y, h_fin) if return_state else y

