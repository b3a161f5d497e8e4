"""Launcher of ``csrc/fused_assemble_id.cu`` (CUDA tensors only).

One node runs on a thread-block cluster of C CTAs, each owning m / C
candidate columns (their residual in its shared memory, or RREG rows a lane
of it in registers) with TPC threads a column.  ``plan`` chooses
(C, TPC, RREG) in plain Python from the level's shape and the card's SM
count and per-block shared-memory limit, so the choice can be checked
without the built library; ``smem_bytes`` is the kernel's own count
(``layout`` in the source).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

_KINDS = {"gaussian": 0, "laplacian": 1}
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_BAD_PLAN = -2

N_SM = 132                  # an H100 SXM's streaming multiprocessors
SMEM_LIMIT = 232_448        # shared memory one block may opt in to on an H100
SMEM_PER_SM = 233_472       # an H100 SM's shared memory, 1 KB of it reserved a block
CLUSTERS = (1, 2, 4, 8)     # portable cluster sizes
MAX_THREADS = 1024          # threads of one CTA (the kernel's launch bound)
_SMEM_RESERVED = 1024       # the shared memory the runtime keeps for each block
REG_ROWS = 16               # residual rows a lane keeps in registers, where used
CLUSTER_WORK = 16_384       # m·s of a node below which clusters never paid (measured)


def block_threads(m: int, c: int, tpc: int) -> int:
    """Threads of one CTA: (m / C)·TPC rounded up to whole warps."""
    return -(-(m // c) * tpc // 32) * 32


def row_lanes(s: int, threads: int) -> int:
    """G, the lanes a row in the re-orthogonalisation: the largest power of
    two <= 32 with G·s <= threads."""
    g = 1
    while g < 32 and 2 * g * s <= threads:
        g *= 2
    return g


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def smem_bytes(m: int, s: int, k: int, c: int, tpc: int, rreg: int = 0) -> int:
    """Shared memory of one CTA (the kernel's ``layout``): its m/C residual
    columns over their first s_sm = s - rreg·TPC rows (the others live in
    registers, rreg a lane), each lane's block of rows (a multiple of 4)
    stored rbs apart (an odd multiple of 32/TPC) and the columns
    ss = TPC·rbs + 1 apart, so that a warp's lanes read 32 banks; Q (k
    directions of stride s32 + 32/G, so the G lanes of a row hit 32 banks);
    q, the pivot column over its norm and the proxy norms; Qᵀq; a cluster's
    exchange buffers (C candidate columns and (norm, index) pairs in two
    parities; none at C = 1); the argmax and sum scratch of its warps."""
    mc, threads = m // c, block_threads(m, c, tpc)
    s_sm = s - rreg * tpc
    rb0 = _round4(-(-s_sm // tpc))
    unit = 32 // tpc
    rbs = rb0 if tpc == 1 else (-(-rb0 // unit) | 1) * unit
    ss = tpc * rbs + 1
    qs = -(-s // 32) * 32 + 32 // row_lanes(s, threads)
    cc = c if c > 1 else 0
    floats = (_round4(mc * ss) + _round4(k * qs) + _round4(s) + 2 * s + k + 2 * cc * s
              + 4 * cc + 3 * (threads // 32))
    return 4 * floats


def ctas_per_sm(m: int, s: int, k: int, c: int, tpc: int, rreg: int = 0) -> int:
    """CTAs of this plan one SM holds: by shared memory, by registers (the
    kernel's launch bounds give a lane 64, or 128 with rows in registers),
    by threads (2048) and by blocks (32)."""
    threads = block_threads(m, c, tpc)
    regs = 128 if rreg else 64
    return min(SMEM_PER_SM // (smem_bytes(m, s, k, c, tpc, rreg) + _SMEM_RESERVED),
               65_536 // (threads * regs), 2048 // threads, 32)


def option(m: int, s: int, k: int, c: int, b: int = 1, n_sm: int = N_SM,
           smem_limit: int = SMEM_LIMIT) -> tuple[int, int] | None:
    """(TPC, RREG) of cluster size ``c`` for a level of ``b`` nodes, or None
    where no CTA fits.  RREG = 0 keeps the whole residual in shared memory;
    where that does not fit, REG_ROWS rows a lane go to registers (CTAs of
    at most 512 threads).  TPC takes the fewest waves of CTAs over ``n_sm``
    SMs, then the most threads up to 512: more nodes in flight hide more of
    a step's latency, more lanes a column shorten its chains."""
    if m % c or m // c > MAX_THREADS:
        return None
    best = None
    for t in (1, 2, 4, 8, 16, 32):
        threads = block_threads(m, c, t)
        if t > 1 and (t > s or threads > MAX_THREADS // 2):
            continue
        if smem_bytes(m, s, k, c, t) <= smem_limit:
            rreg = 0
        elif (threads <= MAX_THREADS // 2 and REG_ROWS * t < s
              and smem_bytes(m, s, k, c, t, REG_ROWS) <= smem_limit):
            rreg = REG_ROWS
        else:
            continue
        per_sm = ctas_per_sm(m, s, k, c, t, rreg)
        if per_sm < 1:
            continue
        key = (-(-b * c // (n_sm * per_sm)), -threads)   # waves, then threads
        if best is None or key < best[0]:
            best = (key, (t, rreg))
    return None if best is None else best[1]


def feasible(m: int, s: int, k: int, b: int = 1, n_sm: int = N_SM,
             smem_limit: int = SMEM_LIMIT) -> list[tuple[int, int, int]]:
    """Every (C, TPC, RREG) the kernel can take at this shape, by increasing C."""
    return [(c, *o) for c in CLUSTERS
            if (o := option(m, s, k, c, b, n_sm=n_sm, smem_limit=smem_limit)) is not None]


def plan(b: int, m: int, s: int, k: int, n_sm: int = N_SM,
         smem_limit: int = SMEM_LIMIT) -> tuple[int, int, int]:
    """(C, TPC, RREG) for a level of ``b`` nodes.  One CTA a node (C = 1)
    while the level has a node for every other SM, or while a node's block
    is small (m·s < CLUSTER_WORK: a step's work then costs less than a
    cluster barrier); on the last few nodes of a large block, the largest C
    that keeps B·C CTAs on at most half the SMs, so that the scheduler can
    give every CTA an SM of its own.  The thresholds are the measured ones
    (chip_smoke.py's sweep of every C at every level; PERF.md)."""
    fits = feasible(m, s, k, b, n_sm, smem_limit)
    if not fits:
        raise ValueError(f"fused_assemble_id: no cluster of {CLUSTERS} fits a node of "
                         f"m={m}, s={s}, k={k} in {smem_limit} bytes of shared memory")
    if b >= n_sm // 2 or m * s < CLUSTER_WORK:
        return fits[0]
    within = [f for f in fits if b * f[0] <= n_sm // 2]
    return within[-1] if within else fits[0]


def _card(dev: int) -> tuple[int, int]:
    props = torch.cuda.get_device_properties(dev)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def kernel_smem_bytes(m: int, s: int, k: int, c: int, tpc: int, rreg: int = 0) -> int:
    """The kernel's own count of ``smem_bytes`` (from the built library)."""
    fn = _build.function("fused_assemble_id", "fused_assemble_id_smem_bytes",
                         [ctypes.c_int] * 6, ctypes.c_longlong)
    return int(fn(m, s, k, c, tpc, rreg))


def max_active_clusters(m: int, s: int, k: int, c: int, tpc: int, rreg: int, device: int,
                        kernel_name: str = "gaussian") -> int:
    """cudaOccupancyMaxActiveClusters of the kernel at (C, TPC, RREG)."""
    fn = _build.function("fused_assemble_id", "fused_assemble_id_max_clusters",
                         [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)])
    out = ctypes.c_int(0)
    _build.check(fn(_KINDS[kernel_name], m, s, k, c, tpc, rreg, device, ctypes.byref(out)),
                 "fused_assemble_id_max_clusters")
    return out.value


def fused_assemble_id_cuda(xc: torch.Tensor, xp: torch.Tensor, cmask: torch.Tensor,
                           k: int, h: float, kernel_name: str = "gaussian", *,
                           cluster: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """xc (B, m, f), xp (B, s, f), cmask (B, m), all f32 on one CUDA device
    -> (piv (B, k) int32, R (B, k, m) f32).  One launch for all B nodes, a
    cluster of C CTAs each: ``plan``'s C, or ``cluster`` where given (the
    sweep of chip_smoke.py and the tests).  Raises without launching when
    no cluster fits a node."""
    tensors = (xc, xp, cmask)
    if kernel_name not in _KINDS:
        raise ValueError(f"unknown kernel {kernel_name!r}")
    if not all(t.is_cuda and t.device == xc.device for t in tensors):
        raise ValueError("fused_assemble_id_cuda needs all inputs on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("fused_assemble_id_cuda takes f32 inputs")
    if xc.dim() != 3 or xp.dim() != 3 or xp.shape[0] != xc.shape[0] \
            or xp.shape[2] != xc.shape[2] or cmask.shape != xc.shape[:2]:
        raise ValueError(f"shapes xc {tuple(xc.shape)}, xp {tuple(xp.shape)}, "
                         f"cmask {tuple(cmask.shape)} do not match")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_assemble_id_cuda needs contiguous inputs")
    batch, m, f = xc.shape
    s = xp.shape[1]
    if not 1 <= k <= m or s < 1:
        raise ValueError(f"need 1 <= k <= m and s >= 1, got k={k}, m={m}, s={s}")
    piv = torch.empty((batch, k), dtype=torch.int32, device=xc.device)
    r = torch.empty((batch, k, m), dtype=torch.float32, device=xc.device)
    if batch == 0:
        return piv, r
    dev = xc.device.index if xc.device.index is not None else torch.cuda.current_device()
    n_sm, smem_limit = _card(dev)
    if cluster is None:
        c, tpc, rreg = plan(batch, m, s, k, n_sm, smem_limit)
    else:
        got = option(m, s, k, cluster, batch, n_sm, smem_limit)
        if got is None:
            raise ValueError(f"fused_assemble_id: a cluster of {cluster} does not fit "
                             f"m={m}, s={s}, k={k}")
        c, (tpc, rreg) = cluster, got
    # The gaussian branch takes -1/2h² (rounded to f32 as the reference
    # does); the laplacian branch divides by h itself, as the reference does.
    param = (float(np.float32(-0.5 / (h * h))) if kernel_name == "gaussian"
             else float(h))
    fn = _build.function("fused_assemble_id", "fused_assemble_id_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(_KINDS[kernel_name], xc.data_ptr(), xp.data_ptr(), cmask.data_ptr(),
                 piv.data_ptr(), r.data_ptr(), batch, m, s, f, k, param, c, tpc, rreg,
                 dev, torch.cuda.current_stream().cuda_stream)
    if err == _BAD_PLAN:
        raise ValueError(f"fused_assemble_id: the card refuses C={c}, TPC={tpc}, RREG={rreg} at "
                         f"m={m}, s={s}, k={k}")
    _build.check(err, "fused_assemble_id")
    _build.launch_counts["fused_assemble_id"] += 1
    return piv, r
