"""The launch planner and launcher of the pairwise kernel block
(``csrc/pairwise_block.cuh``), shared by K1 (``kernels/gaussian/kernel.py``)
and K4 (``kernels/compress/laplacian.py``).

``plan`` maps a call's (batch, Ma, Mb, F, dtype) to one of three kernel
families and its launch parameters, in plain Python, so that the choice can
be checked without the built library:

  skinny  Ma <= 16 query rows against a support of at least SKINNY_MIN_COLS
          rows (the serving loop's 2 x 2^20 tick);
  packed  small blocks, Ma·Mb <= PACKED_MAX_ENTRY (the couplings, the
          streamed level batches), P entries a block;
  wide    everything else (leaf D, scoring blocks, the 128-row tick, the
          dense K), one 64 x 128 output tile a block (32 x 256 in bf16) on
          a (column tiles, row tiles, batch) grid, with 16-byte stores.

A call is one launch, whatever the batch.  The SM count is read once a
device (``sm_count``); no plan makes a device call, so a launch inside a
CUDA-graph capture stays capturable.  The C launcher checks the plan's
shared memory against its own count and refuses one it cannot take.

A plan can be forced for a check on the card: ``gaussian_block_cuda(xa, xb,
h, family="packed")`` or ``laplacian_block_cuda(..., family="wide")``; a
family that cannot take the shape raises ValueError.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build

SKINNY, PACKED, WIDE = "skinny", "packed", "wide"
FAMILIES = (SKINNY, PACKED, WIDE)
_FAMILY_ID = {SKINNY: 0, PACKED: 1, WIDE: 2}
_VEC_LOAD = 1                # the C launcher's flag: 16-byte support loads (skinny)
_BAD_PLAN = -2

N_SM = 132                  # an H100 SXM's streaming multiprocessors
THREADS = 256               # threads of a block, every family
FC = 8                      # features a staged chunk (skinny, wide)
SMEM_DEFAULT = 49_152       # dynamic shared memory a block has without an opt-in
MAX_GRID_Y = 65_535
SKINNY_ROWS = (2, 4, 8, 16)       # the skinny kernel's row buckets
SKINNY_MIN_COLS = 1024            # support rows below which skinny is not chosen
SKINNY_BLOCKS_PER_SM = 4
PACKED_MAX_ENTRY = 4096           # Ma·Mb of the largest packed entry (64 x 64)
PACKED_OUTPUTS = 4096             # outputs a packed block aims at

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_float] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@dataclasses.dataclass(frozen=True)
class Plan:
    family: str
    grid: tuple[int, int, int]  # (x, y, z)
    threads: int
    smem: int                   # dynamic shared memory, bytes
    param: int                  # skinny: row bucket; packed: entries a block; wide: 0
    vec_load: bool              # skinny: 16-byte loads of the support rows

    @property
    def flags(self) -> int:
        return _VEC_LOAD if self.vec_load else 0

    def label(self) -> str:
        """``wide``, ``packed/P4``, ``skinny/R2``: the plan beside a time."""
        if self.family == WIDE:
            return WIDE
        return f"{self.family}/{'R' if self.family == SKINNY else 'P'}{self.param}"


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def wide_tile(elem: int) -> tuple[int, int]:
    """(TM, TN) of the wide kernel: a thread owns 16 bytes of a row (4 f32
    or 8 bf16 columns) over 32 accumulators' rows."""
    rn = 16 // elem
    return 8 * (32 // rn), 32 * rn


def smem_bytes(family: str, elem: int, ma: int, mb: int, f: int, param: int = 0) -> int:
    """Dynamic shared memory of a plan: the kernels' layout (``smem_bytes``
    in the source).  skinny: the query rows and their norms; packed: P
    entries' rows feature-major and their norms; wide: an F-chunk of both
    tiles (rows 4 floats longer than the tile) and their norms."""
    if family == SKINNY:
        return 4 * (ma * f + ma)
    if family == PACKED:
        return 4 * (_round4(param * ma * f) + _round4(param * mb * f) + param * (ma + mb))
    tm, tn = wide_tile(elem)
    return 4 * (FC * (tm + 4) + FC * (tn + 4) + tm + tn)


def _skinny_rows(ma: int) -> int | None:
    return next((r for r in SKINNY_ROWS if ma <= r), None)


def _packed_entries(batch: int, ma: int, mb: int, f: int, n_sm: int) -> int:
    """P: about PACKED_OUTPUTS outputs a block, at least two blocks an SM
    where the batch allows, and the staged rows within SMEM_DEFAULT."""
    p = max(1, min(PACKED_OUTPUTS // (ma * mb), batch // (2 * n_sm)))
    while p > 1 and smem_bytes(PACKED, 4, ma, mb, f, p) > SMEM_DEFAULT:
        p //= 2
    return p


def family_for(batch: int, ma: int, mb: int, f: int) -> str:
    """The family a shape takes when none is forced."""
    if (ma <= SKINNY_ROWS[-1] and mb >= SKINNY_MIN_COLS
            and smem_bytes(SKINNY, 4, ma, mb, f) <= SMEM_DEFAULT):
        return SKINNY
    if ma * mb <= PACKED_MAX_ENTRY and smem_bytes(PACKED, 4, ma, mb, f, 1) <= SMEM_DEFAULT:
        return PACKED
    return WIDE


def plan(batch: int, ma: int, mb: int, f: int, dtype: torch.dtype, *, n_sm: int = N_SM,
         family: str | None = None, aligned: bool = True) -> Plan:
    """The launch of a (batch, ma, f) x (batch, mb, f) block in ``dtype``
    (f32 or bf16).  ``family`` forces a plan (ValueError where it cannot
    take the shape); ``aligned``: the support's data pointer is 16-byte
    aligned (the skinny kernel's vector loads need it)."""
    if dtype not in _SUFFIX:
        raise ValueError(f"the pairwise block takes f32 or bf16, got {dtype}")
    if min(batch, ma, mb, f) < 1:
        raise ValueError(f"empty or featureless block ({batch}, {ma}, {mb}, {f})")
    elem = dtype.itemsize
    fam = family_for(batch, ma, mb, f) if family is None else family
    if fam not in FAMILIES:
        raise ValueError(f"unknown family {fam!r}; one of {FAMILIES}")
    if fam == SKINNY:
        rows = _skinny_rows(ma)
        smem = smem_bytes(SKINNY, elem, ma, mb, f)
        if rows is None or smem > SMEM_DEFAULT:
            raise ValueError(f"the skinny plan takes at most {SKINNY_ROWS[-1]} rows of "
                             f"{smem} <= {SMEM_DEFAULT} bytes, not {ma} x {f}")
        gy = min(batch, MAX_GRID_Y)
        quads = -(-mb // 4)
        gx = max(1, min(-(-quads // THREADS), -(-n_sm * SKINNY_BLOCKS_PER_SM // gy)))
        return Plan(SKINNY, (gx, gy, 1), THREADS, smem, rows, aligned and f * elem % 16 == 0)
    if fam == PACKED:
        p = _packed_entries(batch, ma, mb, f, n_sm)
        smem = smem_bytes(PACKED, elem, ma, mb, f, p)
        if smem > SMEM_DEFAULT:
            raise ValueError(f"one packed entry of {ma} x {mb} x {f} needs {smem} bytes "
                             f"of shared memory, above {SMEM_DEFAULT}")
        return Plan(PACKED, (-(-batch // p), 1, 1), THREADS, smem, p, False)
    if max(ma, mb) >= 2 ** 31 or -(-ma // wide_tile(elem)[0]) > MAX_GRID_Y:
        raise ValueError(f"the wide plan takes at most {MAX_GRID_Y} row tiles and "
                         f"32-bit rows and columns, not {ma} x {mb}")
    tm, tn = wide_tile(elem)
    return Plan(WIDE, (-(-mb // tn), -(-ma // tm), min(batch, MAX_GRID_Y)), THREADS,
                smem_bytes(WIDE, elem, ma, mb, f), 0, False)


_SM: dict[int, int] = {}


def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once."""
    n = _SM.get(index)
    if n is None:
        n = _SM[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


def _check(name: str, xa: torch.Tensor, xb: torch.Tensor) -> None:
    where = f"{name}_cuda"
    if not (xa.is_cuda and xb.is_cuda) or xa.device != xb.device:
        raise ValueError(f"{where} needs both inputs on one CUDA device")
    if xa.dtype not in _SUFFIX or xb.dtype != xa.dtype:
        raise ValueError(f"{where} takes f32 or bf16, got {xa.dtype}/{xb.dtype}")
    if xa.dim() != 3 or xb.dim() != 3 or xa.shape[0] != xb.shape[0] \
            or xa.shape[2] != xb.shape[2]:
        raise ValueError(f"shapes {tuple(xa.shape)} x {tuple(xb.shape)} are not "
                         "(B, Ma, F) x (B, Mb, F)")
    if not (xa.is_contiguous() and xb.is_contiguous()):
        raise ValueError(f"{where} needs contiguous inputs")


def plan_for(xa: torch.Tensor, xb: torch.Tensor, *, family: str | None = None) -> Plan:
    """The plan a launch on these CUDA tensors takes (B, Ma, F) x (B, Mb, F)."""
    batch, ma, f = xa.shape
    index = xa.device.index if xa.device.index is not None else torch.cuda.current_device()
    return plan(batch, ma, xb.shape[1], f, xa.dtype, n_sm=sm_count(index), family=family,
                aligned=xb.data_ptr() % 16 == 0)


def pairwise_block_cuda(name: str, xa: torch.Tensor, xb: torch.Tensor, scale: float, *,
                        family: str | None = None) -> torch.Tensor:
    """One launch of kernel library ``name`` (``gaussian_block`` or
    ``laplacian_block``) on (B, Ma, F) x (B, Mb, F) CUDA tensors -> (B, Ma,
    Mb) in the input type, with ``scale`` its f32 exponent factor, on
    ``plan``'s plan (``family`` forces one).  Raises before building or
    launching on anything else, and on a plan the kernel refuses."""
    _check(name, xa, xb)
    batch, ma, f = xa.shape
    mb = xb.shape[1]
    out = torch.empty((batch, ma, mb), dtype=xa.dtype, device=xa.device)
    if out.numel() == 0:
        return out
    p = plan_for(xa, xb, family=family)
    fn = _build.function(name, f"{name}_{_SUFFIX[xa.dtype]}", _ARGTYPES)
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xa.data_ptr(), xb.data_ptr(), out.data_ptr(), batch, ma, mb, f, scale,
                 _FAMILY_ID[p.family], *p.grid, p.smem, p.param, p.flags, stream)
    if err == _BAD_PLAN:
        raise ValueError(f"{name}: the kernel refuses plan {p} at ({batch}, {ma}, {mb}, {f})")
    _build.check(err, name)
    _build.launch_counts[name] += 1
    return out


def kernel_smem_bytes(name: str, elem: int, p: Plan, ma: int, mb: int, f: int) -> int:
    """The kernels' own count of plan ``p``'s shared memory (built library)."""
    fn = _build.function(name, f"{name}_smem_bytes",
                         [ctypes.c_int, ctypes.c_int] + [ctypes.c_int64] * 3 + [ctypes.c_int],
                         ctypes.c_longlong)
    return int(fn(elem, _FAMILY_ID[p.family], ma, mb, f, p.param))
