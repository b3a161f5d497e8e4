"""The work of K5 and K6, and the least time an H100 needs for it.

One count serves the card and the dry run: ``chip_smoke.py`` prints each
kernel's bound from ``k5_cost`` / ``k6_cost``, and the kernels' wrappers,
given meta tensors (``launch/dryrun.py``), launch nothing and ``record``
the same ``Work`` for the dry run's op counter (``roofline/op_cost.py``),
which sees no aten op inside a kernel.

Rates: the H100 SXM's data sheet at the 700 W limit (NVIDIA), not
measurements: HBM 3.35 TB/s, dense bf16 tensor cores 989 TFLOP/s, f32 67
TFLOP/s, NVLink 450 GB/s a direction; exp on the special-function units,
16 results per clock per SM (CUDA programming guide, compute capability
9.0) on 132 SMs at the 1.98 GHz that the f32 figure implies.
"""
from __future__ import annotations

import contextlib
import dataclasses

HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12
SFU_PER_S = 16 * 132 * 1.98e9
NVLINK_BYTES_PER_S = 450e9


@dataclasses.dataclass(frozen=True)
class Work:
    """What one kernel call must do: ``bytes`` (each input read once, each
    output written once), ``flops`` (the function's arithmetic, a
    multiply-add as 2), and the operations by the unit the kernel runs them
    on: ``tensor`` (bf16 tensor cores, hi/lo splits counted), ``f32`` (CUDA
    cores), ``sfu`` (exps)."""

    bytes: float
    flops: float
    tensor: float = 0.0
    f32: float = 0.0
    sfu: float = 0.0

    def bound(self) -> tuple[float, str]:
        """(ms, "bytes" or "operations"): the larger of the bytes at the HBM
        rate and the longest unit's operations at its rate (the units run
        side by side)."""
        t_ops = max(self.tensor / BF16_TC_FLOP_PER_S, self.f32 / F32_FLOP_PER_S,
                    self.sfu / SFU_PER_S) * 1e3
        t_bytes = self.bytes / HBM_BYTES_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def visible_pairs(s: int, causal: bool, window: int | None, prefix_len: int) -> int:
    """The (query, key) pairs of an S × S attention that its mask leaves
    visible (``attention/ref.py``'s ``visible``: prefix keys always, the
    others at or before the query where causal, within ``window`` of it
    where windowed), counted per query."""
    p = min(prefix_len, s)
    total = 0
    for q in range(s):
        lo = max(p, q - window + 1) if window else p
        hi = q + 1 if causal else s
        total += p + max(0, hi - lo)
    return total


def k5_work(b: int, h: int, kvh: int, s: int, d: int, elem_bytes: int, pairs: int) -> Work:
    """K5 on q (B, H, S, D), k and v (B, KV, S, D) with ``pairs`` visible
    pairs a head.  Bytes: q, k, v read once, out written once.  2D flops a
    pair for QKᵀ and 2D for P·V.  bf16 operands: QKᵀ on the tensor cores
    (their products are exact in f32), and P·V with the reference's f32 P
    as the least the card can do it, two bf16 products P_hi·V + P_lo·V (6D
    a pair in all).  f32 operands: both products at the f32 rate (no TF32).
    One exp a pair."""
    product = 2.0 * d * pairs * b * h
    return Work(bytes=elem_bytes * (2 * b * h * s * d + 2 * b * kvh * s * d),
                flops=2 * product,
                tensor=3 * product if elem_bytes == 2 else 0.0,
                f32=0.0 if elem_bytes == 2 else 2 * product,
                sfu=float(pairs * b * h))


def k6_work(b: int, s: int, h: int, p: int, g: int, n: int, q: int, elem_bytes: int) -> Work:
    """K6 on x (B, S, H, P), B and C (B, S, G, N), chunk Q.  Bytes: x, B and
    C read once in their type (``elem_bytes``), dt, a and D in f32, y and
    the final state written once in f32.  Operations on each chunk's lower
    triangle of Q(Q+1)/2 pairs: C·Bᵀ once per (b, chunk, group), 2N flops a
    pair (it does not depend on the head); per head scores·(dt x), 2P a
    pair, and C·h and the state update, 2QNP each.  bf16: on the tensor
    cores, C·Bᵀ as one product (bf16 values, exact in f32) and the other
    three as two each (their f32 factor as hi + lo, the least way to the
    reference's f32 numerics).  f32: on the CUDA cores (no TF32).  Exps:
    the gate a pair, w and exp(la) a position."""
    heads = float(b * h * (s // q))
    tri = q * (q + 1) // 2
    cb = 2.0 * n * tri * b * (s // q) * g
    per_head = 2.0 * p * tri + 4.0 * q * n * p
    return Work(bytes=(elem_bytes * (b * s * h * p + 2.0 * b * s * g * n)
                       + 4.0 * (b * s * h + 2 * h + b * s * h * p + b * h * n * p)),
                flops=cb + per_head * heads,
                tensor=cb + 2 * per_head * heads if elem_bytes == 2 else 0.0,
                f32=0.0 if elem_bytes == 2 else cb + per_head * heads,
                sfu=heads * (tri + 2 * q))


def k5_cost(b, h, kvh, s, d, elem_bytes, pairs) -> tuple[float, str]:
    """K5's bound: (ms, what bounds it)."""
    return k5_work(b, h, kvh, s, d, elem_bytes, pairs).bound()


def k6_cost(b, s, h, p, g, n, q, elem_bytes) -> tuple[float, str]:
    """K6's bound: (ms, what bounds it)."""
    return k6_work(b, s, h, p, g, n, q, elem_bytes).bound()


# ---------------------------------------------------------------------- #
# the meta path's tally                                                  #
# ---------------------------------------------------------------------- #
_tallies: list = []


def record(name: str, work: Work) -> None:
    """A kernel call on meta tensors: hand its work to every open tally."""
    for tally in _tallies:
        tally(name, work)


@contextlib.contextmanager
def tally(fn):
    """Call ``fn(name, work)`` for each kernel call ``record``ed in the block."""
    _tallies.append(fn)
    try:
        yield
    finally:
        _tallies.remove(fn)
