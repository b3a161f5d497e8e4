"""K2's cluster planner (``repro_torch.kernels.compress.kernel.plan``) on the
CPU: plain Python, no card and no built library needed.

At every K2 shape of the three SVM paths of ``chip_smoke.py`` (12 levels
each, 2²⁰ points at leaf 256) the chosen cluster size C, threads a column
TPC and register rows RREG must give a CTA that fits an H100 block's shared
memory and thread limit, with at least one CTA an SM; a level with a node
for every other SM, or with small nodes, runs one CTA a node, and a thin
level of large nodes spreads them over a quarter to half of the SMs.
"""
import pytest

from repro_torch.core.compression import CompressionParams
from repro_torch.kernels.compress import kernel as ckern
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

LEVELS, LEAF = 12, 256
PATHS = {
    "main": CompressionParams(rank=32, n_near=32, n_far=32),
    "lap": CompressionParams.crude(),
    "accurate": CompressionParams.accurate(),
}


def level_shapes(params: CompressionParams) -> list[tuple[int, int, int, int]]:
    """(B, m, s, k) of K2's launch at each level, as ``compression.compress``
    makes them: the leaf, then levels 1..11 on the children's skeletons."""
    r0 = min(params.rank, LEAF)
    shapes = [(2 ** LEVELS, LEAF, params.n_near + params.n_far, r0)]
    r_prev = r0
    for lvl in range(1, LEVELS):
        r_k = min(params.rank, 2 * r_prev)
        shapes.append((2 ** (LEVELS - lvl), 2 * r_prev, 2 * r_prev + params.n_far, r_k))
        r_prev = r_k
    return shapes


CASES = [(path, lvl, *shape) for path, params in PATHS.items()
         for lvl, shape in enumerate(level_shapes(params))]


@pytest.mark.parametrize("path,lvl,b,m,s,k", CASES,
                         ids=[f"{c[0]}-level{c[1]}" for c in CASES])
def test_plan_fits_and_fills_the_card(path, lvl, b, m, s, k):
    c, tpc, rreg = ckern.plan(b, m, s, k)
    assert c in ckern.CLUSTERS and m % c == 0
    assert ckern.smem_bytes(m, s, k, c, tpc, rreg) <= 232_448
    threads = ckern.block_threads(m, c, tpc)
    assert threads % 32 == 0 and (m // c) * tpc <= threads <= ckern.MAX_THREADS
    assert 1 <= tpc <= 32 and tpc & (tpc - 1) == 0
    assert rreg in (0, ckern.REG_ROWS) and rreg * tpc < s
    assert rreg == 0 or threads <= ckern.MAX_THREADS // 2
    assert ckern.ctas_per_sm(m, s, k, c, tpc, rreg) >= 1
    if b >= ckern.N_SM // 2 or m * s < ckern.CLUSTER_WORK:
        assert c == 1                       # one CTA a node
    elif b * max(ckern.CLUSTERS) >= ckern.N_SM // 4:
        assert ckern.N_SM // 4 < b * c <= ckern.N_SM // 2   # a quarter to half the SMs
    else:
        assert c == max(ckern.CLUSTERS)


def test_the_paths_shapes():
    """The shapes of PERF.md's K2 rows: leaf and level 1 of each path."""
    assert level_shapes(PATHS["main"])[:2] == [(4096, 256, 64, 32), (2048, 64, 96, 32)]
    assert level_shapes(PATHS["lap"])[:2] == [(4096, 256, 64, 32), (2048, 64, 96, 32)]
    assert level_shapes(PATHS["accurate"])[:2] == [(4096, 256, 192, 64), (2048, 128, 256, 64)]
    assert level_shapes(PATHS["accurate"])[-1] == (2, 128, 256, 64)


def test_accurate_leaf_keeps_rows_in_registers():
    """Residual and Q of the accurate leaf (m=256, s=192, k=64) take 255 KB
    in one CTA, more than a block gets; one CTA still takes a node by
    keeping 16 rows a lane (32 rows of the residual) in registers, in
    220,864 B of shared memory and 512 threads, one CTA an SM.  Clusters of
    2, 4 and 8 fit it all in shared memory."""
    m, s, k = 256, 192, 64
    assert ckern.smem_bytes(m, s, k, 1, 2) > 232_448
    assert ckern.plan(4096, m, s, k) == (1, 2, ckern.REG_ROWS)
    assert ckern.smem_bytes(m, s, k, 1, 2, ckern.REG_ROWS) == 220_864
    assert ckern.ctas_per_sm(m, s, k, 1, 2, ckern.REG_ROWS) == 1
    assert [(c, r) for c, _, r in ckern.feasible(m, s, k, 4096)] == [
        (1, ckern.REG_ROWS), (2, 0), (4, 0), (8, 0)]


def test_smem_count_by_hand():
    """The main leaf at C = 1, TPC = 1 (256 threads, G = 4 lanes a row):
    256 columns of stride 64 + 1, Q of 32 directions of stride 64 + 32/4,
    q, the pivot column and the proxy norms (3·64), 32 of Qᵀq, no exchange
    buffers, 3·8 of scratch: 76,768 B, three CTAs an SM."""
    floats = 256 * 65 + 32 * 72 + 3 * 64 + 32 + 3 * 8
    assert ckern.smem_bytes(256, 64, 32, 1, 1) == 4 * floats == 76_768
    assert ckern.ctas_per_sm(256, 64, 32, 1, 1) == 3


@pytest.mark.parametrize("b,m,s,k,want", [
    (4096, 256, 64, 32, (1, 1, 0)),     # main leaf: three nodes an SM
    (2048, 64, 96, 32, (1, 4, 0)),      # main level 1: four nodes an SM
    (128, 64, 96, 32, (1, 8, 0)),       # one wave: more lanes a column
    (2, 64, 96, 32, (1, 8, 0)),         # small nodes: no cluster
    (2048, 128, 256, 64, (1, 4, 0)),    # accurate level 1
    (32, 128, 256, 64, (2, 8, 0)),      # accurate level 7
    (16, 128, 256, 64, (4, 16, 0)),     # accurate level 8
    (2, 128, 256, 64, (8, 32, 0)),      # the top levels: a cluster of 8
])
def test_plan_at_the_measured_shapes(b, m, s, k, want):
    """The plans whose alternatives PERF.md records measured, C and TPC."""
    assert ckern.plan(b, m, s, k) == want


def test_plan_spreads_a_thin_level_of_large_nodes():
    """C = 1 down to a node for every other SM, then the largest C that
    keeps B·C CTAs on at most half the SMs, up to 8; small nodes never
    take a cluster."""
    assert [ckern.plan(b, 128, 256, 64)[0] for b in (256, 66, 64, 32, 16, 8, 2)] == [
        1, 1, 1, 2, 4, 8, 8]
    assert {ckern.plan(b, 64, 96, 32)[0] for b in (256, 64, 16, 2)} == {1}


def test_plan_takes_the_card_it_is_given():
    """A card with fewer SMs keeps C = 1 on a thinner level; a smaller
    shared-memory limit rules out the plans whose CTA does not fit."""
    assert ckern.plan(16, 128, 256, 64, n_sm=32)[0] == 1
    m, s, k = 128, 256, 64
    assert ckern.plan(2048, m, s, k)[0] == 1
    assert ckern.plan(2048, m, s, k, smem_limit=150_000)[0] == 2


def test_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="no cluster"):
        ckern.plan(4, 256, 2048, 256)
