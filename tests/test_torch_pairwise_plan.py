"""The pairwise kernel block's launch planner (``repro_torch.kernels.pairwise``)
on the CPU: no card, no build.

Every shape the paths launch takes the family its design names, one grid
whatever the batch (a call is one launch), a shared-memory count within the
default 48 KB (so no opt-in), and grid dimensions the card takes.  The
kernels' own count of the shared memory is held against the planner's on
the card (tests/test_torch_cuda.py).
"""
import pytest
import torch

from repro_torch.kernels import pairwise as pw
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)

F32, BF16 = torch.float32, torch.bfloat16
N = 2 ** 20
SMEM_LIMIT = 232_448        # shared memory one block may opt in to on an H100
MAX_GRID_X = 2 ** 31 - 1


def _levels(leaves: int, rank: int, f: int):
    """(batch, rank, rank, f) of each coupling level of a build over ``leaves``."""
    out, n = [], leaves
    while n > 1:
        out.append((n // 2, rank, rank, f))
        n //= 2
    return out


# (batch, ma, mb, f, dtype, family): the rows of PERF.md's kernel table, then
# the other launches of the paths.
PATH_SHAPES = [
    (1, 2048, N, 8, F32, "wide"),            # scoring block ([main], [lap], tasks)
    (4096, 256, 256, 8, F32, "wide"),        # leaf D
    (2048, 32, 32, 8, F32, "packed"),        # coupling, level 1
    (1, 2048, N, 2, F32, "wide"),            # [accurate] / [svr] / [gp] scoring
    (4096, 256, 256, 2, F32, "wide"),        # [accurate] leaf D
    (16, 256, 256, 8, F32, "wide"),          # [stream] leaf D batch
    (16, 32, 32, 8, F32, "packed"),          # [stream] level batch
    (1, 32, 32, 8, F32, "packed"),           # [stream] root
    (1, 2, N, 8, F32, "skinny"),             # [serve] loop tick
    (1, 128, N, 8, F32, "wide"),             # [serve] tick
    (1, 128, N, 8, BF16, "wide"),            # [serve] bf16 policy tick
    (1, 64, N, 8, F32, "wide"),              # the serving engine's default buckets
    (1, 256, N, 8, F32, "wide"),
    (1, 1024, N, 8, F32, "wide"),
    (1, 4096, N, 8, F32, "wide"),
    (4096, 256, 256, 8, BF16, "wide"),       # K4 leaf D bf16
    (1, 65536, 65536, 4, F32, "wide"),       # [baselines] dense K
    (1, 65536, 256, 4, F32, "wide"),         # [baselines] Nystrom K(X, L)
    (1, 256, 256, 4, F32, "wide"),           # [baselines] Nystrom W
    (512, 128, 128, 4, F32, "wide"),         # [baselines] HSS leaf D (leaf 128)
    (1, 1024, 65536, 4, F32, "wide"),        # [baselines] scoring
    (70_000, 5, 3, 8, F32, "packed"),        # a batch above 65535
    (131_072, 64, 64, 8, F32, "packed"),     # chip_smoke's 10^7-point leaf count
    (2048, 64, 64, 2, F32, "packed"),        # an adaptive build's couplings at the cap
    (2048, 33, 33, 2, F32, "packed"),        # ... and below it
    (2, 1, N, 8, F32, "skinny"),             # a 1-row request against two supports
    (1, 16, N, 8, F32, "skinny"),
    (1, 17, N, 8, F32, "wide"),
]
PATH_SHAPES += [(*s, F32, "packed") for s in _levels(4096, 32, 8)]    # [main] couplings
PATH_SHAPES += [(*s, F32, "packed") for s in _levels(4096, 64, 2)]    # [accurate], at the cap
PATH_SHAPES += [(*s, F32, "packed") for s in _levels(512, 32, 4)]     # [baselines]' HSS


def _assert_invariants(p: pw.Plan, batch: int, ma: int, mb: int, f: int, dtype) -> None:
    elem = dtype.itemsize
    assert p.threads == pw.THREADS
    assert 1 <= p.grid[0] <= MAX_GRID_X and 1 <= p.grid[1] <= pw.MAX_GRID_Y
    assert 1 <= p.grid[2] <= pw.MAX_GRID_Y
    assert p.smem == pw.smem_bytes(p.family, elem, ma, mb, f, p.param)
    assert 0 < p.smem <= pw.SMEM_DEFAULT <= SMEM_LIMIT
    if p.family == pw.SKINNY:
        assert ma <= p.param in pw.SKINNY_ROWS
        assert p.grid[1] == min(batch, pw.MAX_GRID_Y)
        assert p.grid[0] <= -(-(-(-mb // 4)) // pw.THREADS)   # no block without a quad
        assert p.vec_load == (f * elem % 16 == 0)
    elif p.family == pw.PACKED:
        assert p.grid == (-(-batch // p.param), 1, 1) and p.param >= 1
        assert p.param * ma * mb <= max(pw.PACKED_OUTPUTS, ma * mb)
    else:
        tm, tn = pw.wide_tile(elem)
        assert (tm, tn) == ((64, 128) if elem == 4 else (32, 256))
        assert p.grid == (-(-mb // tn), -(-ma // tm), min(batch, pw.MAX_GRID_Y))


@pytest.mark.parametrize("batch,ma,mb,f,dtype,family", PATH_SHAPES)
def test_path_shapes_take_their_family(batch, ma, mb, f, dtype, family):
    p = pw.plan(batch, ma, mb, f, dtype)
    assert p.family == family, p
    _assert_invariants(p, batch, ma, mb, f, dtype)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("ma", [1, 2, 3, 15, 16, 17])
@pytest.mark.parametrize("f", [1, 2, 5, 8, 11, 33])
def test_ragged_shapes_plan_within_limits(ma, f, dtype):
    """Mb off a multiple of 4, small and long, single and batched; every
    family forced where it can take the shape, the free choice always."""
    for batch, mb in ((1, 7), (3, 130), (2, 1027), (70_000, 5), (1, 4099)):
        _assert_invariants(pw.plan(batch, ma, mb, f, dtype), batch, ma, mb, f, dtype)
        for family in pw.FAMILIES:
            try:
                p = pw.plan(batch, ma, mb, f, dtype, family=family)
            except ValueError:
                feasible = {pw.SKINNY: ma <= 16 and 4 * (ma * f + ma) <= pw.SMEM_DEFAULT,
                            pw.PACKED: pw.smem_bytes(pw.PACKED, 4, ma, mb, f, 1)
                            <= pw.SMEM_DEFAULT,
                            pw.WIDE: True}
                assert not feasible[family], (family, batch, ma, mb, f)
                continue
            assert p.family == family
            _assert_invariants(p, batch, ma, mb, f, dtype)


@pytest.mark.parametrize("mb,dtype", [
    (128, F32), (130, F32), (4, F32), (6, F32),
    (136, BF16), (132, BF16), (8, BF16), (N, BF16),
])
def test_wide_plan_at_any_row_alignment(mb, dtype):
    """The wide kernel stores 16 bytes a thread where the output rows are
    16-byte aligned (Mb·elem % 16 == 0) and element by element at the edge
    otherwise; the plan is the same either way: one tile a block over every
    column, the staged tiles within 48 KB."""
    p = pw.plan(2, 300, mb, 8, dtype, family=pw.WIDE)
    tm, tn = pw.wide_tile(dtype.itemsize)
    assert p.family == pw.WIDE and p.grid == (-(-mb // tn), -(-300 // tm), 2)
    assert p.smem == pw.smem_bytes(pw.WIDE, dtype.itemsize, 300, mb, 8) <= pw.SMEM_DEFAULT
    _assert_invariants(p, 2, 300, mb, 8, dtype)


@pytest.mark.parametrize("batch", [1, 65_535, 65_536, 70_000, 131_072, 10 ** 6])
def test_one_launch_at_any_batch(batch):
    """No plan chunks the batch: packed puts it on grid.x, skinny loops over
    it from grid.y, wide walks its tiles."""
    for ma, mb, family in ((32, 32, pw.PACKED), (2, 4096, pw.SKINNY), (256, 256, pw.WIDE)):
        p = pw.plan(batch, ma, mb, 8, F32)
        assert p.family == family
        _assert_invariants(p, batch, ma, mb, 8, F32)


def test_packed_entries_a_block():
    """P: about PACKED_OUTPUTS outputs a block while the batch fills two
    blocks an SM, one entry a block on short batches, and the staged rows
    within 48 KB at wide F."""
    assert pw.plan(2048, 32, 32, 8, F32).param == 4
    assert pw.plan(16, 32, 32, 8, F32).param == 1
    assert pw.plan(131_072, 64, 64, 8, F32).param == 1
    assert pw.plan(2048, 8, 8, 8, F32).param == 7
    p = pw.plan(100_000, 16, 16, 200, F32)
    assert p.family == pw.PACKED and p.smem <= pw.SMEM_DEFAULT
    assert pw.plan(100_000, 16, 16, 200, F32, n_sm=1).param < 16


def test_skinny_grid_and_rows():
    p = pw.plan(1, 2, N, 8, F32)
    assert p.param == 2 and p.grid == (pw.N_SM * pw.SKINNY_BLOCKS_PER_SM, 1, 1) and p.vec_load
    assert pw.plan(1, 3, N, 8, F32).param == 4
    assert pw.plan(1, 9, N, 8, F32).param == 16
    assert pw.plan(1, 2, 2048, 8, F32).grid == (2, 1, 1)     # 512 quads: two blocks
    assert not pw.plan(1, 2, N, 5, F32).vec_load              # 20-byte rows
    assert not pw.plan(1, 2, N, 4, BF16).vec_load             # 8-byte rows
    assert pw.plan(1, 2, N, 8, BF16).vec_load
    assert not pw.plan(1, 2, N, 8, F32, aligned=False).vec_load
    assert pw.plan(100_000, 2, 4096, 8, F32).grid == (1, pw.MAX_GRID_Y, 1)


@pytest.mark.parametrize("shape,family", [
    ((4, 64, 1024, 8), "skinny"),               # 64 rows: above the skinny buckets
    ((1, 16, N, 800), "skinny"),                # the query rows above 48 KB
    ((4, 64, 2048, 8), "packed"),               # one entry's rows above 48 KB
    ((4, 64, 1024, 8), "tiled"),
    ((1, 2 ** 31, 4, 2), "wide"),               # rows past 32 bits
])
def test_forced_plans_that_cannot_run_raise(shape, family):
    with pytest.raises(ValueError):
        pw.plan(*shape, F32, family=family)


@pytest.mark.parametrize("shape", [(0, 2, 2, 2), (1, 0, 4, 2), (1, 2, 4, 0)])
def test_empty_or_featureless_blocks_raise(shape):
    with pytest.raises(ValueError):
        pw.plan(*shape, F32)


def test_dtypes():
    with pytest.raises(ValueError):
        pw.plan(1, 4, 4, 2, torch.float16)
    assert pw.plan(1, 4, 4, 2, BF16).family == pw.PACKED


def test_plan_labels():
    assert pw.plan(1, 2, N, 8, F32).label() == "skinny/R2"
    assert pw.plan(2048, 32, 32, 8, F32).label() == "packed/P4"
    assert pw.plan(1, 2048, N, 8, F32).label() == "wide"
    assert pw.plan(1, 2048, 2 ** 20 + 2, 8, BF16).label() == "wide"


def test_planner_makes_no_device_call(monkeypatch):
    """plan() reads nothing from the card: with every torch.cuda query
    patched to raise, the path shapes still plan (a launch inside a
    CUDA-graph capture, or under the analysis' host-sync probes, stays
    clean).  The wrapper reads the SM count once a device."""
    def boom(*a, **k):
        raise AssertionError("device call")
    for attr in ("get_device_properties", "synchronize", "current_device", "is_available"):
        monkeypatch.setattr(torch.cuda, attr, boom)
    for batch, ma, mb, f, dtype, family in PATH_SHAPES:
        assert pw.plan(batch, ma, mb, f, dtype).family == family
    monkeypatch.setattr(pw, "_SM", {3: 114})
    assert pw.sm_count(3) == 114
