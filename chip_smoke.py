#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check its kernels.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printed on its own lines, none of them allowed to fail:
  1. device    — the card's name and power limit (nvidia-smi);
  2. build     — nvcc builds every CUDA kernel of the port from csrc/;
  3. kernels   — each kernel against its plain PyTorch version on the card,
                 at the shapes of the main path: K1 on a leaf-D batch, a
                 coupling batch and one scoring block; K2 on the leaf level
                 and the first upper level; K3 on a 2^20 block.  Kernel,
                 plain and bound times in ms;
  4. small     — a 2048-point engine run on the card against the same run
                 on the CPU (plain versions): bias and predictions agree;
  5. main path — HSSSVMEngine prepare / train(C=1) / predict on the
                 10^6-point blobs SVM at fixed rank 32, leaf 256 (2^20 padded
                 points, 12 levels); accuracy >= 0.93 and every K1/K2 launch
                 count equal to what the code implies;
  6. K3 path   — admm_svm_batched(use_fused_update=True) on the engine's
                 factorization against the unfused run; K3 launched 10 times;
  7. summary   — one JSON line {"kernels": [...]}, then the last line
                 {"ok": true, "device": {...}}.

It exits non-zero, before printing any result, when no CUDA device is
available or when the repro_torch package is not beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The repository's own paper-scale configuration (benchmarks/bench_svm.py,
# svm_scaling/n1000000), resident and at fixed rank.
N_TRAIN, N_TEST, N_FEATURES, SEP = 10 ** 6, 2048, 8, 1.6
H, RANK, N_NEAR, N_FAR, LEAF, MAX_IT, C = 1.0, 32, 32, 32, 256, 10, 1.0
MIN_ACCURACY = 0.93

HOLD_CYCLES = 100_000_000    # ~50 ms of spinning at the H100's ~2 GHz clock

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

# Tolerances of kernel against plain version, with their reasons.
K1_ATOL = 2e-5     # K in [0, 1]; f32 norm/cross sums in another order move sq
                   # by a few ulps of |a|²+|b|², times the exp slope <= 1/2h².
K2_PIV_MATCH = 0.999   # greedy pivots may flip on near-tied column norms
K2_R_ATOL = 1e-4   # R entries are O(sqrt(s)); f32 reorderings of k steps.
K3_RTOL = 1e-5     # the kernel multiplies by f32(1/beta), the plain version
                   # divides by beta: ~1 ulp, about 100x below this bound.
FUSED_Z_ATOL = 1e-4    # z in [0, C]; the 1/beta rounding through 10 solves
FUSED_RTOL = 1e-3      # mu and the residual traces, relative to their max


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after one warm-up.

    A spin kernel holds the device first, so the host queues every launch
    before the start event runs: the events then time the launches back to
    back, not the host's Python overhead between them.
    """
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_cost(b, ma, mb, f):
    """Bytes: inputs read once, block written once (f32).  Flops: 2f for
    the cross term, 5 for norms-combine, clamp, scale and exp, per entry."""
    return 4.0 * b * (ma * f + mb * f + ma * mb), float(b) * ma * mb * (2 * f + 5)


def k2_cost(b, m, s, f, k):
    """Bytes: points and mask in, pivots and R out.  Flops per node: the
    assembly, then per step the qᵀ·column dots, the deflation and the new
    column norms (6sm), re-orthogonalisation against the i earlier
    directions (4si) and the normalisations (4s + m).  R = QᵀAᵀ needs no
    pass of its own: R[i, :] is the row of qᵀ·column dots of step i."""
    bytes_moved = 4.0 * b * (m * f + s * f + m + k + k * m)
    per_node = s * m * (2 * f + 5) + sum(6 * s * m + 4 * s * i + 4 * s + m
                                         for i in range(k))
    return bytes_moved, float(b) * per_node


def k3_cost(n):
    """Three f32 reads and two writes per element; 6 flops."""
    return 20.0 * n, 6.0 * n


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the repro_torch package is not beside this script",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core import admm as admm_mod
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core import compression, tree as tree_mod
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import DEFAULT_SCORE_BLOCK, KernelSpec
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.admm_update import ops as aops, ref as aref
    from repro_torch.kernels.compress import kernel as ckern, ref as cref
    from repro_torch.kernels.gaussian import ops as gops, ref as gref

    # Full-f32 matmuls throughout (PyTorch's defaults, set here explicitly).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. device ---------------------------------------------------- #
    card = device_line()
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32}")

    # ---- 2. build ----------------------------------------------------- #
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {len(reports)} of {len(_build.KERNELS)} kernels compiled "
          f"in {time.perf_counter() - t0:.2f} s")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line:
                print(f"[build] {name}: {line.split(':', 1)[-1].strip()}")

    # ---- 3. kernels against their plain versions, main-path shapes ---- #
    # All-real points at the padded size (no inert pads: pad-pad Gaussian
    # values are cancellation noise in f32, see ROADMAP queue 3).
    x_np, _ = synthetic.blobs(2 ** 20, n_features=N_FEATURES, sep=SEP, seed=1)
    t0 = time.perf_counter()
    tree = tree_mod.build_tree(x_np, LEAF)
    t_tree = time.perf_counter() - t0
    x_host = x_np[tree.perm]
    x = torch.as_tensor(x_host, device=dev)
    n_leaf = tree.n_leaves
    xl = x.reshape(n_leaf, LEAF, N_FEATURES)
    rows = {}

    def k1_case(label, xa, xb, reps):
        out = gops.gaussian_block(xa, xb, H)
        ref = gref.gaussian_block_ref(xa, xb, H)
        err = (out - ref).abs().max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        del out, ref
        ms = time_ms(torch, lambda: gops.gaussian_block(xa, xb, H), reps)
        plain = time_ms(torch, lambda: gref.gaussian_block_ref(xa, xb, H), max(1, reps // 4))
        shape = (1, *xa.shape) if xa.dim() == 2 else tuple(xa.shape)
        b, ma, f = shape
        mb = xb.shape[-2]
        bms, by = bound(*k1_cost(b, ma, mb, f))
        print(f"[kernels] K1 gaussian_block {label} ({b},{ma},{f})x({b},{mb},{f}): "
              f"max_abs_err {err:.3e} (tol {K1_ATOL:g}), max_rel_err {rel:.3e}, "
              f"kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
        check(err <= K1_ATOL, f"K1 {label} disagrees with its plain version: {err}")
        torch.cuda.empty_cache()
        return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by)

    k1_rows = [
        k1_case("leaf D", xl, xl, 20),
        k1_case("coupling B level 1", xl[0::2, :RANK].contiguous(),
                xl[1::2, :RANK].contiguous(), 50),
        k1_case("scoring block", x[:N_TEST], x, 8),
    ]
    # A batch above grid.z's 65535 (10^7 points make 131072 leaves at leaf
    # 128): the launcher splits it into chunks.  A check only, outside the
    # cell, at 64 rows a block to keep it small.
    xbig = torch.randn((2 ** 17, 64, N_FEATURES), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    err_big = (gops.gaussian_block(xbig, xbig, H)
               - gref.gaussian_block_ref(xbig, xbig, H)).abs().max().item()
    print(f"[kernels] K1 gaussian_block batch {xbig.shape[0]} (above 65535) "
          f"{tuple(xbig.shape)}: max_abs_err {err_big:.3e} (tol {K1_ATOL:g})")
    check(err_big <= K1_ATOL, f"K1 at batch {xbig.shape[0]} disagrees: {err_big}")
    del xbig
    torch.cuda.empty_cache()

    params = CompressionParams(rank=RANK, n_near=N_NEAR, n_far=N_FAR)
    t0 = time.perf_counter()
    far_host = compression._host_proxy_indices(tree, params)
    t1 = time.perf_counter()
    near_host = compression._host_leaf_near(tree, params, x_host)
    t2 = time.perf_counter()
    # The host stages of prepare at the main path's size: they sit inside
    # compression_s (proxies, KD-tree) or before it (tree).
    print(f"[host] 2^20 points: build_tree {t_tree:.3f} s, far proxies "
          f"{t1 - t0:.3f} s, near proxies (KD-tree) {t2 - t1:.3f} s")
    far = [torch.as_tensor(a, device=dev).long() for a in far_host]
    near = torch.as_tensor(near_host, device=dev).long()
    leaf_xp = x[torch.cat([near, far[0]], dim=1)]
    ones_leaf = torch.ones((n_leaf, LEAF), device=dev)

    def k2_case(label, xc, xp, cm, k, reps):
        piv, r = ckern.fused_assemble_id_cuda(xc, xp, cm, k, H)
        piv_ref, r_ref = cref.fused_assemble_id_ref(xc, xp, cm, k, H)
        same = (piv == piv_ref).all(1)
        mismatch = int((~same).sum())
        err = (r - r_ref)[same].abs().max().item()
        rel = err / max(r_ref[same].abs().max().item(), 1e-30)
        frac = 1.0 - mismatch / xc.shape[0]
        ms = time_ms(torch, lambda: ckern.fused_assemble_id_cuda(xc, xp, cm, k, H), reps)
        plain = time_ms(torch, lambda: cref.fused_assemble_id_ref(xc, xp, cm, k, H), 2)
        b, m, f = xc.shape
        s = xp.shape[1]
        bms, by = bound(*k2_cost(b, m, s, f, k))
        print(f"[kernels] K2 fused_assemble_id {label} B={b} m={m} s={s} k={k}: "
              f"pivot mismatches {mismatch}/{b} (need >= {K2_PIV_MATCH:.1%} equal), "
              f"R max_abs_err {err:.3e} (tol {K2_R_ATOL:g}), max_rel_err {rel:.3e}, "
              f"kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by}), "
              f"smem {ckern.smem_bytes(m, s, k)} B/node")
        check(frac >= K2_PIV_MATCH, f"K2 {label}: {mismatch} pivot mismatches")
        check(err <= K2_R_ATOL, f"K2 {label}: R disagrees: {err}")
        return piv, dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bms, bound_by=by, pivot_mismatches=mismatch)

    piv0, k2_leaf = k2_case("leaf", xl, leaf_xp, ones_leaf, RANK, 5)
    # First upper level, built exactly as compress builds it.
    skel = (torch.arange(n_leaf, device=dev)[:, None] * LEAF + piv0.long())
    cand = skel.reshape(n_leaf // 2, 2 * RANK)
    sib = cand.reshape(n_leaf // 4, 2, 2 * RANK).flip(1).reshape(n_leaf // 2, 2 * RANK)
    prox = torch.cat([sib, far[1]], dim=1)
    _, k2_up = k2_case("level 1", x[cand], x[prox],
                       torch.ones((n_leaf // 2, 2 * RANK), device=dev), RANK, 20)
    k2_rows = [k2_leaf, k2_up]

    g = torch.Generator(device=dev).manual_seed(0)
    n3 = 2 ** 20
    xz = torch.randn(n3, device=dev, generator=g)
    mz = 1e4 * torch.randn(n3, device=dev, generator=g)
    cz = torch.full((n3,), C, device=dev)
    z_k, m_k = aops.fused_zmu_update(xz, mz, cz, 1e4)
    z_r, m_r = aref.fused_zmu_update_ref(xz, mz, cz, 1e4)
    err3 = max((z_k - z_r).abs().max().item(), (m_k - m_r).abs().max().item())
    rel3 = max((z_k - z_r).abs().max().item() / max(1.0, z_r.abs().max().item()),
               (m_k - m_r).abs().max().item() / max(1.0, m_r.abs().max().item()))
    ms3 = time_ms(torch, lambda: aops.fused_zmu_update(xz, mz, cz, 1e4), 200)
    plain3 = time_ms(torch, lambda: aref.fused_zmu_update_ref(xz, mz, cz, 1e4), 50)
    b3, by3 = bound(*k3_cost(n3))
    print(f"[kernels] K3 zmu_update n=2^20 beta=1e4: max_abs_err {err3:.3e}, "
          f"relative {rel3:.3e} (tol {K3_RTOL:g}), kernel {ms3:.4f} ms, "
          f"plain {plain3:.4f} ms, bound {b3:.4f} ms ({by3})")
    check(rel3 <= K3_RTOL, f"K3 disagrees with its plain version: {rel3}")
    k3_row = dict(shape="d*k = 2^20", max_abs_err=err3, ms=ms3, plain_ms=plain3,
                  bound_ms=b3, bound_by=by3)
    del x, xl, leaf_xp, near, far, xz, mz, cz, z_k, m_k, z_r, m_r
    torch.cuda.empty_cache()

    # ---- 4. small engine run: card against CPU ------------------------ #
    xs, ys_, xst, yst = synthetic.train_test("blobs", 2048, 512, seed=3,
                                             n_features=N_FEATURES, sep=SEP)
    small = {}
    for where in ("cuda", "cpu"):
        eng = HSSSVMEngine(spec=KernelSpec(h=H), comp=params, leaf_size=128,
                           admm=ADMMParams(max_it=MAX_IT), device=where)
        eng.prepare(xs, ys_)
        mdl, (zs, _) = eng.train(C)
        small[where] = (mdl.biases.cpu(), mdl.decision_function(xst).cpu(), zs.cpu())
    db = (small["cuda"][0] - small["cpu"][0]).abs().max().item()
    dscore = (small["cuda"][1] - small["cpu"][1]).abs().max().item()
    dz = (small["cuda"][2] - small["cpu"][2]).abs().max().item()
    agree = float((torch.sign(small["cuda"][1]) == torch.sign(small["cpu"][1])).float().mean())
    print(f"[small] n=2048 card vs CPU: |dz| {dz:.3e}, |dbias| {db:.3e}, "
          f"|dscore| {dscore:.3e}, sign agreement {agree:.4f}")
    check(dz <= 1e-3 and db <= 1e-3 and dscore <= 1e-3 and agree >= 0.998,
          "the card and the CPU disagree on the small engine run")

    # ---- 5. main path ------------------------------------------------- #
    xtr, ytr, xte, yte = synthetic.train_test(
        "blobs", N_TRAIN, N_TEST, seed=0, n_features=N_FEATURES, sep=SEP)
    engine = HSSSVMEngine(spec=KernelSpec(h=H), comp=params, leaf_size=LEAF,
                          admm=ADMMParams(max_it=MAX_IT), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    rep = engine.prepare(xtr, ytr)
    model, (z_main, mu_main) = engine.train(C)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pred = model.predict(xte)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    main_counts = dict(_build.launch_counts)
    pred = pred.cpu().numpy()
    acc = float(np.mean(pred == yte))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[main] n={N_TRAIN} padded={engine.hss.n} levels={rep.hss_levels} "
          f"beta={rep.beta:g}: compression_s {rep.compression_s:.3f}, "
          f"factorization_s {rep.factorization_s:.3f}, admm_s {rep.admm_s:.3f}, "
          f"prepare+train_s {t1 - t0:.3f}, predict_s {t2 - t1:.3f}, "
          f"memory_mb {rep.memory_mb:.1f}, kernel_evals {rep.kernel_evals}, "
          f"peak_device_gb {peak_gb:.2f}")
    print(f"[main] accuracy {acc:.4f} (need >= {MIN_ACCURACY}); "
          f"launches {json.dumps(main_counts)}")
    check(pred.shape == (N_TEST,) and np.isin(pred, (-1, 1)).all(),
          "predictions are not a ±1 vector of the test size")
    check(bool(torch.isfinite(z_main).all()) and bool(torch.isfinite(model.biases).all()),
          "non-finite duals or bias")
    check(acc >= MIN_ACCURACY, f"accuracy {acc} below {MIN_ACCURACY}")
    # K1: one leaf-D launch, one coupling launch per level, one per scoring
    # block.  K2: one launch per level that selects skeletons (0..K-1).
    want_k1 = 1 + rep.hss_levels + -(-N_TEST // DEFAULT_SCORE_BLOCK)
    want_k2 = rep.hss_levels
    check(main_counts["gaussian_block"] == want_k1,
          f"K1 launched {main_counts['gaussian_block']} times, expected {want_k1}")
    check(main_counts["fused_assemble_id"] == want_k2,
          f"K2 launched {main_counts['fused_assemble_id']} times, expected {want_k2}")

    # ---- 6. K3 path: the fused z/mu update ---------------------------- #
    ys, pmask = engine.problem_labels, engine.problem_masks
    beta = engine.fac.beta
    _build.reset_launch_counts()
    st_f, tr_f = admm_mod.admm_svm_batched(engine.fac.solve_mat, ys, C * pmask, beta,
                                           MAX_IT, use_fused_update=True)
    torch.cuda.synchronize()
    k3_counts = dict(_build.launch_counts)
    st_u, tr_u = admm_mod.admm_svm_batched(engine.fac.solve_mat, ys, C * pmask, beta,
                                           MAX_IT)
    dz = (st_f.z - st_u.z).abs().max().item()
    dmu = (st_f.mu - st_u.mu).abs().max().item() / max(1.0, st_u.mu.abs().max().item())
    dpr = ((tr_f.primal_res - tr_u.primal_res).abs().max()
           / tr_u.primal_res.abs().max().clamp(min=1e-30)).item()
    ddr = ((tr_f.dual_res - tr_u.dual_res).abs().max()
           / tr_u.dual_res.abs().max().clamp(min=1e-30)).item()
    dz_engine = (st_u.z - z_main).abs().max().item()
    print(f"[k3-path] fused vs unfused, {MAX_IT} iterations at d={engine.hss.n}: "
          f"|dz| {dz:.3e} (tol {FUSED_Z_ATOL:g}), mu rel {dmu:.3e}, primal rel {dpr:.3e}, "
          f"dual rel {ddr:.3e} (tol {FUSED_RTOL:g}); unfused vs engine |dz| "
          f"{dz_engine:.3e}; launches {json.dumps(k3_counts)}")
    check(dz <= FUSED_Z_ATOL and max(dmu, dpr, ddr) <= FUSED_RTOL,
          "the fused ADMM run disagrees with the unfused one")
    check(dz_engine <= FUSED_Z_ATOL, "admm_svm_batched disagrees with the engine's run")
    check(k3_counts["zmu_update"] == MAX_IT,
          f"K3 launched {k3_counts['zmu_update']} times, expected {MAX_IT}")

    # ---- 7. summary --------------------------------------------------- #
    def entry(name, source, replaces, launches, main_row, rows_all):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, shape=main_row["shape"],
                    max_abs_err=max(r["max_abs_err"] for r in rows_all),
                    ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                    bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                    library_ms=None, per_shape=rows_all)

    kernels = [
        entry("gaussian_block", "src/repro_torch/csrc/gaussian_block.cu",
              "src/repro/kernels/gaussian/kernel.py:37",
              main_counts["gaussian_block"], k1_rows[2], k1_rows),
        entry("fused_assemble_id", "src/repro_torch/csrc/fused_assemble_id.cu",
              "src/repro/kernels/compress/kernel.py:142",
              main_counts["fused_assemble_id"], k2_rows[0], k2_rows),
        entry("zmu_update", "src/repro_torch/csrc/zmu_update.cu",
              "src/repro/kernels/admm_update/kernel.py:28",
              k3_counts["zmu_update"], k3_row, [k3_row]),
    ]
    print(f"[summary] card {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
