#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check its kernels.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases, each printed on its own lines, none of them allowed to fail:
  1. device    — the card's name and power limit (nvidia-smi);
  2. build     — nvcc builds every CUDA kernel of the port from csrc/;
  2a. analysis — repro_torch.analysis on the card: the AST lint over
                 src/repro_torch (and this script, and csrc/), then every
                 dispatch-level probe (dispatch_check.run_all) on the card,
                 each under torch.cuda.set_sync_debug_mode("error") (the mesh
                 check on two gloo CPU ranks); the counts of findings,
                 suppressions and stale baseline entries, each check's
                 seconds; any finding outside the baseline fails the run;
  3. kernels   — K1, K4 and K3 against their plain PyTorch versions on the
                 card, at the shapes of the paths below: K1 and K4 on a
                 leaf-D batch, a coupling batch, one scoring block and a
                 batch above 65535 (K4 also in bf16); K3 on a 2^20 block.
                 Kernel, plain and bound times in ms; each K1/K4 row with
                 its launch plan (kernels.pairwise: skinny, packed or wide)
                 and, for a wide plan, a breakdown of its time (the inputs
                 aliased or copied, one feature, a fill of the output:
                 ``wide_breakdown``);
  4. small     — 2048-point engine runs on the card against the same runs on
                 the CPU (plain versions), for the three configurations
                 below: bias and predictions agree; then the tasks of the
                 paths 9-12 at 2048 points (OVR and OVO on 4 classes, SVR,
                 one-class, KRR), a binary run with bf16-stored factors,
                 spectral_embed(3) on circles, the repo's multilevel and
                 adaptive-ρ bench cases (iterations, β sequence, accuracy),
                 and a registry round trip of the card's binary model
                 (loaded on the CPU and on the card);
  5. main      — HSSSVMEngine prepare / train(C=1) / predict on the
                 10^6-point blobs SVM, gaussian, fixed rank 32, leaf 256
                 (2^20 padded points, 12 levels); accuracy >= 0.93.  Then
                 [check main]: every K1 and K2 launch of the path is run
                 again by the plain version on the inputs the path gave it
                 (K2's pivots and R as the path's launch returned them, held
                 with repro_torch.kernels.compress.verify), and K2 is timed
                 at every level of the path, at the planner's cluster size
                 and at every other that fits (the leaf and first upper
                 level also beside the plain version), summed per build;
  6. lap       — the same data with KernelSpec("laplacian", h=2) at the crude
                 preset (CompressionParams.crude()); accuracy >= 0.93; its
                 check and K2's timing as above for K4 and K2, and K2 again
                 on the path's leaf and first upper level with dead
                 candidates added;
  7. accurate  — 10^6 points of 2-feature circles, gaussian h=1.5, at the
                 accurate preset (CompressionParams.accurate()), leaf 256;
                 accuracy >= 0.99, and the adaptive ranks below the cap; its
                 check as above, with K1 timed on its 2-feature leaf D and
                 scoring block;
  8. K3 path   — admm_svm_batched(use_fused_update=True) on the main path's
                 factorization against the unfused run; K3 launched 10 times;
  8m. mesh     — [main]'s path (10^6 points, fixed rank 32, leaf 256, C 1)
                 through HSSSVMEngine(mesh=...): one rank in this process over
                 NCCL, then two ranks as two processes on the card over gloo
                 (repro_torch.dist.api.spawn; [main]'s arrays reach them by
                 CUDA IPC).  Per rank: times, peak bytes, collective bytes,
                 launches (counted from 0 around the path); skeleton ids
                 against [main]'s rows (ties judged by verify), factors,
                 z, scores, accuracy against [main]'s, and every K1/K2
                 launch replayed through the plain versions;
  9. multi     — 10^6 + 2048 points of 6-class multiclass_blobs (8 features,
                 sep 3), gaussian h 1.5, crude, OVO: 15 pair problems on one
                 factorization, train_grid over C 0.5 / 1 / 2 (warm-started),
                 each model predicting; accuracy at C 1 within 0.02 of the
                 JAX package's at the same configuration; [check multi] as
                 [check main], and K1's scoring blocks times the 15-column
                 coefficient block;
     serve     — the serving tier at 2^20 support: [multi]'s three models
                 (one group of 45 columns) and [lap]'s model (saved to a
                 ModelRegistry in [lap]'s phase, loaded by the engine);
                 benchmarks/bench_serve.py's 256 requests of 2 points
                 through a per-request loop (bucket 2) and batched ticks
                 (max_batch 128): q/s, p50/p99, launches (K1 and K4 once a
                 tick, graph replays counted), agreement with
                 EngineModel.predict; the same traffic with eager ticks
                 (no graphs), timed beside the replayed ones; [check serve]
                 replays against eager ticks and the eager K1/K4 blocks
                 against the plain versions; the shared cache (1 entry, 1
                 upload, 1 launch), the LRU under max_resident 1, the bf16
                 policy; K1 and K4 timed at the 2 x 2^20 and 128 x 2^20 tick
                 shapes, K4 also on the bf16 policy's bf16 operands;
 10. svr       — 10^6 points of noisy_sine, ε-SVR (C 2, ε 0.1): R² floor;
 11. oneclass  — 10^6 points of blobs_with_outliers, ν 0.1, 30 iterations:
                 balanced-accuracy floor;
 12. gp        — noisy_sine, task "gp" at λ 0.5 then 2 (one refactorization
                 each, no ADMM), the log marginal, the 8 leading eigenpairs:
                 the solves' backward error and the Ritz residuals bounded;
     baselines — bench_baselines.py's circles at 65536 training points:
                 dense ADMM (K1 over the 65536^2 K, a dense Cholesky), Nyström
                 ADMM (256 landmarks), the HSS trainer, and SMO on the host at
                 16384; wall time, accuracy, peak memory; every K1 launch
                 (the dense K whole) and the HSS build's K2 levels against
                 the plain versions, K1 timed on the dense K; the card's
                 dense fit at 4096 points and Nyström at 4096 and 8192
                 against the CPU's, and that bar failing a faulty K(X, L);
 13. stream    — the 10^6-point blobs SVM through the out-of-core streamed
                 build (crude preset, 16 leaves a batch): accuracy, the
                 batch count, counted peak bytes and kernel evals equal to
                 the JAX package's, the level loop's measured device peak
                 under 1 GiB; [check stream] replays every K1 and K2 launch
                 and prints K2's plan at each batch shape, the 16-node
                 leaf batch timed at every cluster size that fits;
 14. multilevel — on [stream]'s engine: a cold train (tol 3e-2, 400
                 iterations) against train_multilevel(coarse_frac 1/8);
                 every launch of both replayed by the plain versions;
 15. adaptive-rho — the same engine from β 10^4, ρ balanced every 5
                 iterations under the port's floor (rho_guard): rescales,
                 final β, one factorization per β, the scoring launch
                 replayed; then the reference's loop (no floor) reported,
                 and fixed-β ADMM below and at the floor on this K̃ and on
                 a second one (2^17 points, seed 1);
 16. stream-resume — 2^17 points: an uninterrupted streamed build, then
                 one restarted in-process after a failure at level 3 and
                 one resumed by a fresh call after a failure at level 6:
                 every tensor equal to the uninterrupted build's; the
                 engine's build of the same points equal to it too, and
                 its launches replayed;
 17. kernels   — K5 (flash attention) against its plain version at the
                 zamba2 path's shape (4 x 32 x 1024 x 64 bf16, causal; SDPA
                 timed beside it), gemma2-9b's local layer (H16/KV8, D256,
                 window 4096 on S 8192, softcap 50), hubert-xlarge's D80
                 non-causal and paligemma-3b's MQA D256 prefix-LM, and at
                 the shapes of phases 21-23 (SDPA beside each but gemma2's
                 softcap, which SDPA cannot compute); K6 (the SSD
                 chunk scan) at the path's shape and mamba2-780m's (N 128),
                 bf16 (x, B and C as views of one xBC tensor, as the model
                 hands them over) and f32, y and the final state.  Kernel,
                 plain and bound ms;
 18. lm-small  — zamba2-1.2b at full width, 6 layers, f32 and then bf16:
                 prefill of 256 tokens and 4 teacher-forced decode steps on
                 the card against the same model on the CPU; the logits
                 agree;
 19. lm        — the serving entry point (repro_torch.launch.serve) at
                 zamba2-1.2b's full width and depth, bf16, batch 4, prompt
                 1024, 32 generated tokens: prefill runs K5 6 times and K6 38
                 times, decode neither; then again after a warm-up prefill.
                 Then [check lm]: every K5 and K6 launch of the path run again
                 by the plain version on the path's own inputs;
 21. lm-dense  — the serving entry point at gemma2-9b's full width and
                 depth, bf16, batch 2, prompt 4608 (past the even layers'
                 4096 window), 32 generated tokens: prefill runs K5 42
                 times (21 windowed, every one softcapped), decode none;
                 then again after a warm-up prefill, with --profile.  Then
                 [check lm-dense]: one more prefill whose every K5 launch is
                 held against the plain version as it runs (a batch row and
                 a kv head at a time; only the error is kept);
 22. lm-moe    — the same for granite-moe-3b-a800m (40 experts, top 8),
                 batch 4, prompt 1024, 32 tokens: K5 32 times a prefill;
                 [check lm-moe] replays every launch; then one layer's
                 moe_block and one f32 expert product (beside the bf16 one)
                 timed at the path's shape;
 23. lm-families-small — gemma2-9b, granite-moe-3b-a800m, paligemma-3b
                 (256 patches + 64 tokens) and hubert-xlarge (forward_logits
                 of 512 masked frames) at full width, 2 layers, bf16: the
                 card against the CPU with the same weights, prefill and 4
                 teacher-forced decode steps; the logits agree;
                 each serving path's second run gives the first run's
                 greedy tokens (the MoE combine has no atomics);
 25. train-small — one make_train_step of zamba2-1.2b at full width, 6
                 layers, f32 and then bf16, 1 x 128 tokens, on the card
                 against the same step on the CPU from the same weights:
                 the loss, the grad norm, every gradient leaf and the
                 updated parameters agree (K5 2, K6 12: forward and each
                 layer's recompute);
 26. train     — the training entry point (repro_torch.launch.train --task
                 lm) at zamba2-1.2b's full size, bf16, batch 4 x 1024, 6
                 steps: finite losses and grad norms, K5 12 and K6 76
                 launches a step; warm step ms, tokens/s, peak bytes, and
                 one more step under torch.profiler (device time by kernel
                 group, busy share; the plain backward of K5/K6 by CUDA
                 events); then the same command with a checkpoint every 3
                 steps and a failure at step 4: one restart from step 3,
                 the restored state equal to the saved one bit for bit, the
                 losses and final parameters against the uninterrupted run;
 27. check train — every K5 and K6 launch of one more step held against
                 the plain version on its own inputs as it runs;
 28. train-moe — granite-moe-3b-a800m at full width, 4 layers, batch 4 x
                 1024, 3 steps: the aux term, the first step's loss equal
                 in a second fresh run, one layer's moe_block twice under
                 torch.cuda.set_sync_debug_mode("error"), bit-identical;
 29. lm-mesh   — granite-moe-3b-a800m at full size, bf16, batch 2 x 1024:
                 one loss and gradient in this process, then on a ("data",
                 "model") (1, 2) mesh of two gloo processes on the card (the
                 weights by CUDA IPC; each rank 12 query heads, 4 kv heads
                 and its run of the 48 padded experts): the loss, the grad
                 norm, per rank ms, peak bytes and collectives; K5 64 a
                 rank, every launch replayed; the gathered gradients of f32
                 compute against this process's;
 30. mesh-stream — on the same two ranks, [stream-resume]'s 2^17 points
                 streamed on a ("data",) mesh against compress_sharded;
 31. lm-mesh-1 — granite at 2 layers on a (1, 1) mesh over NCCL: the loss
                 and every gradient equal to the local run's bit for bit;
 32. lm-mesh-fsdp — granite at full width, 4 layers, (2, 2) with FSDP, 4
                 gloo processes, 3 AdamW steps of 4 x 512: every rank the
                 same losses, step 0 within 2e-2 of one process's;
 33. collectives — in the same 4 processes: the compressed all-reduce of 4
                 x 2^20 f32 against the plain sum, pipeline_forward on a
                 4-stage mesh against the stages in sequence;
 34. lm-mesh-serve — on the two [lm-mesh] processes, granite-moe-3b-a800m
                 at full size served sharded ((1, 2): prefill of 4 x 1024,
                 16 greedy tokens; K5 32 a rank on its 12 heads, its cache
                 4 of 8 kv heads) against this process: bf16 prefill logits
                 and decode steps whose own routing is equal, f32 compute
                 teacher-forced at full depth on every step, the first 4
                 layers alone; per rank ms,
                 collectives, peak and cache bytes, the bytes held against
                 launch.specs' prediction; every K5 launch replayed;
 35. lm-mesh-serve-families — on the same ranks, gemma2-9b (prompt past
                 its window, softcap) and paligemma-3b (one kv head, the
                 cache replicated) at full width, 2 layers, teacher-forced
                 against this process;
 36. lm-mesh-serve-hybrid — on the four [lm-mesh-fsdp] processes ((2, 2)),
                 zamba2-1.2b at full size, 4 x 1024 and 16 tokens
                 teacher-forced against this process: K6 38 and K5 6 a rank
                 (16 of 32 heads), ssm_state 32 of 64 heads, every launch
                 replayed; then f32 compute, 4 steps, at 1e-4;
 37. dryrun    — python -m repro_torch.launch.dryrun on the host for
                 granite prefill_32k and decode_32k, llama3-405b train_4k
                 (16 x 16) and the SVM cell (2 x 16 x 16), four processes
                 started after phase 36: memory,
                 FLOPs, collectives, roofline terms of one rank's step;
 24. summary   — one JSON line {"kernels": [...]}, then the last line
                 {"ok": true, "device": {...}}.
Every path runs with the launch counts set to 0 just before it, and checks
each count just after it against what the code implies; the launches of the
checks come after that reading.

It exits non-zero, before printing any result, when no CUDA device is
available or when the repro_torch package is not beside it.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # the H100's data-sheet rates and K5's / K6's work counts, shared with
    # the dry run (repro_torch.launch.dryrun)
    from repro_torch.kernels.cost import (BF16_TC_FLOP_PER_S, F32_FLOP_PER_S,
                                          HBM_BYTES_PER_S, SFU_PER_S, k5_cost, k6_cost)
except ImportError:
    sys.exit("chip_smoke: the repro_torch package is not beside this script")

# The repository's own paper-scale configuration (benchmarks/bench_svm.py,
# svm_scaling/n1000000), resident and at fixed rank.
N_TRAIN, N_TEST, N_FEATURES, SEP = 10 ** 6, 2048, 8, 1.6
H, RANK, N_NEAR, N_FAR, LEAF, MAX_IT, C = 1.0, 32, 32, 32, 256, 10, 1.0
MIN_ACCURACY = 0.93
# The laplacian path: the same data and leaf at the crude preset (rtol 1e-2,
# cap 32, 32 + 32 proxies).
H_LAP = 2.0
# The accurate path: benchmarks/bench_svm.py's ADAPTIVE_CASES circles case
# at paper scale (rtol 1e-4, cap 64, 64 + 128 proxies).
ACC_FEATURES, ACC_GAP, H_ACC, MIN_ACCURACY_ACC = 2, 0.8, 1.5, 0.99

# The task paths: benchmarks/bench_svm.py's 6-way MULTICLASS_CASES case and
# its TASK_CASES (:290-291) at paper scale, all at the crude preset, leaf 256.
MULTI_CLASSES, MULTI_SEP, H_MULTI, MULTI_CS = 6, 3.0, 1.5, (0.5, 1.0, 2.0)
H_SVR, SVR_C, SVR_EPS = 1.0, 2.0, 0.1
H_OC, OC_NU, OC_MAX_IT = 2.0, 0.1, 30
H_GP, GP_LAMS = 1.0, (0.5, 2.0)
# The JAX package's own values at the same 10^6-point configurations, on a
# CPU (scripts/reference_quality.py; PERF.md §4): accuracy at C 1, R², and
# balanced accuracy.  Each path's floor sits FLOOR_MARGIN below.
REF_MULTI_ACC, REF_SVR_R2, REF_OC_BA = 0.8306, 0.9360, 0.8371
FLOOR_MARGIN = 0.02
# [gp]'s solve: with the crude preset K̃ + λI is indefinite at scale (its
# compression error, ~1e-2 of |K| ~ 1.8e4 at 2^17 points, dwarfs λ), so
# |(K̃ + λI)α − y| / |y| is no measure of the solve: on 2^17 points on a CPU
# it reads 1.2 (the JAX package) and 27 (the port) at λ 0.5, 7.6 and 0.021
# at λ 2 (scripts/reference_quality.py --impl jax|port).  The normwise
# backward error |r| / ((θ_max + λ)|α| + |y|) is: on the card at 10^6
# points it read 9.8e-6 at λ 0.5 and 1.7e-5 at λ 2, so about 10x the worst.
# It cannot tell λ 0.5 from λ 2 at this scale (a solve at the wrong λ reads
# |Δλ| / θ_max ~ 1e-5 with θ_max ~ 1.4e5), so [small]'s KRR rows hold the
# card's per-λ factorizations against the CPU's at 2048 points.
GP_BACKWARD_TOL = 2e-4
# Ritz residuals |K̃v − θv| / |θ| of the 8 leading pairs: at most 1.1e-5
# (the JAX package) and 1.5e-6 (the port) on the CPU at 2^17; 10x the worst.
RITZ_RTOL = 1e-4
# [small]'s task rows, the card against the CPU: scores and biases relative
# to the largest |score| (f32 sums in other orders through 10-30 solves);
# the bf16-stored row to one bf16 step moved through 10 solves (the bar of
# tests/test_torch_adaptive.py against the f32 solve).
SMALL_RTOL, SMALL_BF16_RTOL, SMALL_AGREE = 1e-3, 1e-2, 0.995
# [small]'s multilevel and adaptive-ρ rows: benchmarks/bench_svm.py's
# svm_multilevel/blobs and svm_adaptive_rho cases (:590-685), card against
# CPU.  The JAX package on a CPU: cold 192, warm 178, coarse 233 iterations;
# fixed 400, adaptive 111 (final β 39.0625, 8 rescales).  Iteration counts
# may move by a freeze test flipping near tol on rounding: ITERS_RTOL.
ML_N, ML_N_TEST, ML_FEATURES, ML_SEP, ML_H = 2048, 512, 5, 3.0, 2.0
ML_BETA, ML_TOL, ML_MAX_IT, ML_COARSE_FRAC, ML_COARSE_LEAF = 100.0, 3e-2, 400, 0.25, 64
RHO_BETA0 = 1e4
REF_ML_ITERS = dict(cold=192, warm=178, coarse=233)
REF_RHO = dict(fixed=400, adaptive=111, rho_final=39.0625, rescales=8)
ITERS_RTOL = 0.05
# [stream]: benchmarks/bench_svm.py's svm_scaling/n1000000/streamed case
# (:508-587) at full size on one device: the [main] data, gaussian h 1, the
# crude preset, leaf 256, 16 leaves a batch, 10 ADMM iterations, C 1.  The
# JAX package's run (BENCH_svm.json, its CPU, mesh-assembled over 8 emulated
# devices): accuracy 0.9546; 515 batches, peak_stream_bytes 4,884,544 and
# kernel_evals 364,891,136, which depend on the shapes only; ranks_post 32 at
# every level but the last (28), rank_sum_post 262,072.
STREAM_BATCH = 16
REF_STREAM_ACC, STREAM_ACC_MARGIN = 0.9546, 0.02
REF_STREAM = dict(batches=515, peak_stream_bytes=4_884_544, kernel_evals=364_891_136,
                  rank_sum_post=262_072)
STREAM_DEVICE_PEAK_MAX = 2 ** 30     # the level loop's measured working set
# [multilevel] / [adaptive-rho] on [stream]'s engine at 10^6 points: the
# bench cases' knobs (tol 3e-2, 400 iterations; coarse 1/8; ρ every 5
# iterations, at most 8 rescales) from the paper's β of 10^4.
BIG_COARSE_FRAC = 0.125
# The floor of adaptive ρ (HSSSVMEngine.rho_floor) on a second K̃: the
# [stream] configuration at 2^17 points from another seed, resident.
FLOOR_N2, FLOOR_SEED2 = 2 ** 17, 1
# [stream-resume]: svm_scaling/n131072/streamed (2^17 points, the same
# configuration; the JAX package: 67 batches, kernel_evals 45,599,744,
# accuracy 0.9434): a failure at level 3 restarted in-process, a failure at
# level 6 with no restart budget resumed by a fresh call.
RESUME_N = 2 ** 17
REF_RESUME = dict(batches=67, kernel_evals=45_599_744)
RESUME_FAIL_IN_PROCESS, RESUME_FAIL_FRESH = 3, 6
# [check multi]: K1's scoring blocks times the coefficient block against the
# plain block times the same block, of the largest score: block entries a
# few f32 ulps apart (K1_ATOL at worst), through the same matmul.
SCORE_RTOL = 1e-4

# The share of the card memory held before the mesh phases that a garbage
# collection may free (reference cycles through CUDA tensors).
GC_FREED_MAX = 0.01

HOLD_CYCLES = 100_000_000    # ~50 ms of spinning at the H100's ~2 GHz clock

# H100 SXM peaks: repro_torch.kernels.cost's data-sheet rates.  Non-FMA f32
# operations (an add, a subtract) retire at half the FMA flop rate.
F32_OP_PER_S = F32_FLOP_PER_S / 2

# Tolerances of kernel against plain version, with their reasons.
K1_ATOL = 2e-5     # K in [0, 1]; f32 norm/cross sums in another order move sq
                   # by a few ulps of |a|²+|b|², times the exp slope <= 1/2h².
# K2: nodes whose live pivots (or adaptive ranks) equal the plain version's.
# Greedy pivots may flip where two residual norms tie to rounding; every
# such node must also read as a tie, and stay a greedy pivoted QR along its
# own pivots after it (repro_torch.kernels.compress.verify).  On 8 features the live
# directions stay well above f32 noise (slice 1's bound).  On the 2-feature
# circles |R_ii| falls to 1e-4 of |R_00| within ~5 steps, where an f32 step
# resolves residual norms only to ~1e-3 of their size, and neighbouring
# candidates are near-duplicates: ties are that much more frequent.
K2_PIV_MATCH = 0.999
K2_PIV_MATCH_F2 = 0.99
# [svr] and [gp]: 10^6 points uniform on a 2-D square, so a leaf spans
# ~0.1 at h 1 and its near block sits at 1 - O(1e-2), where the f32 norm expansion
# |p|² + |c|² − 2p·c (the reference's formula, kept by K2 and its plain
# version alike) errs by ~eps·|x|² an entry: more than the deflation's
# error bars at the first steps.  On these paths each column's error bar
# also holds its assembly error (verify.py, ``*_asm``).  The plain version
# itself, against the f64 greedy pivots on the CPU, takes other live
# pivots on 16 of 1953 such leaves, 3 beyond the deflation-only bars and 0
# beyond the widened ones (scripts/k2_tie_rate.py --path svr; with the
# squared distance taken directly, 4 and 0), so two f32 runs may differ on
# twice its 0.82%: K2_PIV_MATCH_DENSE.
K2_PIV_MATCH_DENSE = 0.98
K2_R_ATOL = 1e-4   # R entries are O(sqrt(s)); f32 reorderings of k steps.
K4_ATOL = 2e-5     # the same f32 L1 sums in the same order; exp's last bits.
CDIST_COLS = 2 ** 15   # columns per torch.cdist call in K4's yardstick
CHECK_ELEMS = 2 ** 28  # entries of a recorded launch's plain version at a time
K4_BF16_ATOL = 2.0 ** -8   # one bf16 rounding step of K in (0, 1].
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


def wide_breakdown(torch, launcher, xa, xb, h, reps: int) -> dict:
    """What holds a wide K1/K4 launch back, read on the card without
    hardware counters (ncu does not run there), in CUDA-event ms a launch
    of: the launch with xa given as a view of xb's first rows
    (``alias_ms``, where that view is contiguous) and as a fresh copy of
    them (``copies_ms``), the same values in other memory, so that the gap
    is the staging loads' cache hits; the same block at one feature
    (``f1_ms``: the arithmetic and the staging of F - 1 features gone, the
    stores the same); and ``fill_ms``, a fill of an output of the same size
    and type, the rate the card's stores reach without the kernel.
    torch.profiler is not used here: on this card its trace dropped some
    of a window's launches (as it can for K6's passes, below)."""
    a3, b3 = (xa[None], xb[None]) if xa.dim() == 2 else (xa, xb)
    ma = a3.shape[1]
    alias = b3[:, :ma]          # a view; contiguous where Ma = Mb or the batch is 1
    copy = b3[:, :ma].clone()
    a1, b1 = a3[..., :1].contiguous(), b3[..., :1].contiguous()
    out = dict(alias_ms=(time_ms(torch, lambda: launcher(alias, b3, h), reps)
                         if alias.is_contiguous() else None),
               copies_ms=time_ms(torch, lambda: launcher(copy, b3, h), reps),
               f1_ms=time_ms(torch, lambda: launcher(a1, b1, h), reps))
    del copy, a1, b1
    o = torch.empty((a3.shape[0], ma, b3.shape[1]), dtype=a3.dtype, device=a3.device)
    out["fill_ms"] = time_ms(torch, lambda: o.fill_(0.5), reps)
    return out


def k1_cost(b, ma, mb, f, elem_bytes=4):
    """Bytes: inputs read once, block written once, in the input type.
    Flops: 2f for the cross term, 5 for norms-combine, clamp, scale and
    exp, per entry."""
    return (float(elem_bytes) * b * (ma * f + mb * f + ma * mb),
            float(b) * ma * mb * (2 * f + 5))


def k2_cost(b, m, s, f, k, kernel_name="gaussian"):
    """Bytes: points and mask in, pivots and R out.  Flops per node: the
    assembly (gaussian 2f+5 per entry; laplacian 2f+2: per feature a
    subtract and an add whose |.| is an operand modifier, then the division
    and exp), then per step the qᵀ·column dots,
    the deflation and the new column norms (6sm), re-orthogonalisation
    against the i earlier directions (4si) and the normalisations (4s + m).
    R = QᵀAᵀ needs no pass of its own: R[i, :] is the row of qᵀ·column dots
    of step i."""
    bytes_moved = 4.0 * b * (m * f + s * f + m + k + k * m)
    per_entry = 2 * f + 5 if kernel_name == "gaussian" else 2 * f + 2
    per_node = s * m * per_entry + sum(6 * s * m + 4 * s * i + 4 * s + m
                                       for i in range(k))
    return bytes_moved, float(b) * per_node


def k4_bound(b, ma, mb, f, elem_bytes):
    """The larger of: bytes (inputs read once, block written once, in the
    input type) at the HBM rate, and operations — 2f f32 adds per entry (a
    subtract, and an add with the |.| as its operand modifier: FADD with
    |R|, no separate abs) at the non-FMA f32 rate, or one exp per entry at
    the SFU rate, whichever is longer (the two units run side by side)."""
    entries = float(b) * ma * mb
    t_bytes = elem_bytes * (b * (ma + mb) * f + entries) / HBM_BYTES_PER_S * 1e3
    t_ops = max(2 * f * entries / F32_OP_PER_S, entries / SFU_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k3_cost(n):
    """Three f32 reads and two writes per element; 6 flops."""
    return 20.0 * n, 6.0 * n


# ---------------------------------------------------------------------- #
# The serving tier (slice 6): [serve] at 2^20 support                     #
# ---------------------------------------------------------------------- #
# benchmarks/bench_serve.py:118-176's procedure: 256 requests of 2 test
# points, through a per-request loop (one tick a request, bucket 2) and
# through batched ticks (max_batch 128, bucket 128).  Here the requests
# go round robin to four models behind one engine: [multi]'s three OVO
# models (C 0.5 / 1 / 2, 15 columns each: ONE group of 45 columns) and
# [lap]'s binary laplacian model, loaded from a ModelRegistry.
SERVE_REQUESTS, SERVE_Q, SERVE_TICK = 256, 2, 128
SERVE_AGREE = 0.999       # served predictions against EngineModel.predict
SERVE_LRU_ROUNDS = 4      # A, B alternations under max_resident=1
# The bf16 policy (its bar stated before its first run on the card): the
# points and coefficients round to bf16 (relative 2^-9).  That moves a
# squared distance of ~h² between points of norm ~8 by ~2·h·8·2^-9, so a
# Gaussian entry by ~1% of itself, with signs that vary over the support
# and mostly cancel in a score.  Bar: 2e-2 of the largest |score| (the
# reference's BF16_ATOL on its O(1) scores); predictions equal on every
# row whose f32 scores all stand clear of 0 by that bar
# (tests/test_serve.py's criterion: a vote near a boundary may flip).
SERVE_BF16_RTOL = 2e-2


def serve_phase(torch, dev, models, multi_test, reg_dir, lap_test, k1_case, k4_case):
    """[serve]: the serving tier on the card at 2^20 support.  Returns the
    counted run's launches, the K1/K4 rows at the serving shapes and the
    numbers to report."""
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels.compress import laplacian as lops, ref as cref
    from repro_torch.kernels.gaussian import kernel as gkern, ref as gref
    from repro_torch.serve import BatchPolicy, ModelRegistry, ServingEngine, batched_scores

    registry = ModelRegistry(reg_dir)
    lap_model, _ = registry.load("lap", device=dev)
    names = [f"multi-C{c:g}" for c in MULTI_CS] + ["lap"]
    refs = list(models) + [lap_model]
    tests = [multi_test] * len(models) + [lap_test]
    idx = np.random.default_rng(1).integers(0, N_TEST, size=(SERVE_REQUESTS, SERVE_Q))
    reqs = [(r % len(names), tests[r % len(names)][idx[r]]) for r in range(SERVE_REQUESTS)]
    # EngineModel.predict on each model's rows (outside the counted run)
    want = {}
    for m, ref in enumerate(refs):
        rows = np.concatenate([q for i, q in reqs if i == m])
        want[m] = (ref.decision_function(rows).cpu().numpy(), ref.predict(rows).cpu().numpy())
    n_multi = sum(1 for i, _ in reqs if i < len(models))

    def engine(policy, **kw):
        eng = ServingEngine(policy=policy, registry=registry, device=dev, **kw)
        ids = [eng.add_model(m, model_id=n) for m, n in zip(models, names)]
        ids.append(eng.load("lap", model_id="lap"))
        return eng, ids

    def agreement(tag, results):
        """Predictions and scores of each model's requests against
        EngineModel's on the same rows."""
        out = {}
        for m, name in enumerate(names):
            got = [res for (i, _), res in zip(reqs, results) if i == m]
            s = np.concatenate([np.asarray(v).reshape(SERVE_Q, -1) for v, _ in got])
            p = np.concatenate([np.asarray(p) for _, p in got])
            ws, wp = want[m]
            agree = float(np.mean(p == wp))
            gap = float(np.abs(s - ws.reshape(s.shape)).max() / np.abs(ws).max())
            out[name] = dict(agreement=agree, max_rel_score_gap=gap)
            check(agree >= SERVE_AGREE, f"serve {tag}: {name}'s predictions agree with "
                  f"EngineModel.predict on {agree} of rows (need {SERVE_AGREE})")
        return out

    def latency(eng):
        lat = np.sort(np.array(eng.drain_latencies())) * 1e3
        return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))

    def traffic(loop, ids, ticks, ids_t):
        """The 256 requests through the per-request loop, then through the
        ticked engine (max_batch auto-ticks and a flush): results, seconds
        and p50/p99 latencies of each."""
        loop.drain_latencies()
        t0 = time.perf_counter()
        res_loop = [loop.score(ids[i], q) for i, q in reqs]
        loop_s = time.perf_counter() - t0
        ticks.drain_latencies()
        t0 = time.perf_counter()
        tickets = [ticks.submit(ids_t[i], q) for i, q in reqs]   # max_batch auto-ticks
        ticks.flush()                                            # the remainder
        ticks_s = time.perf_counter() - t0
        return (res_loop, loop_s, latency(loop),
                [t.result(timeout=0) for t in tickets], ticks_s, latency(ticks))

    def engines(eager=False):
        """A per-request loop engine (bucket 2) and a ticked engine
        (max_batch = bucket = 128), each group ticked once (outside any
        timing: on the card the first tick of a shape captures its graph).
        ``eager``: their ticks call the scorer directly, capturing nothing."""
        loop, ids = engine(BatchPolicy(buckets=(SERVE_Q,)))
        ticks, ids_t = engine(BatchPolicy(max_batch=SERVE_TICK, buckets=(SERVE_TICK,)))
        for eng in (loop, ticks) if eager else ():
            eng._replay = (lambda group, chunk, block, _e=eng:
                           _e._scorer(group, torch.as_tensor(chunk, device=dev), block))
        for m in (0, len(ids) - 1):
            loop.score(ids[m], tests[m][:SERVE_Q])
            ticks.score(ids_t[m], np.concatenate([q for _, q in reqs[:SERVE_TICK // SERVE_Q]]))
        return loop, ids, ticks, ids_t

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    want_counts = {name: 0 for name in _build.launch_counts}
    t_path = time.perf_counter()
    loop, ids, ticks, ids_t = engines()
    (res_loop, loop_s, (loop_p50, loop_p99),
     res_ticks, ticks_s, (tick_p50, tick_p99)) = traffic(loop, ids, ticks, ids_t)
    st_loop, st_ticks = loop.stats(), ticks.stats()
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t_path
    counts = dict(_build.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # one launch a tick: group A (K1) and group B (K4) each ticked once in
    # the loop's warm-up and once a request; in the ticked engine once in
    # the warm-up and once a full max_batch of rows (no remainder here);
    # a call is one launch, whatever its plan (kernels.pairwise)
    n_lap = SERVE_REQUESTS - n_multi
    want_counts["gaussian_block"] = 1 + n_multi + 1 + -(-n_multi * SERVE_Q // SERVE_TICK)
    want_counts["laplacian_block"] = 1 + n_lap + 1 + -(-n_lap * SERVE_Q // SERVE_TICK)
    q_all = SERVE_REQUESTS * SERVE_Q
    out = dict(loop_qps=q_all / loop_s, loop_p50_ms=loop_p50, loop_p99_ms=loop_p99,
               tick_qps=q_all / ticks_s, tick_p50_ms=tick_p50, tick_p99_ms=tick_p99,
               speedup=loop_s / ticks_s, path_s=path_s, peak_device_gb=peak_gb,
               loop_stats=st_loop, tick_stats=st_ticks)
    out["loop_agreement"] = agreement("loop", res_loop)
    out["tick_agreement"] = agreement("ticks", res_ticks)
    for tag, st, bucket in (("loop", st_loop, SERVE_Q), ("ticks", st_ticks, SERVE_TICK)):
        print(f"[serve] {tag} (bucket {bucket}): {json.dumps(st)}")
        check(st["scorer_compiles"] == 2 and st["graph_captures"] == 2,
              f"serve {tag}: {st['scorer_compiles']} scorer shapes and "
              f"{st['graph_captures']} captures, expected 2 (one a group)")
        check(st["support_uploads"] == 2 and st["evictions"] == 0,
              f"serve {tag}: uploads {st['support_uploads']}, evictions {st['evictions']}")
    print(f"[serve] {SERVE_REQUESTS} requests x {SERVE_Q} points round robin over "
          f"{len(names)} models in 2 groups (45 + 1 columns, support {models[0].x_perm.shape[0]}"
          f" x {models[0].x_perm.shape[1]}): loop {out['loop_qps']:.1f} q/s (p50 "
          f"{loop_p50:.4f} ms, p99 {loop_p99:.4f} ms) -> ticks {out['tick_qps']:.1f} q/s (p50 "
          f"{tick_p50:.4f} ms, p99 {tick_p99:.4f} ms) = {out['speedup']:.2f}x; path_s "
          f"{path_s:.3f}, peak_device_gb {peak_gb:.3f}; launches {json.dumps(counts)}")
    print(f"[serve] agreement with EngineModel.predict (need >= {SERVE_AGREE}): loop "
          f"{json.dumps(out['loop_agreement'])}; ticks {json.dumps(out['tick_agreement'])}")
    check(counts == want_counts, f"serve: launches {counts}, expected {want_counts}")

    # graph replay against eager scoring: the same traffic through engines
    # whose ticks call the scorer directly (no capture), in the order
    # graph (the counted run above), eager, eager, graph
    eager = engines(eager=True)
    runs = {"graph": [(loop_s, loop_p50, loop_p99, ticks_s, tick_p50, tick_p99)], "eager": []}
    for mode, engs in (("eager", eager), ("eager", eager), ("graph", (loop, ids, ticks, ids_t))):
        r_l, l_s, l_lat, r_t, t_s, t_lat = traffic(*engs)
        agreement(f"{mode} loop", r_l)
        agreement(f"{mode} ticks", r_t)
        runs[mode].append((l_s, *l_lat, t_s, *t_lat))
    check(eager[0].stats()["graph_captures"] == 0 and eager[2].stats()["graph_captures"] == 0,
          "serve: an eager engine captured a graph")
    out["graph_vs_eager"] = {
        mode: [dict(loop_qps=q_all / r[0], loop_p50_ms=r[1], loop_p99_ms=r[2],
                    tick_qps=q_all / r[3], tick_p50_ms=r[4], tick_p99_ms=r[5]) for r in rs]
        for mode, rs in runs.items()}
    for mode, rs in out["graph_vs_eager"].items():
        print(f"[serve] {mode} ticks, {len(rs)} runs: loop q/s "
              + ", ".join(f"{r['loop_qps']:.1f}" for r in rs) + " (p50 ms "
              + ", ".join(f"{r['loop_p50_ms']:.4f}" for r in rs) + "); ticked q/s "
              + ", ".join(f"{r['tick_qps']:.1f}" for r in rs) + " (p50 ms "
              + ", ".join(f"{r['tick_p50_ms']:.4f}" for r in rs) + ")")
    del eager

    # the device's share of a serving window (torch.profiler): 32 loop
    # requests, and 128 requests through the ticked engine
    from repro_torch.launch.serve import profile_device

    def loop_window():
        for i, q in reqs[:32]:
            loop.score(ids[i], q)

    def tick_window():
        for i, q in reqs[:128]:
            ticks.submit(ids_t[i], q)
        ticks.flush()

    out["profile"] = {"loop": profile_device(dev, loop_window),
                      "ticks": profile_device(dev, tick_window)}
    for tag, prof in out["profile"].items():
        print(f"[serve] profile {tag}: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms ({prof['busy_share']:.1%}); " + "; ".join(
                  f"{k} {v['ms']:.3f} ms in {v['kernels']} kernels"
                  for k, v in prof["groups"].items()))

    # ---- [check serve]: replays against eager ticks, K1/K4 against plain ----
    replay_gap, score_err = 0.0, 0.0
    for tag, eng, eids, bucket in (("loop", loop, ids, SERVE_Q),
                                   ("ticks", ticks, ids_t, SERVE_TICK)):
        for m in (0, len(eids) - 1):
            chunk = np.ascontiguousarray(tests[m][:bucket])
            group = eng.model_group(eids[m])
            before = eng.stats()["graph_replays"]
            ticket = eng.submit(eids[m], chunk)
            eng.flush()
            check(eng.stats()["graph_replays"] == before + 1, f"serve {tag}: no replay")
            got = ticket.result(timeout=0)[0].reshape(bucket, -1)
            xq = torch.as_tensor(chunk, device=dev)
            eager = batched_scores(xq, group.xs_dev, group.zy_dev, group.biases_dev,
                                   spec=group.spec, block=bucket).cpu().numpy()
            eager = eager[:, :got.shape[1]]      # the model's columns: the group's first
            gap = float(np.abs(got - eager).max() / np.abs(eager).max())
            replay_gap = max(replay_gap, gap)
            blk_fn, ref_fn = ((lops.laplacian_block_cuda, cref.laplacian_block_ref)
                              if group.spec.name == "laplacian"
                              else (gkern.gaussian_block_cuda, gref.gaussian_block_ref))
            args = (xq[None], group.xs_dev[None], group.spec.h)
            ref_s = ref_fn(*args)[0] @ group.zy_dev
            err = ((blk_fn(*args)[0] @ group.zy_dev - ref_s).abs().max()
                   / ref_s.abs().max()).item()
            score_err = max(score_err, err)
            print(f"[check serve] {tag} {names[m]} group ({group.spec.name}, "
                  f"{group.zy_host.shape[1]} columns, bucket {bucket}): replayed tick against "
                  f"the eager tick {'bit-equal' if gap == 0.0 else f'max rel gap {gap:.3e}'}; "
                  f"the eager block x the column block against the plain version's: max rel "
                  f"err {err:.3e} of the largest score (tol {SCORE_RTOL:g})")
            check(gap <= SCORE_RTOL, f"serve {tag}: replayed tick differs from eager: {gap}")
            check(err <= SCORE_RTOL, f"serve {tag}: kernel block disagrees: {err}")
    out.update(replay_gap=replay_gap, kernel_score_err=score_err)

    # ---- the shared cache: 3 models, one entry, one upload, one launch ----
    shared = ServingEngine(device=dev)
    sids = [shared.add_model(m) for m in models]
    for i in sids:
        shared.submit(i, multi_test[:64])
    shared.flush()
    st = shared.stats()
    xs_bytes = models[0].x_perm.numel() * models[0].x_perm.element_size()
    print(f"[serve] shared cache: {len(models)} models -> {st['cache_entries']} cache entry, "
          f"{st['support_uploads']} upload, {st['launches']} launch a tick, "
          f"{st['resident_support_bytes']} B resident (unshared {len(models) * xs_bytes} B)")
    check((st["groups"], st["cache_entries"], st["support_uploads"], st["launches"])
          == (1, 1, 1, 1) and st["resident_support_bytes"] == xs_bytes,
          f"serve: the shared cache reads {st}")
    out["shared"] = st
    del shared

    # ---- LRU: max_resident 1, the two groups alternating ----
    lru, lids = engine(BatchPolicy(buckets=(SERVE_Q,)), max_resident=1)
    first = {}
    for k in range(2 * SERVE_LRU_ROUNDS):
        m = 0 if k % 2 == 0 else len(lids) - 1
        s, _ = lru.score(lids[m], tests[m][:SERVE_Q])
        check(np.array_equal(first.setdefault(m, s), s), "serve LRU: a re-uploaded group "
              "scores differently")
    st = lru.stats()
    n = 2 * SERVE_LRU_ROUNDS
    print(f"[serve] LRU max_resident 1, {n} ticks alternating the groups: uploads "
          f"{st['support_uploads']}, evictions {st['evictions']}, captures "
          f"{st['graph_captures']} (expected {n}, {n - 1}, {n}); each group's scores equal "
          f"across re-uploads")
    check((st["support_uploads"], st["evictions"], st["graph_captures"], st["cache_entries"])
          == (n, n - 1, n, 1), f"serve LRU: {st}")
    out["lru"] = st
    del lru

    # ---- bf16 policy against f32, the ticked engine's traffic ----
    b16, bids = engine(BatchPolicy(max_batch=SERVE_TICK, buckets=(SERVE_TICK,),
                                   compute_dtype="bfloat16"))
    tick16 = [b16.submit(bids[i], q) for i, q in reqs]
    b16.flush()
    res16 = [t.result(timeout=0) for t in tick16]
    bf = {}
    for m, name in enumerate(names):
        pairs = [(a, b) for (i, _), a, b in zip(reqs, res_ticks, res16) if i == m]
        s32 = np.concatenate([np.asarray(a[0]).reshape(SERVE_Q, -1) for a, _ in pairs])
        s16 = np.concatenate([np.asarray(b[0]).reshape(SERVE_Q, -1) for _, b in pairs])
        same = np.concatenate([np.asarray(b[1]) == np.asarray(a[1]) for a, b in pairs])
        clear = np.abs(s32).min(axis=1) > SERVE_BF16_RTOL * np.abs(s32).max()
        gap = float(np.abs(s16 - s32).max() / np.abs(s32).max())
        bf[name] = dict(max_rel_score_gap=gap, agreement=float(np.mean(same)),
                        clear_rows=int(clear.sum()), clear_agreement=float(np.mean(same[clear])))
        check(gap <= SERVE_BF16_RTOL and same[clear].all(),
              f"serve bf16: {name} gap {gap}, {int((~same[clear]).sum())} clear rows differ")
    print(f"[serve] bf16 policy against f32 (bar {SERVE_BF16_RTOL:g} of the largest score; "
          f"predictions equal on the rows clear of it): {json.dumps(bf)}")
    out["bf16"] = bf
    del b16, loop, ticks

    # ---- K1 and K4 at the serving shapes: bucket rows x the support ----
    xs_m, xs_l = models[0].x_perm, lap_model.x_perm
    k1_rows, k4_rows = [], []
    for bucket in (SERVE_Q, SERVE_TICK):
        xq = torch.as_tensor(np.ascontiguousarray(multi_test[:bucket]), device=dev)
        k1_rows.append(k1_case(f"serving tick {bucket} x 2^20", xq, xs_m, 50, h=H_MULTI))
        xq = torch.as_tensor(np.ascontiguousarray(lap_test[:bucket]), device=dev)
        k4_rows.append(k4_case(f"serving tick {bucket} x 2^20", xq, xs_l, 50))
    # the bf16 policy's K4 launches: bf16 queries against the bf16 support
    k4_rows.append(k4_case(f"serving tick {SERVE_TICK} x 2^20 bf16", xq.to(torch.bfloat16),
                           xs_l.to(torch.bfloat16), 50))
    return counts, k1_rows, k4_rows, out


# ---------------------------------------------------------------------- #
# The paper's baselines (slice 6): [baselines]                            #
# ---------------------------------------------------------------------- #
# benchmarks/bench_baselines.py:28-83's data and knobs (circles, 4
# features, gap 0.8, seed 1; h 1, C 1, β 100; 1024 test points), with the
# training set at 65536 points: dense ADMM (one K1 launch of K, 17.2 GB,
# then a dense Cholesky), Nyström ADMM (256 landmarks) and the HSS trainer
# (rank 32, 48 + 64 proxies, leaf 128); SMO on the host at 16384 points
# with max_iter 4000.  At 4096 points the card's dense and Nyström fits
# are held against the CPU's.
BASE_N, BASE_SMO_N, BASE_N_TEST = 65536, 16384, 1024
BASE_H, BASE_C, BASE_BETA, BASE_LANDMARKS, BASE_LEAF = 1.0, 1.0, 100.0, 256, 128
BASE_SLAB = 8192              # rows a call when the plain version times the dense K
# [small]'s pattern, card against CPU: z within 1e-4·C, the bias within
# 1e-4, predictions equal on >= 0.999 of the test points; the dense fit at
# 4096 points, Nyström at each (n, seed) of BASE_SMALL.  Nyström's W^{-1/2}
# keeps W's eigenvalues down to the reference's cutoff of 1e-8, far below
# f32's resolution of W (~6e-8·λ_max, λ_max ~63 here): W's condition then
# reaches ~1e7, and the CPU's own f32 fit moves by up to ~1e-4 in z and
# ~2e-4 in the bias when only its linear algebra runs in f64 (the run
# prints that spread at both sizes and seeds).  Two f32 evaluations of it
# (cuSOLVER's eigh against LAPACK's, K1's blocks against the plain
# version's) are held to ten times the dense bar, and the run shows that
# bar failing a fit whose K(X, L) is off by BASE_FAULT_REL of itself.
BASE_SMALL = ((4096, 1), (8192, 2))
BASE_Z_ATOL, BASE_BIAS_ATOL, BASE_AGREE = 1e-4 * BASE_C, 1e-4, 0.999
BASE_NYSTROM_ATOL = 1e-3
BASE_FAULT_REL = 1e-3


def baselines_phase(torch, dev, recording):
    """[baselines]: the paper's rivals against the HSS trainer on the card.
    Returns the counted run's launches and host-kept launch records, the
    HSS build's compression parameters, K1's dense row (timings) and the
    rows."""
    import numpy as np

    from repro_torch.core import baselines as pb
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.svm import HSSSVMTrainer
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build, pairwise
    from repro_torch.kernels.gaussian import ops as gops, ref as gref

    spec = KernelSpec(h=BASE_H)
    xtr, ytr, xte, yte = synthetic.train_test("circles", BASE_N, BASE_N_TEST, seed=1,
                                              n_features=4, gap=0.8)
    xs_, ys_, _, _ = synthetic.train_test("circles", BASE_SMO_N, BASE_N_TEST, seed=1,
                                          n_features=4, gap=0.8)
    x, y = torch.as_tensor(xtr, device=dev), torch.as_tensor(ytr, device=dev)
    xt = torch.as_tensor(xte, device=dev)
    rows = {}

    def row(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        acc, extra = fn()
        torch.cuda.synchronize()
        rows[name] = dict(wall_s=time.perf_counter() - t0, accuracy=acc,
                          peak_device_gb=torch.cuda.max_memory_allocated() / 1e9, **extra)

    def dense():
        z, b = pb.dense_admm_fit(x, y, spec, BASE_C, BASE_BETA)
        pred = pb.dense_predict(x, y, z, b, spec, xt).cpu().numpy()
        return float(np.mean(pred == yte)), dict(n=BASE_N)

    def nystrom():
        z, b = pb.nystrom_admm_fit(x, y, spec, BASE_C, BASE_BETA,
                                   landmarks=pb.nystrom_landmarks(BASE_N, BASE_LANDMARKS))
        pred = pb.dense_predict(x, y, z, b, spec, xt).cpu().numpy()
        return float(np.mean(pred == yte)), dict(n=BASE_N, landmarks=BASE_LANDMARKS)

    comp = CompressionParams(rank=32, n_near=48, n_far=64)
    trainer = HSSSVMTrainer(spec=spec, comp=comp, leaf_size=BASE_LEAF, max_it=10, device=dev)

    def hss():
        model = trainer.fit(xtr, ytr, c_value=BASE_C)
        pred = model.predict(xte).cpu().numpy()
        rep = trainer.report
        return float(np.mean(pred == yte)), dict(
            n=BASE_N, levels=rep.hss_levels, compression_s=rep.compression_s,
            factorization_s=rep.factorization_s, admm_s=rep.admm_s, memory_mb=rep.memory_mb)

    def smo():
        t0 = time.perf_counter()
        alpha, b, iters = pb.smo_fit(xs_, ys_, spec, BASE_C, max_iter=4000)
        host_s = time.perf_counter() - t0
        xs_t = torch.as_tensor(xs_, device=dev)
        pred = pb.dense_predict(xs_t, torch.as_tensor(ys_, device=dev),
                                torch.as_tensor(alpha, dtype=torch.float32, device=dev),
                                b, spec, xt).cpu().numpy()
        return float(np.mean(pred == yte)), dict(n=BASE_SMO_N, iters=iters, host_s=host_s)

    # host-kept records: the dense K's launch keeps only its inputs, and the
    # rows' peaks stay those of the fits
    with recording(to_host=True) as rec:
        _build.reset_launch_counts()
        for name, fn in (("dense_admm", dense), ("nystrom_admm", nystrom),
                         ("hss_admm", hss), ("smo", smo)):
            row(name, fn)
        counts = dict(_build.launch_counts)
    for name, r in rows.items():
        print(f"[baselines] {name}: {json.dumps(r)}")
        check(np.isfinite(r["accuracy"]) and r["accuracy"] > 0.5,
              f"baselines: {name} accuracy {r['accuracy']}")
    levels = rows["hss_admm"]["levels"]
    # K1: dense K + its predict, Nyström's W, K(X, L) and predict, the HSS
    # build (leaf D, one a level) and its scoring block, SMO's predict
    # (a call is one launch, whatever its plan)
    want = {name: 0 for name in counts}
    want["gaussian_block"] = 2 + 3 + 1 + levels + 1 + 1
    want["fused_assemble_id"] = levels
    print(f"[baselines] launches {json.dumps(counts)}")
    check(counts == want, f"baselines: launches {counts}, expected {want}")
    check(tuple(rec["gaussian_block_cuda"][0][0][0].shape) == (1, BASE_N, 4),
          "baselines: the first K1 launch is not the dense K")

    ms = time_ms(torch, lambda: gops.gaussian_block(x, x, BASE_H), 3)
    torch.cuda.empty_cache()

    def plain_slabs():
        for r0 in range(0, BASE_N, BASE_SLAB):
            gref.gaussian_block_ref(x[r0:r0 + BASE_SLAB], x, BASE_H)

    plain = time_ms(torch, plain_slabs, 1)
    bms, by = bound(*k1_cost(1, BASE_N, BASE_N, 4))
    dense_plan = pairwise.plan_for(x[None], x[None]).label()
    print(f"[kernels] K1 gaussian_block dense K (1,{BASE_N},4)x(1,{BASE_N},4): kernel "
          f"{ms:.4f} ms [{dense_plan}], plain {plain:.4f} ms ({BASE_N // BASE_SLAB} slabs "
          f"of {BASE_SLAB} rows), bound {bms:.4f} ms ({by})")
    dense_row = dict(shape=f"dense K {BASE_N}^2", ms=ms, plain_ms=plain, bound_ms=bms,
                     bound_by=by, plan=dense_plan)
    del x, y, xt
    torch.cuda.empty_cache()

    # ---- card against CPU on small sets; Nyström's f32 spread; a fault ----
    def fit_on(where, dtype, fit, data, kw):
        xs4, ys4, xt4 = (torch.as_tensor(a, device=where, dtype=dtype) for a in data)
        z, b = fit(xs4, ys4, spec, BASE_C, BASE_BETA, **kw)
        return z.cpu().double(), float(b), pb.dense_predict(xs4, ys4, z, b, spec, xt4).cpu()

    def gaps(ref, got):
        return ((ref[0] - got[0]).abs().max().item(), abs(ref[1] - got[1]),
                (ref[2] == got[2]).float().mean().item())

    for n, seed in BASE_SMALL:
        xs4, ys4, xt4, _ = synthetic.train_test("circles", n, BASE_N_TEST, seed=seed,
                                                n_features=4, gap=0.8)
        data = (xs4, ys4, xt4)
        cases = [("nystrom_admm", pb.nystrom_admm_fit,
                  dict(landmarks=pb.nystrom_landmarks(n, BASE_LANDMARKS)),
                  BASE_NYSTROM_ATOL * BASE_C, BASE_NYSTROM_ATOL)]
        if (n, seed) == BASE_SMALL[0]:
            cases.insert(0, ("dense_admm", pb.dense_admm_fit, {}, BASE_Z_ATOL, BASE_BIAS_ATOL))
        for name, fit, kw, z_tol, b_tol in cases:
            cpu = fit_on("cpu", torch.float32, fit, data, kw)
            dz, db, agree = gaps(cpu, fit_on(dev, torch.float32, fit, data, kw))
            dz64, db64, _ = gaps(cpu, fit_on("cpu", torch.float64, fit, data, kw))
            print(f"[check baselines] {name} n={n} seed {seed}, card against CPU: |dz| "
                  f"{dz:.3e} (tol {z_tol:g}), |dbias| {db:.3e} (tol {b_tol:g}), predictions "
                  f"equal {agree:.4f} (need >= {BASE_AGREE}); the CPU's f32 fit against its "
                  f"f64 linear algebra: |dz| {dz64:.3e}, |dbias| {db64:.3e}")
            check(dz <= z_tol and db <= b_tol and agree >= BASE_AGREE,
                  f"baselines: {name} at n={n} on the card disagrees with the CPU")
            rows[name].setdefault("small_card_vs_cpu", {})[f"{n}/{seed}"] = dict(
                dz=dz, dbias=db, agreement=agree, f64_dz=dz64, f64_dbias=db64)
            if name != "nystrom_admm" or (n, seed) != BASE_SMALL[0]:
                continue
            # the fault: K(X, L) off by up to BASE_FAULT_REL of itself, on the card
            gen = torch.Generator(device=dev).manual_seed(0)
            orig_block = pb.kernel_block

            def off_block(spec_, xa, xb, _n=n):
                k = orig_block(spec_, xa, xb)
                if xa.shape[0] == _n and xb.shape[0] == BASE_LANDMARKS:
                    k = k * (1 + BASE_FAULT_REL * (2 * torch.rand(
                        k.shape, generator=gen, device=k.device) - 1))
                return k

            pb.kernel_block = off_block
            try:
                fz, fb, _ = gaps(cpu, fit_on(dev, torch.float32, fit, data, kw))
            finally:
                pb.kernel_block = orig_block
            print(f"[check baselines] {name} n={n} seed {seed} with K(X, L) off by up to "
                  f"{BASE_FAULT_REL:g} of itself, against the CPU's fit: |dz| {fz:.3e}, "
                  f"|dbias| {fb:.3e} (the bar {z_tol:g} / {b_tol:g} must fail it)")
            check(fz > z_tol or fb > b_tol, f"baselines: the {name} bar passes a faulty fit")
            rows[name]["fault"] = dict(rel=BASE_FAULT_REL, dz=fz, dbias=fb)
    return counts, rec, comp, dense_row, rows


# ---------------------------------------------------------------------- #
# The LM serving path (slice 3): zamba2-1.2b prefill + decode, K5 and K6  #
# ---------------------------------------------------------------------- #
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "zamba2-1.2b", 4, 1024, 32
LM_SMALL_LAYERS, LM_SMALL_PROMPT, LM_SMALL_STEPS = 6, 256, 4
K5_F32_RTOL = 5e-5   # f32 products summed in another order, of the largest output
# bf16: kernel and plain version round the same f32 result to bf16, so an
# output may differ by one rounding step where their two f32 values straddle
# a rounding boundary.  bf16 has 8 significant bits: at the largest |output|
# (at least 1) a step is 2^(floor(log2) - 7), between 2^-8 and 2^-7 of it.
# (Read as 2^-8 of the largest output until slice 7, which is less than one
# step above a power of 2: gemma2's path showed exactly one step, 2^-6 at an
# output in [2, 4), against a largest output of 3.39.)


def k5_bf16_tol(scale: float) -> float:
    """One bf16 rounding step at ``scale`` = max(1, the largest |output|)."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


K6_RTOL = 1e-4       # f32 chunk sums in another order (the JAX SSD test's rtol)
# The card against the CPU, the same f32 model: f32 reductions in other orders
# through 6 layers, one attention and two SSD chunks (the CPU tests see 1e-6
# between the port and the JAX package), of the largest |logit|.
LM_SMALL_RTOL = 1e-3
# [lm-small-bf16]: the same model in bf16 on both devices, K5 and K6 on bf16
# views on the card, their plain versions on the CPU: bf16 rounds at other
# places in the two runs; the bar of the CPU tests that hold the bf16 port
# against the JAX package (tests/test_torch_lm.py), of the largest |logit|.
LM_SMALL_BF16_RTOL = 5e-2
# K5's cases, all bf16 as the models compute: (label, (B, H, KV, S, D), timing
# repeats, the SDPA call that computes the same function or None, options).
# The first is the zamba2 path's shape; gemma2's softcap has no SDPA twin.
K5_CASES = [
    ("zamba2 path", (LM_BATCH, 32, 32, LM_PROMPT, 64), 20, "causal", dict(causal=True)),
    ("gemma2-9b local layer", (1, 16, 8, 8192, 256), 3, None,
     dict(causal=True, window=4096, softcap=50.0)),
    ("hubert-xlarge", (2, 16, 16, 1024, 80), 10, "full", dict(causal=False)),
    ("paligemma-3b prefix-LM", (2, 8, 1, 512, 256), 10, "prefix",
     dict(causal=True, prefix_len=256)),
    # the shapes of the attention families' paths below
    ("gemma2-9b path, local layer", (2, 16, 8, 4608, 256), 5, None,
     dict(causal=True, window=4096, softcap=50.0)),
    ("gemma2-9b path, global layer", (2, 16, 8, 4608, 256), 5, None,
     dict(causal=True, softcap=50.0)),
    ("granite-moe path", (4, 24, 8, 1024, 64), 20, "causal", dict(causal=True)),
    ("paligemma-3b small path", (1, 8, 1, 320, 256), 20, "prefix",
     dict(causal=True, prefix_len=256)),
    ("hubert-xlarge small path", (1, 16, 16, 512, 80), 20, "full", dict(causal=False)),
]
# K6's cases: (label, (B, S, H, P, G, N, chunk), timing repeats, type of x, B
# and C).  bf16 first, as a bf16 model hands them over (views of one xBC
# tensor); the first is the path's row.  Then the same shapes in f32.
K6_CASES = [
    ("zamba2 path", (LM_BATCH, LM_PROMPT, 64, 64, 1, 64, 128), 20, "bfloat16"),
    ("mamba2-780m", (LM_BATCH, LM_PROMPT, 48, 64, 1, 128, 128), 20, "bfloat16"),
    ("zamba2 path f32", (LM_BATCH, LM_PROMPT, 64, 64, 1, 64, 128), 20, "float32"),
    ("mamba2-780m f32", (LM_BATCH, LM_PROMPT, 48, 64, 1, 128, 128), 20, "float32"),
]
SDPA_RTOL = 2.0 ** -5   # SDPA rounds P to bf16 before P·V; the reference keeps it f32


def errs(out, ref):
    """(max |out - ref|, the scale max(1, max |ref|) its tolerance is of)."""
    out, ref = out.float(), ref.float()
    return (out - ref).abs().max().item(), max(1.0, ref.abs().max().item())


def rel_err(out, ref):
    err, scale = errs(out, ref)
    return err / scale


def sdpa_call(torch, dev, kind, h, kvh, s, opts):
    """The one SDPA call that computes K5's function, or None: "causal",
    "full", or "prefix" (the prefix-LM mask as a boolean mask); GQA through
    ``enable_gqa`` where the heads are grouped."""
    import torch.nn.functional as F

    if kind is None:
        return None
    kw = dict(enable_gqa=True) if h != kvh else {}
    if kind == "causal":
        kw["is_causal"] = True
    elif kind == "prefix":
        from repro_torch.kernels.attention import ref as attn_ref
        pos = torch.arange(s, device=dev)
        kw["attn_mask"] = attn_ref.visible(pos, pos, True, None, opts["prefix_len"])
    return lambda q, k, v: F.scaled_dot_product_attention(q, k, v, **kw)


def k5_case(torch, dev, label, b, h, kvh, s, d, dtype, reps, sdpa=None, **opts):
    """K5 against its plain version (and ``sdpa``, the library's call) on
    random q (B, H, S, D), k and v (B, KV, S, D): error, kernel, plain,
    SDPA and bound ms."""
    from repro_torch.kernels.attention import ops as attn_ops, ref as attn_ref

    def randn(shape, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, device=dev, generator=g).to(dtype)

    q, k, v = (randn((b, n_, s, d), seed) for n_, seed in ((h, 40), (kvh, 41), (kvh, 42)))
    out = attn_ops.flash_attention(q, k, v, **opts)
    ref = attn_ref.attention_ref(q, k, v, **opts)
    err, scale = errs(out, ref)
    del out, ref
    torch.cuda.empty_cache()
    tol = K5_F32_RTOL * scale if dtype == torch.float32 else k5_bf16_tol(scale)
    ms = time_ms(torch, lambda: attn_ops.flash_attention(q, k, v, **opts), reps)
    plain = time_ms(torch, lambda: attn_ref.attention_ref(q, k, v, **opts), 1)
    torch.cuda.empty_cache()
    lib = None
    if sdpa is not None:
        # the same function, up to SDPA's own bf16 rounding of P
        err_lib = rel_err(sdpa(q, k, v), attn_ref.attention_ref(q, k, v, **opts))
        check(err_lib <= SDPA_RTOL, f"K5 {label}: SDPA does not compute the same "
              f"function here ({err_lib})")
        lib = time_ms(torch, lambda: sdpa(q, k, v), reps)
    pos = torch.arange(s, device=dev)
    pairs = int(attn_ref.visible(pos, pos, opts.get("causal", True), opts.get("window"),
                                 opts.get("prefix_len", 0)).sum())
    bms, by = k5_cost(b, h, kvh, s, d, q.element_size(), pairs)
    print(f"[kernels] K5 flash_attention {label} q ({b},{h},{s},{d}) kv {kvh} "
          f"{str(dtype).replace('torch.', '')} {opts}: max_abs_err {err:.3e} "
          f"(tol {tol:.3g}, largest |output| {scale:.3g}), kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, SDPA "
          f"{'-' if lib is None else f'{lib:.4f}'} ms, bound {bms:.4f} ms ({by})")
    check(err <= tol, f"K5 {label} disagrees with its plain version: {err}")
    del q, k, v
    torch.cuda.empty_cache()
    return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib)


def lm_argv(arch, batch, prompt, gen, dev):
    """``launch.serve``'s arguments for ``arch`` at full size."""
    return ["--arch", arch, "--preset", "full", "--batch", str(batch), "--prompt-len",
            str(prompt), "--gen", str(gen), "--device", str(dev)]


def recorder(rec: list):
    """Wraps a launcher so that each call's (args, kw, out) lands in ``rec``."""
    def make(fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            rec.append((args, kw, out))
            return out
        return wrapped
    return make


def moved(obj, where):
    """A launch's arguments or outputs with every tensor on ``where``."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(where)
    if isinstance(obj, tuple):
        return tuple(moved(o, where) for o in obj)
    return obj


@contextlib.contextmanager
def recording(to_host: bool = False):
    """Keep the arguments of every K1, K4 and K2 launch made inside the
    block (and K2's pivots and R): the path's own inputs, which its check
    runs through the plain versions afterwards.  The launchers themselves
    run once per call, so each launch still counts once.  ``to_host`` keeps
    host copies, so that the records of a streamed build take no device
    memory from the working set it measures."""
    from repro_torch.kernels.compress import kernel as ckern, laplacian as lops
    from repro_torch.kernels.gaussian import kernel as gkern

    launchers = ((gkern, "gaussian_block_cuda"), (lops, "laplacian_block_cuda"),
                 (ckern, "fused_assemble_id_cuda"))
    rec = {name: [] for _, name in launchers}
    saved = [(mod, name, getattr(mod, name)) for mod, name in launchers]
    for mod, name, fn in saved:
        def kept(*args, _fn=fn, _name=name, **kw):
            out = _fn(*args, **kw)
            item = (args, out if _name == "fused_assemble_id_cuda" else None)
            rec[_name].append(moved(item, "cpu") if to_host else item)
            return out
        setattr(mod, name, kept)
    try:
        yield rec
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def serve_twice(torch, tag, argv, wraps=()):
    """The serving entry point cold, with the launch counts zeroed just
    before and read just after and each (module, launcher, wrapper) of
    ``wraps`` in place meanwhile; then a steady-state reading: the same
    entry point after one untimed prefill, with a torch.profiler trace of
    one prefill and one decode step.  Returns (the cold result, its counts)."""
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.launch import serve

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in wraps]
    for mod, name, make in wraps:
        setattr(mod, name, make(getattr(mod, name)))
    try:
        _build.reset_launch_counts()
        res = serve.serve_lm(serve.parser().parse_args(argv))
        counts = dict(_build.launch_counts)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    print(f"[{tag}] {res['arch']} {res['n_layers']} layers d_model {res['d_model']} "
          f"{res['compute_dtype']}, batch {res['batch']}, prompt {res['prompt_len']}, gen "
          f"{res['gen']}: prefill_ms {res['prefill_ms']:.3f}, decode_ms {res['decode_ms']:.3f}, "
          f"tok_per_s {res['tok_per_s']:.1f}, peak_device_bytes {res['peak_device_bytes']}; "
          f"launches prefill {json.dumps(res['launches_prefill'])} decode "
          f"{json.dumps(res['launches_decode'])}")
    print(f"[{tag}] sample token ids {res['tokens'][0][:12].tolist()}")
    torch.cuda.empty_cache()
    res2 = serve.serve_lm(serve.parser().parse_args(argv + ["--warmup", "1", "--profile"]))
    print(f"[{tag}] after a warm-up prefill: prefill_ms {res2['prefill_ms']:.3f}, decode_ms "
          f"{res2['decode_ms']:.3f}, tok_per_s {res2['tok_per_s']:.1f}, peak_device_bytes "
          f"{res2['peak_device_bytes']}; the same tokens as the first run: "
          f"{bool(np.array_equal(res2['tokens'], res['tokens']))}")
    check(bool(np.array_equal(res2['tokens'], res['tokens'])),
          f"{tag}: the second run's greedy tokens differ from the first's")
    del res2
    torch.cuda.empty_cache()
    return res, counts


def check_served(torch, tag, res, counts, vocab, want_prefill):
    """Finite logits, token ids of the vocabulary, the launches of
    ``want_prefill`` in prefill (the other kernels none), none in decode."""
    toks = res["tokens"]
    check(toks.shape == (res["batch"], res["gen"]) and ((toks >= 0) & (toks < vocab)).all(),
          f"{tag}: generated tokens are not ids of the vocabulary")
    check(bool(torch.isfinite(res["last_logits"]).all()), f"{tag}: non-finite logits")
    want = {name: 0 for name in counts}
    want_pre = dict(want, **want_prefill)
    check(res["launches_prefill"] == want_pre and res["launches_decode"] == want
          and counts == want_pre,
          f"{tag}: launches {counts} (prefill {res['launches_prefill']}, decode "
          f"{res['launches_decode']}), expected prefill {want_pre} and none in decode")


def k5_replay(rec):
    """Every recorded K5 launch against the plain version on its own inputs:
    (max |error|, the worst launch's error in bf16 steps, the worst relative
    to its output's scale)."""
    from repro_torch.kernels.attention import ref as attn_ref

    abs_ = steps = rel = 0.0
    for args, kw, out in rec:
        err, scale = errs(out, attn_ref.attention_ref(*args, **kw))
        abs_, steps = max(abs_, err), max(steps, err / k5_bf16_tol(scale))
        rel = max(rel, err / scale)
    return abs_, steps, rel


def k6_replay(rec):
    """Every recorded K6 launch (with its final state) against the plain
    version on its own inputs: (max |error|, the worst relative to its
    output's scale), y and the state."""
    from repro_torch.kernels.ssd import ref as ssd_ref

    abs_ = worst = 0.0
    for args, _, out in rec:
        x, dt, a, b_mat, c_mat, d_vec, chunk, _ = args
        y_ref, h_ref = ssd_ref.ssd_chunked_ref(x, dt, a, b_mat, c_mat, d_vec, chunk)
        for got, ref in ((out[0], y_ref), (out[1], h_ref)):
            err, scale = errs(got, ref)
            worst, abs_ = max(worst, err / scale), max(abs_, err)
    return abs_, worst


def lm_phases(torch, dev):
    """[kernels] K5 and K6 against their plain versions, [lm-small], [lm] and
    [check lm].  Returns the kernels' summary entries and the path's counts."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as attn_kern
    from repro_torch.kernels.ssd import kernel as ssd_kern, ops as ssd_ops, ref as ssd_ref
    from repro_torch.models.transformer import Model

    # ---- K5 at the path's shape and the repo's other attention shapes --- #
    k5_rows = [k5_case(torch, dev, label, b, h, kvh, s_, d, torch.bfloat16, reps,
                       sdpa=sdpa_call(torch, dev, sdpa, h, kvh, s_, opts), **opts)
               for label, (b, h, kvh, s_, d), reps, sdpa, opts in K5_CASES]

    # ---- K6 at the path's shape and mamba2-780m's, bf16 and f32 ---------- #
    def ssd_inputs(b, s, h, p, g, n, seed, dtype):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn((b, s, h, p), device=dev, generator=gen)
        dt = torch.rand((b, s, h), device=dev, generator=gen) * 0.1 + 0.001
        bm = torch.randn((b, s, g, n), device=dev, generator=gen) * 0.3
        cm = torch.randn((b, s, g, n), device=dev, generator=gen) * 0.3
        if dtype == "bfloat16":
            # the same values rounded to bf16, as views of one (B, S, HP + 2GN)
            # tensor: the slices of xBC that a bf16 model hands over
            xbc = torch.cat([x.reshape(b, s, h * p), bm.reshape(b, s, g * n),
                             cm.reshape(b, s, g * n)], dim=-1).to(torch.bfloat16)
            xv, bv, cv = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
            x, bm, cm = (xv.reshape(b, s, h, p), bv.reshape(b, s, g, n),
                         cv.reshape(b, s, g, n))
        return (x, dt, -torch.linspace(1.0, 16.0, h, device=dev), bm, cm,
                torch.ones(h, device=dev))

    def k6_passes(fn, reps=5, tries=3):
        """Device ms of each of K6's three CUDA kernels in one call
        (torch.profiler, mean over ``reps`` calls after a warm-up).  The
        profiler's CUPTI trace can drop every event of one kernel in a
        window, so a pass missing from a trace is profiled again, up to
        ``tries`` traces; one still missing then is None ("not measured").
        Whether the kernel ran and agrees is checked apart from this."""
        from torch.profiler import ProfilerActivity, profile
        out = {}
        for _ in range(tries):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            for ev in prof.key_averages():
                for name in ("state", "pass", "scan"):
                    if f"ssd_chunk_{name}_kernel" in ev.key and name not in out:
                        out[name] = ev.device_time_total / ev.count / 1e3
            if len(out) == 3:
                return out
            print(f"[kernels] K6: the profile shows {sorted(out)} of the three passes; "
                  f"profiling again")
        return {name: out.get(name) for name in ("state", "pass", "scan")}

    def k6_case(label, b, s, h, p, g, n, q, reps, dtype):
        args = ssd_inputs(b, s, h, p, g, n, 50, dtype)
        y, hf = ssd_ops.ssd_forward(*args, chunk=q, return_state=True)
        y_ref, h_ref = ssd_ref.ssd_chunked_ref(*args, q)
        (ey, sy), (eh, sh) = errs(y, y_ref), errs(hf, h_ref)
        err, rel = max(ey, eh), max(ey / sy, eh / sh)
        del y, hf, y_ref, h_ref
        ms = time_ms(torch, lambda: ssd_ops.ssd_forward(*args, chunk=q, return_state=True),
                     reps)
        plain = time_ms(torch, lambda: ssd_ref.ssd_chunked_ref(*args, q), 3)
        passes = k6_passes(lambda: ssd_ops.ssd_forward(*args, chunk=q, return_state=True))
        pass_ms = "/".join("not measured" if passes[k] is None else f"{passes[k]:.4f}"
                           for k in ("state", "pass", "scan"))
        elem = args[0].element_size()
        bms, by = k6_cost(b, s, h, p, g, n, q, elem)
        ht = ssd_kern.head_tile(b, s // q, h, g)
        plan = ssd_kern.smem_plan(q, p, n, elem, ht)
        print(f"[kernels] K6 ssd_chunk {label} x ({b},{s},{h},{p}) B/C G={g} N={n} chunk {q} "
              f"{dtype}: max_abs_err y and state {err:.3e}, relative {rel:.3e} (tol "
              f"{K6_RTOL:g}), kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms "
              f"({by}); passes state/pass/scan {pass_ms} ms; head tile {ht}, smem B/block "
              f"state {plan.state_bytes} ({plan.stages_state} stages) "
              f"scan {plan.scan_bytes} ({plan.stages_scan})")
        check(rel <= K6_RTOL, f"K6 {label} disagrees with its plain version: {rel}")
        return dict(shape=f"{label} ({dtype})", max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, library_ms=None, passes_ms=passes)

    k6_rows = [k6_case(label, *shape, reps, dtype) for label, shape, reps, dtype in K6_CASES]
    torch.cuda.empty_cache()

    # ---- [lm-small] (f32) and [lm-small-bf16]: full width, 6 layers, the
    # card against the CPU, the same weights through load_state_dict -------- #
    def lm_small(tag, compute_dtype, tol):
        cfg_small = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_SMALL_LAYERS,
                                        compute_dtype=compute_dtype)
        cpu_model = Model(cfg_small, device="cpu").init(torch.Generator().manual_seed(0))
        card_model = Model(cfg_small, device=dev)
        card_model.load_state_dict(cpu_model.state_dict())
        toks = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg_small.vocab, size=(1, LM_SMALL_PROMPT + LM_SMALL_STEPS)))
        worst = 0.0
        logits = {}
        t0 = time.perf_counter()
        for where, model in (("cpu", cpu_model), ("cuda", card_model)):
            _build.reset_launch_counts()       # read after the card's run, the last
            t = toks.to(model.device)
            out, cache = model.prefill({"tokens": t[:, :LM_SMALL_PROMPT]},
                                       LM_SMALL_PROMPT + LM_SMALL_STEPS)
            outs = [out.cpu()]
            for i in range(LM_SMALL_PROMPT, LM_SMALL_PROMPT + LM_SMALL_STEPS):
                out, cache = model.decode_step(cache, t[:, i:i + 1])
                outs.append(out.cpu())
            logits[where] = outs
        counts = dict(_build.launch_counts)
        for a_, b_ in zip(logits["cuda"], logits["cpu"]):
            check(bool(torch.isfinite(a_.float()).all()), f"{tag}: non-finite logits on the card")
            worst = max(worst, rel_err(a_, b_))
        print(f"[{tag}] {LM_ARCH} full width, {LM_SMALL_LAYERS} layers, {compute_dtype}, batch 1, "
              f"prompt {LM_SMALL_PROMPT}, {LM_SMALL_STEPS} teacher-forced decode steps: card vs "
              f"CPU logits max_rel_err {worst:.3e} (tol {tol:g}); logits "
              f"{logits['cuda'][0].dtype}; {time.perf_counter() - t0:.1f} s both runs; card "
              f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
        check(worst <= tol, f"{tag}: the card and the CPU disagree: {worst}")
        check(counts["flash_attention"] == 1 and counts["ssd_chunk"] == LM_SMALL_LAYERS,
              f"{tag}: launches {counts}")
        del cpu_model, card_model, logits
        torch.cuda.empty_cache()

    lm_small("lm-small", "float32", LM_SMALL_RTOL)
    # the bf16 twin: on the card K6 takes x, B and C as bf16 views of xBC
    rec6 = []
    orig6 = ssd_kern.ssd_chunk_cuda

    def ssd_rec(*args, **kw):
        rec6.append(str(args[0].dtype))
        return orig6(*args, **kw)

    ssd_kern.ssd_chunk_cuda = ssd_rec
    try:
        lm_small("lm-small-bf16", "bfloat16", LM_SMALL_BF16_RTOL)
    finally:
        ssd_kern.ssd_chunk_cuda = orig6
    check(rec6 == ["torch.bfloat16"] * LM_SMALL_LAYERS,
          f"lm-small-bf16: K6 took {rec6}, not the model's bf16")

    # ---- [lm]: the serving entry point at full width and depth ----------- #
    rec5, rec6 = [], []
    cfg = get_config(LM_ARCH)
    napp = cfg.n_layers // cfg.shared_attn_every
    res, lm_counts = serve_twice(
        torch, "lm", lm_argv(LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN, dev),
        [(attn_kern, "flash_attention_cuda", recorder(rec5)),
         (ssd_kern, "ssd_chunk_cuda", recorder(rec6))])
    check_served(torch, "lm", res, lm_counts, cfg.vocab,
                 dict(flash_attention=napp, ssd_chunk=cfg.n_layers))

    # ---- [check lm]: every K5 / K6 launch of the path, replayed plain ---- #
    abs5, worst5, _ = k5_replay(rec5)
    abs6, worst6 = k6_replay(rec6)
    k6_types = sorted({str(args[0].dtype) for args, _, _ in rec6})
    print(f"[check lm] K5: {len(rec5)} launches of the path against the plain version, "
          f"max_abs_err {abs5:.3e}, worst launch {worst5:.2f} bf16 steps (bar 1); K6: "
          f"{len(rec6)} launches (x, B, C {k6_types}), "
          f"y and final state max_abs_err {abs6:.3e}, relative {worst6:.3e} (tol {K6_RTOL:g})")
    check(k6_types == ["torch.bfloat16"], f"check lm: K6 took {k6_types}, not the model's bf16")
    check(len(rec5) == napp and len(rec6) == cfg.n_layers,
          "check lm: the recorded launches are not the path's")
    check(worst5 <= 1, f"check lm: K5 disagrees on the path's inputs: {worst5}")
    check(worst6 <= K6_RTOL, f"check lm: K6 disagrees on the path's inputs: {worst6}")
    del rec5, rec6, res
    torch.cuda.empty_cache()

    def entry(name, source, replaces, rows, path_max):
        main = rows[0]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=lm_counts[name], launches_path="lm",
                    launches_by_path={"lm": lm_counts[name]}, shape=main["shape"],
                    max_abs_err=max([r["max_abs_err"] for r in rows] + [path_max]),
                    ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main["bound_by"], library_ms=main["library_ms"],
                    per_shape=rows)

    return [entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                  "src/repro/kernels/attention/kernel.py:82", k5_rows, abs5),
            entry("ssd_chunk", "src/repro_torch/csrc/ssd_chunk.cu",
                  "src/repro/kernels/ssd/kernel.py:66", k6_rows, abs6)], lm_counts


# ---------------------------------------------------------------------- #
# The attention families (slice 7): [lm-dense], [lm-moe], [lm-families-small]
# ---------------------------------------------------------------------- #
# gemma2-9b at full width and depth in bf16: 10.16 B parameters, 40.6 GB as
# f32 masters and 20.3 GB as the bf16 copies, a 3.2 GB KV cache.  The
# prompt is past the 4096 window, so the even layers' window bites in
# prefill and in every decode step.
DENSE_ARCH, DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = "gemma2-9b", 2, 4608, 32
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_GEN = "granite-moe-3b-a800m", 4, 1024, 32
# [lm-families-small]: (arch, prompt tokens or audio frames) at full width,
# 2 layers, bf16, card against CPU; paligemma's 64 text tokens follow its
# 256 patches, hubert's 512 frames go through forward_logits.
FAMILIES_SMALL = [("gemma2-9b", 256), ("granite-moe-3b-a800m", 256), ("paligemma-3b", 64),
                  ("hubert-xlarge", 512)]
FAMILIES_SMALL_LAYERS, FAMILIES_SMALL_STEPS = 2, 4


def lm_family_phases(torch, dev):
    """[lm-dense], [check lm-dense], [lm-moe], [check lm-moe] and
    [lm-families-small].  Returns each path's launch counts and K5's largest
    error on the two full-size paths."""
    print(f"[lm-dense] this process holds {torch.cuda.memory_allocated()} bytes on the card "
          f"before the phase")
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as attn_kern, ref as attn_ref
    from repro_torch.launch import serve
    from repro_torch.models import layers
    from repro_torch.models.transformer import Model

    paths = {}

    # ---- [lm-dense]: gemma2-9b through the serving entry point ---------- #
    cfg = get_config(DENSE_ARCH)
    argv = lm_argv(DENSE_ARCH, DENSE_BATCH, DENSE_PROMPT, DENSE_GEN, dev)
    kinds = []          # (window, softcap) of each K5 launch: no tensors kept

    def rec_kinds(fn):
        def wrapped(*args, **kw):
            kinds.append((kw.get("window") or 0, kw.get("softcap", 0.0)))
            return fn(*args, **kw)
        return wrapped

    res, paths["lm-dense"] = serve_twice(torch, "lm-dense", argv,
                                         [(attn_kern, "flash_attention_cuda", rec_kinds)])
    check_served(torch, "lm-dense", res, paths["lm-dense"], cfg.vocab,
                 dict(flash_attention=cfg.n_layers))
    n_local = sum(w == cfg.window for w, _ in kinds)
    print(f"[lm-dense] K5 launches: {n_local} with window {cfg.window}, "
          f"{sum(w == 0 for w, _ in kinds)} global, softcaps {sorted({c for _, c in kinds})}")
    check(len(kinds) == cfg.n_layers and n_local == cfg.n_layers // 2
          and all(c == cfg.attn_softcap for _, c in kinds),
          f"lm-dense: K5 launches {kinds}")
    del res

    # ---- [check lm-dense]: one more prefill, each K5 launch held against
    # the plain version as it happens (one batch row and kv head at a time:
    # the inputs of 42 launches would not fit beside the weights) --------- #
    orig = attn_kern.flash_attention_cuda
    seen = []

    def checked(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        rep = q.shape[1] // k.shape[1]
        err = scale = 0.0
        for b_ in range(q.shape[0]):
            for g in range(k.shape[1]):
                hs = slice(g * rep, (g + 1) * rep)
                e_, s_ = errs(out[b_:b_ + 1, hs], attn_ref.attention_ref(
                    q[b_:b_ + 1, hs], k[b_:b_ + 1, g:g + 1], v[b_:b_ + 1, g:g + 1], **kw))
                err, scale = max(err, e_), max(scale, s_)
        seen.append((err, scale))
        return out

    _, model, batch, max_len = serve.lm_setup(serve.parser().parse_args(argv))
    attn_kern.flash_attention_cuda = checked
    try:
        model.prefill(batch, max_len)
    finally:
        attn_kern.flash_attention_cuda = orig
    del model, batch
    torch.cuda.empty_cache()
    abs_dense = max(e_ for e_, _ in seen)
    worst = max(e_ / k5_bf16_tol(s_) for e_, s_ in seen)
    print(f"[check lm-dense] K5: {len(seen)} launches of the path against the plain version "
          f"as they ran, max_abs_err {abs_dense:.3e}, worst launch {worst:.2f} bf16 steps "
          f"(bar 1)")
    check(len(seen) == cfg.n_layers, f"check lm-dense: {len(seen)} launches")
    check(worst <= 1, f"check lm-dense: K5 disagrees on the path's inputs: {worst}")

    # ---- [lm-moe]: granite-moe-3b-a800m, every launch kept and replayed - #
    cfg = get_config(MOE_ARCH)
    rec = []
    res, paths["lm-moe"] = serve_twice(
        torch, "lm-moe", lm_argv(MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_GEN, dev),
        [(attn_kern, "flash_attention_cuda", recorder(rec))])
    check_served(torch, "lm-moe", res, paths["lm-moe"], cfg.vocab,
                 dict(flash_attention=cfg.n_layers))
    abs_moe, worst, _ = k5_replay(rec)
    print(f"[check lm-moe] K5: {len(rec)} launches of the path against the plain version, "
          f"max_abs_err {abs_moe:.3e}, worst launch {worst:.2f} bf16 steps (bar 1)")
    check(len(rec) == cfg.n_layers, f"check lm-moe: {len(rec)} launches")
    check(worst <= 1, f"check lm-moe: K5 disagrees on the path's inputs: {worst}")
    del rec, res
    torch.cuda.empty_cache()

    # What the MoE's f32 expert products cost at the path's shape: one
    # layer's moe_block on the prefill's tokens, and one of its three
    # (E, cap, d) x (E, d, ff) products in f32 (TF32 off) and in bf16.
    t = MOE_BATCH * MOE_PROMPT
    cap = min(int(max(4, t * cfg.top_k / cfg.n_experts * cfg.capacity_factor)), t)
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev).manual_seed(70)
    rnd = lambda *shape: torch.randn(shape, device=dev, generator=gen)
    x = rnd(MOE_BATCH, MOE_PROMPT, d).to(torch.bfloat16)
    p = layers.MoEParams(*((rnd(*sh) * sh[-2] ** -0.5).to(torch.bfloat16) for sh in
                           ((d, e), (e, d, ff), (e, d, ff), (e, ff, d))))
    ms_block = time_ms(torch, lambda: layers.moe_block(x, p, cfg.top_k, cfg.capacity_factor), 5)
    buf, wg = rnd(e, cap, d), rnd(e, d, ff)
    ms_f32 = time_ms(torch, lambda: torch.bmm(buf, wg), 10)
    buf16, wg16 = buf.to(torch.bfloat16), wg.to(torch.bfloat16)
    ms_bf16 = time_ms(torch, lambda: torch.bmm(buf16, wg16), 10)
    flops = 2.0 * e * cap * d * ff
    print(f"[lm-moe] moe_block at the path's shape (T {t}, E {e}, top {cfg.top_k}, cap {cap}, "
          f"d {d}, ff {ff}): {ms_block:.4f} ms a layer; one expert product {flops / 1e9:.1f} "
          f"GFLOP: f32 {ms_f32:.4f} ms (bound {flops / F32_FLOP_PER_S * 1e3:.4f} ms at the f32 "
          f"rate), bf16 operands {ms_bf16:.4f} ms (bound "
          f"{flops / BF16_TC_FLOP_PER_S * 1e3:.4f} ms)")
    del x, p, buf, wg, buf16, wg16
    torch.cuda.empty_cache()

    # ---- [lm-families-small]: four families, card against CPU ----------- #
    small_counts = {name: 0 for name in _build.launch_counts}
    for arch, n in FAMILIES_SMALL:
        cfg_s = dataclasses.replace(get_config(arch), n_layers=FAMILIES_SMALL_LAYERS)
        t0 = time.perf_counter()
        cpu_model = Model(cfg_s, device="cpu").init(torch.Generator().manual_seed(0))
        card_model = Model(cfg_s, device=dev)
        card_model.load_state_dict(cpu_model.state_dict())
        rng = np.random.default_rng(0)
        steps = 0 if cfg_s.frontend == "audio_stub" else FAMILIES_SMALL_STEPS
        inp = {}
        if cfg_s.frontend == "audio_stub":
            inp["frames"] = torch.as_tensor(rng.normal(size=(1, n, cfg_s.frontend_dim)),
                                            dtype=torch.float32)
            inp["mask_indices"] = torch.as_tensor(rng.random((1, n)) < 0.3)
        else:
            inp["tokens"] = torch.as_tensor(rng.integers(0, cfg_s.vocab, size=(1, n + steps)))
        if cfg_s.frontend == "vision_stub":
            inp["patches"] = torch.as_tensor(rng.normal(
                size=(1, cfg_s.n_prefix_tokens, cfg_s.frontend_dim)), dtype=torch.float32)
        logits = {}
        for where, model in (("cpu", cpu_model), ("cuda", card_model)):
            _build.reset_launch_counts()      # read after the card's run, the last
            batch = {k_: v_.to(model.device) for k_, v_ in inp.items()}
            if steps == 0:
                logits[where] = [model.forward_logits(batch).cpu()]
            else:
                toks = batch["tokens"]
                out, cache = model.prefill(dict(batch, tokens=toks[:, :n]),
                                           n + steps + cfg_s.n_prefix_tokens)
                outs = [out.cpu()]
                for i in range(n, n + steps):
                    out, cache = model.decode_step(cache, toks[:, i:i + 1])
                    outs.append(out.cpu())
                logits[where] = outs
        ran = dict(_build.launch_counts)
        for k_ in small_counts:
            small_counts[k_] += ran[k_]
        worst = 0.0
        for a_, b_ in zip(logits["cuda"], logits["cpu"]):
            check(bool(torch.isfinite(a_).all()), f"lm-families-small {arch}: non-finite logits")
            worst = max(worst, rel_err(a_, b_))
        what = (f"forward_logits of {n} frames with a mask" if steps == 0 else
                f"prefill of {cfg_s.n_prefix_tokens} patches + {n} tokens" if
                cfg_s.n_prefix_tokens else f"prefill of {n} tokens")
        print(f"[lm-families-small] {arch} ({cfg_s.family}) full width, "
              f"{FAMILIES_SMALL_LAYERS} layers, {cfg_s.compute_dtype}: {what}"
              f"{'' if steps == 0 else f', {steps} teacher-forced decode steps'}: card vs CPU "
              f"logits max_rel_err {worst:.3e} (tol {LM_SMALL_BF16_RTOL:g}); "
              f"{time.perf_counter() - t0:.1f} s; card launches "
              f"{json.dumps({k_: v_ for k_, v_ in ran.items() if v_})}")
        check(worst <= LM_SMALL_BF16_RTOL, f"lm-families-small {arch}: card and CPU disagree")
        want = {k_: 0 for k_ in ran}
        check(ran == dict(want, flash_attention=FAMILIES_SMALL_LAYERS),
              f"lm-families-small {arch}: launches {ran}")
        del cpu_model, card_model, logits
        torch.cuda.empty_cache()
    paths["lm-families-small"] = small_counts
    return paths, max(abs_dense, abs_moe)


# ---------------------------------------------------------------------- #
# LM training (slice 8): [train-small], [train], [check train], [train-moe]
# ---------------------------------------------------------------------- #
# [train]: launch.train --task lm at zamba2-1.2b's full size (1.2 B
# parameters; f32 masters, gradients and AdamW's two moments ~19 GB), bf16
# compute, remat "block": 6 steps of 4 x 1024 tokens, a checkpoint every 3
# steps, an injected failure at step 4 (resumed from step 3).
TRAIN_ARGV = ["--task", "lm", "--arch", LM_ARCH, "--preset", "full", "--batch", "4",
              "--seq", "1024", "--steps", "6", "--log-every", "1"]
TRAIN_CKPT_EVERY, TRAIN_FAIL_AT = 3, 4
# [train-small]: zamba2 at full width, 6 layers, one step card against CPU
# from the same weights and batch (1 x 128 tokens: one SSD chunk).
TRAIN_SMALL_SEQ = 128
# The bars of [train-small], card against CPU, with their reasons.  f32: the
# forward agrees to ~1e-6 (LM_SMALL_RTOL's 1e-3 on logits is its bar), the
# backward runs the same plain functions in other summation orders: loss
# 1e-4 relative, grad norm 1e-3, each gradient leaf 1e-3 of its largest |g|.
# bf16: the bars of tests/test_torch_train.py, which hold the bf16 port
# against the JAX package (3.2e-2 of a leaf seen there): loss 1e-2, grad
# norm 5e-2, each leaf 1e-1.  The updated parameters: the first AdamW step
# moves each by lr·g/(|g| + eps), a sign where |g| >> eps, so the two agree
# to 1e-2 lr wherever |g| stands above the leaf's gradient bar, and by at
# most 2 lr where the two gradients may differ in sign.
TRAIN_SMALL_BARS = {"float32": dict(loss=1e-4, grad_norm=1e-3, leaf=1e-3),
                    "bfloat16": dict(loss=1e-2, grad_norm=5e-2, leaf=1e-1)}
# [train-moe]: granite-moe-3b-a800m at full width, 4 of its 32 layers, bf16.
TRAIN_MOE_LAYERS, TRAIN_MOE_STEPS = 4, 3


def tree_fingerprint(torch, tree) -> list:
    """Two integer sums of each leaf's bits (the bits summed, and weighted
    by position mod 8191): equal trees give equal lists, and a changed bit
    changes both."""
    sums = []
    for leaf in tree:
        v = leaf.detach().contiguous().reshape(-1)
        v = v.view(torch.int16 if v.element_size() == 2 else torch.int32).long()
        w = torch.arange(v.numel(), device=v.device) % 8191 + 1
        sums.append(torch.stack([v.sum(), (v * w).sum()]))
    return torch.stack(sums).cpu().tolist()


def state_leaves(state: dict) -> list:
    """A launcher state tree's tensors in a fixed order."""
    opt = state["opt"]
    return ([state["params"][k] for k in sorted(state["params"])] + [opt["step"]]
            + [opt["m"][k] for k in sorted(opt["m"])] + [opt["v"][k] for k in sorted(opt["v"])])


def train_small(torch, dev, compute_dtype):
    """[train-small]: one make_train_step on the card against the same step
    on the CPU.  Returns the card's launch counts."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import batch_for_config, to_device
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Model
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    tag = "train-small" if compute_dtype == "float32" else "train-small-bf16"
    bars = TRAIN_SMALL_BARS[compute_dtype]
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_SMALL_LAYERS,
                              compute_dtype=compute_dtype)
    cpu_model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card_model = Model(cfg, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    batch = batch_for_config(cfg, 1, TRAIN_SMALL_SEQ, 0)
    lr = optim.AdamWConfig().lr
    out = {}
    t0 = time.perf_counter()
    for where, model in (("cpu", cpu_model), ("cuda", card_model)):
        _build.reset_launch_counts()           # read after the card's run, the last
        step_fn = make_train_step(model)
        _, met = step_fn(optim.adamw_init(dict(model.named_parameters())),
                         to_device(batch, model.device))
        out[where] = dict(met={k: float(v) for k, v in met.items()},
                          grads={k: p.grad.cpu() for k, p in model.named_parameters()},
                          params={k: p.detach().cpu() for k, p in model.named_parameters()})
    counts = dict(_build.launch_counts)
    cpu, card = out["cpu"], out["cuda"]
    rel = lambda k: abs(card["met"][k] - cpu["met"][k]) / abs(cpu["met"][k])
    worst_leaf, worst_name, worst_p, flips = 0.0, "", 0.0, 0
    for k, g in cpu["grads"].items():
        scale = max(g.abs().max().item(), 1e-30)
        e = (card["grads"][k] - g).abs().max().item() / scale
        if e > worst_leaf:
            worst_leaf, worst_name = e, k
        dp = (card["params"][k] - cpu["params"][k]).abs()
        worst_p = max(worst_p, dp.max().item() / lr)
        # entries off by more than 1e-2 lr: each must be one whose gradient
        # lies within the leaf's bar of zero
        off = dp > 1e-2 * lr
        flips += int(off.sum())
        check(bool((g[off].abs() <= bars["leaf"] * scale).all()),
              f"{tag}: {k}'s update differs where its gradient is above the bar")
    print(f"[{tag}] {LM_ARCH} full width, {LM_SMALL_LAYERS} layers, {compute_dtype}, batch 1 x "
          f"{TRAIN_SMALL_SEQ}, one make_train_step, card vs CPU: loss {card['met']['loss']:.6f} "
          f"vs {cpu['met']['loss']:.6f} (rel {rel('loss'):.3e}, bar {bars['loss']:g}), grad norm "
          f"{card['met']['grad_norm']:.6f} vs {cpu['met']['grad_norm']:.6f} (rel "
          f"{rel('grad_norm'):.3e}, bar {bars['grad_norm']:g}), worst gradient leaf {worst_name} "
          f"{worst_leaf:.3e} of its largest |g| (bar {bars['leaf']:g}), updated parameters "
          f"at most {worst_p:.3e} lr apart ({flips} entries beyond 1e-2 lr, each with |g| "
          f"under the leaf's bar); {time.perf_counter() - t0:.1f} s both; card launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}")
    check(rel("loss") <= bars["loss"] and rel("grad_norm") <= bars["grad_norm"]
          and worst_leaf <= bars["leaf"] and worst_p <= 2.0 + 1e-3,
          f"{tag}: the card and the CPU disagree")
    napp = LM_SMALL_LAYERS // cfg.shared_attn_every
    check(counts["flash_attention"] == 2 * napp and counts["ssd_chunk"] == 2 * LM_SMALL_LAYERS,
          f"{tag}: launches {counts}")
    del cpu_model, card_model, out
    torch.cuda.empty_cache()
    return counts


def backward_timer(torch, store: list):
    """Wrappers for K5's and K6's autograd backward (the plain versions'
    gradient) that record CUDA events around each call into ``store``."""
    def make(fn):
        def timed(ctx, *grads):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(ctx, *grads)
            b.record()
            store.append((a, b))
            return out
        return staticmethod(timed)
    return make


def train_phases(torch, dev):
    """[train-small], [train], [check train] and [train-moe].  Returns each
    path's launch counts."""
    print(f"[train] this process holds {torch.cuda.memory_allocated()} bytes on the card "
          f"before the phase")
    import numpy as np

    from repro_torch.ckpt import checkpoint as ckpt_mod
    from repro_torch.configs.registry import get_config
    from repro_torch.data.tokens import batch_for_config, to_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as attn_kern, ops as attn_ops
    from repro_torch.kernels.attention import ref as attn_ref
    from repro_torch.kernels.ssd import kernel as ssd_kern, ops as ssd_ops, ref as ssd_ref
    from repro_torch.launch import serve, train
    from repro_torch.models import layers
    from repro_torch.models.transformer import Model
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step

    paths = {}
    small = {name: 0 for name in _build.launch_counts}
    for dtype in ("float32", "bfloat16"):
        for k_, v_ in train_small(torch, dev, dtype).items():
            small[k_] += v_
    paths["train-small"] = small

    # ---- [train]: the entry point, uninterrupted ------------------------ #
    cfg = get_config(LM_ARCH)
    napp = cfg.n_layers // cfg.shared_attn_every
    per_step = dict(flash_attention=2 * napp, ssd_chunk=2 * cfg.n_layers)   # forward + recompute
    steps = int(TRAIN_ARGV[TRAIN_ARGV.index("--steps") + 1])
    tokens_step = 4 * 1024
    _build.reset_launch_counts()
    res = train.main(TRAIN_ARGV)
    counts = dict(_build.launch_counts)
    paths["train"] = counts
    want = {name: 0 for name in counts}
    want.update({k_: v_ * steps for k_, v_ in per_step.items()})
    print(f"[train] {res['arch']} {res['n_layers']} layers d_model {res['d_model']} "
          f"{res['compute_dtype']}, {res['n_params']} parameters, batch {res['batch']} x seq "
          f"{res['seq']}, {res['steps']} steps: losses {[round(v, 6) for v in res['losses']]}, "
          f"grad norms {[round(v, 4) for v in res['grad_norms']]}; step ms "
          f"{[round(v, 1) for v in res['step_ms']]}; warm step {res['warm_step_ms']:.3f} ms, "
          f"{res['tokens_per_s']:.1f} tokens/s, peak_device_bytes {res['peak_device_bytes']}; "
          f"launches {json.dumps(counts)}; per step K5 {counts['flash_attention'] / steps:g} "
          f"(expected {per_step['flash_attention']}: {napp} shared-block applications, forward "
          f"and recompute), K6 {counts['ssd_chunk'] / steps:g} (expected {per_step['ssd_chunk']})")
    check(all(math.isfinite(v) for v in res["losses"] + res["grad_norms"]),
          "train: a loss or grad norm is not finite")
    check(counts == want, f"train: launches {counts}, expected {want}")
    model, opt = res["model"], res["opt_state"]
    losses_a = res["losses"]
    final_a = {k_: p.detach().to("cpu", copy=True) for k_, p in model.named_parameters()}
    step_fn = make_train_step(model)

    def next_batch(k_):
        return to_device(batch_for_config(model.cfg, 4, 1024, k_), dev)

    # ---- two more warm steps: the plain backward's device time by CUDA
    # events around each call, then one step under torch.profiler --------- #
    spans = []
    saved = (attn_ops._Attention.backward, ssd_ops._SSD.backward)
    attn_ops._Attention.backward = backward_timer(torch, spans)(saved[0])
    ssd_ops._SSD.backward = backward_timer(torch, spans)(saved[1])
    try:
        batch = next_batch(steps)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt, _ = step_fn(opt, batch)
        torch.cuda.synchronize()
        timed_ms = (time.perf_counter() - t0) * 1e3
    finally:
        attn_ops._Attention.backward, ssd_ops._SSD.backward = saved
    plain_bwd = sum(a.elapsed_time(b) for a, b in spans)
    box = {}
    batch = next_batch(steps + 1)
    prof = serve.profile_device(dev, lambda: box.update(out=step_fn(opt, batch)))
    opt = box["out"][0]
    groups = "; ".join(f"{g}: {v['ms']:.3f} ms in {v['kernels']}" for g, v in
                       prof["groups"].items())
    print(f"[train] one warm step with CUDA events around the backward of K5 and K6: "
          f"{timed_ms:.3f} ms, of which the plain backward spans {plain_bwd:.3f} ms in "
          f"{len(spans)} calls")
    print(f"[train] one warm step under torch.profiler: wall {prof['wall_ms']:.3f} ms, device "
          f"busy {prof['busy_ms']:.3f} ms ({prof['busy_share']:.1%} of the profiled wall, "
          f"{prof['busy_ms'] / res['warm_step_ms']:.1%} of the unprofiled warm step); {groups}")
    # ---- [check train]: every K5 / K6 launch of one step against the plain
    # version on its own inputs, as it runs ------------------------------- #
    seen5, seen6 = [], []
    orig5, orig6 = attn_kern.flash_attention_cuda, ssd_kern.ssd_chunk_cuda

    def checked5(q, k, v, **kw):
        out = orig5(q, k, v, **kw)
        with torch.no_grad():
            seen5.append(errs(out, attn_ref.attention_ref(q, k, v, **kw)))
        return out

    def checked6(*args, **kw):
        out = orig6(*args, **kw)
        with torch.no_grad():
            y_ref, _ = ssd_ref.ssd_chunked_ref(*args[:7])
            seen6.append(errs(out[0] if isinstance(out, tuple) else out, y_ref))
        return out

    attn_kern.flash_attention_cuda, ssd_kern.ssd_chunk_cuda = checked5, checked6
    try:
        opt, _ = step_fn(opt, next_batch(steps + 2))
    finally:
        attn_kern.flash_attention_cuda, ssd_kern.ssd_chunk_cuda = orig5, orig6
    worst5 = max(e_ / k5_bf16_tol(s_) for e_, s_ in seen5)
    worst6 = max(e_ / s_ for e_, s_ in seen6)
    print(f"[check train] one step: K5 {len(seen5)} launches against the plain version, "
          f"max_abs_err {max(e_ for e_, _ in seen5):.3e}, worst launch {worst5:.2f} bf16 steps "
          f"(bar 1); K6 {len(seen6)} launches, y max_abs_err {max(e_ for e_, _ in seen6):.3e}, "
          f"relative {worst6:.3e} (tol {K6_RTOL:g})")
    check(len(seen5) == per_step["flash_attention"] and len(seen6) == per_step["ssd_chunk"],
          "check train: the launches of one step are not the path's")
    check(worst5 <= 1 and worst6 <= K6_RTOL, "check train: a launch disagrees with its plain "
          "version")
    del res, model, opt, step_fn, box, batch
    torch.cuda.empty_cache()

    # ---- [train]: the same command with checkpoints and a failure ------- #
    ckpt_dir = tempfile.mkdtemp(prefix="train_ckpt_")
    free = shutil.disk_usage(ckpt_dir).free
    snaps, restored = {}, {}
    orig_save, orig_restore = ckpt_mod.CheckpointManager.save_async, \
        ckpt_mod.CheckpointManager.restore

    def save_async(self, tree, step, extra=None):
        snaps[step] = tree_fingerprint(torch, state_leaves(tree))
        return orig_save(self, tree, step, extra)

    def restore(self, template, step=None):
        tree, got = orig_restore(self, template, step)
        restored[got] = tree_fingerprint(torch, state_leaves(tree))
        return tree, got

    ckpt_mod.CheckpointManager.save_async = save_async
    ckpt_mod.CheckpointManager.restore = restore
    t0 = time.perf_counter()
    try:
        res = train.main(TRAIN_ARGV + ["--ckpt-dir", ckpt_dir, "--ckpt-every",
                                       str(TRAIN_CKPT_EVERY), "--fail-at", str(TRAIN_FAIL_AT)])
    finally:
        ckpt_mod.CheckpointManager.save_async = orig_save
        ckpt_mod.CheckpointManager.restore = orig_restore
    wall = time.perf_counter() - t0
    on_disk = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*") if f.is_file())
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    diff = max((p.detach().cpu() - final_a[k_]).abs().max().item()
               for k_, p in res["model"].named_parameters())
    bitwise = all(torch.equal(p.detach().cpu(), final_a[k_])
                  for k_, p in res["model"].named_parameters())
    loss_diff = max(abs(a_ - b_) for a_, b_ in zip(res["losses"], losses_a))
    resumed = res["resumed_from"]
    print(f"[train] with --ckpt-dir --ckpt-every {TRAIN_CKPT_EVERY} --fail-at {TRAIN_FAIL_AT}: "
          f"restarts {res['restarts']}, resumed from {resumed}, steps run "
          f"{len(res['step_ms'])}, {wall:.1f} s in all ({free / 2 ** 30:.1f} GiB free before, "
          f"{on_disk} bytes of checkpoints); the restored state equals the saved one bit for "
          f"bit: {bool(resumed) and all(restored[s_] == snaps[s_] for s_ in resumed)}; against "
          f"the uninterrupted run: losses {[round(v, 6) for v in res['losses']]}, largest loss "
          f"difference {loss_diff:.3e}, final parameters largest difference {diff:.3e}, "
          f"bitwise {bitwise}")
    check(res["restarts"] == 1 and resumed == [TRAIN_FAIL_AT - TRAIN_FAIL_AT % TRAIN_CKPT_EVERY],
          f"train: restarts {res['restarts']}, resumed from {resumed}")
    check(all(restored[s_] == snaps[s_] for s_ in resumed),
          "train: the restored state differs from the saved one")
    check(all(math.isfinite(v) for v in res["losses"] + res["grad_norms"]),
          "train: a loss or grad norm of the resumed run is not finite")
    del res, final_a
    torch.cuda.empty_cache()

    # ---- [train-moe]: granite-moe at full width, 4 layers --------------- #
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=TRAIN_MOE_LAYERS)

    def moe_run(n_steps):
        model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
        step_fn = make_train_step(model)
        opt = optim.adamw_init(dict(model.named_parameters()))
        mets = []
        for k_ in range(n_steps):
            opt, met = step_fn(opt, to_device(batch_for_config(cfg, MOE_BATCH, MOE_PROMPT, k_),
                                              dev))
            mets.append({n_: float(v_) for n_, v_ in met.items()})
        return model, mets

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    model, mets = moe_run(TRAIN_MOE_STEPS)
    wall = time.perf_counter() - t0
    paths["train-moe"] = dict(_build.launch_counts)
    # one layer's moe_block as training runs it (weights cast inside
    # autograd), twice, with any read back to the host an error
    moe_w = model._layer_weights(model.layers[0], model._cast).moe
    x = (torch.randn((MOE_BATCH, MOE_PROMPT, cfg.d_model), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(71)).to(torch.bfloat16))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = layers.moe_block(x, moe_w, cfg.top_k, cfg.capacity_factor)
        out2, _ = layers.moe_block(x, moe_w, cfg.top_k, cfg.capacity_factor)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same_block = bool(torch.equal(out, out2)) and aux.requires_grad
    del model, moe_w, x, out, out2, aux
    torch.cuda.empty_cache()
    _, mets2 = moe_run(1)
    same_first = mets2[0]["loss"] == mets[0]["loss"]
    want = {name: 0 for name in paths["train-moe"]}
    want["flash_attention"] = 2 * TRAIN_MOE_LAYERS * TRAIN_MOE_STEPS
    print(f"[train-moe] {MOE_ARCH} full width, {TRAIN_MOE_LAYERS} layers, {cfg.compute_dtype}, "
          f"batch {MOE_BATCH} x {MOE_PROMPT}, {TRAIN_MOE_STEPS} steps in {wall:.1f} s: losses "
          f"{[round(m_['loss'], 6) for m_ in mets]}, ce {[round(m_['ce'], 6) for m_ in mets]}, "
          f"aux {[round(m_['aux'], 6) for m_ in mets]} (0.01 aux in the loss), grad norms "
          f"{[round(m_['grad_norm'], 4) for m_ in mets]}; the first step's loss bit-identical "
          f"in a second fresh run: {same_first}; moe_block under set_sync_debug_mode('error'): "
          f"no sync, two calls bit-identical: {same_block}; launches "
          f"{json.dumps(paths['train-moe'])}")
    check(all(math.isfinite(m_["loss"]) and math.isfinite(m_["grad_norm"]) and m_["aux"] > 0
              for m_ in mets), "train-moe: a loss, aux or grad norm is not finite and positive")
    check(same_first and same_block, "train-moe: the MoE step is not deterministic")
    check(paths["train-moe"] == want, f"train-moe: launches {paths['train-moe']}")
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------- #
# The mesh LM (slice 10): [lm-mesh], [lm-mesh-1], [lm-mesh-fsdp],          #
# [collectives], [mesh-stream]                                            #
# ---------------------------------------------------------------------- #
# [lm-mesh]: granite-moe-3b-a800m at full size (32 layers, d 1536, 24/8
# heads, 40 experts, top 8), f32 parameters, bf16 compute, remat "block",
# batch 2 x 1024, seed 0: one loss and its gradient (the train step's
# gradient path without AdamW's state) on a ("data", "model") mesh (1, 2) of
# two gloo processes on the one card, against the same model and batch in
# this process.  Rank r computes 12 query heads and kv heads 4r..4r+3, and
# the real experts of ids 24r..24r+23 of the 48 padded ones (rank 1: 24-39);
# its slices reach it from this process's model by CUDA IPC.  At dp 1 the
# routing and capacity are the single-device ones, so only the bf16 order
# of the combine and of the wo sum differs (and a routing choice that a
# bf16 rounding upstream flips).  Bars: the loss 1e-2 relative and the global
# grad norm 2e-2 of the bf16 run; every K5 launch of each rank replayed
# through the plain version (k5_bf16_tol).  The gradients: a top-k router
# is not a continuous function of rounding (a choice flipped by one ulp
# upstream moves its token's whole contribution, and through capacity
# other tokens'), and bf16's own rounding already moves a leaf by 2-11% of
# its largest on this layout at a reduced width on the CPU, the mesh's run
# by 4-34% (scripts/mesh_bf16_grad_floor.py).  So each rank runs the same
# loss and gradient once more in f32 compute, recording every layer's
# routing (_routing_recorder), and the script counts by layer the tokens
# whose top-8 set differs from this process's f32 run.  The first layer
# with such a token must hold only rounding ties (margin between the 8th
# and 9th probability <= MESH_TIE_MARGIN of the token's largest); the
# gathered f32 gradients of MESH_LEAVES are held to MESH_GRAD32_RTOL of
# each leaf's largest |g| where no choice differs, MESH_GRAD_RTOL past a
# flipped tie.  Then the first MESH_SHALLOW layers alone, in f32: their
# forward is the whole model's, so their routing must equal this
# process's, and their gradients (MESH_SHALLOW_LEAVES and each rank's first
# expert) are held to MESH_GRAD32_RTOL: f32 sums in another order.  The
# bf16 gradients are printed beside, with bf16's own distance from f32.
MESH_LM_BATCH, MESH_LM_SEQ = 2, 1024
MESH_LOSS_RTOL, MESH_NORM_RTOL, MESH_GRAD_RTOL = 1e-2, 2e-2, 2e-2
MESH_LEAVES = ("layers.0.wq", "layers.0.wo", "layers.0.moe.router", "layers.31.wq",
               "layers.31.wo", "layers.31.moe.router")
MESH_SHALLOW, MESH_GRAD32_RTOL, MESH_TIE_MARGIN = 4, 1e-4, 1e-5
MESH_SHALLOW_LEAVES = ("layers.0.wq", "layers.0.wo", "layers.0.moe.router", "layers.3.wq",
                       "layers.3.wo", "layers.3.moe.router", "embed")
# [lm-mesh-1]: the same model at 2 layers on a (1, 1) mesh of this process
# over NCCL: every collective has one rank, and the loss and every gradient
# equal the local run's bit for bit.
MESH_ONE_LAYERS = 2
# [lm-mesh-fsdp]: granite at full width, 4 of 32 layers, ("data", "model")
# (2, 2), four gloo processes, fsdp=True, 3 AdamW steps of 4 x 512: every
# rank the same losses; the step-0 loss within the reference's own pin (2e-2,
# tests/test_dist.py) of this process's, since at dp 2 each data shard
# routes its own tokens (another function); every rank's K5 launches
# replayed through the plain version (k5_bf16_tol).
FSDP_LAYERS, FSDP_STEPS, FSDP_BATCH, FSDP_SEQ, FSDP_LOSS_RTOL = 4, 3, 4, 512, 2e-2
# [collectives], in the same four processes: the compressed all-reduce of 4 x
# 2^20 f32 over a ("data",) mesh against the plain sum (the reference's bar,
# max error / max |sum| < 0.05), and pipeline_forward over a ("stage",) mesh,
# 6 microbatches of 32 x 1024 through tanh(a W_s + b_s), against the stages
# in sequence (the reference's rtol 1e-5, atol 1e-6).
COMP_N, COMP_RTOL = 2 ** 20, 0.05
PIPE_MICRO, PIPE_MB, PIPE_WIDTH = 6, 32, 1024
# [mesh-stream]: [stream-resume]'s 2^17 points (crude preset, 16 leaves a
# batch) streamed on a ("data",) mesh of the two [lm-mesh] processes, each
# rank its own nodes' batches, against compress_sharded on the same data:
# skeleton ids equal on K2_PIV_MATCH of the nodes (the batches, and so K2's
# plans, differ: a rounding tie may flip a pivot), D within K1_ATOL, the
# observed ranks equal on the same share; each rank's level-loop device
# peak; and every K1/K2 launch of the rank's build replayed through the
# plain versions, as [mesh] does.


def _gap(got, want) -> float:
    """max |got - want| over max |want|."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _checked_k5(rec):
    """Keep every K5 launch's (args, kw, out) in ``rec`` while it runs."""
    from repro_torch.kernels.attention import kernel as attn_kern

    orig = attn_kern.flash_attention_cuda
    attn_kern.flash_attention_cuda = recorder(rec)(orig)
    return lambda: setattr(attn_kern, "flash_attention_cuda", orig)


def _routing_recorder(rec: list, n: int):
    """Keep the routing of the first ``n`` MoE chunks (the forward's layers,
    in order): each token's first top_k + 1 experts and probabilities of the
    f32 router softmax, sorted as ``_moe_local_chunk`` sorts them.  Returns
    the restore."""
    import torch

    from repro_torch.models import layers

    orig = layers._moe_local_chunk

    def wrapped(xf, router, *rest):
        if len(rec) < n:
            k1 = rest[3] + 1                        # top_k + 1
            with torch.no_grad():
                probs = torch.softmax((xf @ router).float(), dim=-1)
                vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
            rec.append((idx[:, :k1].cpu(), vals[:, :k1].cpu()))
        return orig(xf, router, *rest)

    layers._moe_local_chunk = wrapped
    return lambda: setattr(layers, "_moe_local_chunk", orig)


def _routing_diff(mine: list, ref: list, top_k: int) -> tuple[list, list]:
    """Per layer, the tokens whose set of top_k experts differs between two
    runs' routing records, and over those tokens the largest margin in
    ``ref`` between the k-th and the (k+1)-th probability, of the token's
    largest (0 where none differs).  A choice that rounding flips sits at a
    margin near 0; past the first layer that flips one, a token's inputs
    differ by more than rounding (its own flip, or another token's through
    capacity and attention)."""
    per_layer, margins = [], []
    for (ia, _), (ib, vb) in zip(mine, ref):
        diff = (ia[:, :top_k].sort(-1).values != ib[:, :top_k].sort(-1).values).any(-1)
        per_layer.append(int(diff.sum()))
        margins.append(((vb[diff, top_k - 1] - vb[diff, top_k]) / vb[diff, 0]).max().item()
                       if bool(diff.any()) else 0.0)
    return per_layer, margins


def lm_mesh_rank(mesh, cfg, state, batch, want_grads, stream_case, serve_case):
    """One rank of [lm-mesh] (then of [mesh-stream]): the model's slices
    from ``state`` (this process's whole tensors, by CUDA IPC), one loss and
    gradient with the counts zeroed before and read after, its K5 launches
    replayed, the global grad norm, the ``want_grads`` leaves gathered
    (rank 0) and the rank's first expert's gradient.  Numbers and CPU
    tensors only."""
    import torch

    from repro_torch.dist import api as dist_api, sharding
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Model
    from repro_torch.train import optim

    torch.backends.cuda.matmul.allow_tf32 = False
    model = sharding.shard_model(Model(cfg, device="meta"), mesh, full=state).trainable()
    params = dict(model.named_parameters())
    out = dict(rank=mesh.rank, describe=mesh.describe(),
               params_local=sum(p.numel() for p in params.values()),
               experts=sharding.expert_range(cfg.n_experts, dist_api.axis_size("model", mesh),
                                             dist_api.axis_index("model", mesh)))
    rec = []
    restore = _checked_k5(rec)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mesh.reset_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with dist_api.use_mesh(mesh):
            loss, met = model.loss_fn(sharding.shard_batch(batch, mesh))
            got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
            grads = sharding.sync_grads({k: torch.zeros_like(p) if g is None else g
                                         for (k, p), g in zip(params.items(), got)}, model, mesh)
            norm = optim.global_norm(grads, {k: sharding.counted(model.placement[k], mesh)
                                             for k in grads}, mesh)
        torch.cuda.synchronize()
        out["ms"] = (time.perf_counter() - t0) * 1e3
        out["launches"] = dict(_build.launch_counts)
        out["traffic"] = dict(mesh.stats)
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    finally:
        restore()
    del got
    out.update(loss=loss.item(), ce=met["ce"].item(), aux=met["aux"].item(),
               grad_norm=norm.item())
    out["k5_err"], out["k5_steps"], _ = k5_replay(rec)
    out["k5_replayed"] = len(rec)
    del rec
    for tag in ("", "32"):
        if tag:         # the same loss and gradient once more in f32 compute
            model.cfg = dataclasses.replace(cfg, compute_dtype="float32")
            out["routing32"] = []
            restore = _routing_recorder(out["routing32"], cfg.n_layers)
            try:
                with dist_api.use_mesh(mesh):
                    loss, met = model.loss_fn(sharding.shard_batch(batch, mesh))
                    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
                    grads = sharding.sync_grads(
                        {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(params.items(), got)}, model, mesh)
            finally:
                restore()
            out["loss32"] = loss.item()
            del got
        with dist_api.use_mesh(mesh):
            for k, p in params.items():
                p.grad = grads[k] if k in want_grads else None
            gathered = {k: sharding.gather_param(model, k, mesh, grads=True).cpu()
                        for k in want_grads}
        out["grads" + tag] = gathered if mesh.rank == 0 else None
        out["expert_grad" + tag] = grads["layers.0.moe.w_gate"][0].cpu()
        for p in params.values():
            p.grad = None
        del grads, gathered
        torch.cuda.empty_cache()
    # the first MESH_SHALLOW layers alone, in f32: their forward is the whole
    # model's, so their routing is the one-process run's (checked)
    del params
    every = model.layers
    model.layers = every[:MESH_SHALLOW]
    model.cfg = dataclasses.replace(cfg, n_layers=MESH_SHALLOW, compute_dtype="float32")
    sparams = dict(model.named_parameters())
    out["routing_shallow"] = []
    restore = _routing_recorder(out["routing_shallow"], MESH_SHALLOW)
    try:
        with dist_api.use_mesh(mesh):
            loss, met = model.loss_fn(sharding.shard_batch(batch, mesh))
            got = torch.autograd.grad(loss, list(sparams.values()), allow_unused=True)
            grads = sharding.sync_grads({k: torch.zeros_like(p) if g is None else g
                                         for (k, p), g in zip(sparams.items(), got)}, model, mesh)
            for k, p in sparams.items():
                p.grad = grads[k] if k in MESH_SHALLOW_LEAVES else None
            gathered = {k: sharding.gather_param(model, k, mesh, grads=True).cpu()
                        for k in MESH_SHALLOW_LEAVES}
    finally:
        restore()
    out["loss_shallow"] = loss.item()
    out["grads_shallow"] = gathered if mesh.rank == 0 else None
    out["expert_grad_shallow"] = grads["layers.0.moe.w_gate"][0].cpu()
    # the losses' graphs hold the parameters (their AccumulateGrad nodes)
    del got, grads, gathered, sparams, every, model, loss, met, norm
    torch.cuda.empty_cache()
    out["stream"] = mesh_stream_rank(mesh, *stream_case)
    out["serve"] = mesh_serve_rank(mesh, cfg, state, serve_case)
    return out


def mesh_stream_rank(lm_mesh, xr, tree, pad_from):
    """[mesh-stream] on one rank: compress_sharded, then compress_streamed
    on the same ("data",) mesh with the counts zeroed before and read after
    and every K1/K2 launch's inputs (and K2's pivots and R) kept on the
    host; the same build again unrecorded for its time, device peak and
    traffic; the builds compared on the rank's arrays, and every kept launch
    run again through the kernel and the plain version."""
    import torch

    from repro_torch.core import compression
    from repro_torch.core.compression import CompressionParams, StreamParams
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.dist import api as dist_api
    from repro_torch.kernels import _build
    from repro_torch.kernels.gaussian import kernel as gkern, ref as gref

    mesh = dist_api.make_mesh(lm_mesh.device)
    spec, crude = KernelSpec(h=H), CompressionParams.crude()
    sharded = compression.compress_sharded(xr, tree, spec, crude, mesh, device=mesh.device)

    def build():
        return compression.compress_streamed(xr, tree, spec, crude,
                                             StreamParams(batch_leaves=STREAM_BATCH),
                                             mesh=mesh, device=mesh.device)

    with recording(to_host=True) as rec:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        hss_rec, _ = build()
        launches = dict(_build.launch_counts)
    torch.cuda.synchronize()
    mesh.reset_stats()
    t0 = time.perf_counter()
    hss, st = build()
    torch.cuda.synchronize()
    out = dict(s=time.perf_counter() - t0, launches=launches,
               batches=st.n_batches, device_peak=st.device_peak_bytes,
               peak_stream_bytes=st.peak_stream_bytes, traffic=dict(mesh.stats), cut=hss.cut,
               sharded_cut=sharded.cut, node_range=hss.node_range(0),
               same_recorded=all(torch.equal(a, b) for a, b in
                                 zip((hss.skel_leaf, *hss.skels, hss.d_leaf),
                                     (hss_rec.skel_leaf, *hss_rec.skels, hss_rec.d_leaf))))
    del hss_rec
    dev = mesh.device
    out["k1_err"] = max(block_err(torch, moved(args, dev), gkern.gaussian_block_cuda,
                                  gref.gaussian_block_ref, spec, pad_from)[0]
                        for args, _ in rec["gaussian_block_cuda"])
    res = [k2_against_plain(moved(args, dev), moved(o, dev), crude.rtol, spec, pad_from)
           for args, o in rec["fused_assemble_id_cuda"]]
    out.update(k1_replayed=len(rec["gaussian_block_cuda"]),
               k2_replayed=len(res), k2_nodes=sum(r_["nodes"] for r_ in res),
               k2_mismatches=sum(r_["mismatches"] for r_ in res),
               k2_untied=sum(r_["untied"] for r_ in res),
               k2_off_greedy=sum(r_["off_greedy"] for r_ in res),
               k2_r_err=max(r_["r_err"] for r_ in res))
    del rec, res
    torch.cuda.empty_cache()
    same = nodes = 0
    for a, b in zip((hss.skel_leaf, *hss.skels), (sharded.skel_leaf, *sharded.skels)):
        same += int((a == b).all(1).sum())
        nodes += a.shape[0]
    ranks_same = sum(int((a == b).sum()) for a, b in
                     zip((hss.leaf_ranks, *hss.level_ranks),
                         (sharded.leaf_ranks, *sharded.level_ranks)))
    out.update(skel_same=same, skel_nodes=nodes, ranks_same=ranks_same,
               d_err=(hss.d_leaf - sharded.d_leaf).abs().max().item())
    return out


def lm_fsdp_rank(mesh, cfg, state, batches, comp_g, pipe, hybrid):
    """One rank of [lm-mesh-fsdp], [collectives] and [lm-mesh-serve-hybrid]."""
    import torch

    from repro_torch.dist import api as dist_api, sharding
    from repro_torch.dist.pipeline import pipeline_forward
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Model
    from repro_torch.train import grad_compress, optim
    from repro_torch.train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    model = sharding.shard_model(Model(cfg, device="meta"), mesh, fsdp=True, full=state)
    del state
    step = make_train_step(model)
    opt = optim.adamw_init(dict(model.named_parameters()))
    out = dict(rank=mesh.rank, describe=mesh.describe(),
               params_local=sum(p.numel() for p in model.parameters()), losses=[],
               grad_norms=[], step_ms=[])
    rec = []
    restore = _checked_k5(rec)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mesh.reset_stats()
        _build.reset_launch_counts()
        with dist_api.use_mesh(mesh):
            for b in batches:
                t0 = time.perf_counter()
                opt, met = step(opt, sharding.shard_batch(b, mesh))
                out["losses"].append(met["loss"].item())
                out["grad_norms"].append(met["grad_norm"].item())
                out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out.update(launches=dict(_build.launch_counts), traffic=dict(mesh.stats),
                   peak_bytes=torch.cuda.max_memory_allocated() - base)
    finally:
        restore()
    del model, step, opt
    out["k5_err"], out["k5_steps"], _ = k5_replay(rec)
    out["k5_replayed"] = len(rec)
    del rec
    torch.cuda.empty_cache()

    flat = dist_api.make_mesh(mesh.device)
    g = comp_g[flat.rank]
    flat.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summed = grad_compress.make_compressed_allreduce(flat, "data")(g)
    torch.cuda.synchronize()
    comp_ms = (time.perf_counter() - t0) * 1e3
    plain = dist_api.psum(g, "data", flat)
    out["compressed"] = dict(ms=comp_ms, traffic=dict(flat.stats),
                             rel=((summed - plain).abs().max() / plain.abs().max()).item())
    stages = dist_api.make_mesh(mesh.device, (mesh.size,), ("stage",))
    s = dist_api.axis_index("stage", stages)
    w, bias, x = pipe
    stages.reset_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = pipeline_forward(lambda p, a: torch.tanh(a @ p[0] + p[1]), (w[s], bias[s]), x, stages)
    torch.cuda.synchronize()
    seq = x
    for j in range(stages.size):
        seq = torch.tanh(seq @ w[j] + bias[j])
    out["pipeline"] = dict(ms=(time.perf_counter() - t0) * 1e3, traffic=dict(stages.stats),
                           close=bool(torch.allclose(y, seq, rtol=1e-5, atol=1e-6)),
                           err=(y - seq).abs().max().item())
    del y, seq, summed, plain
    torch.cuda.empty_cache()
    out["hybrid"] = hybrid_serve_rank(mesh, hybrid)
    return out


# ---------------------------------------------------------------------- #
# Serving a model sharded over a mesh (slice 11)                           #
# ---------------------------------------------------------------------- #
# [lm-mesh-serve]: granite-moe-3b-a800m at full size, bf16, [lm-moe]'s call
# (batch 4 x prompt 1024, then 16 greedy tokens) on the two [lm-mesh]
# processes, a ("data", "model") (1, 2) mesh: each rank 12 of 24 query heads,
# 4 of 8 kv heads in its cache, its run of the 48 padded experts; against
# this process serving the same prompt.  bf16: the prefill's last logits
# within MESH_SERVE_BF16_RTOL of the largest (the CPU tests' bf16 bar)
# whatever the routing (bf16 rounding flips choices whose top-k margin is
# below its 2^-8 step, and one flipped prompt token's expert mix reaches
# the last position only through attention); each decode step whose input
# tokens are equal held at the same bar unless its own token's routing
# differs (a flipped choice changes that token's expert mix outright).
# f32 compute, teacher-forced with one process's tokens, at full depth (all
# 32 layers' sharded decode and cache writes): SERVE_F32_RTOL of the largest
# |logit| on every step before the first routing difference, which must be
# a rounding tie (MESH_TIE_MARGIN), and SERVE_F32_TIE_RTOL on every step
# from it on (the readings of PR 24's runs: at most 1.11e-5 on every step,
# past a tie at margin 2.53e-7); and the first MESH_SHALLOW layers alone,
# whose routing must equal one process's, on every step.  Every K5 launch of
# the bf16 path replayed (k5_bf16_tol).  The rank's parameter and cache
# bytes equal what launch.specs.rank_bytes predicts for the decode shape
# (B 4, cache 1040) at (1, 2).
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 16
MESH_SERVE_BF16_RTOL, SERVE_F32_RTOL, SERVE_F32_TIE_RTOL = LM_SMALL_BF16_RTOL, 1e-4, 1e-3
SERVE_F32_GEN = 4         # decode steps of the f32 and the 4-layer passes
# [lm-mesh-serve-hybrid]: zamba2-1.2b at full size, bf16, on the four
# [lm-mesh-fsdp] processes ((2, 2): 2 sequences a data shard, 16 of 32
# attention heads and 32 of 64 SSM state heads a model rank), teacher-forced
# with one process's 16 greedy tokens: logits within MESH_SERVE_BF16_RTOL; K6
# 38 and K5 6 a rank, every launch replayed.  Then f32 compute on the same
# ranks, teacher-forced for SERVE_F32_GEN steps: zamba2 routes nothing, so
# every step within SERVE_F32_RTOL (the split SSM state update and the
# gather of y, the head-parallel shared attention), every launch replayed.
# [lm-mesh-serve-families]: (arch, batch, prompt tokens, decode steps) at
# full width, 2 layers, bf16, on the two [lm-mesh] processes, teacher-forced
# against one process: gemma2's prompt past its 4096 window (the even
# layer's window and the softcap in the head-parallel decode), paligemma's
# one kv head (the plan replicates its cache; each rank reads its slice).
SERVE_FAMILIES = [("gemma2-9b", 2, 4352, 4), ("paligemma-3b", 2, 64, 4)]


def serve_path(mesh, model, batch, max_len, gen, teacher=None, routing=None):
    """One serving path of ``model`` on this rank of ``mesh`` (None: one
    process), the launch counts zeroed just before and read just after:
    prefill of the global ``batch``, then ``gen`` decode steps, greedy from
    the rank's own logits or teacher-forced with ``teacher`` (B, gen) (the
    rank feeds its rows).  ``routing``: a list that receives every MoE
    chunk's routing (_routing_recorder).  Returns the logits of prefill and
    each step and the greedy tokens (CPU), prefill and decode ms, launches
    (prefill, decode), traffic, peak above the start, the cache's bytes and
    shapes, and every K5 / K6 launch replayed against the plain version."""
    import torch

    from repro_torch.dist import api as dist_api, sharding
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as attn_kern
    from repro_torch.kernels.ssd import kernel as ssd_kern

    rec5, rec6 = [], []
    launchers = [(attn_kern, "flash_attention_cuda", rec5), (ssd_kern, "ssd_chunk_cuda", rec6)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in launchers]
    for mod, name, rec in launchers:
        setattr(mod, name, recorder(rec)(getattr(mod, name)))
    restore = (_routing_recorder(routing, 1 << 30) if routing is not None
               else (lambda: None))
    mine = None
    if teacher is not None:
        mine = teacher if mesh is None else sharding.shard_batch({"t": teacher}, mesh)["t"]
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if mesh is not None:
            mesh.reset_stats()
        _build.reset_launch_counts()
        with dist_api.use_mesh(mesh):
            t0 = time.perf_counter()
            logits, cache = model.prefill(batch, max_len)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pre = dict(_build.launch_counts)
            _build.reset_launch_counts()
            outs, toks = [logits.float().cpu()], [logits.argmax(-1).cpu()]
            for i in range(gen):
                step = toks[-1][:, None].to(logits.device) if mine is None else mine[:, i:i + 1]
                logits, cache = model.decode_step(cache, step)
                outs.append(logits.float().cpu())
                toks.append(logits.argmax(-1).cpu())
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        out = dict(prefill_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3 / max(gen, 1),
                   launches=(pre, dict(_build.launch_counts)),
                   traffic=None if mesh is None else dict(mesh.stats),
                   peak_bytes=torch.cuda.max_memory_allocated() - base)
    finally:
        restore()
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    leaves = {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}
    out.update(logits=torch.stack(outs), tokens=torch.stack(toks, 1),
               cache_bytes=sum(v.numel() * v.element_size() for v in leaves.values()),
               cache_shapes={k: tuple(v.shape) for k, v in leaves.items()},
               pos=cache["pos"])
    del cache, leaves
    out["k5_err"], out["k5_steps"], out["k5_rel"] = k5_replay(rec5)
    out["k6_err"], out["k6_rel"] = k6_replay(rec6)
    out["replayed"] = (len(rec5), len(rec6))
    del rec5, rec6
    torch.cuda.empty_cache()
    return out


def _serve_inputs(torch, cfg, batch, prompt, gen, dev):
    """The prompt's batch (``tokens``; vlm ``patches`` and text), max_len."""
    from repro_torch.data.tokens import batch_for_config, to_device

    seq = prompt + cfg.n_prefix_tokens
    b = to_device(batch_for_config(cfg, batch, seq, 7), dev)
    b.pop("labels", None)
    if "patches" in b:
        b["patches"] = b["patches"].to(torch.bfloat16)
    return b, seq + gen


def mesh_serve_rank(mesh, cfg, state, case):
    """[lm-mesh-serve] and [lm-mesh-serve-families] on one of the [lm-mesh]
    ranks: the model's slices from ``state`` (by CUDA IPC); the bf16 path
    greedy, then f32 compute and the first MESH_SHALLOW layers teacher-forced
    with one process's tokens; then each family's 2-layer model, drawn here
    from the seed this process drew it from, and sliced."""
    import dataclasses as dc

    import torch

    from repro_torch.dist import sharding
    from repro_torch.models.transformer import Model

    torch.cuda.empty_cache()
    model = sharding.shard_model(Model(cfg, device="meta"), mesh, full=state)
    out = dict(params_bytes=sum(p.numel() * p.element_size() for p in model.parameters()))
    routing = []
    out["bf16"] = serve_path(mesh, model, case["batch"], case["max_len"], SERVE_GEN,
                             routing=routing)
    out["bf16"]["routing"] = routing
    model.cfg = dc.replace(cfg, compute_dtype="float32")
    model.weights_changed()
    routing = []
    out["f32"] = serve_path(mesh, model, case["batch"], case["max_len"], SERVE_F32_GEN,
                            teacher=case["teacher"], routing=routing)
    out["f32"]["routing"] = routing
    model.layers = model.layers[:MESH_SHALLOW]
    model.cfg = dc.replace(cfg, n_layers=MESH_SHALLOW, compute_dtype="float32")
    model.weights_changed()
    routing = []
    out["shallow"] = serve_path(mesh, model, case["batch"], case["max_len"], SERVE_F32_GEN,
                                teacher=case["teacher"], routing=routing)
    out["shallow"]["routing"] = routing
    del model
    torch.cuda.empty_cache()
    for name, fcfg, fbatch, fmax, fteacher in case["families"]:
        gen = torch.Generator(device=mesh.device).manual_seed(0)
        fm = sharding.shard_model(Model(fcfg, device=mesh.device).init(gen), mesh)
        out[name] = serve_path(mesh, fm, fbatch, fmax, fteacher.shape[1], teacher=fteacher)
        del fm
        torch.cuda.empty_cache()
    return out


def hybrid_serve_rank(mesh, case):
    """[lm-mesh-serve-hybrid] on one of the four [lm-mesh-fsdp] ranks: bf16,
    then f32 compute, both teacher-forced with one process's tokens."""
    import dataclasses as dc

    import torch

    from repro_torch.dist import sharding
    from repro_torch.models.transformer import Model

    model = sharding.shard_model(Model(case["cfg"], device="meta"), mesh, full=case["state"])
    out = serve_path(mesh, model, case["batch"], case["max_len"], SERVE_GEN,
                     teacher=case["teacher"])
    out["params_bytes"] = sum(p.numel() * p.element_size() for p in model.parameters())
    model.cfg = dc.replace(case["cfg"], compute_dtype="float32")
    model.weights_changed()
    out["f32"] = serve_path(mesh, model, case["batch"], case["max_len"], SERVE_F32_GEN,
                            teacher=case["teacher"])
    del model
    torch.cuda.empty_cache()
    return out


def _first_step(routing: list, ref: list, n_layers: int, top_k: int):
    """(the first serving step whose routing differs from ``ref``'s: 0 for
    prefill, i for decode step i, or None; that chunk's largest margin in
    ``ref``, of the token's largest probability; the tokens that differ)."""
    flips, margins = _routing_diff(routing, ref, top_k)
    first = next((i for i, n in enumerate(flips) if n), None)
    if first is None:
        return None, 0.0, 0
    return first // n_layers, margins[first], sum(flips)


def _step_flips(routing: list, ref: list, n_layers: int, top_k: int) -> list:
    """Per serving step (0 prefill, i decode step i), the token choices
    whose routing differs from ``ref``'s, summed over the layers."""
    flips, _ = _routing_diff(routing, ref, top_k)
    return [sum(flips[i:i + n_layers]) for i in range(0, len(flips), n_layers)]


def serve_gap(got, want, rows=slice(None)):
    """Per step, max |got - want| over the largest |want| (want's ``rows``)."""
    want = want[:, rows]
    return [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]


def _line(tag, o, extra=""):
    pre, dec = o["launches"]
    print(f"[{tag}] prefill {o['prefill_ms']:.1f} ms, decode {o['decode_ms']:.2f} ms a step, "
          f"peak {o['peak_bytes']} bytes above the start, cache {o['cache_bytes']} bytes "
          f"{json.dumps(o['cache_shapes'])}; launches prefill "
          f"{json.dumps({k: v for k, v in pre.items() if v})} decode "
          f"{json.dumps({k: v for k, v in dec.items() if v})}; collectives "
          f"{json.dumps(o['traffic'])}; replayed K5 {o['replayed'][0]} (max_abs_err "
          f"{o['k5_err']:.3e}, worst {o['k5_steps']:.2f} bf16 steps or {o['k5_rel']:.3e} of "
          f"its scale), K6 "
          f"{o['replayed'][1]} (max_abs_err {o['k6_err']:.3e}, relative {o['k6_rel']:.3e}, "
          f"tol {K6_RTOL:g}){extra}")


def _path_checks(tag, o, want_pre, f32=False):
    """The launches of the path (``want_pre`` in prefill, none in decode),
    each replayed and within its bar: K5 one bf16 step, or K5_F32_RTOL of
    its scale for an ``f32`` path; K6 K6_RTOL."""
    pre, dec = o["launches"]
    check(pre == dict(dict.fromkeys(pre, 0), **want_pre) and not any(dec.values()),
          f"{tag}: launches {o['launches']}, expected prefill {want_pre} and none in decode")
    k5_ok = o["k5_rel"] <= K5_F32_RTOL if f32 else o["k5_steps"] <= 1
    check(o["replayed"] == (want_pre.get("flash_attention", 0), want_pre.get("ssd_chunk", 0))
          and k5_ok and o["k6_rel"] <= K6_RTOL,
          f"{tag}: the kernels' launches against their plain versions")


def serve_references(torch, dev, model, cfg):
    """One process serving [lm-mesh-serve]'s prompt with ``model`` (granite
    at full size, this process's): bf16 greedy, then f32 compute and the
    first MESH_SHALLOW layers teacher-forced with its tokens; and each of
    SERVE_FAMILIES' 2-layer models greedy.  Returns the references and the
    ranks' case (inputs on the card, the families' whole tensors)."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model

    batch, max_len = _serve_inputs(torch, cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, dev)
    ref = {}
    routing = []
    ref["bf16"] = serve_path(None, model, batch, max_len, SERVE_GEN, routing=routing)
    ref["bf16"]["routing"] = routing
    teacher = ref["bf16"]["tokens"][:, :SERVE_GEN].to(dev)
    every = model.layers
    for tag, n in (("f32", cfg.n_layers), ("shallow", MESH_SHALLOW)):
        model.layers = every[:n]
        model.cfg = dc.replace(cfg, n_layers=n, compute_dtype="float32")
        model.weights_changed()
        routing = []
        ref[tag] = serve_path(None, model, batch, max_len, SERVE_F32_GEN, teacher=teacher,
                              routing=routing)
        ref[tag]["routing"] = routing
    model.layers, model.cfg = every, cfg
    model.weights_changed()
    families = []
    for arch, b, prompt, steps in SERVE_FAMILIES:
        fcfg = dc.replace(get_config(arch), n_layers=2)
        fm = Model(fcfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
        fbatch, fmax = _serve_inputs(torch, fcfg, b, prompt, steps, dev)
        ref[arch] = serve_path(None, fm, fbatch, fmax, steps)
        # the ranks draw the same weights from the same seed (no copy held
        # here while they train)
        families.append((arch, fcfg, fbatch, fmax, ref[arch]["tokens"][:, :steps].to(dev)))
        del fm
    torch.cuda.empty_cache()
    return ref, dict(batch=batch, max_len=max_len, teacher=teacher, families=families)


def serve_checks(runs, ref, cfg, paths):
    """[lm-mesh-serve] and [lm-mesh-serve-families] on the two ranks against
    one process, and the dry run's byte prediction against what they hold.
    Returns the largest K5 error of their launches."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import specs
    from repro_torch.models.transformer import Model

    one = ref["bf16"]
    print(f"[lm-mesh-serve] one process: {MOE_ARCH} {cfg.n_layers} layers, bf16, batch "
          f"{SERVE_BATCH} x prompt {SERVE_PROMPT}, {SERVE_GEN} greedy tokens; sample token ids "
          f"{one['tokens'][0][:12].tolist()}")
    _line("lm-mesh-serve one process", one)
    shape = ShapeSpec("lm-mesh-serve", "decode", SERVE_PROMPT + SERVE_GEN, SERVE_BATCH)
    predicted, _ = specs.rank_bytes(Model(cfg, device="meta"), shape, dict(data=1, model=2),
                                    fsdp=False)
    kv = cfg.n_kv_heads // 2
    want_cache = (2 * cfg.n_layers * SERVE_BATCH * (SERVE_PROMPT + SERVE_GEN) * kv
                  * cfg.head_dim * 2)
    k5_err = 0.0
    for o in runs:
        r, sv = o["rank"], o["serve"]
        b16 = sv["bf16"]
        paths[f"lm-mesh-serve-rank{r}"] = b16["launches"][0]
        gap = serve_gap(b16["logits"], one["logits"])
        first, margin, n_flip = _first_step(b16["routing"], one["routing"], cfg.n_layers,
                                            cfg.top_k)
        same = (b16["tokens"] == one["tokens"]).all(0)
        j_tok = next((j for j, eq in enumerate(same.tolist()) if not eq), None)
        # a token that differs before any routing difference must be a tie of
        # the logits: one process's top two within the runs' gap at that step
        tie = None
        if j_tok is not None and (first is None or j_tok < first):
            top2 = one["logits"][j_tok].topk(2, -1).values
            tie = ((top2[:, 0] - top2[:, 1]).min() / one["logits"][j_tok].abs().max()).item()
        # held: the prefill whatever the routing; a decode step whose inputs
        # are equal (before the first token that differs feeds one) and whose
        # own token's routing is equal to one process's
        per_step = _step_flips(b16["routing"], one["routing"], cfg.n_layers, cfg.top_k)
        held = [0] + [i for i in range(1, SERVE_GEN + 1)
                      if (j_tok is None or i <= j_tok) and not per_step[i]]
        _line(f"lm-mesh-serve rank {r}", b16,
              f"; parameters {sv['params_bytes']} bytes (the dry run predicts "
              f"{predicted[r]['params']}), cache {b16['cache_bytes']} bytes (predicted "
              f"{predicted[r]['cache']}; 4 of 8 kv heads: {want_cache})")
        print(f"[lm-mesh-serve] rank {r} against one process, bf16: logits gap by step "
              f"{[float(f'{g:.3e}') for g in gap]} (bar {MESH_SERVE_BF16_RTOL:g}); greedy "
              f"tokens equal on {int(same.sum())} of {same.numel()} steps, the first that "
              f"differs {j_tok}; routing differences by step {per_step} (the first {first}, "
              f"{n_flip} token choices in all, margin {margin:.3e}); held at "
              f"{MESH_SERVE_BF16_RTOL:g} on steps {held}"
              + ("" if tie is None else f"; top-two logit margin there {tie:.3e}"))
        check(all(gap[i] <= MESH_SERVE_BF16_RTOL for i in held),
              f"lm-mesh-serve: rank {r}'s bf16 logits disagree with one process")
        check(tie is None or tie <= gap[j_tok],
              f"lm-mesh-serve: rank {r}'s tokens differ before any routing or logit tie")
        check(sv["params_bytes"] == predicted[r]["params"]
              and b16["cache_bytes"] == predicted[r]["cache"] == want_cache,
              f"lm-mesh-serve: rank {r}'s bytes differ from the dry run's prediction")
        check(b16["cache_shapes"]["k"] == (cfg.n_layers, SERVE_BATCH, SERVE_PROMPT + SERVE_GEN,
                                           kv, cfg.head_dim), "lm-mesh-serve: cache shape")
        _path_checks(f"lm-mesh-serve rank {r}", b16, dict(flash_attention=cfg.n_layers))
        k5_err = max(k5_err, b16["k5_err"])
        # f32 compute, teacher-forced: tight where the routing is equal
        f32 = sv["f32"]
        gap32 = serve_gap(f32["logits"], ref["f32"]["logits"])
        first32, margin32, n32 = _first_step(f32["routing"], ref["f32"]["routing"],
                                             cfg.n_layers, cfg.top_k)
        # every step: SERVE_F32_RTOL before the first routing difference (a
        # rounding tie, checked), SERVE_F32_TIE_RTOL from it on
        bars = [SERVE_F32_RTOL if first32 is None or i < first32 else SERVE_F32_TIE_RTOL
                for i in range(len(gap32))]
        sh = sv["shallow"]
        gap_sh = serve_gap(sh["logits"], ref["shallow"]["logits"])
        first_sh, _, _ = _first_step(sh["routing"], ref["shallow"]["routing"], MESH_SHALLOW,
                                     cfg.top_k)
        print(f"[lm-mesh-serve] rank {r} f32 compute, teacher-forced, {cfg.n_layers} layers: "
              f"logits gap by step {[float(f'{g:.3e}') for g in gap32]}, bars {bars} "
              f"({SERVE_F32_RTOL:g} before the first step whose routing differs, "
              f"{SERVE_F32_TIE_RTOL:g} from it on); that step {first32} ({n32} token "
              f"choices, margin {margin32:.3e}, bar {MESH_TIE_MARGIN:g}: a rounding tie); "
              f"the first {MESH_SHALLOW} layers alone: routing equal {first_sh is None}, "
              f"logits gap {max(gap_sh):.3e} (bar {SERVE_F32_RTOL:g})")
        check(len(gap32) == SERVE_F32_GEN + 1
              and all(g <= bar for g, bar in zip(gap32, bars)),
              f"lm-mesh-serve: rank {r}'s f32 logits")
        check(first32 is None or margin32 <= MESH_TIE_MARGIN,
              f"lm-mesh-serve: rank {r}'s first f32 routing difference is not a tie")
        check(first_sh is None and max(gap_sh) <= SERVE_F32_RTOL,
              f"lm-mesh-serve: rank {r}'s first {MESH_SHALLOW} layers disagree in f32")
        _path_checks(f"lm-mesh-serve rank {r} f32 compute", f32,
                     dict(flash_attention=cfg.n_layers), f32=True)
        _path_checks(f"lm-mesh-serve rank {r} first {MESH_SHALLOW} layers", sh,
                     dict(flash_attention=MESH_SHALLOW), f32=True)
        k5_err = max(k5_err, f32["k5_err"], sh["k5_err"])
        # the families
        for arch, *_ in SERVE_FAMILIES:
            fo, fr = sv[arch], ref[arch]
            fgap = serve_gap(fo["logits"], fr["logits"])
            paths[f"lm-mesh-serve-{arch}-rank{r}"] = fo["launches"][0]
            _line(f"lm-mesh-serve-families {arch} rank {r}", fo,
                  f"; logits gap by step {[float(f'{g:.3e}') for g in fgap]} (bar "
                  f"{MESH_SERVE_BF16_RTOL:g})")
            check(max(fgap) <= MESH_SERVE_BF16_RTOL,
                  f"lm-mesh-serve-families: {arch} rank {r} disagrees with one process")
            _path_checks(f"lm-mesh-serve-families {arch} rank {r}", fo,
                         dict(flash_attention=2))
            k5_err = max(k5_err, fo["k5_err"])
    for arch, *_ in SERVE_FAMILIES:
        print(f"[lm-mesh-serve-families] {arch} one process: cache "
              f"{json.dumps(ref[arch]['cache_shapes'])}; rank 0's "
              f"{json.dumps(runs[0]['serve'][arch]['cache_shapes'])}")
    return k5_err


def hybrid_reference(torch, dev):
    """zamba2-1.2b at full size served greedy in this process, then in f32
    compute teacher-forced with its tokens (``ref["f32"]``); the ranks' case."""
    import dataclasses as dc

    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model

    cfg = get_config(LM_ARCH)
    model = Model(cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    batch, max_len = _serve_inputs(torch, cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, dev)
    ref = serve_path(None, model, batch, max_len, SERVE_GEN)
    teacher = ref["tokens"][:, :SERVE_GEN].to(dev)
    model.cfg = dc.replace(cfg, compute_dtype="float32")
    model.weights_changed()
    ref["f32"] = serve_path(None, model, batch, max_len, SERVE_F32_GEN, teacher=teacher)
    model.cfg = cfg
    model.weights_changed()
    case = dict(cfg=cfg, state={k: p.detach() for k, p in model.named_parameters()},
                batch=batch, max_len=max_len, teacher=teacher)
    return ref, case


def hybrid_checks(runs, ref, paths):
    """[lm-mesh-serve-hybrid] on the four ranks against one process.
    Returns the largest K5 and K6 errors of their launches."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(LM_ARCH)
    napp = cfg.n_layers // cfg.shared_attn_every
    _line("lm-mesh-serve-hybrid one process", ref)
    _line("lm-mesh-serve-hybrid one process f32 compute", ref["f32"])
    k5 = k6 = 0.0
    for o in runs:
        r, h = o["rank"], o["hybrid"]
        d = r // 2
        rows = slice(d * SERVE_BATCH // 2, (d + 1) * SERVE_BATCH // 2)
        gap = serve_gap(h["logits"], ref["logits"], rows)
        agree = (h["tokens"] == ref["tokens"][rows]).float().mean().item()
        paths[f"lm-mesh-serve-hybrid-rank{r}"] = h["launches"][0]
        _line(f"lm-mesh-serve-hybrid rank {r}", h,
              f"; parameters {h['params_bytes']} bytes; logits gap by step "
              f"{[float(f'{g:.3e}') for g in gap]} (bar {MESH_SERVE_BF16_RTOL:g}); its greedy "
              f"choice equal to one process's token on {agree:.4f} of the steps")
        check(max(gap) <= MESH_SERVE_BF16_RTOL, f"lm-mesh-serve-hybrid: rank {r} disagrees")
        f32 = h["f32"]
        gap32 = serve_gap(f32["logits"], ref["f32"]["logits"], rows)
        _line(f"lm-mesh-serve-hybrid rank {r} f32 compute", f32,
              f"; logits gap by step {[float(f'{g:.3e}') for g in gap32]} (bar "
              f"{SERVE_F32_RTOL:g})")
        check(len(gap32) == SERVE_F32_GEN + 1 and max(gap32) <= SERVE_F32_RTOL,
              f"lm-mesh-serve-hybrid: rank {r}'s f32 logits disagree with one process")
        _path_checks(f"lm-mesh-serve-hybrid rank {r} f32 compute", f32,
                     dict(flash_attention=napp, ssd_chunk=cfg.n_layers), f32=True)
        check(h["cache_shapes"]["ssm_state"] == (cfg.n_layers, SERVE_BATCH // 2,
                                                 cfg.ssm_heads // 2, cfg.ssm_state,
                                                 cfg.ssm_head_dim)
              and h["cache_shapes"]["shared_k"][1:4] == (SERVE_BATCH // 2,
                                                          SERVE_PROMPT + SERVE_GEN,
                                                          cfg.n_kv_heads // 2),
              f"lm-mesh-serve-hybrid: rank {r}'s cache {h['cache_shapes']}")
        _path_checks(f"lm-mesh-serve-hybrid rank {r}", h,
                     dict(flash_attention=napp, ssd_chunk=cfg.n_layers))
        k5, k6 = max(k5, h["k5_err"], f32["k5_err"]), max(k6, h["k6_err"], f32["k6_err"])
    return k5, k6


DRYRUN_CELLS = [("granite-moe-3b-a800m", "prefill_32k", False),
                ("granite-moe-3b-a800m", "decode_32k", False),
                ("llama3-405b", "train_4k", False), ("svm-hss-admm", "admm_grid", True)]


def dryrun_start():
    """Start [dryrun]: ``python -m repro_torch.launch.dryrun`` for each of
    DRYRUN_CELLS, one subprocess a cell, all at once, on the host (no card).
    Returns (the start time, the processes)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for arch, shape, multi in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
               shape] + (["--multi-pod"] if multi else [])
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=env, cwd=ROOT))
    return time.perf_counter(), procs


def dryrun_phase(started):
    """[dryrun]: each record's memory, FLOPs, collectives and seconds."""
    t0, procs = started
    for (arch, shape, _), proc in zip(DRYRUN_CELLS, procs):
        out, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"dryrun: {arch} {shape} exited {proc.returncode}: "
              f"{err[-2000:]}")
        rec = json.loads(out.strip().splitlines()[-1])
        m, c, rf = rec["memory"], rec["collectives"], rec["roofline"]
        extra = ""
        if "model_flops_global" in rec:
            extra = (f"; model_flops_global {rec['model_flops_global']:.4e}, "
                     f"model_vs_counted_flops {rec['model_vs_counted_flops']:.4f}")
        print(f"[dryrun] {arch} {shape} on {rec['mesh']} ({rec['n_devices']} ranks, rank "
              f"{rec['traced_rank']} traced): status {rec['status']}, {rec['compile_s']} s; "
              f"memory argument {m['argument_bytes']} (by group "
              f"{json.dumps(rec['argument_bytes_by_group'])}), output {m['output_bytes']}, "
              f"temp {m['temp_bytes']}, total {m['total_per_device']} bytes; flops "
              f"{rf['flops_per_device']:.4e}, bytes {rf['bytes_per_device']:.4e} a rank (K5/K6: "
              f"{json.dumps(rf['kernels'])}); collectives {c['n_collectives']} calls, operand "
              f"{c['operand_bytes']:.4e} B, ring {c['ring_bytes']:.4e} B "
              f"{json.dumps(c['per_op'])}; roofline compute {rf['t_compute_s']:.4e} s, memory "
              f"{rf['t_memory_s']:.4e} s, collective {rf['t_collective_s']:.4e} s "
              f"({rf['dominant']}){extra}")
        check(rec["status"] == "ok", f"dryrun: {arch} {shape}: {rec.get('error')}")
    print(f"[dryrun] {len(DRYRUN_CELLS)} cells done {time.perf_counter() - t0:.1f} s after "
          f"they started")


def lm_mesh_phases(torch, dev):
    """[lm-mesh], [lm-mesh-1], [mesh-stream], [lm-mesh-fsdp] and
    [collectives].  Returns each path's launch counts by rank, and the
    largest error of [lm-mesh]'s and [lm-mesh-fsdp]'s K5 launches against
    the plain version."""
    import dataclasses as dc

    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.core import tree as tree_mod
    from repro_torch.data import synthetic
    from repro_torch.data.tokens import batch_for_config, to_device
    from repro_torch.dist import api as dist_api, sharding
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Model
    from repro_torch.train import optim

    # the mesh phases share the card between this process and 2 or 4 ranks:
    # free what the earlier phases left to the garbage collector
    held = torch.cuda.memory_allocated()
    gc.set_debug(gc.DEBUG_SAVEALL)      # keep what the collection finds, to name it
    gc.collect()
    found = [o for o in gc.garbage if isinstance(o, types.FrameType)]
    frames = collections.Counter(f"{f.f_code.co_name}@{Path(f.f_code.co_filename).name}"
                                 for f in found)
    del found
    gc.garbage.clear()
    gc.set_debug(0)
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    print(f"[lm-mesh] this process holds {after} bytes on the card "
          f"before the mesh phases ({held} before a garbage collection)")
    if frames:
        print(f"[lm-mesh] frames the collection found in reference cycles: "
              f"{frames.most_common(16)}")
    # nothing of the earlier phases may wait for the collector (reference
    # cycles through CUDA tensors): it frees under 1% of what is held
    check(held - after <= GC_FREED_MAX * held,
          f"a garbage collection freed {held - after} of {held} bytes on the card: "
          "earlier phases left tensors in reference cycles")
    paths = {}
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev)

    # ---- [lm-mesh]: the one-process run, then two ranks ---------------- #
    model = Model(cfg, device=dev).init(gen.manual_seed(0)).trainable()
    batch = to_device(batch_for_config(cfg, MESH_LM_BATCH, MESH_LM_SEQ, 0), dev)
    params = dict(model.named_parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    loss, met = model.loss_fn(batch)
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), got)}
    norm = optim.global_norm(grads).item()
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    one_counts = dict(_build.launch_counts)
    one_peak = torch.cuda.max_memory_allocated()
    ref = dict(loss=loss.item(), aux=met["aux"].item(), norm=norm,
               grads={k: grads[k].cpu() for k in MESH_LEAVES})
    e_pad, _, _ = sharding.expert_range(cfg.n_experts, 2, 0)
    firsts = [0, e_pad // 2]                 # each rank's first expert
    ref["experts"] = [grads["layers.0.moe.w_gate"][e].cpu() for e in firsts]
    del got, grads, loss, met
    # the same model and batch computing in f32: the gradients' reference,
    # and how far bf16's own rounding moves them
    model.cfg = dc.replace(cfg, compute_dtype="float32")
    routing32 = []
    restore = _routing_recorder(routing32, cfg.n_layers)
    try:
        loss32, _ = model.loss_fn(batch)
        got = torch.autograd.grad(loss32, list(params.values()), allow_unused=True)
    finally:
        restore()
    g32 = dict(zip(params, got))
    ref["grads32"] = {k: g32[k].cpu() for k in MESH_LEAVES}
    ref["experts32"] = [g32["layers.0.moe.w_gate"][e].cpu() for e in firsts]
    floor = {k: _gap(ref["grads"][k], ref["grads32"][k]) for k in MESH_LEAVES}
    del got, g32
    # the first MESH_SHALLOW layers alone, in f32
    every = model.layers
    model.layers = every[:MESH_SHALLOW]
    model.cfg = dc.replace(cfg, n_layers=MESH_SHALLOW, compute_dtype="float32")
    sparams = dict(model.named_parameters())
    routing_shallow = []
    restore = _routing_recorder(routing_shallow, MESH_SHALLOW)
    try:
        loss_sh, _ = model.loss_fn(batch)
        got = torch.autograd.grad(loss_sh, list(sparams.values()), allow_unused=True)
    finally:
        restore()
    gs = dict(zip(sparams, got))
    ref["shallow"] = {k: gs[k].cpu() for k in MESH_SHALLOW_LEAVES}
    ref["experts_shallow"] = [gs["layers.0.moe.w_gate"][e].cpu() for e in firsts]
    model.layers = every
    model.cfg = cfg
    del got, gs, sparams, every
    model.requires_grad_(False)
    torch.cuda.empty_cache()
    print(f"[lm-mesh] one process: {MOE_ARCH} {cfg.n_layers} layers, "
          f"{sum(p.numel() for p in params.values())} parameters, batch {MESH_LM_BATCH} x "
          f"{MESH_LM_SEQ}: loss {ref['loss']:.6f}, aux {ref['aux']:.6f}, grad norm {norm:.6f}; "
          f"loss and gradient {one_ms:.1f} ms, peak {one_peak} bytes; launches "
          f"{json.dumps(one_counts)}; in f32 compute: loss {loss32.item():.6f}, the bf16 "
          f"gradients' distance from the f32 ones, of each leaf's largest: "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in floor.items()})}")

    rdata = synthetic.train_test("blobs", RESUME_N, N_TEST, seed=0, n_features=N_FEATURES,
                                 sep=SEP)
    x_pad, _, _, r_levels = tree_mod.pad_dataset(rdata[0], rdata[1].astype(np.float32), LEAF)
    r_pad_from = float(rdata[0][:, 0].max())
    r_tree = tree_mod.build_tree(x_pad, LEAF, r_levels)
    # [lm-mesh-serve] and [lm-mesh-serve-families]: one process first
    serve_ref, serve_case = serve_references(torch, dev, model, cfg)
    state = {k: p.detach() for k, p in params.items()}
    t0 = time.perf_counter()
    runs = dist_api.spawn(lm_mesh_rank, 2, cfg, state, batch, MESH_LEAVES,
                          (x_pad[r_tree.perm], r_tree, r_pad_from), serve_case, backend="gloo",
                          device=dev.type, mesh_shape=(1, 2), mesh_names=("data", "model"))
    t_spawn = time.perf_counter() - t0
    torch.cuda.ipc_collect()
    del state, params, model, serve_case
    torch.cuda.empty_cache()
    want5 = 2 * cfg.n_layers                     # forward and each layer's recompute
    for o in runs:
        r = o["rank"]
        paths[f"lm-mesh-rank{r}"] = o["launches"]
        _, first, end = o["experts"]
        gap = abs(o["loss"] - ref["loss"]) / abs(ref["loss"])
        ngap = abs(o["grad_norm"] - ref["norm"]) / ref["norm"]
        egap = _gap(o["expert_grad32"], ref["experts32"][r])
        print(f"[lm-mesh] world 2 rank {r}: {o['describe']}; {o['params_local']} parameters "
              f"here (12 query heads, kv heads {4 * r}..{4 * r + 3}, real experts "
              f"{first}..{end - 1}); loss and gradient {o['ms']:.1f} ms, peak "
              f"{o['peak_bytes']} bytes above the parameters; collectives "
              f"{json.dumps(o['traffic'])}; loss {o['loss']:.6f} (gap {gap:.3e}, bar "
              f"{MESH_LOSS_RTOL:g}), aux {o['aux']:.6f}, grad norm {o['grad_norm']:.6f} (gap "
              f"{ngap:.3e}, bar {MESH_NORM_RTOL:g}); expert {first}'s w_gate gradient in f32 "
              f"compute {egap:.3e} of its largest (bar {MESH_GRAD_RTOL:g}), in bf16 "
              f"{_gap(o['expert_grad'], ref['experts'][r]):.3e}; launches "
              f"{json.dumps(o['launches'])}; K5 {o['k5_replayed']} launches replayed, "
              f"max_abs_err {o['k5_err']:.3e}, worst {o['k5_steps']:.2f} bf16 steps (bar 1)")
        check(gap <= MESH_LOSS_RTOL and ngap <= MESH_NORM_RTOL and egap <= MESH_GRAD_RTOL,
              f"lm-mesh: rank {r} disagrees with the one-process run")
        check(o["launches"]["flash_attention"] == want5 == o["k5_replayed"]
              and o["k5_steps"] <= 1, f"lm-mesh: rank {r}'s K5 launches")
        check(math.isfinite(o["loss"]) and o["aux"] > 0, f"lm-mesh: rank {r}'s loss")
    check(runs[0]["loss"] == runs[1]["loss"], "lm-mesh: the ranks' losses differ")
    k5_err = max(o["k5_err"] for o in runs)
    gaps = {k: _gap(runs[0]["grads32"][k], ref["grads32"][k]) for k in MESH_LEAVES}
    gaps16 = {k: _gap(runs[0]["grads"][k], ref["grads"][k]) for k in MESH_LEAVES}
    check(one_counts["flash_attention"] == want5, f"lm-mesh: one-process K5 {one_counts}")
    # the f32 pass at full depth: the loss gap, and the routing choices that
    # differ from the one-process run's, by layer
    gap32 = abs(runs[0]["loss32"] - loss32.item()) / abs(loss32.item())
    flips, margins = _routing_diff(runs[0]["routing32"], routing32, cfg.top_k)
    same_ranks = _routing_diff(runs[1]["routing32"], runs[0]["routing32"], cfg.top_k)[0]
    first_flip = next((i for i, n in enumerate(flips) if n), None)
    n_tok = routing32[0][0].shape[0]
    print(f"[lm-mesh] f32 compute, {cfg.n_layers} layers: loss {runs[0]['loss32']:.6f} against "
          f"one process's {loss32.item():.6f} (gap {gap32:.3e}); tokens whose top-{cfg.top_k} "
          f"experts differ from the one-process run's, of {n_tok} a layer, by layer: {flips} "
          f"({sum(flips)} in all; rank 1's routing against rank 0's: {sum(same_ranks)}); the "
          f"first layer with one: {first_flip}, its largest margin between the k-th and "
          f"(k+1)-th probability "
          f"{margins[first_flip] if first_flip is not None else 0.0:.3e} of the token's largest "
          f"(bar {MESH_TIE_MARGIN:g}: a rounding tie), the later layers' "
          f"{json.dumps([float(f'{m:.3e}') for m in margins])}")
    check(len(flips) == cfg.n_layers and sum(same_ranks) == 0,
          "lm-mesh: the ranks' routing differs")
    check(first_flip is None or margins[first_flip] <= MESH_TIE_MARGIN,
          "lm-mesh: the first routing choice that differs is not a rounding tie")
    # the gathered f32 gradients at full depth, where flips allow it, and of
    # the first MESH_SHALLOW layers alone, whose routing must be equal
    bar32 = MESH_GRAD32_RTOL if first_flip is None else MESH_GRAD_RTOL
    flips_sh, _ = _routing_diff(runs[0]["routing_shallow"], routing_shallow, cfg.top_k)
    gaps_sh = {k: _gap(runs[0]["grads_shallow"][k], ref["shallow"][k])
               for k in MESH_SHALLOW_LEAVES}
    for o in runs:
        gaps_sh[f"expert {firsts[o['rank']]} w_gate"] = _gap(o["expert_grad_shallow"],
                                                            ref["experts_shallow"][o["rank"]])
    gap_sh = abs(runs[0]["loss_shallow"] - loss_sh.item()) / abs(loss_sh.item())
    print(f"[lm-mesh] gathered gradients against the one-process run's, of each leaf's "
          f"largest: in f32 compute at {cfg.n_layers} layers "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})} (bar {bar32:g}: "
          f"{MESH_GRAD32_RTOL:g} with the routing equal, {MESH_GRAD_RTOL:g} past a flipped "
          f"tie); in bf16 {json.dumps({k: float(f'{v:.3e}') for k, v in gaps16.items()})}; "
          f"two processes {t_spawn:.1f} s with [mesh-stream], start included")
    print(f"[lm-mesh] the first {MESH_SHALLOW} layers alone in f32: tokens whose experts "
          f"differ {flips_sh}, loss gap {gap_sh:.3e}, gradients "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in gaps_sh.items()})} of each leaf's "
          f"largest (bar {MESH_GRAD32_RTOL:g})")
    check(max(gaps.values()) <= bar32, "lm-mesh: a gathered gradient disagrees")
    check(sum(flips_sh) == 0 and max(gaps_sh.values()) <= MESH_GRAD32_RTOL,
          f"lm-mesh: the first {MESH_SHALLOW} layers' f32 gradients disagree")

    # ---- [mesh-stream] -------------------------------------------------- #
    for o in runs:
        s = o["stream"]
        r = o["rank"]
        paths[f"mesh-stream-rank{r}"] = s["launches"]
        print(f"[mesh-stream] rank {r}: {RESUME_N} points, levels {r_levels}, cut {s['cut']} "
              f"(compress_sharded's {s['sharded_cut']}), leaves {s['node_range']}: "
              f"{s['batches']} batches in {s['s']:.3f} s, stream_device_peak_bytes "
              f"{s['device_peak']}, peak_stream_bytes {s['peak_stream_bytes']}; against "
              f"compress_sharded: skeletons equal on {s['skel_same']} of {s['skel_nodes']} "
              f"nodes, observed ranks equal on {s['ranks_same']}, D max_abs_err "
              f"{s['d_err']:.3e} (tol {K1_ATOL:g}); collectives {json.dumps(s['traffic'])}; "
              f"launches {json.dumps(s['launches'])}; the recorded build equal to the timed "
              f"one: {s['same_recorded']}")
        print(f"[mesh-stream] rank {r}: replayed {s['k1_replayed']} K1 launches (max_abs_err "
              f"{s['k1_err']:.3e}, tol {K1_ATOL:g}) and {s['k2_replayed']} K2 launches against "
              f"the plain versions: live-pivot mismatches {s['k2_mismatches']}/{s['k2_nodes']}, "
              f"not ties {s['k2_untied']}, off greedy {s['k2_off_greedy']}, R max_abs_err "
              f"{s['k2_r_err']:.3e} (tol {K2_R_ATOL:g})")
        check(s["same_recorded"], "mesh-stream: the recorded build differs from the timed one")
        check(s["k1_replayed"] == s["launches"]["gaussian_block"] and s["k1_err"] <= K1_ATOL,
              f"mesh-stream: rank {r}'s K1 launches against the plain version")
        check(s["k2_replayed"] == s["launches"]["fused_assemble_id"]
              and 1 - s["k2_mismatches"] / s["k2_nodes"] >= K2_PIV_MATCH
              and s["k2_untied"] == 0 and s["k2_off_greedy"] == 0
              and s["k2_r_err"] <= K2_R_ATOL,
              f"mesh-stream: rank {r}'s K2 launches against the plain version")
        check(s["cut"] == s["sharded_cut"] > 0, "mesh-stream: the cut differs")
        check(s["skel_same"] >= K2_PIV_MATCH * s["skel_nodes"]
              and s["ranks_same"] >= K2_PIV_MATCH * s["skel_nodes"] and s["d_err"] <= K1_ATOL,
              f"mesh-stream: rank {r} disagrees with compress_sharded")
        check(s["launches"]["gaussian_block"] == s["batches"]
              and s["launches"]["fused_assemble_id"] == s["batches"] - 1,
              f"mesh-stream: launches {s['launches']} for {s['batches']} batches")
        check(s["device_peak"] is not None and s["device_peak"] <= STREAM_DEVICE_PEAK_MAX,
              "mesh-stream: the level loop's device peak")
    # ---- [lm-mesh-serve] and [lm-mesh-serve-families] ----------------- #
    k5_err = max(k5_err, serve_checks(runs, serve_ref, cfg, paths))
    del serve_ref
    del runs

    # ---- [lm-mesh-1]: a (1, 1) mesh over NCCL, bit for bit ------------- #
    small = dc.replace(cfg, n_layers=MESH_ONE_LAYERS)

    def one_rank(mesh):
        m = Model(small, device=dev).init(gen.manual_seed(0))
        if mesh is not None:
            sharding.shard_model(m, mesh)
        m.trainable()
        ps = list(m.parameters())
        with dist_api.use_mesh(mesh):
            loss_, _ = m.loss_fn(batch)
            gs = torch.autograd.grad(loss_, ps)
        return loss_, gs

    _build.reset_launch_counts()
    loss_l, g_l = one_rank(None)
    with dist_api.process_group_mesh(dev.type):
        mesh1 = dist_api.make_mesh(dev, (1, 1), ("data", "model"))
        _build.reset_launch_counts()
        loss_m, g_m = one_rank(mesh1)
        paths["lm-mesh-1"] = dict(_build.launch_counts)
        backend = mesh1.describe()
    bitwise = bool(torch.equal(loss_l, loss_m)) and all(torch.equal(a, b)
                                                        for a, b in zip(g_l, g_m))
    print(f"[lm-mesh-1] {MESH_ONE_LAYERS} layers on {backend}: loss {loss_m.item():.6f}, the "
          f"loss and all {len(g_m)} gradients equal to the local run's bit for bit: "
          f"{bitwise}; launches {json.dumps(paths['lm-mesh-1'])}")
    check(bitwise, "lm-mesh-1: the one-rank mesh differs from the local run")
    del g_l, g_m, batch
    torch.cuda.empty_cache()

    # ---- [lm-mesh-fsdp] and [collectives]: four processes -------------- #
    fcfg = dc.replace(cfg, n_layers=FSDP_LAYERS)
    model = Model(fcfg, device=dev).init(gen.manual_seed(0))
    batches = [to_device(batch_for_config(fcfg, FSDP_BATCH, FSDP_SEQ, k), dev)
               for k in range(FSDP_STEPS)]
    with torch.no_grad():
        loss0 = model.loss_fn(batches[0])[0].item()
    state = {k: p.detach() for k, p in model.named_parameters()}
    g_comp = torch.randn((4, COMP_N), device=dev, generator=gen.manual_seed(5))
    pipe = (torch.randn((4, PIPE_WIDTH, PIPE_WIDTH), device=dev, generator=gen.manual_seed(6))
            / PIPE_WIDTH ** 0.5,
            0.1 * torch.randn((4, PIPE_WIDTH), device=dev, generator=gen.manual_seed(7)),
            torch.randn((PIPE_MICRO, PIPE_MB, PIPE_WIDTH), device=dev,
                        generator=gen.manual_seed(8)))
    hyb_ref, hybrid = hybrid_reference(torch, dev)
    t0 = time.perf_counter()
    runs = dist_api.spawn(lm_fsdp_rank, 4, fcfg, state, batches, g_comp, pipe, hybrid,
                          backend="gloo", device=dev.type, mesh_shape=(2, 2),
                          mesh_names=("data", "model"))
    t_spawn = time.perf_counter() - t0
    torch.cuda.ipc_collect()
    del state, model, batches, g_comp, pipe, hybrid
    torch.cuda.empty_cache()
    want5 = 2 * FSDP_LAYERS * FSDP_STEPS
    for o in runs:
        r = o["rank"]
        paths[f"lm-mesh-fsdp-rank{r}"] = o["launches"]
        print(f"[lm-mesh-fsdp] rank {r}: {o['describe']}; {o['params_local']} parameters "
              f"here; losses {[round(v, 6) for v in o['losses']]}, grad norms "
              f"{[round(v, 4) for v in o['grad_norms']]}; step ms "
              f"{[round(v, 1) for v in o['step_ms']]}; peak {o['peak_bytes']} bytes above the "
              f"parameters; collectives {json.dumps(o['traffic'])}; launches "
              f"{json.dumps(o['launches'])}; K5 {o['k5_replayed']} launches replayed, "
              f"max_abs_err {o['k5_err']:.3e}, worst {o['k5_steps']:.2f} bf16 steps (bar 1)")
        check(o["losses"] == runs[0]["losses"] and all(math.isfinite(v) for v in o["losses"]),
              f"lm-mesh-fsdp: rank {r}'s losses differ")
        check(o["launches"]["flash_attention"] == want5 == o["k5_replayed"]
              and o["k5_steps"] <= 1, f"lm-mesh-fsdp: rank {r}'s K5 launches")
        k5_err = max(k5_err, o["k5_err"])
    gap = abs(runs[0]["losses"][0] - loss0) / abs(loss0)
    print(f"[lm-mesh-fsdp] step-0 loss {runs[0]['losses'][0]:.6f} against one process's "
          f"{loss0:.6f}: gap {gap:.3e} (bar {FSDP_LOSS_RTOL:g}); four processes "
          f"{t_spawn:.1f} s with [collectives], start included")
    check(gap <= FSDP_LOSS_RTOL, "lm-mesh-fsdp: the step-0 loss")
    for o in runs:
        c, p = o["compressed"], o["pipeline"]
        print(f"[collectives] rank {o['rank']}: compressed all-reduce of {COMP_N} f32 over 4 "
              f"ranks {c['ms']:.3f} ms, error {c['rel']:.3e} of the largest |sum| (bar "
              f"{COMP_RTOL:g}), traffic {json.dumps(c['traffic'])}; pipeline_forward "
              f"{PIPE_MICRO} microbatches x 4 stages {p['ms']:.3f} ms, max_abs_err "
              f"{p['err']:.3e} against the stages in sequence, traffic "
              f"{json.dumps(p['traffic'])}")
        chunk = COMP_N // 4
        blocks = chunk // 2048
        check(c["rel"] < COMP_RTOL and c["traffic"]["all_to_all_bytes"] == COMP_N + 4 * blocks * 4
              and c["traffic"]["all_gather_bytes"] == chunk + blocks * 4,
              "collectives: the compressed all-reduce")
        check(p["close"], "collectives: the pipeline disagrees with the stages in sequence")
    # ---- [lm-mesh-serve-hybrid] ------------------------------------------ #
    k5_h, k6_err = hybrid_checks(runs, hyb_ref, paths)
    return paths, max(k5_err, k5_h), k6_err


# ---------------------------------------------------------------------- #
# The mesh (slice 9): [mesh], [main]'s configuration node-split            #
# ---------------------------------------------------------------------- #
# [main]'s 10^6 points (2^20 padded, 12 levels, rank 32, leaf 256, beta
# 10^4, 10 iterations, C 1) through HSSSVMEngine(mesh=...): (a) one rank
# in this process over NCCL, (b) two ranks as two processes on the one
# card over gloo (NCCL refuses two ranks on one GPU; the card's gloo takes
# all_gather and all_reduce of CUDA tensors, and each rank's line prints its
# backend and device).  Each rank is held
# against the single-device [main] run of this script: skeleton ids equal
# to the matching rows of [main]'s (a differing node must be a rounding tie
# of K2, judged by verify.compare_row_ids against [main]'s pivots and R on
# the same inputs, and K2_PIV_MATCH of the nodes equal); the factors of
# every node whose subtree kept [main]'s skeletons within MESH_FAC_RTOL of
# each array's largest entry (the batch of a K1/K2 launch, and so its
# plan, differs from [main]'s, and cuBLAS may pick another algorithm for
# another batch count: no bit equality); z within MESH_Z_ATOL·C (the CPU
# tests' bar); scores within MESH_SCORE_RTOL of the largest |score|, with
# the same sign wherever |score| clears that bar; accuracy >= MIN_ACCURACY
# and within MESH_ACC_GAP of [main]'s; and every K1/K2 launch of the rank
# replayed through the plain versions, as [check main] does.
MESH_FAC_RTOL, MESH_Z_ATOL, MESH_SCORE_RTOL, MESH_ACC_GAP = 1e-5, 1e-4, 1e-4, 0.002


def mesh_rank(mesh, data, refs, pad_from):
    """One rank of [mesh]: the path with the counts zeroed before it and
    read after it, then the rank's checks against [main]'s ``refs`` (CUDA
    tensors: this process's own, or shared by CUDA IPC) and the replay of
    its launches.  Returns numbers only."""
    import numpy as np
    import torch

    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import DEFAULT_SCORE_BLOCK, KernelSpec
    from repro_torch.dist import api as dist_api
    from repro_torch.kernels import _build
    from repro_torch.kernels.compress import verify
    from repro_torch.kernels.gaussian import kernel as gkern, ref as gref

    torch.backends.cuda.matmul.allow_tf32 = False
    spec = KernelSpec(h=H)
    comp = CompressionParams(rank=RANK, n_near=N_NEAR, n_far=N_FAR)
    xtr, ytr, xte, yte = data
    engine = HSSSVMEngine(spec=spec, comp=comp, leaf_size=LEAF,
                          admm=ADMMParams(max_it=MAX_IT), mesh=mesh, device=mesh.device)
    # the path's K1/K2 inputs (and K2's pivots and R)
    with recording() as rec:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mesh.reset_stats()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        rep = engine.prepare(xtr, ytr)
        model, (z, _) = engine.train(C)
        t1 = time.perf_counter()
        scores = model.decision_function(xte)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = dict(_build.launch_counts)
        traffic = dict(mesh.stats)
    peak = torch.cuda.max_memory_allocated() - base
    hss, fac = engine.hss, engine.fac
    out = dict(rank=mesh.rank, ranks=rep.mesh_ranks, cut=hss.cut, levels=hss.levels,
               compression_s=rep.compression_s, factorization_s=rep.factorization_s,
               admm_s=rep.admm_s, prepare_train_s=t1 - t0, predict_s=t2 - t1,
               peak_bytes=peak, memory_mb=rep.memory_mb, traffic=traffic, launches=counts,
               e_leaf=tuple(fac.e_leaf.shape), describe=mesh.describe(),
               k1_want=1 + hss.levels + -(-xte.shape[0] // DEFAULT_SCORE_BLOCK))

    # skeletons: equal to [main]'s rows, a differing node a rounding tie
    k2 = rec["fused_assemble_id_cuda"]
    skels = (hss.skel_leaf, *hss.skels)
    same_subtree = []                  # per level: nodes whose whole subtree agrees
    mism = ties_judged = untied = nodes = 0
    for lvl, ((args, (piv, r)), mine) in enumerate(zip(k2, skels)):
        lo, hi = hss.node_range(lvl)
        want = refs["skels"][lvl][lo:hi]
        agree = (mine == want).all(1)
        if lvl > 0:                    # inputs equal where both children agree
            kids = same_subtree[-1]
            if lvl == hss.cut:
                kids = dist_api.all_gather_nodes(kids.to(torch.int32), mesh).bool()
            inputs_equal = kids.reshape(-1, 2).all(1)
        else:
            inputs_equal = torch.ones_like(agree)
        same_subtree.append(agree & inputs_equal)
        judge = (~agree & inputs_equal).nonzero().flatten()
        if judge.numel():
            xc, xp, cm, k, h, kind = args
            piv_ref, r_ref = refs["k2"][lvl][0][lo:hi], refs["k2"][lvl][1][lo:hi]
            res = verify.compare_row_ids(xc[judge], xp[judge], cm[judge], h, kind, comp.rtol,
                                         piv[judge], r[judge], piv_ref[judge], r_ref[judge])
            untied += res["untied"]
            ties_judged += int(judge.numel())
        mism += int((~agree).sum())
        nodes += int(agree.numel())
    out.update(skel_mismatches=mism, skel_nodes=nodes, skel_ties_judged=ties_judged,
               skel_untied=untied)

    # factors of the nodes whose subtree kept [main]'s skeletons
    fac_err, left_out = 0.0, 0

    def held(mine, ref, keep):
        nonlocal fac_err, left_out
        left_out += int((~keep).sum())
        if bool(keep.any()):
            err = (mine[keep].float() - ref[keep].float()).abs().max().item()
            fac_err = max(fac_err, err / max(ref.float().abs().max().item(), 1e-30))

    lo, hi = hss.node_range(0)
    held(fac.e_leaf, refs["e_leaf"][lo:hi], same_subtree[0])
    held(fac.g_leaf, refs["g_leaf"][lo:hi], same_subtree[0])
    for k in range(1, hss.levels):
        lo, hi = hss.node_range(k)
        held(fac.e_lvls[k - 1], refs["e_lvls"][k - 1][lo:hi], same_subtree[k])
        held(fac.g_lvls[k - 1], refs["g_lvls"][k - 1][lo:hi], same_subtree[k])
    if bool(same_subtree[-1].all()):
        held(fac.root_lu[None], refs["root_lu"][None], torch.ones(1, dtype=torch.bool,
                                                                   device=mesh.device))
    out.update(fac_err=fac_err, fac_nodes_left_out=left_out)

    # duals, scores, predictions, accuracy
    lo, hi = hss.node_range(0)
    out["dz"] = (z - refs["z"][lo * LEAF:hi * LEAF]).abs().max().item()
    ref_s = refs["scores"]
    scale = ref_s.abs().max().item()
    s = scores.float()
    out["dscore"] = (s - ref_s).abs().max().item() / scale
    clear = ref_s.abs() > MESH_SCORE_RTOL * scale
    out["sign_flips"] = int(((s >= 0) != (ref_s >= 0))[clear].sum())
    pred = torch.where(s >= 0, 1, -1).cpu().numpy()
    out["accuracy"] = float(np.mean(pred == yte))

    # every K1 / K2 launch of the rank through the plain versions
    k1_worst = max(block_err(torch, args, gkern.gaussian_block_cuda,
                             gref.gaussian_block_ref, spec, pad_from)[0]
                   for args, _ in rec["gaussian_block_cuda"])
    res = [k2_against_plain(args, o, comp.rtol, spec, pad_from) for args, o in k2]
    out.update(k1_replayed=len(rec["gaussian_block_cuda"]), k1_err=k1_worst,
               k2_replayed=len(k2), k2_nodes=sum(r_["nodes"] for r_ in res),
               k2_mismatches=sum(r_["mismatches"] for r_ in res),
               k2_untied=sum(r_["untied"] for r_ in res),
               k2_off_greedy=sum(r_["off_greedy"] for r_ in res),
               k2_r_err=max(r_["r_err"] for r_ in res))
    return out


def mesh_checks(runs: list, main_acc: float) -> None:
    """Print each rank's line of [mesh] and fail on a miss."""
    for o in runs:
        tag = f"[mesh] world {len(runs)} rank {o['rank']}"
        print(f"{tag}: {o['describe']}; split over {o['ranks']} ranks, cut at level "
              f"{o['cut']} of {o['levels']}, e_leaf {o['e_leaf']}; compression_s "
              f"{o['compression_s']:.3f}, factorization_s {o['factorization_s']:.3f}, admm_s "
              f"{o['admm_s']:.3f}, prepare+train_s {o['prepare_train_s']:.3f}, predict_s "
              f"{o['predict_s']:.3f}; peak device bytes {o['peak_bytes']} "
              f"({o['peak_bytes'] / 1e9:.2f} GB), HSS {o['memory_mb']:.1f} MB on this rank; "
              f"collectives {json.dumps(o['traffic'])}; launches {json.dumps(o['launches'])}")
        print(f"{tag}: accuracy {o['accuracy']:.4f} ([main] {main_acc:.4f}, need >= "
              f"{MIN_ACCURACY} and within {MESH_ACC_GAP}); skeleton ids differing from "
              f"[main]'s {o['skel_mismatches']}/{o['skel_nodes']} nodes (need >= "
              f"{K2_PIV_MATCH:.1%} equal), {o['skel_ties_judged']} on equal inputs judged, "
              f"{o['skel_untied']} not rounding ties; factors max err {o['fac_err']:.3e} of "
              f"each array's largest (tol {MESH_FAC_RTOL:g}), {o['fac_nodes_left_out']} "
              f"nodes above a tie left out; |dz| {o['dz']:.3e} (tol {MESH_Z_ATOL * C:g}); "
              f"scores {o['dscore']:.3e} of the largest (tol {MESH_SCORE_RTOL:g}), "
              f"{o['sign_flips']} sign flips beyond it")
        print(f"{tag}: replayed {o['k1_replayed']} K1 launches (max_abs_err "
              f"{o['k1_err']:.3e}, tol {K1_ATOL:g}) and {o['k2_replayed']} K2 launches "
              f"against the plain versions: live-pivot mismatches {o['k2_mismatches']}/"
              f"{o['k2_nodes']}, not ties {o['k2_untied']}, off greedy {o['k2_off_greedy']}, "
              f"R max_abs_err {o['k2_r_err']:.3e} (tol {K2_R_ATOL:g})")
        check(o["ranks"] == len(runs), f"{tag}: built over {o['ranks']} ranks")
        check(o["accuracy"] >= MIN_ACCURACY and abs(o["accuracy"] - main_acc) <= MESH_ACC_GAP,
              f"{tag}: accuracy {o['accuracy']} against [main]'s {main_acc}")
        check(1 - o["skel_mismatches"] / o["skel_nodes"] >= K2_PIV_MATCH and o["skel_untied"] == 0,
              f"{tag}: skeletons differ from [main]'s beyond rounding ties")
        check(o["fac_err"] <= MESH_FAC_RTOL, f"{tag}: factors off by {o['fac_err']}")
        check(o["dz"] <= MESH_Z_ATOL * C, f"{tag}: z off by {o['dz']}")
        check(o["dscore"] <= MESH_SCORE_RTOL and o["sign_flips"] == 0,
              f"{tag}: scores off by {o['dscore']} ({o['sign_flips']} sign flips)")
        check(o["k1_err"] <= K1_ATOL, f"{tag}: a K1 launch disagrees: {o['k1_err']}")
        check(1 - o["k2_mismatches"] / o["k2_nodes"] >= K2_PIV_MATCH
              and o["k2_untied"] == 0 and o["k2_off_greedy"] == 0
              and o["k2_r_err"] <= K2_R_ATOL, f"{tag}: a K2 launch disagrees")
        want = {name: 0 for name in o["launches"]}
        want["gaussian_block"] = o["k1_want"]      # leaf D, a coupling a level, scoring
        want["fused_assemble_id"] = o["levels"]
        check(o["launches"] == want, f"{tag}: launches {o['launches']}, expected {want}")


def pad_pairs(xa, xb, spec, pad_from):
    """(…, Ma, Mb) mask of the pad-pad entries, or None (laplacian: its
    L1 distances between pads are exact)."""
    if spec.name == "laplacian":
        return None
    return (xa[..., :, 0] > pad_from)[..., :, None] & (xb[..., :, 0] > pad_from)[..., None, :]


def block_err(torch, args, kernel_fn, plain_fn, spec, pad_from) -> tuple[float, int]:
    """One recorded K1/K4 launch run again, kernel and plain version on the
    same inputs: the largest |difference| and the pad-pad entries left out.
    The plain version runs on slabs of CHECK_ELEMS entries (the dense
    baseline's 65536² block would not fit with its temporaries)."""
    xa, xb = args[0], args[1]
    out = kernel_fn(*args)
    step = max(1, CHECK_ELEMS // (xa.shape[0] * xb.shape[1]))
    err, skipped = 0.0, 0
    for r0 in range(0, xa.shape[1], step):
        sa = xa[:, r0:r0 + step]
        diff = (out[:, r0:r0 + step].float() - plain_fn(sa, xb, *args[2:]).float()).abs_()
        pads = pad_pairs(sa, xb, spec, pad_from)
        if pads is not None:
            skipped += int(pads.sum())
            diff.masked_fill_(pads, 0.0)
        err = max(err, diff.max().item())
        del diff, pads
    del out
    torch.cuda.empty_cache()
    return err, skipped


def k2_against_plain(args, out, rtol, spec, pad_from) -> dict:
    """One recorded K2 launch's (piv, R) against the plain version's on the
    same inputs (``verify.compare_row_ids``), nodes holding pad-pad entries
    left out (``dropped``)."""
    from repro_torch.kernels.compress import ref as cref, verify

    xc, xp, cm, k, h, kind = args
    piv, r = out
    pads = pad_pairs(xc, xp, spec, pad_from)
    dropped = 0
    if pads is not None:
        keep = ~pads.flatten(1).any(1)
        dropped = int((~keep).sum())
        if dropped:
            xc, xp, cm, piv, r = xc[keep], xp[keep], cm[keep], piv[keep], r[keep]
    piv_ref, r_ref = cref.fused_assemble_id_ref(xc, xp, cm, k, h, kind)
    res = verify.compare_row_ids(xc, xp, cm, h, kind, rtol, piv, r, piv_ref, r_ref)
    res.update(dropped=dropped, dead=int((cm == 0).sum()))
    return res


def analysis_phase(card: str) -> None:
    """[analysis]: the lint and the dispatch-level checks on the card."""
    from repro_torch.analysis import baseline as baseline_mod, dispatch_check
    from repro_torch.analysis.lint import lint_paths

    t0 = time.perf_counter()
    lint = lint_paths(base=str(ROOT))
    seconds = {"lint": time.perf_counter() - t0}
    trace = dispatch_check.run_all(device="cuda", seconds=seconds)
    new, suppressed, stale = baseline_mod.partition(lint + trace, baseline_mod.load())
    print(f"[analysis] {len(lint)} lint and {len(trace)} dispatch-level findings: "
          f"{len(new)} new, {len(suppressed)} suppressed by the baseline, {len(stale)} "
          f"stale baseline entries; every probe under set_sync_debug_mode('error')")
    for name, sec in seconds.items():
        print(f"[analysis] {name}: {sec:.3f} s on {card}")
    for f in new:
        print(f"[analysis] new finding: {f.render()}")
    for e in stale:
        print(f"[analysis] stale baseline entry: [{e['rule']}] {e['path']}: "
              f"{e['line_content']!r}")
    check(not new, f"[analysis] {len(new)} finding(s) outside the baseline")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch._lazy_import import import_dynamo_aside

    # The profiler and activation checkpoints below would import torch._dynamo
    # from deep in a phase, and that import leaves the phase's frames, with
    # its models and tensors, in a reference cycle: import it here instead.
    import_dynamo_aside()
    import numpy as np

    from repro_torch.core import admm as admm_mod, compression
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import StreamParams
    from repro_torch.dist.fault import FailureInjector, InjectedFailure
    from repro_torch.serve import ModelRegistry
    from repro_torch.core import tree as tree_mod
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.hss import rank_mask
    from repro_torch.core import factorization, krr as krr_mod
    from repro_torch.core.kernelfn import DEFAULT_SCORE_BLOCK, KernelSpec, kernel_matvec_streamed
    from repro_torch.core.tasks import oneclass_metrics as oc_metrics
    from repro_torch.data import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.admm_update import ops as aops, ref as aref
    from repro_torch.kernels.compress import kernel as ckern, laplacian as lops, ref as cref
    from repro_torch.kernels.compress import verify
    from repro_torch.kernels.gaussian import kernel as gkern, ops as gops, ref as gref
    from repro_torch.kernels import pairwise

    # Full-f32 matmuls throughout (PyTorch's defaults, set here explicitly).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    rho_params = ADMMParams(max_it=ML_MAX_IT, tol=ML_TOL, adapt_rho=True, rho_every=5,
                            rho_max_updates=8)

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
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {name}: {line.split(':', 1)[-1].strip()}")

    # ---- 2a. analysis ------------------------------------------------- #
    analysis_phase(card)

    # ---- 3. kernels against their plain versions, main-path shapes ---- #
    # All-real points at the padded size (no inert pads: pad-pad Gaussian
    # values are cancellation noise in f32, see ROADMAP queue 3).
    x_np, _ = synthetic.blobs(2 ** 20, n_features=N_FEATURES, sep=SEP, seed=1)
    t0 = time.perf_counter()
    tree = tree_mod.build_tree(x_np, LEAF)
    t_tree = time.perf_counter() - t0
    print(f"[host] build_tree on 2^20 points: {t_tree:.3f} s")
    x_host = x_np[tree.perm]
    x = torch.as_tensor(x_host, device=dev)
    n_leaf = tree.n_leaves
    xl = x.reshape(n_leaf, LEAF, N_FEATURES)

    def plan_times(launcher, xa, xb, h, reps):
        """The plan (kernels.pairwise) a K1/K4 call takes at this shape and,
        for a wide plan, ``wide_breakdown``'s times."""
        a3, b3 = (xa[None], xb[None]) if xa.dim() == 2 else (xa, xb)
        p = pairwise.plan_for(a3, b3)
        parts = (wide_breakdown(torch, launcher, xa, xb, h, reps)
                 if p.family == pairwise.WIDE else {})
        text = "".join(f"; {k} {v:.4f}" if isinstance(v, float) else f"; {k} {v}"
                       for k, v in parts.items())
        return p.label(), parts, f"[{p.label()}{text}]"

    def k1_case(label, xa, xb, reps, h=H, pads=None):
        """``pads``: a mask of entries to leave out of the comparison."""
        out = gops.gaussian_block(xa, xb, h)
        ref = gref.gaussian_block_ref(xa, xb, h)
        diff = (out - ref).abs_()
        if pads is not None:
            diff.masked_fill_(pads, 0.0)
        err = diff.max().item()
        rel = err / max(ref.abs().max().item(), 1e-30)
        del out, ref, diff
        ms = time_ms(torch, lambda: gops.gaussian_block(xa, xb, h), reps)
        plan, parts, plan_text = plan_times(gkern.gaussian_block_cuda, xa, xb, h, reps)
        plain = time_ms(torch, lambda: gref.gaussian_block_ref(xa, xb, h), max(1, reps // 4))
        shape = (1, *xa.shape) if xa.dim() == 2 else tuple(xa.shape)
        b, ma, f = shape
        mb = xb.shape[-2]
        bms, by = bound(*k1_cost(b, ma, mb, f, xa.element_size()))
        print(f"[kernels] K1 gaussian_block {label} ({b},{ma},{f})x({b},{mb},{f}): "
              f"max_abs_err {err:.3e} (tol {K1_ATOL:g}), max_rel_err {rel:.3e}, "
              f"kernel {ms:.4f} ms {plan_text}, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
        check(err <= K1_ATOL, f"K1 {label} disagrees with its plain version: {err}")
        torch.cuda.empty_cache()
        return dict(shape=label, max_abs_err=err, ms=ms, plain_ms=plain,
                    bound_ms=bms, bound_by=by, plan=plan, breakdown=parts)

    k1_rows = [
        k1_case("leaf D", xl, xl, 20),
        k1_case("coupling B level 1", xl[0::2, :RANK].contiguous(),
                xl[1::2, :RANK].contiguous(), 50),
        k1_case("scoring block", x[:N_TEST], x, 8),
    ]
    # Batches above grid.z's 65535, one launch each: 131072 blocks of 64 x
    # 64 (the packed plan, the batch on grid.x), and 70000 blocks of 64 x
    # 128 (the wide plan, the batch looped past grid.z).  10^7 points make
    # 131072 leaves at leaf 128.  Checks only, outside the cell, small rows.
    xbig = torch.randn((2 ** 17, 64, N_FEATURES), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    xwide = torch.randn((70_000, 128, N_FEATURES), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(2))
    for xa_, xb_, family in ((xbig, xbig, pairwise.PACKED),
                             (xwide[:, :64].contiguous(), xwide, pairwise.WIDE)):
        before_big = _build.launch_counts["gaussian_block"]
        out_big = gops.gaussian_block(xa_, xb_, H)
        launched = _build.launch_counts["gaussian_block"] - before_big
        err_big = (out_big - gref.gaussian_block_ref(xa_, xb_, H)).abs().max().item()
        del out_big
        big_plan = pairwise.plan_for(xa_, xb_).label()
        print(f"[kernels] K1 gaussian_block batch {xa_.shape[0]} (above 65535) "
              f"{tuple(xa_.shape)}x{tuple(xb_.shape)}: max_abs_err {err_big:.3e} "
              f"(tol {K1_ATOL:g}) [{big_plan}, {launched} launch]")
        check(err_big <= K1_ATOL, f"K1 at batch {xa_.shape[0]} disagrees: {err_big}")
        check(big_plan.split("/")[0] == family and launched == 1,
              f"K1 at batch {xa_.shape[0]}: plan {big_plan}, {launched} launches")
        torch.cuda.empty_cache()

    def k4_case(label, xa, xb, reps, time_it=True):
        tol = K4_ATOL if xa.dtype == torch.float32 else K4_BF16_ATOL
        out = lops.laplacian_block(xa, xb, H_LAP)
        ref = cref.laplacian_block_ref(xa, xb, H_LAP)
        err = (out.float() - ref.float()).abs().max().item()
        del out, ref
        torch.cuda.empty_cache()
        shape = (1, *xa.shape) if xa.dim() == 2 else tuple(xa.shape)
        b, ma, f = shape
        mb = xb.shape[-2]
        row = dict(shape=label, dtype=str(xa.dtype).replace("torch.", ""),
                   max_abs_err=err)
        line = (f"[kernels] K4 laplacian_block {label} ({b},{ma},{f})x({b},{mb},{f}) "
                f"{row['dtype']}: max_abs_err {err:.3e} (tol {tol:g})")
        if time_it:
            inv_h = 1.0 / H_LAP
            ms = time_ms(torch, lambda: lops.laplacian_block(xa, xb, H_LAP), reps)
            plan, parts, plan_text = plan_times(lops.laplacian_block_cuda, xa, xb, H_LAP, reps)
            plain = time_ms(torch, lambda: cref.laplacian_block_ref(xa, xb, H_LAP),
                            max(1, reps // 4))
            # The yardstick, torch.cdist(p=1) then exp, in f32 only (cdist
            # takes no bf16), over column chunks of CDIST_COLS: one cdist
            # launch cannot take the scoring block's 2^20 columns (CUDA's
            # "invalid configuration argument" on an H100, torch 2.11).
            def cdist_exp():
                for c0 in range(0, xb.shape[-2], CDIST_COLS):
                    torch.cdist(xa, xb[..., c0:c0 + CDIST_COLS, :], p=1).mul_(-inv_h).exp_()

            cdist = (time_ms(torch, cdist_exp, max(1, reps // 4))
                     if xa.dtype == torch.float32 else None)
            bms, by = k4_bound(b, ma, mb, f, xa.element_size())
            row.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                       cdist_exp_ms=cdist, plan=plan, breakdown=parts)
            line += (f", kernel {ms:.4f} ms {plan_text}, plain {plain:.4f} ms, "
                     f"torch.cdist(p=1)+exp "
                     f"{'-' if cdist is None else f'{cdist:.4f}'} ms, "
                     f"bound {bms:.4f} ms ({by})")
            torch.cuda.empty_cache()
        print(line)
        check(err <= tol, f"K4 {label} disagrees with its plain version: {err}")
        return row

    k4_rows = [
        k4_case("leaf D", xl, xl, 20),
        k4_case("coupling B level 1", xl[0::2, :RANK].contiguous(),
                xl[1::2, :RANK].contiguous(), 50),
        k4_case("scoring block", x[:N_TEST], x, 8),
        k4_case("leaf D bf16", xl.to(torch.bfloat16), xl.to(torch.bfloat16), 20),
    ]
    k4_rows.append(k4_case("batch 131072 (above 65535)", xbig, xbig, 0, time_it=False))
    k4_rows.append(k4_case("batch 70000 (above 65535), wide", xwide[:, :64].contiguous(), xwide,
                           0, time_it=False))
    del xbig, xwide
    torch.cuda.empty_cache()

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
    del x, xl, xz, mz, cz, z_k, m_k, z_r, m_r
    torch.cuda.empty_cache()

    # ---- 4. small engine runs: card against CPU ----------------------- #
    params = CompressionParams(rank=RANK, n_near=N_NEAR, n_far=N_FAR)
    crude, acc = CompressionParams.crude(), CompressionParams.accurate()
    xs, ys_, xst, yst = synthetic.train_test("blobs", 2048, 512, seed=3,
                                             n_features=N_FEATURES, sep=SEP)
    configs = {
        "gaussian fixed": (KernelSpec(h=H), params),
        "laplacian crude": (KernelSpec("laplacian", H_LAP), crude),
        "gaussian accurate": (KernelSpec(h=H_ACC), acc),
    }
    card_models = {}
    for label, (spec, comp) in configs.items():
        small = {}
        for where in ("cuda", "cpu"):
            eng = HSSSVMEngine(spec=spec, comp=comp, leaf_size=128,
                               admm=ADMMParams(max_it=MAX_IT), device=where)
            rep_s = eng.prepare(xs, ys_)
            mdl, (zs, _) = eng.train(C)
            small[where] = (mdl.biases.cpu(), mdl.decision_function(xst).cpu(), zs.cpu(),
                            rep_s.ranks_post)
            if where == "cuda":
                card_models[label] = mdl
        db = (small["cuda"][0] - small["cpu"][0]).abs().max().item()
        dscore = (small["cuda"][1] - small["cpu"][1]).abs().max().item()
        dz = (small["cuda"][2] - small["cpu"][2]).abs().max().item()
        agree = float((torch.sign(small["cuda"][1])
                       == torch.sign(small["cpu"][1])).float().mean())
        print(f"[small] {label} n=2048 card vs CPU: |dz| {dz:.3e}, |dbias| {db:.3e}, "
              f"|dscore| {dscore:.3e}, sign agreement {agree:.4f}; ranks_post card "
              f"{small['cuda'][3]} cpu {small['cpu'][3]}")
        check(dz <= 1e-3 and db <= 1e-3 and dscore <= 1e-3 and agree >= 0.998,
              f"the card and the CPU disagree on the small {label} engine run")

    # The task rows (this slice): each a 2048-point engine on the card and on
    # the CPU, compared on biases (or -ρ), scores, predictions and iteration
    # counts; the spectral row on eigenvalues and the embedding.
    def small_task(label, make, data, knob, rtol=SMALL_RTOL):
        xtr_, ytr_, xte_, _ = data
        out = {}
        for where in ("cuda", "cpu"):
            eng = make(where)
            eng.prepare(xtr_, ytr_)
            mdl, _ = eng.train(knob)
            out[where] = (mdl.biases.cpu(), mdl.decision_function(xte_).cpu(),
                          mdl.predict(xte_).cpu(), eng.report.iters_run)
        (bk, sk, pk, ik), (bc, sc, pc, ic) = out["cuda"], out["cpu"]
        scale = max(sc.abs().max().item(), 1e-30)
        db, ds = (bk - bc).abs().max().item() / scale, (sk - sc).abs().max().item() / scale
        # a regressor's predictions are its scores: "agree" within the tolerance
        agree = float(((pk == pc) if not pk.is_floating_point()
                       else (pk - pc).abs() <= rtol * scale).float().mean())
        print(f"[small] {label} n=2048 card vs CPU: |dbias| {db:.3e}, |dscore| {ds:.3e} of the "
              f"largest |score| {scale:.3g} (tol {rtol:g}), predictions agree {agree:.4f} (need "
              f">= {SMALL_AGREE}), iters_run card {ik[:4]} cpu {ic[:4]}")
        check(db <= rtol and ds <= rtol and agree >= SMALL_AGREE and ik == ic,
              f"the card and the CPU disagree on the small {label} engine run")

    mc_small = synthetic.train_test("multiclass_blobs", 2048, 512, seed=3, n_classes=4,
                                    sep=MULTI_SEP)
    sine_small = synthetic.train_test("noisy_sine", 2048, 512, seed=3, noise=0.1)
    oc_small = synthetic.train_test("blobs_with_outliers", 2048, 512, seed=3,
                                    outlier_frac=0.1)
    oc_small = (oc_small[0], None, oc_small[2], oc_small[3])
    eng_kw = dict(comp=crude, leaf_size=128, admm=ADMMParams(max_it=MAX_IT))
    for strategy in ("ovr", "ovo"):
        small_task(f"{strategy} 4 classes", lambda w, s_=strategy: HSSSVMEngine(
            spec=KernelSpec(h=H_MULTI), strategy=s_, device=w, **eng_kw), mc_small, C)
    small_task("svr", lambda w: HSSSVMEngine(spec=KernelSpec(h=H_SVR), task="svr", svr_c=SVR_C,
                                             device=w, **eng_kw), sine_small, SVR_EPS)
    small_task("oneclass", lambda w: HSSSVMEngine(
        spec=KernelSpec(h=H_OC), comp=crude, leaf_size=128, admm=ADMMParams(max_it=OC_MAX_IT),
        task="oneclass", device=w), oc_small, OC_NU)
    # KRR at the fixed rank, where K̃ + λI is positive definite at λ 2 and 4
    # (least eigenvalue 1.12 and 3.12, condition 239 and 87 on the CPU's
    # build; at λ 0.5, and at the crude preset, it is indefinite).  (1) The
    # card's own HSS: its per-λ factorizations (``_fac_for``: λ 2, 4, then 2
    # again from the cache) and solves against the CPU's factorizations of
    # that HSS at the same λ, the other λ's error printed beside to show the
    # row tells them apart.  (2) The card's engine against the CPU's: the two
    # builds may take different pivots on the 2-feature data's rounding
    # ties, so α may move by cond(K̃ + λI) times the relative difference of
    # the two K̃ (first order, x2 for the second order) plus the solves' own
    # SMALL_RTOL; the card's K̃ must also be as close to the exact K as the
    # CPU's (within 2x), so a wrong card build fails there.
    krr_lams = (GP_LAMS[1], 2 * GP_LAMS[1], GP_LAMS[1])
    keng = HSSSVMEngine(spec=KernelSpec(h=H_GP), comp=params, leaf_size=128, task="krr",
                        device="cuda")
    keng.prepare(sine_small[0], sine_small[1])
    kmodels = keng.train_grid(krr_lams)
    hss_cpu = keng.hss.to("cpu")
    rhs, kmask = keng.problem_labels.T.cpu(), keng.problem_masks.T.cpu()
    alpha_cpu = {lam: krr_mod.krr_solve(factorization.factorize(hss_cpu, lam), rhs) * kmask
                 for lam in sorted(set(krr_lams))}
    xst_k = torch.as_tensor(sine_small[2])
    for lam, km in zip(krr_lams, kmodels):
        a_card, a_ref = km.z_y.cpu(), alpha_cpu[lam]
        other = alpha_cpu[krr_lams[1] if lam == krr_lams[0] else krr_lams[0]]
        da = ((a_card - a_ref).abs().max() / a_ref.abs().max()).item()
        dx = ((a_card - other).abs().max() / other.abs().max()).item()
        s_cpu = kernel_matvec_streamed(keng.spec, xst_k, hss_cpu.x, a_ref)[:, 0]
        dsk = ((km.decision_function(sine_small[2]).cpu() - s_cpu).abs().max()
               / s_cpu.abs().max()).item()
        print(f"[small] krr lambda {lam} n=2048, the card's HSS factorized and solved on the "
              f"card and on the CPU: alpha rel err {da:.3e}, scores rel err {dsk:.3e} (tol "
              f"{SMALL_RTOL:g}); against the CPU's solve at the other lambda {dx:.3e}; "
              f"model beta {km.beta}")
        check(da <= SMALL_RTOL and dsk <= SMALL_RTOL and km.beta == lam,
              f"the card and the CPU disagree on the small krr solve at lambda {lam}")
    # prepare's factorization at the paper's β, then one for each λ visited
    check(keng.report.iters_run == (0,)
          and sorted(keng._fac_cache) == sorted({keng.report.beta, *krr_lams}),
          f"krr: iters_run {keng.report.iters_run}, factorizations {sorted(keng._fac_cache)}")
    lam = krr_lams[0]
    ceng = HSSSVMEngine(spec=KernelSpec(h=H_GP), comp=params, leaf_size=128, task="krr",
                        device="cpu")
    ceng.prepare(sine_small[0], sine_small[1])
    cmodel, (calpha, _) = ceng.train(lam)
    check(torch.equal(keng.hss.x.cpu(), ceng.hss.x), "krr: the two engines' trees differ")
    eye = torch.eye(ceng.hss.n)
    k_card = keng.hss.matmat(eye.to(dev)).cpu().double()
    k_cpu = ceng.hss.matmat(eye).double()
    x64 = ceng.hss.x.double()
    k_exact = torch.exp(torch.cdist(x64, x64) ** 2 * (-0.5 / H_GP ** 2))
    norm2 = lambda m: torch.linalg.matrix_norm(m, ord=2).item()  # noqa: E731
    e_card, e_cpu = (norm2(k - k_exact) / norm2(k_exact) for k in (k_card, k_cpu))
    sv = torch.linalg.svdvals(k_cpu + lam * torch.eye(ceng.hss.n, dtype=torch.float64))
    cond = (sv[0] / sv[-1]).item()
    dk = norm2(k_card - k_cpu) / sv[0].item()
    tol_e = 2.0 * cond * dk + SMALL_RTOL
    a_card, a_cpu = kmodels[0].z_y.cpu().double(), calpha.double()
    da = ((a_card - a_cpu).norm() / a_cpu.norm()).item()
    s_card = kmodels[0].decision_function(sine_small[2]).cpu()
    s_cpu = cmodel.decision_function(sine_small[2])
    scale = s_cpu.abs().max().item()
    dsk = (s_card - s_cpu).abs().max().item() / scale
    agree = float(((s_card - s_cpu).abs() <= tol_e * scale).float().mean())
    print(f"[small] krr lambda {lam} n=2048, the card's engine against the CPU's: |K̃ - K|/|K| "
          f"card {e_card:.3e}, cpu {e_cpu:.3e} (card need <= 2x cpu); |K̃_card - K̃_cpu| / "
          f"|K̃_cpu + λI| {dk:.3e}, cond {cond:.1f}; alpha rel err {da:.3e} (tol 2 cond dK + "
          f"{SMALL_RTOL:g} = {tol_e:.3e}); scores rel err {dsk:.3e}, within the tol {agree:.4f} "
          f"(need >= {SMALL_AGREE})")
    check(e_card <= 2.0 * e_cpu, "krr: the card's build is further from K than the CPU's")
    check(da <= tol_e and agree >= SMALL_AGREE,
          "the card's and the CPU's krr engines disagree beyond their builds' difference")
    del keng, kmodels, hss_cpu, ceng, cmodel, k_card, k_cpu, k_exact
    small_task("binary, bf16-stored factors", lambda w: HSSSVMEngine(
        spec=KernelSpec(h=H), comp=params, leaf_size=128, admm=ADMMParams(max_it=MAX_IT),
        store_dtype="bfloat16", device=w), (xs, ys_, xst, yst), C, rtol=SMALL_BF16_RTOL)
    circ_small = synthetic.train_test("circles", 2048, 0, seed=3, n_features=2)
    v0 = torch.randn(2048, generator=torch.Generator().manual_seed(0))
    emb = {}
    for where in ("cuda", "cpu"):
        eng = HSSSVMEngine(spec=KernelSpec(h=0.25), device=where, **eng_kw)
        eng.prepare(circ_small[0], circ_small[1])
        evals, _ = eng.top_eigenpairs(3, v0=v0)
        emb[where] = (evals.cpu(), eng.spectral_embed(3, v0=v0))
    dev_ = (emb["cuda"][0] - emb["cpu"][0]).abs().max().item() / emb["cpu"][0].abs().max().item()
    sgn = np.sign((emb["cuda"][1] * emb["cpu"][1]).sum(0))
    demb = np.abs(emb["cuda"][1] * sgn - emb["cpu"][1]).max() / np.abs(emb["cpu"][1]).max()
    print(f"[small] spectral_embed(3) circles h=0.25 n=2048 card vs CPU: eigenvalues "
          f"{emb['cuda'][0].tolist()} rel err {dev_:.3e} (tol {SMALL_RTOL:g}), embedding rel "
          f"err {demb:.3e} up to sign (tol 5e-3, tests/test_torch_krr.py's bar)")
    check(dev_ <= SMALL_RTOL and demb <= 5e-3, "the card and the CPU disagree on spectral_embed")

    # The multilevel warm start and adaptive ρ (this slice) at the repo's own
    # fixed-size bench cases, card against CPU: the same β sequence and
    # rescale count, iteration counts within ITERS_RTOL, accuracy equal.
    ml_data = synthetic.train_test("blobs", ML_N, ML_N_TEST, seed=0, n_features=ML_FEATURES,
                                   sep=ML_SEP)

    def ml_acc(model):
        return float(np.mean(model.predict(ml_data[2]).cpu().numpy() == ml_data[3]))

    def close_iters(a, b):
        return abs(a - b) <= ITERS_RTOL * b

    ml_rows, rho_rows = {}, {}
    for where in ("cuda", "cpu"):
        eng = HSSSVMEngine(spec=KernelSpec(h=ML_H), comp=crude, leaf_size=128, beta=ML_BETA,
                           admm=ADMMParams(max_it=ML_MAX_IT, tol=ML_TOL), device=where)
        eng.prepare(ml_data[0], ml_data[1])
        m_cold, _ = eng.train(C)
        cold = eng.report.iters_run[0]
        m_warm, info = eng.train_multilevel(C, coarse_frac=ML_COARSE_FRAC,
                                            coarse_leaf_size=ML_COARSE_LEAF, seed=0)
        ml_rows[where] = dict(cold=cold, warm=info["iters_run"][0],
                              coarse=info["coarse_iters_run"][0], coarse_n=info["coarse_n"],
                              acc_cold=ml_acc(m_cold), acc_warm=ml_acc(m_warm))
        eng = HSSSVMEngine(spec=KernelSpec(h=ML_H), comp=crude, leaf_size=128, beta=RHO_BETA0,
                           admm=ADMMParams(max_it=ML_MAX_IT, tol=ML_TOL), device=where)
        eng.prepare(ml_data[0], ml_data[1])
        m_fixed, _ = eng.train(C)
        fixed = eng.report.iters_run[0]
        eng.admm = rho_params
        m_rho, _ = eng.train(C)
        rho_rows[where] = dict(fixed=fixed, adaptive=eng.report.iters_run[0],
                               rho_final=eng.report.rho_final,
                               rescales=eng.report.rho_rescales, betas=list(eng._fac_cache),
                               acc_fixed=ml_acc(m_fixed), acc_adaptive=ml_acc(m_rho))
    mk, mc = ml_rows["cuda"], ml_rows["cpu"]
    print(f"[small] svm_multilevel/blobs n={ML_N} card vs CPU: iterations cold {mk['cold']} vs "
          f"{mc['cold']}, warm {mk['warm']} vs {mc['warm']}, coarse {mk['coarse']} vs "
          f"{mc['coarse']} (need within {ITERS_RTOL:.0%}; JAX CPU {REF_ML_ITERS}), coarse_n "
          f"{mk['coarse_n']} vs {mc['coarse_n']}, accuracy cold {mk['acc_cold']:.4f} vs "
          f"{mc['acc_cold']:.4f}, warm {mk['acc_warm']:.4f} vs {mc['acc_warm']:.4f}")
    check(all(close_iters(mk[key], mc[key]) for key in ("cold", "warm", "coarse"))
          and mk["coarse_n"] == mc["coarse_n"] and mk["acc_cold"] == mc["acc_cold"]
          and mk["acc_warm"] == mc["acc_warm"],
          "the card and the CPU disagree on the small multilevel run")
    rk, rc = rho_rows["cuda"], rho_rows["cpu"]
    print(f"[small] svm_adaptive_rho n={ML_N} beta0 {RHO_BETA0:g} card vs CPU: iterations fixed "
          f"{rk['fixed']} vs {rc['fixed']}, adaptive {rk['adaptive']} vs {rc['adaptive']} (need "
          f"within {ITERS_RTOL:.0%}; JAX CPU {REF_RHO}), rescales {rk['rescales']} vs "
          f"{rc['rescales']}, final beta {rk['rho_final']} vs {rc['rho_final']}, beta sequence "
          f"{rk['betas']} (CPU equal: {rk['betas'] == rc['betas']}), accuracy fixed "
          f"{rk['acc_fixed']:.4f} vs {rc['acc_fixed']:.4f}, adaptive {rk['acc_adaptive']:.4f} vs "
          f"{rc['acc_adaptive']:.4f}")
    check(rk["betas"] == rc["betas"] and rk["rescales"] == rc["rescales"]
          and rk["rho_final"] == rc["rho_final"]
          and close_iters(rk["fixed"], rc["fixed"]) and close_iters(rk["adaptive"], rc["adaptive"])
          and rk["acc_fixed"] == rc["acc_fixed"] and rk["acc_adaptive"] == rc["acc_adaptive"],
          "the card and the CPU disagree on the small adaptive-rho run")

    # The registry: the binary model trained on the card above, saved, then
    # loaded on the CPU and on the card.
    reg_dir = tempfile.mkdtemp(prefix="chip_smoke_registry_")
    try:
        registry = ModelRegistry(reg_dir)
        card_model = card_models["gaussian fixed"]
        registry.save("binary", card_model)
        want_pred = card_model.predict(xst).cpu()
        for where in ("cpu", "cuda"):
            back, info = registry.load("binary", device=where)
            same = back.x_perm.device.type == where and all(
                torch.equal(getattr(back, n).cpu(), getattr(card_model, n).cpu())
                for n in ("x_perm", "z_y", "biases"))
            pred_eq = torch.equal(back.predict(xst).cpu(), want_pred)
            print(f"[small] registry: the card's binary model loaded on the {where} (version "
                  f"{info.version}, {info.n_support_kept} support rows): arrays bit-equal "
                  f"{same}, predictions equal {pred_eq}")
            check(same and pred_eq, f"registry: the model loaded on the {where} differs")
    finally:
        shutil.rmtree(reg_dir, ignore_errors=True)

    # ---- 5-7. the paths at paper scale, each with its check ----------- #
    class OnCard:
        """A path's host-kept records, moved to the card one at a time."""

        def __init__(self, items):
            self.items = items

        def __len__(self):
            return len(self.items)

        def __iter__(self):
            return (moved(item, dev) for item in self.items)

    def run_path(tag, spec, comp, data, min_acc):
        xtr, ytr, xte, yte = data
        engine = HSSSVMEngine(spec=spec, comp=comp, leaf_size=LEAF,
                              admm=ADMMParams(max_it=MAX_IT), device="cuda")
        torch.cuda.reset_peak_memory_stats()
        with recording() as rec:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            rep = engine.prepare(xtr, ytr)
            model, (z, _) = engine.train(C)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred = model.predict(xte)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            counts = dict(_build.launch_counts)
        pred = pred.cpu().numpy()
        acc_ = float(np.mean(pred == yte))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        path_peaks[tag] = peak_gb
        print(f"[{tag}] kernel={spec.name} h={spec.h} rtol={comp.rtol} n={xtr.shape[0]} "
              f"padded={engine.hss.n} levels={rep.hss_levels} beta={rep.beta:g}: "
              f"compression_s {rep.compression_s:.3f}, "
              f"factorization_s {rep.factorization_s:.3f}, admm_s {rep.admm_s:.3f}, "
              f"prepare+train_s {t1 - t0:.3f}, predict_s {t2 - t1:.3f}, "
              f"memory_mb {rep.memory_mb:.1f}, kernel_evals {rep.kernel_evals}, "
              f"peak_device_gb {peak_gb:.2f}")
        print(f"[{tag}] ranks_pre {list(rep.ranks_pre)} -> ranks_post "
              f"{list(rep.ranks_post)}, rank_sum {rep.rank_sum_pre} -> {rep.rank_sum_post}")
        print(f"[{tag}] accuracy {acc_:.4f} (need >= {min_acc}); "
              f"launches {json.dumps(counts)}")
        check(pred.shape == (xte.shape[0],) and np.isin(pred, (-1, 1)).all(),
              f"{tag}: predictions are not a ±1 vector of the test size")
        check(bool(torch.isfinite(z).all()) and bool(torch.isfinite(model.biases).all()),
              f"{tag}: non-finite duals or bias")
        check(acc_ >= min_acc, f"{tag}: accuracy {acc_} below {min_acc}")
        # The block kernel of the spec (K1 gaussian, K4 laplacian): one
        # leaf-D launch, one coupling launch per level, one per scoring
        # block; K2: one launch per level that selects skeletons (0..K-1).
        block = "laplacian_block" if spec.name == "laplacian" else "gaussian_block"
        want = {name: 0 for name in counts}
        want[block] = 1 + rep.hss_levels + -(-xte.shape[0] // DEFAULT_SCORE_BLOCK)
        want["fused_assemble_id"] = rep.hss_levels
        check(counts == want, f"{tag}: launches {counts}, expected {want}")
        return engine, rep, counts, z, rec, model

    # The paths pad 10^6 points to 2^20 with far-away points along the first
    # axis (tree.pad_dataset).  Between two pads the f32 norm expansion of the
    # Gaussian block is cancellation noise, 0 or 1, in the kernel and in the
    # plain version alike (ROADMAP queue 3): the checks of the Gaussian paths
    # leave pad-pad entries, and the K2 nodes that hold any, out.  A pad is a
    # point beyond the largest first coordinate of the real data.
    def check_blocks(tag, launches, kernel_fn, plain_fn, tol, spec, pad_from):
        """Run each recorded K1/K4 launch again, kernel and plain version on
        the same inputs (these launches come after the path's count); the
        plain version runs on slabs of CHECK_ELEMS entries (the dense
        baseline's 65536² block would not fit with its temporaries).  Each
        launch's error goes to ``block_errs[tag]``."""
        worst, skipped = 0.0, 0
        block_errs[tag] = []
        for n, (args, _) in enumerate(launches):
            err, sk = block_err(torch, args, kernel_fn, plain_fn, spec, pad_from)
            skipped += sk
            shape = "x".join(str(tuple(t.shape)) for t in args[:2])
            check(err <= tol, f"{tag}: launch {n} {shape} disagrees with its plain version: {err}")
            block_errs[tag].append(err)
            worst = max(worst, err)
        print(f"[check {tag}] {kernel_fn.__name__}: {len(launches)} launches of the path "
              f"against the plain version, max_abs_err {worst:.3e} (tol {tol:g}); "
              f"{skipped} pad-pad entries left out")

    def compare_k2(tag, label, args, out, rtol, min_match, spec, pad_from, asm=False,
                   quiet=False):
        """K2's (piv, R) on one level against the plain version's on the
        same inputs: live-slot pivots and ranks, each mismatch a rounding tie
        that stays a greedy pivoted QR after it, R on the agreeing nodes'
        live rows.  With ``asm`` a tie's error bars also hold each column's
        f32 assembly error (verify.py; see K2_PIV_MATCH_DENSE).  ``quiet``
        prints nothing (the caller sums many launches into one line)."""
        xc, xp, cm, k, h, kind = args
        res = k2_against_plain(args, out, rtol, spec, pad_from)
        dropped = res["dropped"]
        b, m, f = xc.shape
        b -= dropped
        print_ = (lambda *a: None) if quiet else print
        print_(f"[check {tag}] K2 {kind} {label} B={b} m={m} s={xp.shape[1]} k={k} f={f} "
              f"({dropped} nodes with pad-pad entries left out), "
              f"{res['dead']} dead candidates: live-pivot mismatches "
              f"{res['mismatches']}/{b}" + (f" (need >= {min_match:.1%} equal)"
                                              if min_match is not None else "")
              + f", not rounding ties {res['untied']} (worst gap {res['worst_gap']:.3g} of "
              f"the bound), off greedy past the divergence {res['off_greedy']} (worst step "
              f"{res['worst_step_gap']:.3g} of the bound; residual ratio to the plain "
              f"skeleton's {res['worst_ratio']:.4g}); with the assembly error in the bars "
              f"{res['untied_asm']} not ties (worst {res['worst_gap_asm']:.3g}), "
              f"{res['off_greedy_asm']} off greedy (worst {res['worst_step_gap_asm']:.3g})"
              + (" [held]" if asm else "")
              + f"; R max_abs_err {res['r_err']:.3e} (tol {K2_R_ATOL:g})")
        untied, off = ("untied_asm", "off_greedy_asm") if asm else ("untied", "off_greedy")
        check(min_match is None or 1 - res["mismatches"] / b >= min_match,
              f"K2 {tag} {label}: {res['mismatches']} of {b} nodes differ")
        check(res[untied] == 0, f"K2 {tag} {label}: {res[untied]} pivot mismatches "
              "beyond rounding ties")
        check(res[off] == 0, f"K2 {tag} {label}: {res[off]} nodes "
              "leave greedy pivoted QR past their divergence")
        check(res["r_err"] <= K2_R_ATOL, f"K2 {tag} {label}: R disagrees: {res['r_err']}")
        return res

    def k2_time(args, reps, cluster=None):
        return time_ms(torch, lambda: ckern.fused_assemble_id_cuda(*args, cluster=cluster),
                       reps)

    def k2_plan(args):
        """(C, TPC, RREG) of the plan the launcher takes for one level's
        inputs, its shared bytes (the kernel's count) and the card's
        co-resident clusters of it."""
        xc, xp, _, k, _, kind = args
        b, m, _ = xc.shape
        s_ = xp.shape[1]
        dev_i = torch.cuda.current_device()
        props = torch.cuda.get_device_properties(dev_i)
        c, tpc, rreg = ckern.plan(b, m, s_, k, props.multi_processor_count,
                                  props.shared_memory_per_block_optin)
        return (c, tpc, rreg, ckern.kernel_smem_bytes(m, s_, k, c, tpc, rreg),
                ckern.max_active_clusters(m, s_, k, c, tpc, rreg, dev_i, kind))

    def k2_sweep(args, reps):
        """K2 at every cluster size that fits this level (the planner's
        evidence): {C: ms}."""
        xc, xp, _, k, _, _ = args
        b, m, _ = xc.shape
        return {c: k2_time(args, reps, c) for c, _, _ in ckern.feasible(m, xp.shape[1], k, b)}

    def k2_row(tag, label, args, reps, plain_reps, extra=None):
        """Device times of K2 and its plain version on one level's inputs,
        and K2 at every cluster size that fits."""
        xc, xp, cm, k, h, kind = args
        ms = k2_time(args, reps)
        plain = time_ms(torch, lambda: cref.fused_assemble_id_ref(*args), plain_reps)
        torch.cuda.empty_cache()
        b, m, f = xc.shape
        s_ = xp.shape[1]
        bms, by = bound(*k2_cost(b, m, s_, f, k, kind))
        c, tpc, rreg, smem, active = k2_plan(args)
        sweep = k2_sweep(args, reps)
        print(f"[kernels] K2 fused_assemble_id {kind} {tag} {label} B={b} m={m} s={s_} "
              f"k={k} f={f}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms "
              f"({by}), cluster C={c} TPC={tpc} register rows {rreg}, smem {smem} B/CTA, "
              f"{active} clusters co-resident; each C: "
              + ", ".join(f"C={cc} {t:.4f} ms" for cc, t in sweep.items()))
        return dict(shape=f"{kind} {tag} {label}", ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, cluster=c, threads_per_column=tpc, register_rows=rreg,
                    ms_by_cluster={str(cc): t for cc, t in sweep.items()}, **(extra or {}))

    def check_launches(tag, rec, spec, comp, min_match, pad_from, asm=False):
        """Hold every K1/K4 and K2 launch of the path against the plain
        version on its own inputs (K2's leaf and level 1, and the build as a
        whole, need ``min_match`` of their nodes' live pivots equal);
        returns each level's comparison."""
        if spec.name == "laplacian":
            check_blocks(tag, rec["laplacian_block_cuda"], lops.laplacian_block_cuda,
                         cref.laplacian_block_ref, K4_ATOL, spec, pad_from)
        else:
            check_blocks(tag, rec["gaussian_block_cuda"], gkern.gaussian_block_cuda,
                         gref.gaussian_block_ref, K1_ATOL, spec, pad_from)
        results = [compare_k2(tag, "leaf" if lvl == 0 else f"level {lvl}", args, out,
                              comp.rtol, min_match if lvl <= 1 else None, spec, pad_from,
                              asm)
                   for lvl, (args, out) in enumerate(rec["fused_assemble_id_cuda"])]
        total = sum(r["nodes"] for r in results)
        mism = sum(r["mismatches"] for r in results)
        print(f"[check {tag}] K2 over the path's {len(results)} levels: {mism}/{total} nodes "
              f"differ on live pivots (need >= {min_match:.1%} equal)")
        check(1 - mism / total >= min_match, f"K2 {tag}: {mism} of {total} nodes differ")
        return results

    def check_path(tag, rec, spec, comp, min_match, plain_reps, pad_from):
        """Hold every launch of the path against the plain version, then
        time K2 at every level of the path (its leaf and level 1 beside the
        plain version and at each cluster size) and print the build's sum."""
        results = check_launches(tag, rec, spec, comp, min_match, pad_from)
        levels = rec["fused_assemble_id_cuda"]
        rows = []
        sum_ms = sum_bound = 0.0
        plans = []
        for lvl, ((args, _), res) in enumerate(zip(levels, results)):
            label = "leaf" if lvl == 0 else f"level {lvl}"
            xc, xp, _, k, _, kind = args
            plans.append(k2_plan(args)[0])
            if lvl <= 1:
                row = k2_row(tag, label, args, 5 if lvl == 0 else 20, plain_reps,
                             dict(max_abs_err=res["r_err"],
                                  pivot_mismatches=res["mismatches"],
                                  untied_mismatches=res["untied"]))
                rows.append(row)
                ms = row["ms"]
            else:
                sweep = k2_sweep(args, 20)
                ms = sweep[plans[-1]]
                print(f"[kernels] K2 fused_assemble_id {kind} {tag} {label} B={xc.shape[0]} "
                      f"m={xc.shape[1]} s={xp.shape[1]} k={k}: kernel {ms:.4f} ms, "
                      f"cluster C={plans[-1]}; each C: "
                      + ", ".join(f"C={cc} {t:.4f} ms" for cc, t in sweep.items()))
            sum_ms += ms
            sum_bound += bound(*k2_cost(xc.shape[0], xc.shape[1], xp.shape[1], xc.shape[2],
                                        k, kind))[0]
        print(f"[kernels] K2 {tag} build: {len(levels)} launches, kernel {sum_ms:.4f} ms, "
              f"bound {sum_bound:.4f} ms, gap {sum_ms - sum_bound:.4f} ms; cluster C by "
              f"level {plans}")
        k2_builds[tag] = dict(launches=len(levels), ms=sum_ms, bound_ms=sum_bound,
                              clusters=plans)
        return rows

    k2_builds = {}
    path_peaks = {}
    block_errs = {}
    blobs = synthetic.train_test("blobs", N_TRAIN, N_TEST, seed=0,
                                 n_features=N_FEATURES, sep=SEP)
    engine, rep, main_counts, z_main, rec, main_model = run_path(
        "main", KernelSpec(h=H), params, blobs, MIN_ACCURACY)
    pad_from = float(blobs[0][:, 0].max())
    k2_rows = check_path("main", rec, KernelSpec(h=H), params, K2_PIV_MATCH, 2, pad_from)
    # what [mesh] holds its ranks against: [main]'s skeletons, K2's pivots
    # and R per level, its scores (this scoring runs after the count's read)
    main_skels = [engine.hss.skel_leaf, *engine.hss.skels]
    main_k2 = [out for _, out in rec["fused_assemble_id_cuda"]]
    main_scores = main_model.decision_function(blobs[2]).float()
    main_acc = float(np.mean(torch.where(main_scores >= 0, 1, -1).cpu().numpy() == blobs[3]))
    del rec, main_model
    main_beta, main_n = engine.fac.beta, engine.hss.n
    ys, pmask, main_fac = engine.problem_labels, engine.problem_masks, engine.fac
    del engine
    torch.cuda.empty_cache()

    lap_spec = KernelSpec("laplacian", H_LAP)
    lap_engine, rep_lap, lap_counts, _, rec, lap_model = run_path("lap", lap_spec, crude,
                                                                  blobs, MIN_ACCURACY)
    # [serve]'s second group: this model through a registry
    serve_dir = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    ModelRegistry(serve_dir).save("lap", lap_model)
    lap_test = blobs[2]
    del lap_model
    check_path("lap", rec, lap_spec, crude, K2_PIV_MATCH, 2, pad_from)
    # K2's laplacian branch with dead candidates on the path's own inputs:
    # 10% of the leaf's candidates, and at level 1 the slots past ranks
    # drawn in [16, 32] (on these blobs every rank is at the cap of 32, so
    # the path's own masks are all ones).
    gen = torch.Generator(device=dev).manual_seed(2)
    (xc0, xp0, cm0, k0, h0, kind0), _ = rec["fused_assemble_id_cuda"][0]
    (xc1, xp1, cm1, k1, h1, kind1), _ = rec["fused_assemble_id_cuda"][1]
    dead0 = cm0 * (torch.rand(cm0.shape, device=dev, generator=gen) >= 0.1).float()
    ranks = torch.randint(16, k0 + 1, (2 * xc1.shape[0],), device=dev, generator=gen)
    dead1 = cm1 * rank_mask(ranks, k0).reshape(-1, 2 * k0)
    for label, args, reps in (("leaf, dead candidates", (xc0, xp0, dead0, k0, h0, kind0), 5),
                              ("level 1, dead candidates", (xc1, xp1, dead1, k1, h1, kind1),
                               20)):
        res = compare_k2("lap", label, args, ckern.fused_assemble_id_cuda(*args),
                         crude.rtol, K2_PIV_MATCH, lap_spec, pad_from)
        k2_rows.append(k2_row("lap", label, args, reps, 2, dict(
            max_abs_err=res["r_err"], pivot_mismatches=res["mismatches"],
            untied_mismatches=res["untied"], dead_candidates=int((args[2] == 0).sum()))))
    del lap_engine, blobs, rec, xc0, xp0, cm0, xc1, xp1, cm1, dead0, dead1
    torch.cuda.empty_cache()

    circles = synthetic.train_test("circles", N_TRAIN, N_TEST, seed=0,
                                   n_features=ACC_FEATURES, gap=ACC_GAP)
    acc_spec = KernelSpec(h=H_ACC)
    acc_engine, rep_acc, acc_counts, _, rec, _ = run_path("accurate", acc_spec, acc, circles,
                                                          MIN_ACCURACY_ACC)
    check(rep_acc.rank_sum_post < rep_acc.rank_sum_pre,
          f"accurate: rank_sum_post {rep_acc.rank_sum_post} not below "
          f"rank_sum_pre {rep_acc.rank_sum_pre}")
    check(rep_acc.ranks_post[0] < acc.rank,
          f"accurate: leaf rank {rep_acc.ranks_post[0]} not below the cap {acc.rank}")
    acc_pad_from = float(circles[0][:, 0].max())
    k2_rows += check_path("accurate", rec, acc_spec, acc, K2_PIV_MATCH_F2, 1, acc_pad_from)
    # K1 on the path's 2-feature inputs: its leaf D (first launch) and its
    # scoring block (last launch), timed; pad-pad entries left out.
    blocks = rec["gaussian_block_cuda"]
    k1_rows += [k1_case(f"accurate path {label}, 2 features", xa, xb, reps, h=H_ACC,
                        pads=pad_pairs(xa, xb, acc_spec, acc_pad_from))
                for label, (xa, xb, _), reps in (("leaf D", blocks[0][0], 20),
                                                 ("scoring block", blocks[-1][0], 8))]
    del acc_engine, circles, rec, blocks
    torch.cuda.empty_cache()

    # ---- 8. K3 path: the fused z/mu update ---------------------------- #
    _build.reset_launch_counts()
    st_f, tr_f = admm_mod.admm_svm_batched(main_fac.solve_mat, ys, C * pmask, main_beta,
                                           MAX_IT, use_fused_update=True)
    torch.cuda.synchronize()
    k3_counts = dict(_build.launch_counts)
    st_u, tr_u = admm_mod.admm_svm_batched(main_fac.solve_mat, ys, C * pmask, main_beta,
                                           MAX_IT)
    dz = (st_f.z - st_u.z).abs().max().item()
    dmu = (st_f.mu - st_u.mu).abs().max().item() / max(1.0, st_u.mu.abs().max().item())
    dpr = ((tr_f.primal_res - tr_u.primal_res).abs().max()
           / tr_u.primal_res.abs().max().clamp(min=1e-30)).item()
    ddr = ((tr_f.dual_res - tr_u.dual_res).abs().max()
           / tr_u.dual_res.abs().max().clamp(min=1e-30)).item()
    dz_engine = (st_u.z - z_main).abs().max().item()
    print(f"[k3-path] fused vs unfused, {MAX_IT} iterations at d={main_n}: "
          f"|dz| {dz:.3e} (tol {FUSED_Z_ATOL:g}), mu rel {dmu:.3e}, primal rel {dpr:.3e}, "
          f"dual rel {ddr:.3e} (tol {FUSED_RTOL:g}); unfused vs engine |dz| "
          f"{dz_engine:.3e}; launches {json.dumps(k3_counts)}")
    check(dz <= FUSED_Z_ATOL and max(dmu, dpr, ddr) <= FUSED_RTOL,
          "the fused ADMM run disagrees with the unfused one")
    check(dz_engine <= FUSED_Z_ATOL, "admm_svm_batched disagrees with the engine's run")
    want3 = {name: 0 for name in k3_counts}
    want3["zmu_update"] = MAX_IT
    check(k3_counts == want3, f"K3 path launches {k3_counts}, expected {want3}")
    del st_f, st_u, tr_f, tr_u

    # ---- [mesh]: [main]'s path node-split over one rank, then two ------ #
    from repro_torch.dist import api as dist_api

    mesh_data = synthetic.train_test("blobs", N_TRAIN, N_TEST, seed=0,
                                     n_features=N_FEATURES, sep=SEP)
    refs = dict(skels=main_skels, k2=main_k2, e_leaf=main_fac.e_leaf, g_leaf=main_fac.g_leaf,
                e_lvls=list(main_fac.e_lvls), g_lvls=list(main_fac.g_lvls),
                root_lu=main_fac.root_lu, z=z_main, scores=main_scores)
    t0 = time.perf_counter()
    with dist_api.process_group_mesh("cuda") as mesh:       # (a) one rank over NCCL
        mesh_runs1 = [mesh_rank(mesh, mesh_data, refs, pad_from)]
    t_mesh1 = time.perf_counter() - t0
    torch.cuda.empty_cache()
    mesh_checks(mesh_runs1, main_acc)
    # (b) two processes on the card over gloo; the kernels were built above
    t0 = time.perf_counter()
    mesh_runs2 = dist_api.spawn(mesh_rank, 2, mesh_data, refs, pad_from, backend="gloo",
                                device="cuda")
    t_mesh2 = time.perf_counter() - t0
    torch.cuda.ipc_collect()        # the ranks have released [main]'s shared arrays
    mesh_checks(mesh_runs2, main_acc)
    print(f"[mesh] world 1 (this process, NCCL) {t_mesh1:.1f} s; world 2 (two spawned "
          f"processes, gloo) {t_mesh2:.1f} s, each with its checks and replays")
    mesh_counts = {"mesh-1": mesh_runs1[0]["launches"],
                   **{f"mesh-2-rank{o['rank']}": o["launches"] for o in mesh_runs2}}
    del main_fac, ys, pmask, z_main, refs, main_skels, main_k2, main_scores, mesh_data
    torch.cuda.empty_cache()

    # ---- 9-12. the task paths at paper scale (this slice) -------------- #
    def counted_run(tag, fn):
        """Zero the counts, run ``fn`` (the path: prepare, train, predict)
        with every K1/K4/K2 launch recorded, and read the counts after it."""
        torch.cuda.reset_peak_memory_stats()
        with recording() as rec:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(_build.launch_counts)
        return out, counts, rec, wall, torch.cuda.max_memory_allocated() / 1e9

    def expect_launches(tag, counts, rep, scoring_blocks):
        """K1 once for the leaf D, once per level's couplings, once per
        scoring block; K2 once per level; nothing else."""
        want = {name: 0 for name in counts}
        want["gaussian_block"] = 1 + rep.hss_levels + scoring_blocks
        want["fused_assemble_id"] = rep.hss_levels
        check(counts == want, f"{tag}: launches {counts}, expected {want}")

    def report_line(tag, eng, rep, wall, peak, extra=""):
        print(f"[{tag}] task={eng.task} kernel={eng.spec.name} h={eng.spec.h} rtol={eng.comp.rtol} "
              f"padded={eng.hss.n} levels={rep.hss_levels} beta={rep.beta:g}: compression_s "
              f"{rep.compression_s:.3f}, factorization_s {rep.factorization_s:.3f}, admm_s "
              f"{rep.admm_s:.3f}, {extra}path_s {wall:.3f}, memory_mb {rep.memory_mb:.1f}, "
              f"peak_device_gb {peak:.2f}; ranks_post {list(rep.ranks_post)}, rank_sum "
              f"{rep.rank_sum_pre} -> {rep.rank_sum_post}")

    n_blocks = -(-N_TEST // DEFAULT_SCORE_BLOCK)

    # [multi]: 6-class OVO (15 pair problems on one factorization), C grid
    mdata = synthetic.train_test("multiclass_blobs", N_TRAIN, N_TEST, seed=0,
                                 n_classes=MULTI_CLASSES, sep=MULTI_SEP)
    multi_spec = KernelSpec(h=H_MULTI)
    multi = HSSSVMEngine(spec=multi_spec, comp=crude, leaf_size=LEAF,
                         admm=ADMMParams(max_it=MAX_IT), strategy="ovo", device="cuda")

    def run_multi():
        rep_ = multi.prepare(mdata[0], mdata[1])
        models_ = multi.train_grid(MULTI_CS)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        preds_ = [m.predict(mdata[2]).cpu().numpy() for m in models_]
        return rep_, models_, preds_, time.perf_counter() - t1

    (rep_m, models_m, preds_m, pred_s), multi_counts, rec, wall, peak = counted_run(
        "multi", run_multi)
    accs = {c: float(np.mean(p == mdata[3])) for c, p in zip(MULTI_CS, preds_m)}
    report_line("multi", multi, rep_m, wall, peak,
                f"predict_s {pred_s:.3f} ({len(MULTI_CS)} models), ")
    floor_m = REF_MULTI_ACC - FLOOR_MARGIN
    print(f"[multi] {MULTI_CLASSES} classes, ovo: {multi.n_problems} pair problems, "
          f"accuracy by C {json.dumps(accs)} (need >= {floor_m:.4f} at C {C}: the JAX "
          f"package's {REF_MULTI_ACC} less {FLOOR_MARGIN}); iters_run "
          f"{multi.report.iters_run}; launches {json.dumps(multi_counts)}")
    check(multi.n_problems == MULTI_CLASSES * (MULTI_CLASSES - 1) // 2,
          f"multi: {multi.n_problems} problems")
    check(all(bool(torch.isfinite(m.z_y).all() & torch.isfinite(m.biases).all())
              for m in models_m), "multi: non-finite duals or biases")
    check(all(np.isin(p, np.arange(MULTI_CLASSES)).all() and p.shape == (N_TEST,)
              for p in preds_m), "multi: predictions are not class labels of the test size")
    check(accs[C] >= floor_m, f"multi: accuracy {accs[C]} below {floor_m}")
    expect_launches("multi", multi_counts, rep_m, len(MULTI_CS) * n_blocks)
    mpad_from = float(mdata[0][:, 0].max())
    check_path("multi", rec, multi_spec, crude, K2_PIV_MATCH, 2, mpad_from)
    # K1's scoring blocks times the (2^20, 15) coefficient block of each model
    worst_s = 0.0
    for m, (args, _) in zip(models_m, rec["gaussian_block_cuda"][-len(models_m):]):
        ref_s = gref.gaussian_block_ref(*args) @ m.z_y
        worst_s = max(worst_s, ((gkern.gaussian_block_cuda(*args) @ m.z_y - ref_s).abs().max()
                                / ref_s.abs().max()).item())
    print(f"[check multi] K1 scoring blocks x the ({multi.hss.n}, {multi.n_problems}) "
          f"coefficient block, {len(models_m)} models: max rel err {worst_s:.3e} of the largest "
          f"score (tol {SCORE_RTOL:g})")
    check(worst_s <= SCORE_RTOL, f"check multi: scores disagree: {worst_s}")
    del multi, rec
    torch.cuda.empty_cache()

    # [serve]: the serving tier on [multi]'s three models and [lap]'s
    try:
        serve_counts, k1_serve, k4_serve, serve_out = serve_phase(
            torch, dev, models_m, mdata[2], serve_dir, lap_test, k1_case, k4_case)
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    k1_rows += k1_serve
    k4_rows += k4_serve
    del models_m, mdata, lap_test
    torch.cuda.empty_cache()

    # [svr]: ε-SVR on noisy_sine
    sdata = synthetic.train_test("noisy_sine", N_TRAIN, N_TEST, seed=0, noise=0.1)
    svr = HSSSVMEngine(spec=KernelSpec(h=H_SVR), comp=crude, leaf_size=LEAF,
                       admm=ADMMParams(max_it=MAX_IT), task="svr", svr_c=SVR_C, device="cuda")

    def run_svr():
        rep_ = svr.prepare(sdata[0], sdata[1])
        model_, (z_, _) = svr.train(SVR_EPS)
        return rep_, model_, z_, model_.predict(sdata[2]).cpu().numpy()

    (rep_s, model_s, z_s, pred_sv), svr_counts, rec, wall, peak = counted_run("svr", run_svr)
    rmse = float(np.sqrt(np.mean((pred_sv - sdata[3]) ** 2)))
    r2 = 1.0 - rmse ** 2 / float(np.var(sdata[3]))
    real_s = svr.problem_masks[0] > 0
    nz = float((z_s[:, 0][real_s].abs() > 0).float().mean())
    floor_s = REF_SVR_R2 - FLOOR_MARGIN
    report_line("svr", svr, rep_s, wall, peak)
    print(f"[svr] svr_c {SVR_C} epsilon {SVR_EPS}: R2 {r2:.4f} (need >= {floor_s:.4f}: the JAX "
          f"package's {REF_SVR_R2} less {FLOOR_MARGIN}), rmse {rmse:.4f}, nonzero duals "
          f"{nz:.4f} of the real points; launches {json.dumps(svr_counts)}")
    check(np.isfinite(pred_sv).all() and bool(torch.isfinite(z_s).all()),
          "svr: non-finite predictions or duals")
    check(r2 >= floor_s, f"svr: R2 {r2} below {floor_s}")
    expect_launches("svr", svr_counts, rep_s, n_blocks)
    # every K1 and K2 launch of the path replayed (dense 2-feature data:
    # see K2_PIV_MATCH_DENSE)
    check_launches("svr", rec, svr.spec, crude, K2_PIV_MATCH_DENSE,
                   float(sdata[0][:, 0].max()), asm=True)
    del svr, model_s, z_s, real_s, rec
    torch.cuda.empty_cache()

    # [oneclass]: ν one-class SVM on blobs with 10% outliers
    odata = synthetic.train_test("blobs_with_outliers", N_TRAIN, N_TEST, seed=0,
                                 outlier_frac=0.1)
    onec = HSSSVMEngine(spec=KernelSpec(h=H_OC), comp=crude, leaf_size=LEAF,
                        admm=ADMMParams(max_it=OC_MAX_IT), task="oneclass", device="cuda")

    def run_oc():
        rep_ = onec.prepare(odata[0])
        model_, _ = onec.train(OC_NU)
        return rep_, model_, model_.predict(odata[2]).cpu().numpy()

    (rep_o, model_o, pred_o), oc_counts, rec, wall, peak = counted_run("oneclass", run_oc)
    met = oc_metrics(pred_o, odata[3])
    floor_o = REF_OC_BA - FLOOR_MARGIN
    report_line("oneclass", onec, rep_o, wall, peak)
    print(f"[oneclass] nu {OC_NU}, {OC_MAX_IT} iterations: precision {met['precision']:.4f}, "
          f"recall {met['recall']:.4f}, balanced accuracy {met['balanced_accuracy']:.4f} (need "
          f">= {floor_o:.4f}: the JAX package's {REF_OC_BA} less {FLOOR_MARGIN}), rho "
          f"{-model_o.biases.item():.6g}; launches {json.dumps(oc_counts)}")
    check(np.isin(pred_o, (-1, 1)).all() and bool(torch.isfinite(model_o.z_y).all()),
          "oneclass: predictions not ±1 or non-finite duals")
    check(met["balanced_accuracy"] >= floor_o,
          f"oneclass: balanced accuracy {met['balanced_accuracy']} below {floor_o}")
    expect_launches("oneclass", oc_counts, rep_o, n_blocks)
    # every K1 and K2 launch replayed (4 features: below 8, the 2-feature bar)
    check_launches("oneclass", rec, onec.spec, crude, K2_PIV_MATCH_F2,
                   float(odata[0][:, 0].max()))
    del onec, model_o, odata, rec
    torch.cuda.empty_cache()

    # [gp]: GP posterior mean at two noise levels (one refactorization), the
    # log marginal, the 8 leading eigenpairs
    gp = HSSSVMEngine(spec=KernelSpec(h=H_GP), comp=crude, leaf_size=LEAF, task="gp",
                      device="cuda")

    def run_gp():
        rep_ = gp.prepare(sdata[0], sdata[1])
        out_ = []
        for lam in GP_LAMS:
            f0 = gp.report.factorization_s
            model_, (alpha_, _) = gp.train(lam)
            out_.append((lam, alpha_[:, 0], model_.predict(sdata[2]).cpu().numpy(),
                         gp.report.factorization_s - f0, gp.report.iters_run))
        lml_ = gp.log_marginal(GP_LAMS[0], n_probes=4, num_iters=20, seed=0)
        return rep_, out_, lml_, gp.top_eigenpairs(8)

    (rep_g, solves, lml, (evals, vecs)), gp_counts, rec, wall, peak = counted_run("gp", run_gp)
    report_line("gp", gp, rep_g, wall, peak)
    real_g = gp.problem_masks[0] > 0
    y_g = gp.problem_labels[0]
    ritz = ((gp.hss.matmat(vecs) - vecs * evals[None, :]).norm(dim=0) / evals.abs()).tolist()
    for lam, alpha, pred_g, dfac, iters in solves:
        r = (gp.hss.matvec(alpha) + lam * alpha - y_g)[real_g].norm()
        rel = (r / y_g[real_g].norm()).item()
        eta = (r / ((evals[0] + lam) * alpha.norm() + y_g[real_g].norm())).item()
        rmse_g = float(np.sqrt(np.mean((pred_g - sdata[3]) ** 2)))
        print(f"[gp] lambda {lam}: solve |r|/|y| {rel:.4g} (no bound: K̃ + λI is indefinite "
              f"at the crude preset), backward error {eta:.3e} (tol {GP_BACKWARD_TOL:g}), R2 "
              f"{1.0 - rmse_g ** 2 / float(np.var(sdata[3])):.4f} (no floor), rmse {rmse_g:.4f}, "
              f"refactorization {dfac:.3f} s, iters_run {iters}")
        check(bool(torch.isfinite(alpha).all()) and np.isfinite(pred_g).all(),
              f"gp: non-finite solve or predictions at lambda {lam}")
        check(iters == (0,), f"gp: iters_run {iters}, expected (0,)")
        check(dfac > 0.0, f"gp: lambda {lam} did not refactorize")
        check(eta <= GP_BACKWARD_TOL, f"gp: backward error {eta} at lambda {lam}")
    print(f"[gp] log_marginal(lambda {GP_LAMS[0]}, 4 seeded probes, 20 Lanczos steps) "
          f"{lml:.6g}; top 8 eigenvalues {[round(v, 3) for v in evals.tolist()]}, Ritz "
          f"residuals |K̃v − θv|/|θ| {[f'{v:.2e}' for v in ritz]} (tol {RITZ_RTOL:g}); "
          f"launches {json.dumps(gp_counts)}")
    check(np.isfinite(lml) and bool(torch.isfinite(evals).all() & torch.isfinite(vecs).all()),
          "gp: non-finite log marginal or eigenpairs")
    check(max(ritz) <= RITZ_RTOL, f"gp: Ritz residuals {ritz}")
    expect_launches("gp", gp_counts, rep_g, len(GP_LAMS) * n_blocks)
    check_launches("gp", rec, gp.spec, crude, K2_PIV_MATCH_DENSE,
                   float(sdata[0][:, 0].max()), asm=True)
    del gp, vecs, sdata, rec
    torch.cuda.empty_cache()

    # [baselines]: dense ADMM, Nyström, SMO and the HSS trainer (this slice)
    base_counts, base_rec, base_comp, k1_dense, base_rows = baselines_phase(
        torch, dev, recording)
    # every K1 launch of the four rows (the dense K's 65536² block whole)
    # and the HSS build's K2 levels; no pads (65536 = 512 leaves of 128).
    # K2 to K2_PIV_MATCH_F2: a leaf of 128 points spans ~0.5 of the 4-D
    # circles at h 1, so its |R_ii| reach f32 noise well within the 32
    # steps, as on the 2-feature circles (an H100 read 3 of the 512 leaves
    # off, each a tie that stays greedy).
    check_launches("baselines", {k: OnCard(v) for k, v in base_rec.items()},
                   KernelSpec(h=BASE_H), base_comp, K2_PIV_MATCH_F2, float("inf"))
    k1_dense["max_abs_err"] = block_errs["baselines"][0]
    k1_rows.append(k1_dense)
    del base_rec
    torch.cuda.empty_cache()

    # ---- 13-16. paper-scale builds (this slice) ------------------------ #
    def streamed_batches(levels):
        """Batches of a streamed build of ``levels`` levels, by level below
        the root: the leaves in STREAM_BATCH-node batches, each upper level
        in batches of the even node count at most STREAM_BATCH.  The root
        is one batch more."""
        lvl = max(2, STREAM_BATCH - STREAM_BATCH % 2)
        return [-(-2 ** levels // STREAM_BATCH)] + [-(-(2 ** (levels - k)) // lvl)
                                                   for k in range(1, levels)]

    def hss_tensors(hss):
        return ([hss.x, hss.d_leaf, hss.u_leaf, hss.skel_leaf, *hss.transfers, *hss.skels,
                 *hss.b_mats, *hss.level_ranks]
                + ([hss.leaf_ranks] if hss.leaf_ranks is not None else []))

    def bit_equal(a, b):
        ta, tb = hss_tensors(a), hss_tensors(b)
        return len(ta) == len(tb) and all(torch.equal(u, v) for u, v in zip(ta, tb))

    # [stream]: the out-of-core build at 10^6 points through the engine
    blobs = synthetic.train_test("blobs", N_TRAIN, N_TEST, seed=0,
                                 n_features=N_FEATURES, sep=SEP)
    pad_from = float(blobs[0][:, 0].max())
    st_spec = KernelSpec(h=H)
    stream_engine = HSSSVMEngine(spec=st_spec, comp=crude, leaf_size=LEAF,
                                 admm=ADMMParams(max_it=MAX_IT),
                                 stream=StreamParams(batch_leaves=STREAM_BATCH), device="cuda")
    stream_calls = []
    orig_streamed = compression.compress_streamed

    def streamed_kept(*args, **kw):
        out = orig_streamed(*args, **kw)
        stream_calls.append((args, kw, out))
        return out

    compression.compress_streamed = streamed_kept
    try:
        with recording(to_host=True) as rec:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            rep_st = stream_engine.prepare(blobs[0], blobs[1])
            model_st, (z_st, _) = stream_engine.train(C)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred_st = model_st.predict(blobs[2]).cpu().numpy()
            t2 = time.perf_counter()
            stream_counts = dict(_build.launch_counts)
        # compress_streamed reset the peak at the build's start
        st_path_peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        compression.compress_streamed = orig_streamed
    # The same build again, unrecorded: its seconds without the records'
    # host copies (one per launch), and bit-equal to the recorded build, so
    # the records below are this build's launches too.  After the count.
    s_args, s_kw, (s_hss, _) = stream_calls.pop()
    torch.cuda.synchronize()
    t_u = time.perf_counter()
    hss_t, sst = orig_streamed(*s_args, **s_kw)
    torch.cuda.synchronize()
    st_build_s = time.perf_counter() - t_u
    st_same = bit_equal(hss_t, s_hss)
    del s_args, s_kw, s_hss, hss_t
    torch.cuda.empty_cache()
    acc_st = float(np.mean(pred_st == blobs[3]))
    st_batches = streamed_batches(rep_st.hss_levels)
    leaf_b, level_b = st_batches[0], sum(st_batches[1:])
    want_st = {name: 0 for name in stream_counts}
    want_st["gaussian_block"] = leaf_b + level_b + 1 + n_blocks
    want_st["fused_assemble_id"] = leaf_b + level_b
    print(f"[stream] kernel=gaussian h={H} rtol={crude.rtol} n={N_TRAIN} "
          f"padded={stream_engine.hss.n} levels={rep_st.hss_levels} beta={rep_st.beta:g} "
          f"batch_leaves={STREAM_BATCH}: compression_s {rep_st.compression_s:.3f} (recorded: "
          f"with the records' host copies; the same build unrecorded {st_build_s:.3f} s, "
          f"every tensor equal: {st_same}), factorization_s {rep_st.factorization_s:.3f}, "
          f"admm_s {rep_st.admm_s:.3f}, "
          f"prepare+train_s {t1 - t0:.3f}, predict_s {t2 - t1:.3f}, memory_mb "
          f"{rep_st.memory_mb:.1f}, kernel_evals {rep_st.kernel_evals} (need "
          f"{REF_STREAM['kernel_evals']})")
    print(f"[stream] batches {rep_st.stream_batches} (need {REF_STREAM['batches']}), "
          f"peak_stream_bytes {rep_st.peak_stream_bytes} (a count; need "
          f"{REF_STREAM['peak_stream_bytes']}), level-loop device peak "
          f"{rep_st.stream_device_peak_bytes} bytes measured (need < {STREAM_DEVICE_PEAK_MAX}), "
          f"path peak from the build's start {st_path_peak:.3f} GB (assembly, factorization, "
          f"ADMM, predict); [main]'s resident path peak {path_peaks['main']:.2f} GB")
    print(f"[stream] host seconds of the unrecorded build: gathers and uploads "
          f"{sst.upload_s:.3f}, downloads (each waits for its batch's kernels) "
          f"{sst.download_s:.3f}, over {sst.n_batches} batches")
    print(f"[stream] ranks_pre {list(rep_st.ranks_pre)} -> ranks_post {list(rep_st.ranks_post)}, "
          f"rank_sum {rep_st.rank_sum_pre} -> {rep_st.rank_sum_post} (the JAX package: 32 at "
          f"every level but the last, 28; {REF_STREAM['rank_sum_post']})")
    print(f"[stream] accuracy {acc_st:.4f} (need >= {MIN_ACCURACY} and within "
          f"{STREAM_ACC_MARGIN} of the JAX package's {REF_STREAM_ACC}); launches "
          f"{json.dumps(stream_counts)}")
    check(pred_st.shape == (N_TEST,) and np.isin(pred_st, (-1, 1)).all(),
          "stream: predictions are not a ±1 vector of the test size")
    check(bool(torch.isfinite(z_st).all()) and bool(torch.isfinite(model_st.biases).all()),
          "stream: non-finite duals or bias")
    check(acc_st >= MIN_ACCURACY and abs(acc_st - REF_STREAM_ACC) <= STREAM_ACC_MARGIN,
          f"stream: accuracy {acc_st}")
    check(rep_st.stream_batches == REF_STREAM["batches"] == leaf_b + level_b + 1,
          f"stream: {rep_st.stream_batches} batches")
    check(rep_st.peak_stream_bytes == REF_STREAM["peak_stream_bytes"],
          f"stream: peak_stream_bytes {rep_st.peak_stream_bytes}")
    check(rep_st.kernel_evals == REF_STREAM["kernel_evals"],
          f"stream: kernel_evals {rep_st.kernel_evals}")
    check(rep_st.stream_device_peak_bytes < STREAM_DEVICE_PEAK_MAX,
          f"stream: level-loop device peak {rep_st.stream_device_peak_bytes} bytes")
    check(stream_counts == want_st, f"stream: launches {stream_counts}, expected {want_st}")
    check(st_same, "stream: the unrecorded build differs from the recorded one")

    # [check stream]: every K1 and K2 launch of the path, on the card again
    def check_streamed(tag, rec, levels, spec, pad_from):
        """Hold every K1 and K2 launch of a streamed build (host-kept
        records) against the plain version, K2 summed by level: its leaf and
        level 1, and the build as a whole, need K2_PIV_MATCH of their nodes'
        live pivots equal.  Returns the first K2 launch's comparison."""
        check_blocks(tag, OnCard(rec["gaussian_block_cuda"]), gkern.gaussian_block_cuda,
                     gref.gaussian_block_ref, K1_ATOL, spec, pad_from)
        k2_rec = rec["fused_assemble_id_cuda"]
        groups, start = [], 0
        for k, count in enumerate(streamed_batches(levels)):
            groups.append(("leaf" if k == 0 else f"level {k}", start, start + count))
            start += count
        check(start == len(k2_rec), f"check {tag}: {len(k2_rec)} K2 launches, {start} expected")
        tot_nodes = tot_mism = 0
        first_res = None
        for label, a, b in groups:
            nodes = mism = dropped = 0
            r_err = gap = step_gap = 0.0
            for args, out in OnCard(k2_rec[a:b]):
                res = compare_k2(tag, label, args, out, crude.rtol, None, spec, pad_from,
                                 quiet=True)
                first_res = first_res or res
                nodes += res["nodes"]
                mism += res["mismatches"]
                dropped += res["dropped"]
                r_err = max(r_err, res["r_err"])
                gap, step_gap = max(gap, res["worst_gap"]), max(step_gap, res["worst_step_gap"])
            print(f"[check {tag}] K2 {label}: {b - a} launches of B <= {STREAM_BATCH}, {nodes} "
                  f"nodes ({dropped} with pad-pad entries left out): live-pivot mismatches "
                  f"{mism}, each a rounding tie (worst gap {gap:.3g} of the bound) that stays "
                  f"greedy (worst step {step_gap:.3g}); R max_abs_err {r_err:.3e} "
                  f"(tol {K2_R_ATOL:g})")
            if label in ("leaf", "level 1"):
                check(1 - mism / nodes >= K2_PIV_MATCH,
                      f"K2 {tag} {label}: {mism} of {nodes} differ")
            tot_nodes, tot_mism = tot_nodes + nodes, tot_mism + mism
        print(f"[check {tag}] K2 over the path's {len(k2_rec)} launches: {tot_mism}/{tot_nodes} "
              f"nodes differ on live pivots (need >= {K2_PIV_MATCH:.1%} equal)")
        check(1 - tot_mism / tot_nodes >= K2_PIV_MATCH,
              f"K2 {tag}: {tot_mism} of {tot_nodes} differ")
        return first_res

    first_res = check_streamed("stream", rec, rep_st.hss_levels, st_spec, pad_from)
    k2_rec = rec["fused_assemble_id_cuda"]
    # K2's plan at each distinct batch shape of the path, its time at that
    # plan (times the shape's launches: the build's estimate), and the
    # 16-node leaf batch at every cluster size that fits
    shapes = {}
    for args, _ in k2_rec:
        key = (args[0].shape[0], args[0].shape[1], args[1].shape[1], args[3])
        shapes.setdefault(key, [args, 0])[1] += 1
    est_ms = est_bound = 0.0
    plans = {}
    for (b, m, s_, k), (args, count) in shapes.items():
        c, tpc, rreg, smem, active = k2_plan(args)
        ms = k2_time(moved(args, dev), 20)
        bms = bound(*k2_cost(b, m, s_, args[0].shape[2], k, args[5]))[0]
        est_ms, est_bound = est_ms + count * ms, est_bound + count * bms
        plans[f"B={b} m={m} s={s_} k={k}"] = c
        print(f"[kernels] K2 stream shape B={b} m={m} s={s_} k={k}: {count} launches, plan C={c} "
              f"TPC={tpc} register rows {rreg}, smem {smem} B/CTA, {active} clusters "
              f"co-resident; kernel {ms:.4f} ms, bound {bms:.4f} ms")
    k2_builds["stream"] = dict(launches=len(k2_rec), ms=est_ms, bound_ms=est_bound,
                               clusters=plans, estimate="per-shape time x launches")
    print(f"[kernels] K2 stream build: {len(k2_rec)} launches, kernel {est_ms:.4f} ms (each "
          f"shape's time x its launches), bound {est_bound:.4f} ms")
    (args0, out0) = k2_rec[0]
    k2_rows.append(k2_row("stream", f"leaf batch of {STREAM_BATCH}", moved(args0, dev), 20, 5,
                          dict(max_abs_err=first_res["r_err"],
                               pivot_mismatches=first_res["mismatches"],
                               untied_mismatches=first_res["untied"])))
    xa0 = moved(rec["gaussian_block_cuda"][0][0][0], dev)
    k1_rows.append(k1_case(f"stream leaf D batch of {STREAM_BATCH}", xa0, xa0, 50,
                           pads=pad_pairs(xa0, xa0, st_spec, pad_from)))
    del rec, k2_rec, shapes, args0, out0, xa0
    torch.cuda.empty_cache()

    # [multilevel] and [adaptive-rho] on [stream]'s prepared engine
    def big_run(tag, fn):
        """Zero the counts, train (``fn``), predict, read the counts; the
        block's launches recorded for the check that follows."""
        with recording() as rec:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            model, info = fn()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            pred = model.predict(blobs[2]).cpu().numpy()
            counts = dict(_build.launch_counts)
        acc_ = float(np.mean(pred == blobs[3]))
        check(np.isin(pred, (-1, 1)).all() and bool(torch.isfinite(model.z_y).all()),
              f"{tag}: predictions not ±1 or non-finite duals")
        check(acc_ >= MIN_ACCURACY, f"{tag}: accuracy {acc_} below {MIN_ACCURACY}")
        return info, counts, acc_, t1 - t0, rec

    want_score = {name: 0 for name in stream_counts}
    want_score["gaussian_block"] = n_blocks
    stream_engine.admm = ADMMParams(max_it=ML_MAX_IT, tol=ML_TOL)
    _, cold_counts, acc_cold, cold_s, rec = big_run(
        "multilevel", lambda: (stream_engine.train(C)[0], None))
    cold_iters = stream_engine.report.iters_run[0]
    check(cold_counts == want_score, f"multilevel: cold launches {cold_counts}")
    check_blocks("multilevel cold", rec["gaussian_block_cuda"], gkern.gaussian_block_cuda,
                 gref.gaussian_block_ref, K1_ATOL, st_spec, pad_from)
    del rec
    info, ml_counts, acc_ml, ml_s, rec = big_run(
        "multilevel", lambda: stream_engine.train_multilevel(C, coarse_frac=BIG_COARSE_FRAC))
    coarse_levels = tree_mod.pad_dataset(np.zeros((info["coarse_n"], 1), np.float32),
                                         np.zeros(info["coarse_n"], np.float32),
                                         min(LEAF, 64))[3]
    want_ml = dict(want_score, gaussian_block=1 + coarse_levels + n_blocks,
                   fused_assemble_id=coarse_levels)
    print(f"[multilevel] n={N_TRAIN} tol {ML_TOL} max_it {ML_MAX_IT} beta {rep_st.beta:g}: cold "
          f"train {cold_iters} iterations {cold_s:.3f} s (accuracy {acc_cold:.4f}); "
          f"train_multilevel(coarse_frac={BIG_COARSE_FRAC}): coarse_n {info['coarse_n']} "
          f"({coarse_levels} levels, leaf {min(LEAF, 64)}), coarse iterations "
          f"{info['coarse_iters_run'][0]}, fine iterations {info['iters_run'][0]}, {ml_s:.3f} s "
          f"in all (coarse build, coarse train, prolongation, fine train); accuracy "
          f"{acc_ml:.4f} (need >= {MIN_ACCURACY}); launches {json.dumps(ml_counts)}")
    check(ml_counts == want_ml, f"multilevel: launches {ml_counts}, expected {want_ml}")
    # the coarse engine's leaf D, couplings and K2 levels, and the fine
    # scoring (the coarse pads lie beyond every real point too)
    check_launches("multilevel", rec, st_spec, crude, K2_PIV_MATCH, pad_from)
    del rec
    torch.cuda.empty_cache()

    fac_calls = []
    orig_factorize = factorization.factorize

    def timed_factorize(hss, beta, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_factorize(hss, beta, **kw)
        torch.cuda.synchronize()
        fac_calls.append((float(beta), time.perf_counter() - t0))
        return out

    def beta_probe(engine, floor):
        """Fixed-β ADMM on the engine's K̃ (the knobs of the adaptive run)
        just above |λ_min|, inside (|λ_min|, 2|λ_min|), and at the floor:
        {label: (β, duals finite and iterations to tol, first non-finite
        residual and the last primal residual of ML_MAX_IT iterations
        without tol)}.  Runs no kernel."""
        task_b = admm_mod.svm_task(engine.problem_labels, C * engine.problem_masks)
        out = {}
        for label, frac in (("1.05 |lambda_min|", 0.525), ("1.5 |lambda_min|", 0.75),
                            ("the floor", 1.0)):
            b = frac * floor
            solve = factorization.factorize(engine.hss, b).solve_mat
            st_b, tr_b = admm_mod.admm_boxqp(solve, task_b, b, ML_MAX_IT, tol=ML_TOL)
            _, tr_n = admm_mod.admm_boxqp(solve, task_b, b, ML_MAX_IT)
            bad = (~torch.isfinite(tr_n.primal_res[:, 0])).nonzero()
            out[label] = (b, bool(torch.isfinite(st_b.z).all()), int(tr_b.iters_run[0]),
                          int(bad[0]) + 1 if len(bad) else None, float(tr_n.primal_res[-1, 0]))
            del solve, st_b, tr_b, tr_n
        return out

    def probe_line(probe):
        return "; ".join(
            f"{label} = {b:.4g}: duals finite {ok}, {it} iterations to tol; without tol first "
            f"non-finite residual at iteration {nan_at}, primal residual after {ML_MAX_IT} "
            f"{res:.4g}" for label, (b, ok, it, nan_at, res) in probe.items())

    beta0 = float(stream_engine.fac.beta)
    # the floor of the downward rescales: 2 |least eigenvalue of K̃| (Lanczos)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rho_floor = stream_engine.rho_floor()
    torch.cuda.synchronize()
    floor_s = time.perf_counter() - t0
    guarded = dataclasses.replace(rho_params, rho_guard=True)
    stream_engine.admm = guarded
    factorization.factorize = timed_factorize
    try:
        _, rho_counts, acc_rho, rho_s, rec = big_run(
            "adaptive-rho", lambda: (stream_engine.train(C)[0], None))
    finally:
        factorization.factorize = orig_factorize
    rep_rho = stream_engine.report
    visited = [b for b, _ in fac_calls]
    print(f"[adaptive-rho] n={N_TRAIN} tol {ML_TOL} max_it {ML_MAX_IT} from beta {beta0:g}, "
          f"every {guarded.rho_every} iterations, at most {guarded.rho_max_updates} "
          f"rescales, rho_guard on: none below the floor {rho_floor:.4g} (2 |least eigenvalue "
          f"of K̃| from Lanczos, {floor_s:.3f} s): {rep_rho.iters_run[0]} iterations, "
          f"{rep_rho.rho_rescales} rescales, final beta {rep_rho.rho_final:g}, {rho_s:.3f} s in "
          f"all; factorizations built {[(b, round(t, 4)) for b, t in fac_calls]} (beta, s); "
          f"cached betas {list(stream_engine._fac_cache)}; accuracy {acc_rho:.4f} (need >= "
          f"{MIN_ACCURACY}); launches {json.dumps(rho_counts)}")
    check(rep_rho.rho_rescales <= guarded.rho_max_updates,
          f"adaptive-rho: {rep_rho.rho_rescales} rescales")
    check(min(visited, default=beta0) >= rho_floor and rep_rho.rho_final >= rho_floor,
          f"adaptive-rho: a beta below the floor {rho_floor}: {visited}")
    check(len(visited) == len(set(visited)) and beta0 not in visited
          and set(stream_engine._fac_cache) == {beta0, *visited},
          f"adaptive-rho: factorizations {visited} for the visited betas "
          f"{list(stream_engine._fac_cache)}")
    check(rho_counts == want_score, f"adaptive-rho: launches {rho_counts}")
    check_blocks("adaptive-rho", rec["gaussian_block_cuda"], gkern.gaussian_block_cuda,
                 gref.gaussian_block_ref, K1_ATOL, st_spec, pad_from)
    del rec
    # The reference's loop on the same K̃ (the engine's default, no floor;
    # ROADMAP queue 3): reported, not held.  Outside the counted run; it
    # launches no kernel (no predict).
    stream_engine._fac_cache = {beta0: stream_engine.fac}
    stream_engine.admm = rho_params
    try:
        _, (z_ref, _) = stream_engine.train(C)
        ref_out = (f"{stream_engine.report.iters_run[0]} iterations, "
                   f"{stream_engine.report.rho_rescales} rescales, final beta "
                   f"{stream_engine.report.rho_final:g}, duals finite "
                   f"{bool(torch.isfinite(z_ref).all())}")
        del z_ref
    except torch.linalg.LinAlgError as e:     # a factorization of an indefinite K̃ + βI
        ref_out = f"raised {type(e).__name__}: {str(e)[:120]}"
    print(f"[adaptive-rho] the reference's loop (rho_guard off) on the same K̃: {ref_out}; "
          f"betas visited {list(stream_engine._fac_cache)}")
    stream_engine._fac_cache = {beta0: stream_engine.fac}
    torch.cuda.empty_cache()
    # The floor's reason, on this K̃: fixed-β ADMM below and at the floor.
    # Outside the counted run.
    probe = beta_probe(stream_engine, rho_floor)
    print(f"[adaptive-rho] fixed beta on the same K̃: {probe_line(probe)}")
    check(probe["the floor"][1] and probe["the floor"][2] < ML_MAX_IT,
          f"adaptive-rho: fixed-beta ADMM at the floor does not converge: {probe}")
    del stream_engine, model_st, z_st, blobs
    torch.cuda.empty_cache()
    # ... and on a second K̃: another size and seed (resident, no scoring)
    data2 = synthetic.train_test("blobs", FLOOR_N2, N_TEST, seed=FLOOR_SEED2,
                                 n_features=N_FEATURES, sep=SEP)
    eng2 = HSSSVMEngine(spec=st_spec, comp=crude, leaf_size=LEAF, device="cuda")
    eng2.prepare(data2[0], data2[1])
    floor2 = eng2.rho_floor()
    probe2 = beta_probe(eng2, floor2)
    print(f"[adaptive-rho] a second K̃, n={FLOOR_N2} seed {FLOOR_SEED2}: floor {floor2:.4g}; "
          f"fixed beta {probe_line(probe2)}")
    check(floor2 > 0.0 and probe2["the floor"][1] and probe2["the floor"][2] < ML_MAX_IT,
          f"adaptive-rho: fixed-beta ADMM at the second K̃'s floor does not converge: {probe2}")
    del eng2, data2
    torch.cuda.empty_cache()

    # [stream-resume]: 2^17 points, checkpointed level by level
    rdata = synthetic.train_test("blobs", RESUME_N, N_TEST, seed=0, n_features=N_FEATURES,
                                 sep=SEP)
    x_pad, _, _, r_levels = tree_mod.pad_dataset(rdata[0], rdata[1].astype(np.float32), LEAF)
    r_tree = tree_mod.build_tree(x_pad, LEAF, r_levels)
    xr = x_pad[r_tree.perm]

    def rbuild(on_level=None, **kw):
        return compression.compress_streamed(
            xr, r_tree, st_spec, crude, StreamParams(batch_leaves=STREAM_BATCH, **kw),
            on_level=on_level, device="cuda")

    dirs = [tempfile.mkdtemp(prefix="chip_smoke_resume_") for _ in range(2)]
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        hss_a, st_a = rbuild()
        t_a = time.perf_counter() - t0
        # the engine's build of the same points, its launches recorded
        eng_r = HSSSVMEngine(spec=st_spec, comp=crude, leaf_size=LEAF,
                             admm=ADMMParams(max_it=MAX_IT),
                             stream=StreamParams(batch_leaves=STREAM_BATCH), device="cuda")
        compression.compress_streamed = streamed_kept
        try:
            with recording(to_host=True) as rec:
                rep_r = eng_r.prepare(rdata[0], rdata[1])
                model_r, _ = eng_r.train(C)
                acc_r = float(np.mean(model_r.predict(rdata[2]).cpu().numpy() == rdata[3]))
        finally:
            compression.compress_streamed = orig_streamed
        t0 = time.perf_counter()
        hss_b, st_b = rbuild(FailureInjector(fail_at=(RESUME_FAIL_IN_PROCESS,)).check,
                             ckpt_dir=dirs[0])
        t_b = time.perf_counter() - t0
        raised = None
        try:
            rbuild(FailureInjector(fail_at=(RESUME_FAIL_FRESH,)).check, ckpt_dir=dirs[1],
                   max_restarts=0)
        except InjectedFailure as e:
            raised = repr(e)      # not the exception: its traceback holds the build
        hss_c, st_c = rbuild(ckpt_dir=dirs[1])
        torch.cuda.synchronize()
        resume_counts = dict(_build.launch_counts)
        disk = [sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file()) for d in dirs]
        manifest = Path(dirs[0]) / f"step_{r_levels + 1:08d}" / "manifest.json"
        codec = json.loads(manifest.read_text())["codec"]
    finally:
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    eq_b, eq_c = bit_equal(hss_b, hss_a), bit_equal(hss_c, hss_a)
    eq_eng = bit_equal(stream_calls.pop()[2][0], hss_a)
    r_batches = streamed_batches(r_levels)
    leaf_r, level_r = r_batches[0], sum(r_batches[1:])
    want_r = {name: 0 for name in resume_counts}
    want_r["gaussian_block"] = 4 * (leaf_r + level_r + 1) + n_blocks
    want_r["fused_assemble_id"] = 4 * (leaf_r + level_r)
    have_zstd = importlib.util.find_spec("zstandard") is not None
    print(f"[stream-resume] n={RESUME_N} padded={r_tree.n} levels={r_levels}: (a) uninterrupted "
          f"build {t_a:.3f} s ({st_a.n_batches} batches, host up {st_a.upload_s:.3f} s, down "
          f"{st_a.download_s:.3f} s, level-loop device peak {st_a.device_peak_bytes} bytes); "
          f"engine batches {rep_r.stream_batches} (need {REF_RESUME['batches']}), kernel_evals "
          f"{rep_r.kernel_evals} (need {REF_RESUME['kernel_evals']}), its build's every tensor "
          f"equal to (a): {eq_eng}, accuracy {acc_r:.4f} (need >= {MIN_ACCURACY})")
    print(f"[stream-resume] (b) failure at level {RESUME_FAIL_IN_PROCESS}, restarted in "
          f"process: {t_b:.3f} s, restarts {st_b.restarts}, resumed_level {st_b.resumed_level}, "
          f"every tensor equal to (a): {eq_b}; checkpoints save {st_b.ckpt_save_s:.3f} s, load "
          f"{st_b.ckpt_load_s:.3f} s, {disk[0]} bytes on disk")
    print(f"[stream-resume] (c) failure at level {RESUME_FAIL_FRESH} with max_restarts=0 raised "
          f"{raised}; a fresh call resumed_level {st_c.resumed_level}, restarts "
          f"{st_c.restarts}, every tensor equal to (a): {eq_c}; its checkpoints save "
          f"{st_c.ckpt_save_s:.3f} s, load {st_c.ckpt_load_s:.3f} s; {disk[1]} bytes on disk "
          f"after both calls; codec {codec!r} (zstandard importable: {have_zstd}); launches "
          f"{json.dumps(resume_counts)}")
    check(acc_r >= MIN_ACCURACY, f"stream-resume: accuracy {acc_r}")
    check(rep_r.stream_batches == REF_RESUME["batches"] == leaf_r + level_r + 1
          and rep_r.kernel_evals == REF_RESUME["kernel_evals"],
          f"stream-resume: batches {rep_r.stream_batches}, kernel_evals {rep_r.kernel_evals}")
    check(st_b.restarts == 1 and st_b.resumed_level == RESUME_FAIL_IN_PROCESS and eq_b,
          "stream-resume: the in-process restart is not bit-identical to the uninterrupted build")
    check(raised is not None and raised.startswith("InjectedFailure("),
          f"stream-resume: the failing call raised {raised}")
    check(st_c.resumed_level == RESUME_FAIL_FRESH and st_c.restarts == 0 and eq_c,
          "stream-resume: the fresh call's resume is not bit-identical to the uninterrupted build")
    check(codec == ("zstd" if have_zstd else "raw"), f"stream-resume: codec {codec}")
    check(resume_counts == want_r, f"stream-resume: launches {resume_counts}, expected {want_r}")
    check(eq_eng, "stream-resume: the engine's streamed build differs from the uninterrupted one")
    # every launch of the engine's run (build and scoring); the four builds
    # above repeat its build bit for bit
    check_streamed("stream-resume", rec, r_levels, st_spec, float(rdata[0][:, 0].max()))
    del hss_a, hss_b, hss_c, eng_r, model_r, rdata, x_pad, xr, rec
    torch.cuda.empty_cache()

    # ---- 17-20. the LM serving path ----------------------------------- #
    lm_kernels, lm_counts = lm_phases(torch, dev)
    # ---- 21-23. the attention families -------------------------------- #
    family_counts, k5_family_err = lm_family_phases(torch, dev)
    # ---- 25-28. LM training ------------------------------------------- #
    train_counts = train_phases(torch, dev)
    # ---- 29-33. the mesh LM and the streamed build on a mesh ----------- #
    lm_mesh_counts, k5_mesh_err, k6_mesh_err = lm_mesh_phases(torch, dev)
    # ---- 37. the dry run (after the mesh phases, whose host-bound gloo
    # ranks it would otherwise slow) ------------------------------------ #
    dryrun_phase(dryrun_start())

    # ---- 16. summary -------------------------------------------------- #
    by_path = {"main": main_counts, "lap": lap_counts, "accurate": acc_counts,
               "k3-path": k3_counts, "multi": multi_counts, "svr": svr_counts,
               "oneclass": oc_counts, "gp": gp_counts, "stream": stream_counts,
               "multilevel": ml_counts, "adaptive-rho": rho_counts,
               "stream-resume": resume_counts, "serve": serve_counts,
               "baselines": base_counts, "lm": lm_counts, **family_counts, **train_counts,
               **mesh_counts, **lm_mesh_counts}

    def entry(name, source, replaces, path, main_row, rows_all, **extra):
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=by_path[path][name], launches_path=path,
                    launches_by_path={p: c[name] for p, c in by_path.items()},
                    shape=main_row["shape"],
                    max_abs_err=max(r["max_abs_err"] for r in rows_all),
                    ms=main_row["ms"], plain_ms=main_row["plain_ms"],
                    bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
                    library_ms=None, per_shape=rows_all, **extra)

    kernels = [
        entry("gaussian_block", "src/repro_torch/csrc/gaussian_block.cu",
              "src/repro/kernels/gaussian/kernel.py:37", "main", k1_rows[2], k1_rows),
        entry("fused_assemble_id", "src/repro_torch/csrc/fused_assemble_id.cu",
              "src/repro/kernels/compress/kernel.py:142", "main", k2_rows[0], k2_rows,
              per_build=k2_builds),
        entry("zmu_update", "src/repro_torch/csrc/zmu_update.cu",
              "src/repro/kernels/admm_update/kernel.py:28", "k3-path", k3_row, [k3_row]),
        entry("laplacian_block", "src/repro_torch/csrc/laplacian_block.cu",
              "src/repro/kernels/compress/laplacian.py:47", "lap", k4_rows[2], k4_rows),
    ] + lm_kernels
    for e in lm_kernels:          # K5 and K6 on every path (0 off the LM paths)
        e["launches_by_path"] = {p: c[e["name"]] for p, c in by_path.items()}
        # the serving path's launches, and the training paths' added
        e["launches_path"] = "lm, train, train-moe"
        e["launches"] = sum(by_path[p][e["name"]] for p in ("lm", "train", "train-moe"))
    lm_kernels[0]["max_abs_err"] = max(lm_kernels[0]["max_abs_err"], k5_family_err,
                                       k5_mesh_err)
    lm_kernels[1]["max_abs_err"] = max(lm_kernels[1]["max_abs_err"], k6_mesh_err)
    # K5 on each rank of [lm-mesh] (granite at full size, (1, 2) mesh)
    lm_kernels[0]["launches_lm_mesh_per_rank"] = [
        by_path[f"lm-mesh-rank{r}"]["flash_attention"] for r in range(2)]
    # the sharded serving paths (slice 11): K5 on each rank's heads, K6 a rank
    for e in lm_kernels:
        e["launches_lm_mesh_serve_per_rank"] = {
            p: by_path[p][e["name"]] for p in by_path if p.startswith("lm-mesh-serve")}
    print(f"[summary] card {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
