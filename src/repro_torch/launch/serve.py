"""Serving entry point of the port: batched LM prefill + greedy decode, or
kernel box-QP scoring through the serving tier.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --preset tiny \\
      --device cpu --batch 2 --prompt-len 32 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b --preset full \\
      --batch 2 --prompt-len 4608 --gen 32

  PYTHONPATH=src python -m repro_torch.launch.serve --task svm \\
      --svm-classes 4 --svm-train 8192 --batch 256 --requests 50
  PYTHONPATH=src python -m repro_torch.launch.serve --task svr|oneclass|krr|gp \\
      --batch 256 [--registry DIR] [--prune-tol 1e-3] [--serve-dtype bfloat16]

The twin of ``repro.launch.serve``.  The LM path serves every decoder
family (dense, moe, ssm, hybrid, vlm; an encoder-only arch exits, as the
reference's does): weights from ``Model.init`` with a generator seeded 0
on the serving device, prompt tokens from ``numpy.random.default_rng(0)``
(vlm: then the patches), one prefill and ``--gen`` greedy decode steps.
On a CUDA device prefill runs K5 (every attention) and K6 (the SSD scan);
decode runs plain torch.

The kernel paths train one model on ONE shared HSS factorization
(``HSSSVMEngine``) and serve it through ``serve.ServingEngine``: ``--task
svm`` is k-class classification, ``svr`` ε-SVR regression values on the
noisy sine, ``oneclass`` ν one-class novelty scores on blobs with
outliers, ``krr``/``gp`` kernel ridge / GP posterior-mean values from one
multi-RHS solve (the knobs are --svm-c, --svm-eps, --svm-nu, --svm-lam).
``--registry DIR`` round-trips the model through the persistent registry
(``--prune-tol`` prunes support vectors on load); ``--serve-dtype
bfloat16`` evaluates the score blocks from bf16 operands.  On a CUDA device
every f32 tick runs K1 through one captured CUDA graph per bucket.
``--svm-mesh`` trains the model node-split over a mesh of every rank
(``repro_torch.dist.api``; under ``torchrun`` NCCL on ``cuda:LOCAL_RANK``
or gloo on the CPU, without it one rank), then gathers it once into the
serving tier, which serves in each process; rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._lazy_import import import_dynamo_aside


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_group(name: str) -> str:
    if "flash_fwd" in name:
        return "K5 flash_attention"
    if "ssd_chunk" in name:
        return "K6 ssd_chunk"
    if "pairwise_block" in name:
        return "K1/K4 pairwise_block"
    if any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def profile_device(device: torch.device, fn) -> dict:
    """Device time of ``fn`` by kernel group and the device's busy share of
    the window, from one ``torch.profiler`` trace (CUDA only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import_dynamo_aside()          # the profiler's first use imports it
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    groups: dict[str, list] = {}
    busy, end = 0.0, float("-inf")
    for start, stop, name in spans:
        g = groups.setdefault(_kernel_group(name), [0.0, 0])
        g[0] += (stop - start) / 1e3
        g[1] += 1
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return dict(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                busy_share=busy / wall_us if wall_us else 0.0,
                groups={k: dict(ms=v[0], kernels=v[1]) for k, v in
                        sorted(groups.items(), key=lambda kv: -kv[1][0])})


def lm_setup(args):
    """The LM path's model and prompt: (cfg, model, batch, max_len).

    Weights from ``Model.init`` with a generator seeded 0 on the serving
    device; tokens from ``numpy.random.default_rng(0)``, then (vlm) the
    patches from the same rng, whose prefix the cache also holds."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.transformer import Model

    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = cfg.reduced()
    if not cfg.is_decoder:
        raise SystemExit("encoder-only arch has no decode step")
    device = torch.device(args.device)
    model = Model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.gen
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)), device=device)}
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.as_tensor(rng.normal(
            size=(args.batch, cfg.n_prefix_tokens, cfg.frontend_dim)),
            dtype=torch.float32, device=device)
        max_len += cfg.n_prefix_tokens
    return cfg, model, batch, max_len


def serve_lm(args) -> dict:
    """Run the LM serving path; print and return its numbers."""
    from repro_torch.kernels import _build

    cfg, model, batch, max_len = lm_setup(args)
    device = model.device
    for _ in range(args.warmup):
        model.prefill(batch, max_len)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _sync(device)
    counts0 = dict(_build.launch_counts)
    t0 = time.perf_counter()
    logits, cache = model.prefill(batch, max_len)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    counts1 = dict(_build.launch_counts)

    generated = []
    nxt = logits.argmax(-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(args.gen):
        generated.append(nxt[:, 0])
        logits, cache = model.decode_step(cache, nxt)
        nxt = logits.argmax(-1)[:, None]
    _sync(device)
    t_decode = time.perf_counter() - t0
    counts2 = dict(_build.launch_counts)

    toks = torch.stack(generated, dim=1).cpu().numpy() if generated else \
        np.zeros((args.batch, 0), np.int64)
    tok_s = args.gen * args.batch / max(t_decode, 1e-9)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    out = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        compute_dtype=cfg.compute_dtype, device=str(device), batch=args.batch,
        prompt_len=args.prompt_len, gen=args.gen, prefill_ms=t_prefill * 1e3,
        decode_ms=t_decode * 1e3, tok_per_s=tok_s, peak_device_bytes=peak,
        launches_prefill={k: counts1[k] - counts0[k] for k in counts0},
        launches_decode={k: counts2[k] - counts1[k] for k in counts0},
        tokens=toks, last_logits=logits)
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill * 1e3:.1f}ms")
    print(f"decode: {args.gen} steps x batch {args.batch} in {t_decode * 1e3:.1f}ms "
          f"({tok_s:.1f} tok/s)")
    if peak is not None:
        print(f"peak device memory: {peak / 2 ** 30:.2f} GiB")
    print("sample token ids:", toks[0][:12].tolist())
    if args.profile:
        if device.type != "cuda":
            raise SystemExit("--profile traces the CUDA device: pass --device cuda")
        cache2: dict = {}

        def prefill():
            cache2["c"] = model.prefill(batch, max_len)[1]

        step = torch.as_tensor(toks[:, :1], device=device)
        out["profile"] = {"prefill": profile_device(device, prefill),
                          "decode step": profile_device(
                              device, lambda: model.decode_step(cache2["c"], step))}
        for phase, prof in out["profile"].items():
            print(f"profile {phase}: wall {prof['wall_ms']:.3f} ms, device busy "
                  f"{prof['busy_ms']:.3f} ms ({prof['busy_share']:.1%}); " + "; ".join(
                      f"{k} {v['ms']:.3f} ms in {v['kernels']} kernels"
                      for k, v in prof["groups"].items()))
    return out


def serve_svm(args) -> dict:
    """Train one kernel model, serve ``--requests`` requests of ``--batch``
    points through the serving tier; print and return its numbers (under
    ``--svm-mesh``, trained inside a mesh of every rank)."""
    if not args.svm_mesh:
        return _serve_svm(args, torch.device(args.device), None)
    from repro_torch.dist.api import process_group_mesh

    with process_group_mesh(args.device) as mesh:
        if mesh.rank == 0:
            print(mesh.describe())
        return _serve_svm(args, mesh.device, mesh)


def _serve_svm(args, device, mesh) -> dict:
    from repro_torch.core.admm import ADMMParams
    from repro_torch.core.compression import CompressionParams
    from repro_torch.core.engine import HSSSVMEngine
    from repro_torch.core.kernelfn import KernelSpec
    from repro_torch.core.tasks import oneclass_metrics
    from repro_torch.data import synthetic
    from repro_torch.serve import BatchPolicy, ModelRegistry, ServingEngine

    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    task = args.task
    n_test = max(args.batch, 512)
    # --svm-h defaults to a task-appropriate value for the built-in demo
    # dataset; an explicit value always wins.
    if task in ("svr", "krr", "gp"):
        xtr, ytr, xte, yte = synthetic.train_test(
            "noisy_sine", n_train=args.svm_train, n_test=n_test, seed=0, noise=0.1)
        knob = args.svm_eps if task == "svr" else args.svm_lam
        h = 1.0 if args.svm_h is None else args.svm_h
    elif task == "oneclass":
        xtr, ytr = synthetic.blobs_with_outliers(args.svm_train, n_features=4,
                                                 outlier_frac=0.1, seed=0)
        xte, yte = synthetic.blobs_with_outliers(n_test, n_features=4, outlier_frac=0.1,
                                                 seed=1)
        knob, h = args.svm_nu, 2.0 if args.svm_h is None else args.svm_h
    else:
        xtr, ytr, xte, yte = synthetic.train_test(
            "multiclass_blobs", n_train=args.svm_train, n_test=n_test, seed=0,
            n_classes=args.svm_classes, sep=3.0)
        knob, h = args.svm_c, 1.5 if args.svm_h is None else args.svm_h

    t0 = time.perf_counter()
    engine = HSSSVMEngine(
        spec=KernelSpec(h=h), comp=CompressionParams(rank=32, n_near=48, n_far=64),
        leaf_size=256, admm=ADMMParams(max_it=30 if task == "oneclass" else 10),
        task=task, svr_c=args.svm_c, device=device, mesh=mesh)
    model = engine.fit(xtr, None if task == "oneclass" else ytr, c_value=knob)
    _sync(device)
    t_train = time.perf_counter() - t0
    pred = model.predict(xte).cpu().numpy()
    out = dict(task=task, device=str(device), n_train=args.svm_train, knob=knob, h=h,
               train_s=t_train, mesh_ranks=engine.report.mesh_ranks)
    if task in ("svr", "krr", "gp"):
        out["rmse"] = float(np.sqrt(np.mean((pred - yte) ** 2)))
        quality = f"holdout rmse {out['rmse']:.4f}"
        if task == "svr":
            head = f"ε-SVR (ε={knob})"
        else:
            quality += f", admm iters {engine.report.iters_run}"
            head = f"{'KRR' if task == 'krr' else 'GP mean'} (λ={knob})"
    elif task == "oneclass":
        m = oneclass_metrics(pred, yte)
        out.update(precision=m["precision"], recall=m["recall"])
        quality = f"outlier precision {m['precision']:.3f} / recall {m['recall']:.3f}"
        head = f"one-class SVM (ν={knob})"
    else:
        out["accuracy"] = float(np.mean(pred == yte))
        quality = f"holdout acc {out['accuracy']:.4f}"
        head = f"{args.svm_classes}-class SVM (C={knob})"
    rep = engine.report
    say(f"trained {head} on {args.svm_train} pts in {t_train:.1f}s (compress "
        f"{rep.compression_s:.1f}s / factor {rep.factorization_s:.2f}s / batched ADMM "
        f"{rep.admm_s:.2f}s), {quality}")

    # The request loop through the serving tier: ServingEngine.score is the
    # one scoring entry point for every task decode.  --registry round-trips
    # the model through the persistent registry first.  A mesh model is
    # gathered once on every rank; rank 0 writes the registry.
    model = model.gathered()
    registry = None
    if args.registry:
        registry = ModelRegistry(args.registry)
        if mesh is None or mesh.rank == 0:
            version = registry.save(task, model)
            say(f"registered model {task!r} v{version} under {args.registry}")
        if mesh is not None:
            torch.distributed.barrier(mesh.group)
    serve = ServingEngine(policy=BatchPolicy(compute_dtype=args.serve_dtype),
                          registry=registry, device=device)
    mid = (serve.load(task, prune_tol=args.prune_tol) if registry is not None
           else serve.add_model(model))

    rng = np.random.default_rng(1)
    serve.score(mid, xte[:args.batch])          # first tick (graph capture) untimed
    serve.drain_latencies()
    t_serve = time.perf_counter()
    for _ in range(args.requests):
        idx = rng.integers(0, xte.shape[0], size=args.batch)
        scores, _ = serve.score(mid, xte[idx])
    t_serve = time.perf_counter() - t_serve
    lat_ms = np.sort(np.array(serve.drain_latencies())) * 1e3
    qps = args.requests * args.batch / max(t_serve, 1e-9)
    p50, p95 = lat_ms[len(lat_ms) // 2], lat_ms[int(len(lat_ms) * 0.95) - 1]
    per_pass = (f"{args.svm_classes} classes" if task == "svm"
                else {"svr": "regression values", "krr": "regression values",
                      "gp": "posterior means", "oneclass": "novelty scores"}[task])
    say(f"served {args.requests} requests x batch {args.batch}: {qps:.0f} points/s, "
        f"latency p50 {p50:.2f}ms p95 {p95:.2f}ms ({per_pass} per pass)")
    out.update(requests=args.requests, batch=args.batch, points_per_s=qps,
               p50_ms=float(p50), p95_ms=float(p95), last_scores=scores,
               stats=serve.stats())
    return out


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", default="lm",
                    choices=["lm", "svm", "svr", "oneclass", "krr", "gp"])
    ap.add_argument("--arch", default=None, help="LM arch (required for lm)")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warmup", type=int, default=0,
                    help="untimed prefills before the timed one")
    ap.add_argument("--profile", action="store_true",
                    help="then trace one prefill and one decode step with torch.profiler: "
                         "device time by kernel group and the device's busy share")
    ap.add_argument("--requests", type=int, default=20)
    ap.add_argument("--svm-classes", type=int, default=4)
    ap.add_argument("--svm-train", type=int, default=8192)
    ap.add_argument("--svm-h", type=float, default=None,
                    help="kernel bandwidth (default: per-task demo value "
                         "1.5 svm / 1.0 svr, krr, gp / 2.0 oneclass)")
    ap.add_argument("--svm-c", type=float, default=1.0,
                    help="C (svm); the SVR box bound (svr)")
    ap.add_argument("--svm-eps", type=float, default=0.1, help="ε tube half-width (svr)")
    ap.add_argument("--svm-nu", type=float, default=0.1,
                    help="ν outlier-fraction bound (oneclass)")
    ap.add_argument("--svm-lam", type=float, default=1.0,
                    help="ridge / GP noise λ (krr and gp)")
    ap.add_argument("--svm-mesh", action="store_true",
                    help="train node-split over a mesh of every rank (torchrun's, or "
                         "one), then serve the gathered model")
    ap.add_argument("--registry", default=None,
                    help="model-registry root: save the trained model there and serve "
                         "it back through the registry")
    ap.add_argument("--prune-tol", type=float, default=None,
                    help="SV-pruning tolerance applied on registry load")
    ap.add_argument("--serve-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="serving-tier kernel block compute dtype")
    return ap


def main(argv=None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    if args.task != "lm":
        return serve_svm(args)
    if args.arch is None:
        ap.error("--arch is required for --task lm")
    return serve_lm(args)


if __name__ == "__main__":
    main()
