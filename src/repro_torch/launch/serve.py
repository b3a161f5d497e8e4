"""Serving entry point of the port: batched LM prefill + greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --preset full
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --preset tiny \\
      --device cpu --batch 2 --prompt-len 32 --gen 8

The twin of ``repro.launch.serve``'s LM path for the ssm and hybrid
families: weights from ``Model.init`` with a generator seeded 0 on the
serving device, prompt tokens from ``numpy.random.default_rng(0)``, then
one prefill and ``--gen`` greedy decode steps.  On a CUDA device prefill
runs K5 (attention) and K6 (the SSD scan); decode runs plain torch.  The
kernel-model paths (``--task svm`` and the others) are ROADMAP queue 1
item 11.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernel_group(name: str) -> str:
    if "flash_fwd" in name:
        return "K5 flash_attention"
    if "ssd_chunk" in name:
        return "K6 ssd_chunk"
    if any(t in name.lower() for t in ("gemm", "xmma", "cutlass", "nvjet", "gemv")):
        return "matmul (cuBLAS)"
    return "other (elementwise, reductions, copies)"


def profile_device(device: torch.device, fn) -> dict:
    """Device time of ``fn`` by kernel group and the device's busy share of
    the window, from one ``torch.profiler`` trace (CUDA only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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


def serve_lm(args) -> dict:
    """Run the LM serving path; print and return its numbers."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import Model

    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = cfg.reduced()
    device = torch.device(args.device)
    model = Model(cfg, device=device)
    model.init(torch.Generator(device=device).manual_seed(0))
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.gen
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, size=(args.batch, args.prompt_len)), device=device)}

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
    return ap


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.task != "lm":
        raise NotImplementedError(f"--task {args.task}: the serving tier is ROADMAP "
                                  "queue 1 item 11")
    if args.arch is None:
        ap.error("--arch is required for --task lm")
    serve_lm(args)


if __name__ == "__main__":
    main()
