"""Deterministic synthetic LM token pipeline (a copy of ``repro.data.tokens``).

Host-sharded: each host materializes ONLY its slice of the global batch
(``host_slice``).  Deterministic in (seed, step) — a restart resumes the
exact stream, which is what makes checkpoint/resume bit-exact end to end.
The arrays are drawn with numpy, as the reference draws them;
``to_device`` makes them tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenStream:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0

    def batch_at(self, step: int, host_slice: slice = slice(None)) -> dict:
        idx = np.arange(self.global_batch)[host_slice]
        rows = []
        for i in idx:
            r = np.random.default_rng((self.seed * 1_000_003 + step) * 65_537 + int(i))
            rows.append(r.integers(0, self.vocab, size=self.seq_len + 1, dtype=np.int32))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


def batch_for_config(cfg, global_batch: int, seq_len: int, step: int, seed: int = 0) -> dict:
    """Modality-aware synthetic batch for any arch: tokens and labels; audio
    frames, labels and ``mask_indices``; or vision patches, then text of
    ``seq_len - n_prefix_tokens`` tokens and its labels."""
    r = np.random.default_rng(seed * 7_919 + step)
    if cfg.frontend == "audio_stub":
        return {
            "frames": r.normal(size=(global_batch, seq_len, cfg.frontend_dim)).astype(np.float32),
            "labels": r.integers(0, cfg.vocab, size=(global_batch, seq_len), dtype=np.int32),
            "mask_indices": r.random((global_batch, seq_len)) < 0.3,
        }
    if cfg.frontend == "vision_stub":
        s_txt = seq_len - cfg.n_prefix_tokens
        return {
            "patches": r.normal(size=(global_batch, cfg.n_prefix_tokens, cfg.frontend_dim)
                                ).astype(np.float32),
            "tokens": r.integers(0, cfg.vocab, size=(global_batch, s_txt), dtype=np.int32),
            "labels": r.integers(0, cfg.vocab, size=(global_batch, s_txt), dtype=np.int32),
        }
    return TokenStream(cfg.vocab, global_batch, seq_len, seed).batch_at(step)


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``, integer arrays as int64 (the
    index type of torch)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.ascontiguousarray(v))
        out[k] = (t.long() if t.dtype == torch.int32 else t).to(device)
    return out
