"""The dry run's input-shape grid and each (arch x shape) cell's
applicability (a copy of ``repro.configs.shapes``)."""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_status(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-skipped) for an (arch x shape) cell."""
    if shape.kind == "decode":
        if cfg.family == "encoder":
            return False, "encoder-only arch has no decode step"
        if shape.name == "long_500k" and not cfg.supports_long_decode:
            return False, ("pure full-attention arch: 500k decode needs "
                           "sub-quadratic state (skip per assignment)")
    if shape.kind == "prefill" and cfg.family == "encoder":
        # interpreted as a 32k-frame encoder forward (inference analogue)
        return True, "prefill = encoder forward for encoder-only arch"
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    from repro_torch.configs.registry import list_archs

    return [(a, s) for a in list_archs() for s in SHAPES]
