"""GPipe-style pipeline parallelism over a "stage" mesh axis.

Twin of ``repro.dist.pipeline``.  ``pipeline_forward`` runs a per-stage
function over microbatches with the classic fill/steady/drain schedule: at
tick t, stage s processes microbatch t - s; activations move one stage a
tick by point-to-point sends (``dist.api.ppermute``).  Each rank holds ONE
stage's parameters, every rank is given the microbatches, and the outputs
come back on every rank (the last stage's, summed over the stage axis with
zeros elsewhere, as the reference's psum): numerically the stages applied
in sequence.  A stage computes only on the ticks where it holds a
microbatch (the reference computes on every tick and discards the rest).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.dist import api as dist_api


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     params_local: Any, x: torch.Tensor, mesh: dist_api.Mesh,
                     axis: str = "stage"
                     ) -> torch.Tensor:
    """Run the mesh's ``axis`` size of chained ``stage_fn`` applications
    as a pipeline.

    params_local — this rank's stage's parameters (any object ``stage_fn``
                   takes);
    x            — the microbatched input (n_micro, microbatch, ...), the same
                   on every rank;
    returns the (n_micro, microbatch, ...) output of the final stage, on
    every rank.  ``stage_fn`` must keep the activation's shape and type."""
    n_stages = dist_api.axis_size(axis, mesh)
    stage = dist_api.axis_index(axis, mesh)
    n_micro = x.shape[0]
    outputs = torch.zeros_like(x)
    recv = torch.zeros_like(x[0])
    for t in range(n_micro + n_stages - 1):
        mb = t - stage                                  # microbatch index here
        if 0 <= mb < n_micro:
            # stage 0 reads fresh microbatches; later stages consume what the
            # previous stage sent last tick
            out = stage_fn(params_local, x[mb] if stage == 0 else recv)
            if stage == n_stages - 1:
                outputs[mb] = out
        else:
            out = torch.zeros_like(x[0])
        # hand each active stage's activation to the next (it drops off the end)
        sends = [(s, s + 1) for s in range(n_stages - 1) if 0 <= t - s < n_micro]
        recv = dist_api.ppermute(out, axis, sends, mesh)
    if stage != n_stages - 1:
        outputs = torch.zeros_like(outputs)
    return dist_api.psum(outputs, axis, mesh)
