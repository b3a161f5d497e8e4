"""The production meshes of the dry run (counterpart of ``repro.launch.mesh``).

Functions, not module constants, so that importing this module starts no
process group.  Single pod: ("data", "model") (16, 16), 256 ranks;
multi-pod: ("pod", "data", "model") (2, 16, 16), 512 ranks, where "pod"
composes with "data" for the batch and FSDP, and "model" stays inside a
pod.  Both are meshes that move nothing (``dist.api.make_mesh("meta", ...)``:
a fake process group in which this process stands for ``rank``): the dry
run runs one rank's step on them.
"""
from __future__ import annotations

from repro_torch.dist import api as dist_api


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> dist_api.Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dist_api.make_mesh("meta", shape, axes, rank=rank)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, rank: int = 0) -> dist_api.Mesh:
    """A small ("data", "model") mesh that moves nothing, for tests of the
    dry run's cells (this process as ``rank``)."""
    return dist_api.make_mesh("meta", (n_data, n_model), ("data", "model"), rank=rank)
