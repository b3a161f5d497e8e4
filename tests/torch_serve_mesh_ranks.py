"""What each rank runs in tests/test_torch_serve_mesh.py (``dist.api.spawn``).

Module-level functions of ``(mesh, *args)``, importable without jax: the
ranks import this module only.  Every model is drawn by ``Model.init`` from
a seeded generator (``torch_lm_mesh_ranks.model_of``), as the test process
draws the same one for its references; each rank returns CPU tensors.
"""
import torch

from repro_torch.dist import api as dist_api, sharding
from repro_torch.models import layers
from torch_lm_mesh_ranks import model_of

torch.set_float32_matmul_precision("highest")


def _cache(cache: dict) -> dict:
    return {k: v.clone() for k, v in cache.items() if isinstance(v, torch.Tensor)}


def serve(mesh, arch, over, batch, steps, max_len, fallback=False):
    """The model sharded on ``mesh``: prefill of the global ``batch``, then
    one teacher-forced decode step a column of ``steps`` (B, n), each rank
    feeding its data shard's rows.  Returns the rank's logits and its cache
    after prefill and after the last step.  ``fallback``: the attention
    takes the reference's fallback (every head on every rank) while the
    cache plan still splits the kv heads."""
    model = sharding.shard_model(model_of(arch, over), mesh)
    tensors = {k: torch.as_tensor(v) for k, v in batch.items()}
    mine = sharding.shard_batch({"t": torch.as_tensor(steps)}, mesh)["t"]
    saved = layers._head_split
    if fallback:
        layers._head_split = lambda cfg: None
    try:
        with dist_api.use_mesh(mesh):
            logits, cache = model.prefill(tensors, max_len)
            out = dict(prefill=logits, cache_prefill=_cache(cache), pos_prefill=cache["pos"])
            dec = []
            for i in range(mine.shape[1]):
                step, cache = model.decode_step(cache, mine[:, i:i + 1])
                dec.append(step)
    finally:
        layers._head_split = saved
    out.update(decode=torch.stack(dec), cache=_cache(cache), pos=cache["pos"],
               coords=(dist_api.axis_index("data", mesh), dist_api.axis_index("model", mesh)),
               stats=dict(mesh.stats), ring=dict(mesh.ring))
    return out


def world(mesh, cases):
    """Every case (args of ``serve``) on this rank, in order."""
    return [serve(mesh, *args) for args in cases]
