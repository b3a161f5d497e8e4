"""Roofline terms of one rank's step (counterpart of ``repro.roofline.analysis``).

The reference reads a compiled, SPMD-partitioned module; the port's dry run
counts one rank's step as it runs on meta tensors (``roofline/op_cost.py``)
and the collectives as its mesh makes them (``Mesh.stats``, ``Mesh.ring``).
Every quantity is per rank (per device).

Terms (an H100 SXM's data-sheet rates at the 700 W limit, per card; not
measurements, ``kernels/cost.py``):
  compute    = flops / peak_flops                (989 TFLOP/s dense bf16)
  memory     = bytes_accessed / hbm_bw           (3.35 TB/s)
  collective = collective_bytes / link_bw        (450 GB/s NVLink, a direction)

``collective_bytes`` follows the reference's definition: the operand bytes
of every all-gather / all-reduce / reduce-scatter / all-to-all /
point-to-point send the rank makes (a gather's operand is its shard).  The
ring-model estimate (×2(n−1)/n for an all-reduce, ×(n−1) for an
all-gather, ×(n−1)/n for a reduce-scatter or an all-to-all, ×1 for a send,
n the group's ranks) is reported beside it.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels import cost

# the port's collective kinds under the reference's (HLO) names
_OP_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
             "send_recv": "collective-permute"}


@dataclasses.dataclass(frozen=True)
class HW:
    """H100 SXM per-card constants (data sheet, 700 W)."""
    peak_flops: float = cost.BF16_TC_FLOP_PER_S     # dense bf16
    hbm_bw: float = cost.HBM_BYTES_PER_S            # bytes/s
    link_bw: float = cost.NVLINK_BYTES_PER_S        # bytes/s, one direction


def collective_bytes(mesh) -> dict:
    """The rank's collectives on ``mesh`` since its last ``reset_stats``:
    operand bytes, ring-model bytes, operand bytes per op, call count."""
    per_op = {}
    count = 0
    for kind, name in _OP_NAMES.items():
        calls = mesh.stats[f"{kind}_calls"]
        if calls:
            per_op[name] = float(mesh.stats[f"{kind}_bytes"])
            count += calls
    return dict(operand_bytes=float(sum(per_op.values())),
                ring_bytes=float(sum(mesh.ring.values())), per_op=per_op,
                n_collectives=count)


def roofline_report(cost_: dict, coll: dict, hw: HW = HW()) -> dict:
    """The three roofline terms in seconds + dominant-term tag."""
    flops = float(cost_.get("flops", 0.0) or 0.0)
    bytes_acc = float(cost_.get("bytes accessed", 0.0) or 0.0)
    t_compute = flops / hw.peak_flops
    t_memory = bytes_acc / hw.hbm_bw
    t_coll = coll["operand_bytes"] / hw.link_bw
    t_coll_ring = coll["ring_bytes"] / hw.link_bw
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)), key=lambda kv: kv[1])[0]
    return dict(
        flops_per_device=flops,
        bytes_per_device=bytes_acc,
        collective_bytes=coll["operand_bytes"],
        collective_ring_bytes=coll["ring_bytes"],
        t_compute_s=t_compute,
        t_memory_s=t_memory,
        t_collective_s=t_coll,
        t_collective_ring_s=t_coll_ring,
        dominant=dominant,
        step_time_bound_s=max(t_compute, t_memory, t_coll),
    )


def model_flops_train(cfg, shape) -> float:
    """6·N_active·D model FLOPs for one training step (global)."""
    n_active = active_param_count(cfg)
    tokens = shape.global_batch * shape.seq_len
    return 6.0 * n_active * tokens


def active_param_count(cfg) -> float:
    """Per-token active parameter count (MoE counts top_k experts)."""
    d, l, v = cfg.d_model, cfg.n_layers, cfg.vocab
    total = 2.0 * v * d          # embed + head
    if cfg.family in ("ssm", "hybrid"):
        d_in = cfg.d_inner
        gn = cfg.ssm_groups * cfg.ssm_state
        per = d * (2 * d_in + 2 * gn + cfg.ssm_heads) + d_in * d
        total += l * per
        if cfg.family == "hybrid" and cfg.shared_attn_every:
            napp = l // cfg.shared_attn_every
            attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
                + cfg.n_heads * cfg.head_dim * d
            mlp = 3 * d * cfg.d_ff
            total += napp * (attn + mlp)    # active at every application
        return total
    attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim \
        + cfg.n_heads * cfg.head_dim * d
    if cfg.family == "moe":
        ff = 3 * d * cfg.d_ff * cfg.top_k
        if cfg.moe_dense_ff:
            ff += 3 * d * cfg.moe_dense_ff
        ff += d * cfg.n_experts      # router
    else:
        ff = 3 * d * cfg.d_ff
    total += l * (attn + ff)
    return total
