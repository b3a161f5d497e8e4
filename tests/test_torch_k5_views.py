"""Which views K5's tensor-core (bf16) path takes, on the CPU: its TMA
tensor maps need a 16-byte aligned base and 16-byte multiples for every
stride of a dimension longer than 1.  The model's views, (B, heads, S, D)
and the transposed (B, S, heads, D) projections, qualify at every head dim
of the kernel; a view that starts one element in does not, and the
launcher raises for it rather than launch.
"""
import pytest
import torch

from repro_torch.kernels.attention import kernel as attn_kern
from torch_test_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("d", attn_kern.HEAD_DIMS)
def test_the_models_views_are_tma_ready(d):
    q = torch.zeros((2, 4, 50, d), dtype=torch.bfloat16)
    proj = torch.zeros((2, 50, 4, d), dtype=torch.bfloat16)
    assert attn_kern._tma_ready(q)
    assert attn_kern._tma_ready(proj.transpose(1, 2))


def test_an_offset_view_is_not():
    base = torch.zeros(2 * 4 * 50 * 64 + 1, dtype=torch.bfloat16)
    assert not attn_kern._tma_ready(base[1:].view(2, 4, 50, 64))


def test_a_length_one_dimension_needs_no_stride():
    """MQA's single kv head: its stride is never used."""
    kv = torch.zeros((2, 50, 1, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert attn_kern._tma_ready(kv.as_strided(kv.shape, (kv.stride(0), 3, kv.stride(2), 1)))
