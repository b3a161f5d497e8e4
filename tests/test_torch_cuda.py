"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``: without a card every test here skips.  On a GPU machine
with nvcc, from the repository root:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports torch and the port only, so it runs where jax is absent.
Tolerances are those of ``chip_smoke.py``, with their reasons there.
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.admm_update import ops as aops, ref as aref
from repro_torch.kernels.compress import kernel as ckern, ref as cref
from repro_torch.kernels.gaussian import ops as gops, ref as gref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dev, seed):
    return torch.randn(shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(seed))


@pytest.mark.parametrize("b,ma,mb,f", [
    (1, 3, 2, 2), (3, 255, 129, 5), (2, 300, 7, 11),
    (70_000, 5, 3, 8),          # batch above grid.z's 65535: two launches
])
def test_gaussian_block_kernel_matches_plain(dev, b, ma, mb, f):
    xa, xb = _randn((b, ma, f), dev, 0), _randn((b, mb, f), dev, 1)
    before = _build.launch_counts["gaussian_block"]
    out = gops.gaussian_block(xa, xb, 0.9)
    assert _build.launch_counts["gaussian_block"] == before + (1 if b <= 65535 else 2)
    assert out.shape == (b, ma, mb)
    assert (out - gref.gaussian_block_ref(xa, xb, 0.9)).abs().max().item() <= 2e-5


@pytest.mark.parametrize("b,m,s,f,k", [(5, 64, 48, 8, 12), (3, 100, 37, 3, 8)])
def test_fused_assemble_id_kernel_matches_plain(dev, b, m, s, f, k):
    xc, xp = _randn((b, m, f), dev, 2), _randn((b, s, f), dev, 3)
    cmask = torch.ones((b, m), device=dev)
    cmask[0, m // 2:] = 0.0
    piv, r = ckern.fused_assemble_id_cuda(xc, xp, cmask, k, 1.0)
    piv_ref, r_ref = cref.fused_assemble_id_ref(xc, xp, cmask, k, 1.0)
    assert torch.equal(piv, piv_ref)
    assert (r - r_ref).abs().max().item() <= 1e-4


def test_zmu_update_kernel_matches_plain(dev):
    n = 4097
    x, mu = _randn((n,), dev, 4), 1e4 * _randn((n,), dev, 5)
    c = torch.full((n,), 1.0, device=dev)
    z, mu_new = aops.fused_zmu_update(x, mu, c, 1e4)
    z_ref, mu_ref = aref.fused_zmu_update_ref(x, mu, c, 1e4)
    assert (z - z_ref).abs().max().item() <= 1e-5
    assert (mu_new - mu_ref).abs().max().item() <= 1e-5 * mu_ref.abs().max().item()
