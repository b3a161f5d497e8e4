"""Seeded violations of rng-discipline."""
import numpy as np
import torch


def draws(n, gen):
    a = torch.randn(n)  # VIOLATION
    b = torch.randn(n, generator=gen)
    c = torch.rand(n)  # VIOLATION
    d = torch.randint(0, 5, (n,))  # VIOLATION
    e = torch.empty(n).normal_()  # VIOLATION
    f = torch.empty(n).uniform_(generator=gen)
    g = np.random.rand(n)  # VIOLATION
    np.random.seed(0)  # VIOLATION
    rng = np.random.default_rng(0)
    h = rng.normal(size=n)
    p = torch.randperm(n, generator=gen)
    return a, b, c, d, e, f, g, h, p


def reuse(seed):
    g1 = torch.Generator().manual_seed(seed)
    g2 = torch.Generator().manual_seed(seed)
    a = torch.randn(3, generator=g1)
    b = torch.randn(3, generator=g2)  # VIOLATION
    r1 = np.random.default_rng(7)
    r2 = np.random.default_rng(7)
    x = r1.normal(size=3)
    y = r2.normal(size=3)  # VIOLATION
    r3 = np.random.default_rng(seed + 1)
    z = r3.normal(size=3)
    return a, b, x, y, z
