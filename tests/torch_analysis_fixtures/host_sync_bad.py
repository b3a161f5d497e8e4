"""Seeded violations of host-sync-in-hot-path."""
import numpy as np
import torch
from torch import nn


class Op(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n: int):
        s = x.sum().item()  # VIOLATION
        k = int(x.max())  # VIOLATION
        m = int(n)                       # a Python scalar by annotation
        d = int(x.shape[0]) + x.size(1)  # shape probes
        idx = torch.nonzero(x)  # VIOLATION
        sel = x[x > 0]  # VIOLATION
        r = torch.repeat_interleave(x, x.long())  # VIOLATION
        r2 = torch.repeat_interleave(x, x.long(), output_size=8)
        r3 = x.repeat_interleave(2, dim=0)
        h = x.cpu()  # VIOLATION
        a = np.asarray(x)  # VIOLATION
        c = torch.linalg.cholesky(x)  # VIOLATION
        c2, info = torch.linalg.cholesky_ex(x)
        return s, k, m, d, idx, sel, r, r2, r3, h, a, c, c2, info

    @staticmethod
    def backward(ctx, g):
        torch.cuda.synchronize()  # VIOLATION
        return g.to("cpu"), None  # VIOLATION


class Block(nn.Module):
    def forward(self, x):
        return x.tolist()  # VIOLATION


def capture(g, x):
    with torch.cuda.graph(g):
        y = helper(x)
        z = x.numpy()  # VIOLATION
    return y, z


def helper(x):
    return torch.unique(x)  # VIOLATION


def cold(x):
    return x.item(), torch.nonzero(x)    # not on the hot set
