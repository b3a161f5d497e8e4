"""Seeded violations of precision-accumulate (torch spellings)."""
import numpy as np
import torch
import torch.nn.functional as F


def products(a, b, w, x):
    c = torch.einsum("ij,jk->ik", a, b)  # VIOLATION
    d = torch.matmul(a, b)  # VIOLATION
    e = a.mm(b)  # VIOLATION
    f = torch.bmm(a[None], b[None])  # VIOLATION
    g = F.linear(x, w)  # VIOLATION
    h = torch.baddbmm(f, a[None], b[None])  # VIOLATION
    late = torch.matmul(a, b).float()  # VIOLATION: the product is rounded already
    ok1 = torch.einsum("ij,jk->ik", a.float(), b)
    ok2 = torch.mm(a, b, out_dtype=torch.float32)
    ok3 = a.to(torch.float32).mm(b)
    ok4 = torch.matmul(a.to(dtype=torch.float32), b)
    ok5 = a @ b                      # bare @: the dispatch layer's business
    ok6 = np.matmul(np.ones((2, 2)), np.ones((2, 2)))
    return c, d, e, f, g, h, late, ok1, ok2, ok3, ok4, ok5, ok6


def tf32():
    torch.backends.cuda.matmul.allow_tf32 = True  # VIOLATION
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("high")  # VIOLATION
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.fp32_precision = "tf32"  # VIOLATION
