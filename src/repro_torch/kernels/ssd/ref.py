"""Plain PyTorch SSD chunk scan: the function K6 computes (any device).

Twins of ``repro.kernels.ssd.ref``: ``ssd_chunked_ref`` evaluates the
semiseparable token mixer chunk by chunk (a dense Q x Q block inside each
chunk, the (N, P) state carried across chunks), here batched over
(batch, head) as written-out dimensions instead of vmap.  All of it in f32.
"""
from __future__ import annotations

import torch


def _check(x, dt, a, b_mat, c_mat, d_vec, chunk):
    bsz, s, h, p = x.shape
    g = b_mat.shape[2]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    if h % g:
        raise ValueError(f"{h} heads are not a multiple of {g} groups")
    return bsz, s, h, p, g


def ssd_chunked_ref(x, dt, a, b_mat, c_mat, d_vec, chunk: int = 16):
    """x (B, S, H, P), dt (B, S, H), a (H,), b_mat/c_mat (B, S, G, N) with
    heads sharing B/C within each of G groups, d_vec (H,).

    Returns (y (B, S, H, P), h_final (B, H, N, P)), both f32.  Per chunk:
      la     = cumsum(dt) * a                      (inclusive log decay)
      scores = (C Bᵀ) ⊙ exp(la_i − la_j) [i ≥ j]
      y      = scores (dt ⊙ x) + (C ⊙ exp(la)) h + D x
      h      = exp(la_Q) h + (B ⊙ exp(la_Q − la) dt)ᵀ x
    """
    bsz, s, h, p, g = _check(x, dt, a, b_mat, c_mat, d_vec, chunk)
    n = b_mat.shape[-1]
    x, dt = x.float(), dt.float()
    # head i reads group i // (h // g): an expand, whose gradient is a sum
    # (an index would add it with atomics on the card)
    b_full, c_full = (m.float()[:, :, :, None].expand(bsz, s, g, h // g, n).reshape(bsz, s, h, n)
                      for m in (b_mat, c_mat))             # (B, S, H, N)
    a, d_vec = a.float(), d_vec.float()
    tril = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        xq = x[:, c0:c0 + chunk]                          # (B, Q, H, P)
        dtq = dt[:, c0:c0 + chunk]                        # (B, Q, H)
        bq = b_full[:, c0:c0 + chunk]                     # (B, Q, H, N)
        cq = c_full[:, c0:c0 + chunk]
        la = torch.cumsum(dtq, dim=1) * a                 # (B, Q, H)
        la_h = la.transpose(1, 2)                         # (B, H, Q)
        seg = la_h[:, :, :, None] - la_h[:, :, None, :]   # (B, H, Q, Q)
        # exp of -inf above the diagonal: the same zeros as the reference's
        # where(tril, exp(seg), 0), but where seg overflows exp there the
        # reference's gradient is 0 * inf = NaN and this one is 0
        gate = torch.exp(torch.where(tril, seg, torch.full((), -torch.inf, device=x.device)))
        scores = torch.einsum("bihn,bjhn->bhij", cq.float(), bq) * gate
        y_intra = torch.einsum("bhij,bjhp->bihp", scores.float(), xq * dtq[..., None])
        y_state = torch.einsum("bihn,bhnp->bihp", cq * torch.exp(la)[..., None], state.float())
        la_tot = la[:, -1]                                # (B, H)
        w = torch.exp(la_tot[:, None] - la) * dtq         # (B, Q, H)
        state = (torch.exp(la_tot)[..., None, None] * state
                 + torch.einsum("bjhn,bjhp->bhnp", bq * w[..., None], xq.float()))
        ys.append(y_intra + y_state + d_vec[:, None] * xq)
    return torch.cat(ys, dim=1), state


def ssd_batched_ref(x, dt, a, b_mat, c_mat, d_vec, chunk: int = 16):
    """y (B, S, H, P) of ``ssd_chunked_ref``."""
    return ssd_chunked_ref(x, dt, a, b_mat, c_mat, d_vec, chunk)[0]


def ssd_batched_with_state(x, dt, a, b_mat, c_mat, d_vec, chunk: int = 16):
    """(y (B, S, H, P), final states (B, H, N, P)) of ``ssd_chunked_ref``."""
    return ssd_chunked_ref(x, dt, a, b_mat, c_mat, d_vec, chunk)
