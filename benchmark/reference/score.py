"""Sliding-window LLR scores of a Bernoulli bank, in plain PyTorch.

A frozen copy of ``oracle/score.py``'s ``llr_filter`` and
``sliding_score`` (the valid sliding correlation ``W . X + c`` over
time, full F x E support), with the LLR filter worked out in float64
and the correlation as float32 matrix products with TF32 off, one
product a template row.  ``interval_scores`` adds the bounds that the
front end's ambiguous cells put on each window (``reference.frontend``):
every map between the sure cells and the sure-or-ambiguous cells scores
between them.
"""

from __future__ import annotations

import torch

K_CHUNK = 1024


def llr_rows(templates: torch.Tensor, background: torch.Tensor):
    """P [K, L, F, E], q [F, E] -> (Wt [L, F*E, K] float32, c [K] float64):
    W = log(P / (1 - P)) - log(q / (1 - q)), c = sum log((1 - P) / (1 - q))."""
    k, length = templates.shape[:2]
    q = background.to(torch.float64)
    wq = torch.log(q) - torch.log1p(-q)
    cq = torch.log1p(-q)
    wt = torch.empty((length, q.numel(), k), dtype=torch.float32, device=templates.device)
    c = torch.empty(k, dtype=torch.float64, device=templates.device)
    for k0 in range(0, k, K_CHUNK):
        p = templates[k0: k0 + K_CHUNK].to(torch.float64)
        w = (torch.log(p) - torch.log1p(-p)) - wq
        wt[:, :, k0: k0 + K_CHUNK] = w.reshape(p.shape[0], length, -1).permute(1, 2, 0)
        c[k0: k0 + K_CHUNK] = (torch.log1p(-p) - cq).sum(dim=(1, 2, 3))
        del p, w
    return wt, c


def sliding_scores(x: torch.Tensor, wt: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Binary map x [T, D] -> scores [T - L + 1, K] float32."""
    length = wt.shape[0]
    tout = x.shape[0] - length + 1
    if tout <= 0:
        raise ValueError(f"map of {x.shape[0]} frames shorter than the template ({length})")
    xf = x.to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = c.to(torch.float32).expand(tout, -1).clone()
        for l in range(length):
            s.addmm_(xf[l: l + tout], wt[l])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return s


def ambiguity_terms(amb: torch.Tensor, wt: torch.Tensor, tout: int, sign: int,
                    cells_a_chunk: int = 256) -> torch.Tensor:
    """The most (sign 1) or least (sign -1) that the ambiguous cells
    ``amb`` [T, D] add to each window's score -> [tout, K] float32."""
    length, _d, k = wt.shape
    out = torch.zeros((tout, k), dtype=torch.float32, device=wt.device)
    cells = torch.nonzero(amb)                                  # [n, 2]: (t, d)
    ls = torch.arange(length, device=wt.device)
    for i in range(0, cells.shape[0], cells_a_chunk):
        t, d = cells[i: i + cells_a_chunk].unbind(1)
        t0 = t[:, None] - ls[None, :]                           # window starts
        ok = (t0 >= 0) & (t0 < tout)
        w = wt[ls[None, :].expand_as(t0)[ok], d[:, None].expand_as(t0)[ok]]   # [m, K]
        w = torch.clamp(w, min=0.0) if sign > 0 else torch.clamp(w, max=0.0)
        out.index_add_(0, t0[ok], w)
    return out


def interval_scores(lo: torch.Tensor, amb: torch.Tensor, wt: torch.Tensor, c: torch.Tensor):
    """(s_lo, s_hi) [T - L + 1, K]: the least and the most that any map
    between ``lo`` and ``lo | amb`` ([T, D] each) scores."""
    base = sliding_scores(lo, wt, c)
    if not bool(amb.any()):
        return base, base
    tout = base.shape[0]
    return (base + ambiguity_terms(amb, wt, tout, -1),
            base + ambiguity_terms(amb, wt, tout, 1))
