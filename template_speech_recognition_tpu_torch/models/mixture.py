"""Bernoulli mixture EM, restarts in lockstep.

Counterpart of ``template_speech_recognition_tpu.models.mixture``: the
same update equations in float32 (M-step from the current
responsibilities, then the E-step with the new parameters, means
clipped to [eps, 1 - eps]) and the same stop rule (after iteration
i > 1 whose mean log-likelihood improves by less than ``tol``, or at
``num_iters``); the history is NaN-padded.  Initial responsibilities
are an input (``oracle.mixture.init_responsibilities``), so parity
never depends on RNG equivalence.

R restarts advance together, as the reference's ``vmap`` of its
``while_loop`` does: their R*K components are the columns of the same
two GEMMs an iteration (E-step ``x [N, D] @ logit.T [D, R*K]``, M-step
``resp [N, R*K].T @ x``), so ``x`` is read once a GEMM, not 2R times.
A restart that has met ``tol`` freezes while the others go on.  The
GEMMs run in full float32 (TF32 off, ``utils.precision.full_fp32``), as
the reference runs them at ``Precision.HIGHEST``.  ``resume_fit`` runs
the same loop from a given state for a bounded number of iterations
(``checkpoint.run_em_checkpointed``'s chunks).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from template_speech_recognition_tpu_torch.utils.precision import full_fp32


class EMState(NamedTuple):
    iteration: torch.Tensor         # int32, iterations completed
    responsibilities: torch.Tensor  # [N, K] float32
    means: torch.Tensor             # [K, D] float32
    weights: torch.Tensor           # [K] float32
    log_likelihood: torch.Tensor    # float32, latest mean log-likelihood
    done: torch.Tensor              # bool, tolerance reached
    history: torch.Tensor           # [num_iters] float32, NaN-padded


def _step(x, resp, mask, eps):
    """One M-step + E-step of R fits at once: x [N, D], resp [N, R, K],
    mask [N] -> (new resp [N, R, K], means [R, K, D], weights [R, K],
    mean log-likelihood [R]).  ``mask`` zero-weights padded rows
    everywhere, the reported log-likelihood included."""
    n, r, k = resp.shape
    resp = resp * mask[:, None, None]
    n_eff = mask.sum().clamp(min=1.0)
    counts = resp.sum(dim=0)                                        # [R, K]
    weights = counts / n_eff
    means = (resp.reshape(n, r * k).T @ x).reshape(r, k, -1)
    means = (means / counts.clamp(min=1e-30)[..., None]).clamp(eps, 1.0 - eps)
    log_1mp = torch.log1p(-means)
    logit = torch.log(means) - log_1mp
    # logit.T contiguous [D, R*K]: equal components give equal columns
    # (a transposed view takes a GEMV path on the CPU at N = 1 whose
    # columns round differently), so restarts that end equal tie
    # exactly, as the reference's vmapped restarts do
    ll = ((x @ logit.reshape(r * k, -1).T.contiguous()).reshape(n, r, k)
          + log_1mp.sum(dim=-1)[None] + torch.log(weights.clamp(min=1e-30))[None])
    mx = ll.amax(dim=-1, keepdim=True)
    p = torch.exp(ll - mx)
    z = p.sum(dim=-1, keepdim=True)
    per_row = (torch.log(z[..., 0]) + mx[..., 0]) * mask[:, None]  # [N, R]
    return p / z, means, weights, per_row.sum(dim=0) / n_eff


def em_step(x, resp, mask, eps: float):
    """One M-step + E-step -> (new resp [N, K], means [K, D], weights
    [K], mean log-likelihood): the update of ``bernoulli_mixture_em``."""
    with full_fp32():
        new_resp, means, weights, mean_ll = _step(
            x.to(torch.float32), resp.to(torch.float32)[:, None],
            mask.to(torch.float32), eps)
    return new_resp[:, 0], means[0], weights[0], mean_ll[0]


def _start(init_resps, d: int, num_iters: int, device) -> EMState:
    """The state before iteration 1 of R fits, with a leading R axis."""
    init = torch.as_tensor(init_resps, dtype=torch.float32, device=device)
    r, _n, k = init.shape
    return EMState(
        iteration=torch.zeros(r, dtype=torch.int32, device=device),
        responsibilities=init,
        means=torch.zeros((r, k, d), device=device),
        weights=torch.full((r, k), 1.0 / k, device=device),
        log_likelihood=torch.full((r,), float("-inf"), device=device),
        done=torch.zeros(r, dtype=torch.bool, device=device),
        history=torch.full((r, num_iters), float("nan"), device=device),
    )


def resume_fit(x, state: EMState, num_iters, eps, tol, mask, max_steps=None) -> EMState:
    """R fits in lockstep from ``state`` (a leading R axis), for at most
    ``max_steps`` more iterations and at most ``num_iters`` in all ->
    EMState with a leading R axis.

    The fits still running have all completed ``max(state.iteration)``
    iterations, so the loop goes on from there; the iterations are the
    same operations whether they run in one call or in several."""
    x = x.to(torch.float32)
    n = x.shape[0]
    mask = (torch.ones(n, device=x.device) if mask is None
            else torch.as_tensor(mask, device=x.device).to(torch.float32))
    resp = state.responsibilities.permute(1, 0, 2).contiguous()     # [N, R, K]
    means, weights, ll = state.means, state.weights, state.log_likelihood
    it, done, history = state.iteration, state.done, state.history
    cols = torch.arange(history.shape[-1], device=x.device)
    first = int(it.max()) if it.numel() else 0
    last = num_iters if max_steps is None else min(num_iters, first + max_steps)
    with full_fp32():
        for step in range(first, last):
            # the stop test reads ``done`` on the host: one sync an
            # iteration (the reference's while_loop keeps it on device)
            if bool(done.all()):
                break
            run = ~done
            new_resp, new_means, new_weights, mean_ll = _step(x, resp, mask, eps)
            stop = (mean_ll - ll < tol) & (step > 0)
            resp = torch.where(run[None, :, None], new_resp, resp)
            means = torch.where(run[:, None, None], new_means, means)
            weights = torch.where(run[:, None], new_weights, weights)
            ll = torch.where(run, mean_ll, ll)
            history = torch.where(run[:, None] & (cols == step)[None], mean_ll[:, None],
                                  history)
            it = it + run.to(torch.int32)
            done = done | (run & stop)
    return EMState(it, resp.permute(1, 0, 2), means, weights, ll, done, history)


def _fit(x, init_resps, num_iters, eps, tol, mask):
    """R fits in lockstep -> EMState with a leading R axis."""
    return resume_fit(x, _start(init_resps, x.shape[1], num_iters, x.device), num_iters,
                      eps, tol, mask)


def bernoulli_mixture_em(x, init_resp, num_iters: int = 50, eps: float = 0.01,
                         tol: float = 1e-4, mask=None) -> EMState:
    """Fit a K-component Bernoulli mixture on ``x``'s device.

    x: [N, D] binary (any dtype); init_resp: [N, K]
    (``oracle.mixture.init_responsibilities``); mask: [N] optional
    row validity."""
    init = torch.as_tensor(init_resp, dtype=torch.float32, device=x.device)
    s = _fit(x, init[None], num_iters, eps, tol, mask)
    return EMState(*(a[0] for a in s))


def bernoulli_mixture_em_restarts(x, init_resps, num_iters: int = 50, eps: float = 0.01,
                                  tol: float = 1e-4, mask=None) -> tuple[EMState, int]:
    """Multi-restart EM: the R fits of ``init_resps`` [R, N, K] in
    lockstep; the restart with the highest final mean log-likelihood
    wins, ties to the lowest restart index.  Returns (winning EMState,
    winning restart index)."""
    s = _fit(x, init_resps, num_iters, eps, tol, mask)
    best = int(torch.argmax(s.log_likelihood))
    return EMState(*(a[best] for a in s)), best
