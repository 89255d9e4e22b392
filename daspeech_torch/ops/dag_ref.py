"""The DAG dynamic programs (PyTorch): plain loops, and the route to the
CUDA kernels.

Counterpart of ``daspeech_tpu/ops/dag_ref.py``, with the same definitions
(``match_all [B, T, L]`` log P(y_t | v_j), ``links [B, L, L]`` log
transitions, -inf where invalid):

- alpha[0, 0] = match[0, 0]; alpha[t, j] = logsumexp_i(alpha[t-1, i]
  + links[i, j]) + match[t, j];
- beta[tl-1, j] = match[tl-1, j] at j = ol-1, else -inf; beta[t, j] =
  logsumexp_k(beta[t+1, k] + links[j, k]) + match[t, j];
- logZ = beta[0, 0], and the closed-form gradients of ``dag_loss.cu``.

:func:`dag_loss_forward` and :func:`dag_best_alignment` take the plain
loops here for CPU tensors (the JAX ``lax.scan``s as Python loops) and the
kernels of ``ops/dag_kernels.py`` for CUDA tensors. The gradient's
contraction S = Σ_t exp(alpha[t] + beta[t+1] - logZ) stays a ``torch.bmm``
on both, as it stayed an XLA einsum outside the Pallas kernel. All
arithmetic is float32.
"""

from __future__ import annotations

import torch

from daspeech_torch.ops import dag_kernels

NEG_INF = -torch.inf


def _finite_max(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """max along ``dim`` (kept), 0 where the row is all -inf, so that
    ``x - m`` never produces NaN."""
    m = x.amax(dim=dim, keepdim=True)
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def dag_loss_forward_plain(match_all, links, output_length, target_length):
    """(logprob [B], alpha, beta) by the reference's loops over t: each
    step one batched log-space mat-vec against exp(links) with the max
    shift (``dag_ref.py:53-122``), in ``match_all``'s dtype."""
    B, T, L = match_all.shape
    exp_links = torch.exp(links)
    f = torch.full((B, L), NEG_INF, dtype=match_all.dtype,
                   device=match_all.device)
    f[:, 0] = match_all[:, 0, 0]
    alphas = [f]
    for t in range(1, T):
        c = _finite_max(f)
        nxt = torch.bmm(torch.exp(f - c)[:, None, :], exp_links)[:, 0]
        f = torch.log(nxt) + c + match_all[:, t]
        alphas.append(f)

    pos = torch.arange(L, device=match_all.device)[None, :]
    final_onehot = pos == (output_length[:, None] - 1)
    b = torch.full((B, L), NEG_INF, dtype=match_all.dtype,
                   device=match_all.device)
    betas = [None] * T
    for t in range(T - 1, -1, -1):
        c = _finite_max(b)
        nxt = torch.bmm(exp_links, torch.exp(b - c)[:, :, None])[:, :, 0]
        match_t = match_all[:, t]
        propagated = torch.log(nxt) + c + match_t
        init_t = torch.where(final_onehot, match_t,
                             torch.full_like(match_t, NEG_INF))
        b = torch.where((target_length == t + 1)[:, None], init_t,
                        propagated)
        betas[t] = b
    beta = torch.stack(betas, dim=1)
    return beta[:, 0, 0], torch.stack(alphas, dim=1), beta


def dag_loss_forward(match_all, links, output_length, target_length):
    """(logprob [B], alpha [B, T, L], beta [B, T, L]): the plain loops for
    CPU tensors, the alpha/beta kernel for CUDA tensors."""
    match_all = match_all.float().contiguous()
    links = links.float().contiguous()
    if match_all.device.type == "cpu":
        return dag_loss_forward_plain(match_all, links, output_length,
                                      target_length)
    return dag_kernels.dag_loss_forward_kernel(match_all, links,
                                               output_length, target_length)


def _dag_loss_bwd_grads(match_all, links, alpha, beta, g):
    """Closed-form cotangents of logZ (``dag_ref.py:125-151``): zero, never
    NaN, for infeasible samples (logZ = -inf) and at -inf entries."""
    logZ = beta[:, 0, 0][:, None, None]
    expo = alpha + beta - match_all - logZ
    zero = torch.zeros_like(expo)
    grad_match = torch.where(torch.isinf(match_all) | ~torch.isfinite(expo),
                             zero, torch.exp(expo)) * g[:, None, None]
    w = _finite_max(alpha[:, :-1], dim=2)                     # [B, T-1, 1]
    a_sh = torch.exp(alpha[:, :-1] - w)
    b_sh = torch.exp(beta[:, 1:] + w - logZ)
    b_sh = torch.where(torch.isfinite(b_sh), b_sh, torch.zeros_like(b_sh))
    S = torch.bmm(a_sh.transpose(1, 2), b_sh)                 # [B, L, L]
    grad_links = S * torch.exp(links) * g[:, None, None]
    grad_links = torch.where(torch.isfinite(grad_links), grad_links,
                             torch.zeros_like(grad_links))
    grad_match = torch.where(torch.isfinite(grad_match), grad_match, zero)
    return grad_match, grad_links


class _DagLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, match_all, links, output_length, target_length):
        logprob, alpha, beta = dag_loss_forward(match_all, links,
                                                output_length, target_length)
        ctx.save_for_backward(match_all, links, alpha, beta)
        return logprob

    @staticmethod
    def backward(ctx, g):
        match_all, links, alpha, beta = ctx.saved_tensors
        gm, gl = _dag_loss_bwd_grads(match_all.float(), links.float(), alpha,
                                     beta, g)
        return gm, gl, None, None


class _DagLossWithAlphaBeta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, match_all, links, output_length, target_length):
        logprob, alpha, beta = dag_loss_forward(match_all, links,
                                                output_length, target_length)
        ctx.save_for_backward(match_all, links, alpha, beta)
        return logprob, alpha, beta

    @staticmethod
    def backward(ctx, g, _g_alpha, _g_beta):
        # the alpha/beta cotangents are dropped, as in the reference
        # (``dag_ref.py:205-209``): the posteriors are constants
        match_all, links, alpha, beta = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(alpha[:, 0, 0])
        gm, gl = _dag_loss_bwd_grads(match_all.float(), links.float(), alpha,
                                     beta, g)
        return gm, gl, None, None


def dag_loss(match_all, links, output_length, target_length):
    """DAG marginal log-likelihood logZ [B], differentiable in match_all and
    links (closed-form backward)."""
    return _DagLoss.apply(match_all, links, output_length, target_length)


def dag_loss_with_alpha_beta(match_all, links, output_length, target_length):
    """(logprob, alpha, beta); only logprob carries gradient."""
    return _DagLossWithAlphaBeta.apply(match_all, links, output_length,
                                       target_length)


def dag_best_alignment_plain(match_all, links, output_length, target_length):
    """Viterbi path [B, L] int32 by the reference's loops: max-plus steps
    with first-argmax traces, then the backtrace from (tl-1, ol-1); path[j]
    is the smallest t visiting j, -1 where none (``dag_ref.py:215-278``)."""
    B, T, L = match_all.shape
    f = torch.full((B, L), NEG_INF, dtype=torch.float32,
                   device=match_all.device)
    f[:, 0] = match_all[:, 0, 0]
    traces = []
    for t in range(1, T):
        best, arg = (f[:, :, None] + links).max(dim=1)   # first argmax
        f = best + match_all[:, t]
        traces.append(arg)
    return backtrace(traces, output_length, target_length, L)


def backtrace(traces, output_length, target_length, L: int) -> torch.Tensor:
    """The Viterbi backtrace over ``traces`` (T - 1 tensors [B, >= L]: the
    best predecessor of each vertex at steps 1 .. T-1): from (tl-1, ol-1)
    back to step 0; path[j] is the smallest t visiting j, -1 where none
    (``dag_ref.py:256-278``)."""
    T = len(traces) + 1
    dev = output_length.device
    ol = output_length.to(torch.int64)
    tl = target_length.to(torch.int64)
    cur = torch.zeros_like(ol)
    visited = []
    for t in range(T - 1, -1, -1):
        cur = torch.where(tl - 1 == t, ol - 1, cur)
        visited.append(cur)
        if t >= 1:
            prev = traces[t - 1].gather(1, cur.clamp(0, L - 1)[:, None])[:, 0]
            cur = torch.where(t <= tl - 1, prev, cur)
    ts = torch.arange(T - 1, -1, -1, device=dev)
    visited = torch.stack(visited)                          # [T, B]
    active = ts[:, None] <= (tl[None, :] - 1)
    mark = ((visited[:, :, None] == torch.arange(L, device=dev))
            & active[:, :, None])
    path = torch.where(mark, ts[:, None, None],
                       torch.full_like(mark, T, dtype=torch.int64)).amin(0)
    return torch.where(path == T, -1, path).to(torch.int32)


@torch.no_grad()
def dag_best_alignment(match_all, links, output_length, target_length):
    """Viterbi path [B, L] int32 (non-differentiable): the plain loops for
    CPU tensors, the Viterbi kernel for CUDA tensors."""
    match_all = match_all.float().contiguous()
    links = links.float().contiguous()
    if match_all.device.type == "cpu":
        return dag_best_alignment_plain(match_all, links, output_length,
                                        target_length)
    return dag_kernels.dag_best_alignment_kernel(match_all, links,
                                                 output_length, target_length)


def dag_logsoftmax_gather_tokens(word_ins_out: torch.Tensor,
                                 tgt_tokens: torch.Tensor) -> torch.Tensor:
    """match [B, L, T] f32: log_softmax(logits)[b, j, tgt[b, t]] — every
    vertex gathers the same target row (``dag_ref.py:304-335``)."""
    logits = word_ins_out.float()
    B, L, _ = logits.shape
    logz = torch.logsumexp(logits, dim=-1, keepdim=True)
    idx = tgt_tokens.to(torch.int64)[:, None, :].expand(B, L, -1)
    return logits.gather(-1, idx) - logz
