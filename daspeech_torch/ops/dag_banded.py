"""Block-banded DAG dynamic programs for a bounded transition length
(PyTorch).

Counterpart of ``daspeech_tpu/ops/dag_banded.py``. Links come in the
reference CUDA kernels' banded layout ``band[b, i, d] = log P(v_i ->
v_{i+d+1})``, d < W = ``max_transition_length`` (``ops/links_utils.py``).
The L vertices split into blocks of W: every edge i -> j (0 < j - i <= W)
lies inside block m (the strictly-upper ``intra`` matrix) or reaches block
m + 1 (the lower-triangular ``inter`` matrix), so a step of the DP is two
batched [W] x [W, W] products per block: O(L W) work and memory a target
step instead of the full matrix's O(L^2), and the [B, L, L] matrix never
exists. All gathers happen once, outside the loops over target steps.

The semantics are those of ``ops/dag_ref.py`` on ``band_to_full(band)``,
and so is the arithmetic: each step shifts by the previous row's finite
maximum (``_finite_max``) and sums in fp32, as JAX's ``lax.scan`` does
(the shift's loss far below the maximum is ROADMAP Queue 3's "The DP's
fp32 shift"). Matmuls run in fp32 with TF32 off (importing
``daspeech_torch`` turns it off), as JAX's ``Precision.HIGHEST``. Plain
tensor ops on any device: there is no kernel behind this module.
"""

from __future__ import annotations

from typing import Tuple

import torch

from daspeech_torch.ops.dag_ref import _finite_max, backtrace

NEG_INF = -torch.inf


def _pad_to_blocks(x: torch.Tensor, W: int, fill: float) -> torch.Tensor:
    """``x`` padded along axis 1 (length L) to a multiple of W."""
    L = x.shape[1]
    Lp = -(-L // W) * W
    if Lp == L:
        return x
    shape = list(x.shape)
    shape[1] = Lp - L
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=1)


def _pad_vertices(x: torch.Tensor, W: int) -> torch.Tensor:
    """[B, T, L] -> [B, T, Lp] with -inf vertices at the end."""
    return _pad_to_blocks(x.transpose(1, 2), W, NEG_INF).transpose(1, 2)


def _block_offsets(W: int, device):
    """(d_intra, d_inter, q > p) [W, W]: the band column of the edge from
    local row p to local column q inside the block, and into the next
    block."""
    p = torch.arange(W, device=device)[:, None]
    q = torch.arange(W, device=device)[None, :]
    return q - p - 1, W + q - p - 1, q > p


def _band_blocks(band: torch.Tensor):
    """(blocks [B, nblk, W(p), W(d)], d_intra, d_inter, upper) of a band
    padded to whole blocks with -inf rows."""
    W = band.shape[2]
    band = _pad_to_blocks(band, W, NEG_INF)
    B, Lp, _ = band.shape
    return (band.reshape(B, Lp // W, W, W),) + _block_offsets(W, band.device)


def _gather_d(blocks: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """blocks[b, m, p, d[p, q]] -> [B, nblk, W, W]."""
    B, nblk, W, _ = blocks.shape
    idx = d.clamp(0, W - 1)[None, None].expand(B, nblk, W, W)
    return blocks.gather(3, idx)


def band_to_blocks(band: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, L, W] banded links (log space) -> the block transition matrices
    in PROBABILITY space, (intra, inter) [B, nblk, W, W]
    (``dag_banded.py:42-73``): ``intra[b, m, p, q] = exp(links[mW+p,
    mW+q])`` (q > p), ``inter[b, m, p, q] = exp(links[mW+p, (m+1)W+q])``
    (q <= p); the last block's inter matrix is zero."""
    blocks, d_intra, d_inter, upper = _band_blocks(band)
    zero = torch.zeros((), dtype=blocks.dtype, device=blocks.device)
    intra = torch.where(upper, torch.exp(_gather_d(blocks, d_intra)), zero)
    inter = torch.where(~upper, torch.exp(_gather_d(blocks, d_inter)), zero)
    inter[:, -1] = 0.0
    return intra, inter


def _alpha_step(a, intra, inter):
    """One forward hop in probability space: ``a`` [B, nblk, W] is
    exp(alpha - max) blockwise; block m's inter product feeds block m+1."""
    intra_out = torch.matmul(a[:, :, None, :], intra)[:, :, 0]
    inter_out = torch.matmul(a[:, :, None, :], inter)[:, :, 0]
    shifted = torch.cat([torch.zeros_like(inter_out[:, :1]),
                         inter_out[:, :-1]], dim=1)
    return intra_out + shifted


def _beta_step(bvec, intra, inter):
    """One backward hop, the transposed contraction: block n pulls from
    blocks n (intra) and n+1 (inter)."""
    intra_out = torch.matmul(intra, bvec[..., None])[..., 0]
    nxt = torch.cat([bvec[:, 1:], torch.zeros_like(bvec[:, :1])], dim=1)
    inter_out = torch.matmul(inter, nxt[..., None])[..., 0]
    return intra_out + inter_out


def banded_forward(match_all, band, output_length, target_length):
    """(logprob [B], alpha [B, T, L], beta [B, T, L]) from banded links
    (``dag_banded.py:104-154``), fp32. beta restarts per sample at
    t = target_length - 1 from the graph's last vertex."""
    match_all = match_all.float()
    band = band.float()
    B, T, L = match_all.shape
    W = band.shape[2]
    intra, inter = band_to_blocks(band)
    nblk = intra.shape[1]
    Lp = nblk * W
    match_p = _pad_vertices(match_all, W)                 # [B, T, Lp]
    dev = match_all.device

    f = torch.full((B, Lp), NEG_INF, dtype=torch.float32, device=dev)
    f[:, 0] = match_all[:, 0, 0]
    alphas = [f]
    for t in range(1, T):
        c = _finite_max(f)
        nxt = _alpha_step(torch.exp(f - c).reshape(B, nblk, W), intra,
                          inter).reshape(B, Lp)
        f = torch.log(nxt) + c + match_p[:, t]
        alphas.append(f)

    final_onehot = (torch.arange(Lp, device=dev)[None, :]
                    == (output_length[:, None] - 1))
    b = torch.full((B, Lp), NEG_INF, dtype=torch.float32, device=dev)
    betas = [None] * T
    for t in range(T - 1, -1, -1):
        c = _finite_max(b)
        nxt = _beta_step(torch.exp(b - c).reshape(B, nblk, W), intra,
                         inter).reshape(B, Lp)
        match_t = match_p[:, t]
        propagated = torch.log(nxt) + c + match_t
        init_t = torch.where(final_onehot, match_t,
                             torch.full_like(match_t, NEG_INF))
        b = torch.where((target_length == t + 1)[:, None], init_t,
                        propagated)
        betas[t] = b
    alpha = torch.stack(alphas, dim=1)[:, :, :L]
    beta = torch.stack(betas, dim=1)[:, :, :L]
    return beta[:, 0, 0], alpha, beta


def _banded_bwd_grads(match_all, band, alpha, beta, g):
    """Closed-form cotangents in the banded layout (``dag_banded.py:
    157-213``): the S matrix only on its two block diagonals, scattered back
    into the band; zero, never NaN, at -inf entries and for infeasible
    samples."""
    B, T, L = match_all.shape
    W = band.shape[2]
    logZ = beta[:, 0, 0][:, None, None]
    zero = torch.zeros((), dtype=torch.float32, device=match_all.device)

    expo = alpha + beta - match_all - logZ
    grad_match = torch.where(torch.isinf(match_all) | ~torch.isfinite(expo),
                             zero, torch.exp(expo)) * g[:, None, None]
    grad_match = torch.where(torch.isfinite(grad_match), grad_match, zero)

    alpha_p = _pad_vertices(alpha, W)
    beta_p = _pad_vertices(beta, W)
    Lp = alpha_p.shape[2]
    nblk = Lp // W
    w = _finite_max(alpha_p[:, :-1], dim=2)               # [B, T-1, 1]
    a_sh = torch.exp(alpha_p[:, :-1] - w).reshape(B, T - 1, nblk, W)
    b_sh = torch.exp(beta_p[:, 1:] + w - logZ)
    b_sh = torch.where(torch.isfinite(b_sh), b_sh, zero
                       ).reshape(B, T - 1, nblk, W)
    b_next = torch.cat([b_sh[:, :, 1:], torch.zeros_like(b_sh[:, :, :1])],
                       dim=2)
    # S restricted to the two block diagonals: sum over t of outer products
    a_t = a_sh.permute(0, 2, 3, 1)                        # [B, m, p, T-1]
    S_intra = torch.matmul(a_t, b_sh.permute(0, 2, 1, 3))  # [B, m, p, q]
    S_inter = torch.matmul(a_t, b_next.permute(0, 2, 1, 3))

    # band[b, mW+p, d] <- S_intra[p, p+d+1] (inside the block) or
    # S_inter[p, p+d+1-W] (the next block)
    p = torch.arange(W, device=band.device)[:, None]
    q_full = p + torch.arange(W, device=band.device)[None, :] + 1
    idx_i = q_full.clamp(0, W - 1)[None, None].expand(B, nblk, W, W)
    idx_x = (q_full - W).clamp(0, W - 1)[None, None].expand(B, nblk, W, W)
    S_band = torch.where(q_full < W, S_intra.gather(3, idx_i),
                         S_inter.gather(3, idx_x)).reshape(B, Lp, W)[:, :L]

    grad_band = S_band * torch.exp(band.float()) * g[:, None, None]
    grad_band = torch.where(torch.isfinite(grad_band), grad_band, zero)
    return grad_match, grad_band


class _DagLossBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, match_all, band, output_length, target_length):
        logprob, alpha, beta = banded_forward(match_all, band, output_length,
                                              target_length)
        ctx.save_for_backward(match_all, band, alpha, beta)
        return logprob

    @staticmethod
    def backward(ctx, g):
        match_all, band, alpha, beta = ctx.saved_tensors
        gm, gb = _banded_bwd_grads(match_all.float(), band.float(), alpha,
                                   beta, g)
        return gm, gb, None, None


class _DagLossBandedWithAlphaBeta(torch.autograd.Function):
    @staticmethod
    def forward(ctx, match_all, band, output_length, target_length):
        logprob, alpha, beta = banded_forward(match_all, band, output_length,
                                              target_length)
        ctx.save_for_backward(match_all, band, alpha, beta)
        return logprob, alpha, beta

    @staticmethod
    def backward(ctx, g, _g_alpha, _g_beta):
        # the alpha/beta cotangents are dropped, as ``_dlbab_bwd`` does
        # (``dag_banded.py:257-261``): the posteriors are constants
        match_all, band, alpha, beta = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(alpha[:, 0, 0])
        gm, gb = _banded_bwd_grads(match_all.float(), band.float(), alpha,
                                   beta, g)
        return gm, gb, None, None


def dag_loss_banded(match_all, band, output_length, target_length):
    """DAG marginal log-likelihood logZ [B] over banded links [B, L, W],
    differentiable in match_all and band (``dag_banded.py:216-247``)."""
    return _DagLossBanded.apply(match_all, band, output_length,
                                target_length)


def dag_loss_banded_with_alpha_beta(match_all, band, output_length,
                                    target_length):
    """(logprob, alpha, beta) over banded links; only logprob carries
    gradient (``dag_banded.py:236-264``)."""
    return _DagLossBandedWithAlphaBeta.apply(match_all, band, output_length,
                                             target_length)


@torch.no_grad()
def dag_best_alignment_banded(match_all, band, output_length, target_length):
    """Banded Viterbi path [B, L] int32 (``dag_banded.py:267-347``): a
    max-plus forward over the two block diagonals, then the backtrace of
    ``dag_ref.dag_best_alignment``. Within a diagonal the first maximal
    source wins; between the two, the intra one unless the inter one is
    strictly greater."""
    match_all = match_all.float()
    band = band.float()
    B, T, L = match_all.shape
    W = band.shape[2]
    blocks, d_intra, d_inter, upper = _band_blocks(band)
    nblk = blocks.shape[1]
    Lp = nblk * W
    match_p = _pad_vertices(match_all, W)
    ninf = torch.full((), NEG_INF, device=band.device)
    Ti = torch.where(upper, _gather_d(blocks, d_intra), ninf)   # log space
    Tx = torch.where(~upper, _gather_d(blocks, d_inter), ninf)
    Tx[:, -1] = NEG_INF
    base = (torch.arange(nblk, device=band.device) * W)[None, :, None]

    f = torch.full((B, Lp), NEG_INF, dtype=torch.float32,
                   device=band.device)
    f[:, 0] = match_all[:, 0, 0]
    traces = []
    for t in range(1, T):
        fb = f.reshape(B, nblk, W)
        best_i, arg_i = (fb[..., None] + Ti).max(dim=2)   # into block m
        best_x, arg_x = (fb[..., None] + Tx).max(dim=2)   # into block m+1
        arg_i = arg_i + base
        arg_x = arg_x + base
        best_x = torch.cat([torch.full_like(best_x[:, :1], NEG_INF),
                            best_x[:, :-1]], dim=1)
        arg_x = torch.cat([torch.zeros_like(arg_x[:, :1]), arg_x[:, :-1]],
                          dim=1)
        take_x = best_x > best_i
        best = torch.where(take_x, best_x, best_i).reshape(B, Lp)
        traces.append(torch.where(take_x, arg_x, arg_i).reshape(B, Lp))
        f = best + match_p[:, t]
    return backtrace(traces, output_length, target_length, L)
