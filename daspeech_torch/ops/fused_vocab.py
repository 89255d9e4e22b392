"""Vocabulary projection + log-softmax + target gather, streamed over
vocabulary chunks (PyTorch).

Counterpart of ``daspeech_tpu/ops/fused_vocab.py``, the functional form of
the reference's in-place ``logsoftmax_gather`` (``DASpeech/custom_ops/
logsoftmax_gather.cu``). With a multilingual subword vocabulary (|V| ~ 10k,
B = 80, L = 240) the [B, L, V] fp32 logits alone are 768 MB; here they never
exist:

    match[b, t, j] = (feat[b, j] . W[:, y_t] + bias[y_t]) - logZ[b, j]
    logZ[b, j]     = logsumexp_v(feat[b, j] . W[:, v] + bias[v])

with logZ accumulated over chunks of the vocabulary (a running maximum and
a rescaled sum), so the peak is O(B L chunk). The backward recomputes each
chunk's softmax instead of storing it (G = sum_t g):

    d feat[b, j] = sum_t g[b, t, j] W[:, y_t] - G[b, j] (p[b, j, :] @ W^T)
    d W[:, v]    = sum_{b, j} feat[b, j] (g scattered at y)[v]
                   - sum_{b, j} G[b, j] p[b, j, v] feat[b, j]
    d bias[v]    = (g scattered at y)[v] - sum_{b, j} G[b, j] p[b, j, v]

An odd |V| is padded to whole chunks with zero columns and a -inf bias.
Everything runs in fp32 (inputs are cast, as JAX's op casts them), so the
op composes with bf16 compute. Plain tensor ops on any device: there is no
kernel behind this module; matmuls run with TF32 off.
"""

from __future__ import annotations

import torch


def _chunks(W: torch.Tensor, bias: torch.Tensor, chunk: int):
    """(W_i [D, chunk], b_i [chunk]) over the vocabulary, the last chunk
    padded with zero columns and -inf biases."""
    V = W.shape[1]
    for c0 in range(0, V, chunk):
        Wi, bi = W[:, c0:c0 + chunk], bias[c0:c0 + chunk]
        pad = chunk - Wi.shape[1]
        if pad:
            Wi = torch.cat([Wi, Wi.new_zeros((Wi.shape[0], pad))], dim=1)
            bi = torch.cat([bi, bi.new_full((pad,), -torch.inf)])
        yield c0, Wi, bi


def _chunked_logz(feat2d: torch.Tensor, W: torch.Tensor, bias: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """logZ [N] of feat2d [N, D] by a streaming logsumexp over vocabulary
    chunks (``fused_vocab.py:38-66``)."""
    N = feat2d.shape[0]
    m = feat2d.new_full((N,), -torch.inf)
    s = feat2d.new_zeros((N,))
    for _, Wi, bi in _chunks(W, bias, chunk):
        logits = feat2d @ Wi + bi
        m_new = torch.maximum(m, logits.amax(dim=-1))
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
    return torch.log(s) + m


def _target_columns(W: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """W[:, y] as [B, T, D]."""
    return W.t()[targets]


def _gathered_logits(feat, W, bias, targets) -> torch.Tensor:
    """Unnormalised match [B, T, L]: feat [B, L, D] . W[:, y_t] + bias[y_t]
    (``fused_vocab.py:69-75``)."""
    un = torch.bmm(_target_columns(W, targets), feat.transpose(1, 2))
    return un + bias[targets][:, :, None]


def _fp32(feat, W, bias):
    return feat.float(), W.float(), bias.float()


class _FusedLogSoftmaxGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, W, bias, targets, chunk):
        dtypes = (feat.dtype, W.dtype, bias.dtype)
        feat, W, bias = _fp32(feat, W, bias)
        targets = targets.long()
        B, L, D = feat.shape
        logz = _chunked_logz(feat.reshape(B * L, D), W, bias,
                             chunk).reshape(B, L)
        ctx.save_for_backward(feat, W, bias, targets, logz)
        ctx.chunk, ctx.dtypes = chunk, dtypes
        return _gathered_logits(feat, W, bias, targets) - logz[:, None, :]

    @staticmethod
    def backward(ctx, g):
        feat, W, bias, targets, logz = ctx.saved_tensors
        B, L, D = feat.shape
        V = W.shape[1]
        g = g.float()                                          # [B, T, L]
        ys = targets.reshape(-1)

        # the gather-side terms
        dfeat = torch.bmm(g.transpose(1, 2), _target_columns(W, targets))
        gf = torch.bmm(g, feat)                                # [B, T, D]
        dW = feat.new_zeros((V, D)).index_add_(0, ys, gf.reshape(-1, D))
        dbias = feat.new_zeros((V,)).index_add_(0, ys, g.sum(dim=2)
                                                .reshape(-1))

        # the softmax-side terms, streamed over the vocabulary
        feat2d = feat.reshape(B * L, D)
        G = g.sum(dim=1).reshape(B * L, 1)
        logz2 = logz.reshape(B * L, 1)
        dfeat_soft = torch.zeros_like(feat2d)
        for c0, Wi, bi in _chunks(W, bias, ctx.chunk):
            gp = torch.exp(feat2d @ Wi + bi - logz2) * G        # [N, C]
            dfeat_soft += gp @ Wi.t()
            n = min(ctx.chunk, V - c0)
            dW[c0:c0 + n] -= (gp.t() @ feat2d)[:n]
            dbias[c0:c0 + n] -= gp.sum(dim=0)[:n]
        dfeat = dfeat - dfeat_soft.reshape(B, L, D)
        ft, wt, bt = ctx.dtypes
        return dfeat.to(ft), dW.t().to(wt), dbias.to(bt), None, None


def fused_logsoftmax_gather(feat: torch.Tensor, W: torch.Tensor,
                            bias: torch.Tensor, targets: torch.Tensor,
                            vocab_chunk: int = 2048) -> torch.Tensor:
    """match [B, T, L] f32 = log_softmax(feat @ W + bias)[..., y_t] without
    the [B, L, V] logits (``fused_vocab.py:78-165``): feat [B, L, D],
    W [D, V], bias [V], targets [B, T]. Differentiable in feat, W and
    bias."""
    return _FusedLogSoftmaxGather.apply(feat, W, bias, targets, vocab_chunk)


@torch.no_grad()
def streaming_argmax_and_match(feat: torch.Tensor, W: torch.Tensor,
                               bias: torch.Tensor, targets: torch.Tensor,
                               vocab_chunk: int = 2048):
    """(argmax tokens [B, L], match [B, T, L]) for the glance pass, without
    the [B, L, V] logits (``fused_vocab.py:168-208``). A tie between chunks
    keeps the earlier chunk's index (strictly greater wins), a tie inside
    one the first index."""
    feat, W, bias = _fp32(feat, W, bias)
    B, L, D = feat.shape
    feat2d = feat.reshape(B * L, D)
    N = B * L
    m = feat.new_full((N,), -torch.inf)
    s = feat.new_zeros((N,))
    best = feat.new_full((N,), -torch.inf)
    best_ix = torch.zeros((N,), dtype=torch.int64, device=feat.device)
    for c0, Wi, bi in _chunks(W, bias, vocab_chunk):
        logits = feat2d @ Wi + bi
        cmax, carg = logits.max(dim=-1)
        better = cmax > best
        best = torch.where(better, cmax, best)
        best_ix = torch.where(better, carg + c0, best_ix)
        m_new = torch.maximum(m, cmax)
        s = s * torch.exp(m - m_new) + torch.exp(
            logits - m_new[:, None]).sum(dim=-1)
        m = m_new
    logz = (torch.log(s) + m).reshape(B, L)
    match = _gathered_logits(feat, W, bias, targets.long()) - logz[:, None, :]
    return best_ix.reshape(B, L), match
