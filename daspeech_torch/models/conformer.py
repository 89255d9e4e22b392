"""Conformer speech encoder (PyTorch), batch-first.

Counterpart of ``daspeech_tpu/models/conformer.py``: Conv1d 2x-stride-2 GLU
subsampler, scaled embedding, rel-pos MHSA in the rotation form, macaron
FFNs and the depthwise-conv module. The rel-pos attention always goes
through ``ops.fused_relpos.fused_attention_relpos`` (CUDA kernels for CUDA
tensors, plain versions for CPU tensors). A forward given ``rng`` is a
training pass (``models/layers.py``): dropout on, BatchNorm on the batch's
valid frames.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch.models.layers import (
    FP32,
    Compute,
    Conv1d,
    Linear,
    dropout,
    layer_norm,
    padding_bias,
    row_seeds,
    set_dtype,
)
from daspeech_torch.ops import fused_ffn as _ff
from daspeech_torch.ops import fused_relpos as _fr
from daspeech_torch.parallel import multihost as mh


class Conv1dSubsampler(nn.Module):
    """Two stride-2 Conv1d + GLU (``conformer.py:23-60``); frames beyond
    ``lengths`` are zeroed before each conv and after the last."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 kernel_sizes: Tuple[int, ...] = (5, 5)):
        super().__init__()
        n = len(kernel_sizes)
        self.conv = nn.ModuleList()     # flax conv0, conv1, ...
        cin = in_channels
        for i, k in enumerate(kernel_sizes):
            cout = mid_channels if i < n - 1 else out_channels * 2
            self.conv.append(Conv1d(cin, cout, k, stride=2,
                                    padding=k // 2))
            cin = cout // 2

    def forward(self, x: torch.Tensor, lengths: torch.Tensor):
        # x: [B, T, F] -> [B, T', C]
        for conv in self.conv:
            mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                    < lengths[:, None])
            x = x * mask[:, :, None]
            x = F.glu(conv(x.transpose(1, 2)), dim=1).transpose(1, 2)
            lengths = torch.floor((lengths.float() - 1) / 2 + 1).long()
        mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                < lengths[:, None])
        return x * mask[:, :, None], lengths


class RelPosMultiHeadAttention(Compute, nn.Module):
    """Transformer-XL rel-pos MHSA with learned pos_bias_u/v in the rotation
    form (``conformer.py:99-189``), dropout on the probabilities. In bf16,
    pos_bias_u/v, the permuted ``linear_pos`` kernel, the rotation's sin/cos
    and the basis e are rounded to bf16 (``conformer.py:143-154``), and the
    attention kernel takes bf16 q_u, k, v, a and e."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        C, d = embed_dim, embed_dim // num_heads
        self.linear_q = Linear(C, C)
        self.linear_k = Linear(C, C)
        self.linear_v = Linear(C, C)
        self.linear_out = Linear(C, C)
        self.linear_pos = Linear(C, C, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, d))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, d))
        # split-half (sin | cos) channel order of W_p's input rows
        self.register_buffer(
            "perm", torch.cat([torch.arange(0, C, 2), torch.arange(1, C, 2)]),
            persistent=False)

    def forward(self, x: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, C = x.shape
        H = self.num_heads
        d = C // H
        q = self.linear_q(x)
        k = self.linear_k(x)
        v = self.linear_v(x)
        cast = self.compute
        q_u = q + cast(self.pos_bias_u.reshape(-1))
        q_v = (q + cast(self.pos_bias_v.reshape(-1))).reshape(B, T, H, d)
        # z = W_p^T q_v per head; flax's kernel [in, out] is weight^T
        Kr = cast(self.linear_pos.weight.t()[self.perm]).reshape(C, H, d)
        z = torch.einsum("bthm,chm->bthc", q_v, Kr)          # [B, T, H, C]
        s_i, c_i, e = _fr.relpos_basis(T, C, device=x.device)
        a = _fr.relpos_rotate(z, cast(s_i[:, None]), cast(c_i[:, None]))
        e = cast(e)
        bias = padding_bias(key_padding_mask, B, T, x.device)
        seeds = row_seeds(rng, self.dropout, B, x.device)
        out = _fr.fused_attention_relpos(
            q_u, k, v, a.reshape(B, T, H * C), e, bias, H, 1.0 / math.sqrt(d),
            0.0 if seeds is None else self.dropout, seeds)
        return self.linear_out(out)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the channel axis of [B, T, C] (``conformer.py:
    203-240``; eps 1e-5). Inference uses the running statistics; a training
    pass (``valid`` given) normalizes by the mean and biased variance of the
    valid frames only and moves the running statistics toward them with
    flax's momentum 0.9 (in place, outside autograd). The statistics, the
    running statistics and the output are float32 whatever the input's
    dtype, as in JAX (a bf16 input meets the fp32 mask and statistics)."""

    MOMENTUM = 0.9

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
        if valid is None:
            mean, var = self.running_mean, self.running_var
        else:
            if mh.step_group() is not None:
                mean, var = self._group_statistics(x, valid)
            else:
                w = valid[:, :, None].to(FP32)
                n = torch.clamp(w.sum(), min=1.0)
                mean = (x * w).sum(dim=(0, 1)) / n
                var = (torch.square(x - mean) * w).sum(dim=(0, 1)) / n
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias

    @staticmethod
    def _group_statistics(x: torch.Tensor, valid: torch.Tensor):
        """The masked mean and biased variance of the valid frames of every
        rank of the data-parallel step (``parallel.multihost``), in the
        single-process arithmetic: the summed frames and their count give
        the mean, then the summed centred squares the variance (not
        E[x^2] - E[x]^2, which rounds otherwise). Both sums are reduced
        differentiably: each rank's frames move every rank's statistics.
        The sums and the count are float32 (a bf16 x meets the fp32 w)."""
        w = valid[:, :, None].to(FP32)
        C = x.shape[-1]
        sums = mh.global_sum_autograd(torch.cat([(x * w).sum(dim=(0, 1)),
                                                 w.sum()[None]]))
        n = torch.clamp(sums[C], min=1.0)
        mean = sums[:C] / n
        var = mh.global_sum_autograd(
            (torch.square(x - mean) * w).sum(dim=(0, 1))) / n
        return mean, var


class ConvolutionModule(nn.Module):
    """Pointwise-GLU -> depthwise conv -> BatchNorm -> swish -> pointwise
    -> dropout (``conformer.py:243-290``); padded frames are zeroed before
    the depthwise conv and left out of the BatchNorm statistics."""

    def __init__(self, embed_dim: int, kernel_size: int = 31,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = layer_norm(embed_dim)
        self.pointwise_conv1 = Linear(embed_dim, 2 * embed_dim, bias=False)
        self.depthwise_conv = Conv1d(
            embed_dim, embed_dim, kernel_size, padding=(kernel_size - 1) // 2,
            groups=embed_dim, bias=False)
        self.batch_norm = MaskedBatchNorm(embed_dim)
        self.pointwise_conv2 = Linear(embed_dim, embed_dim, bias=False)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.glu(self.pointwise_conv1(self.layer_norm(x)), dim=-1)
        if pad_mask is not None:
            x = x * (~pad_mask)[:, :, None]
        x = self.depthwise_conv(x.transpose(1, 2)).transpose(1, 2)
        valid = None
        if rng is not None:
            valid = (torch.ones(x.shape[:2], dtype=torch.bool,
                                device=x.device)
                     if pad_mask is None else ~pad_mask)
        x = self.pointwise_conv2(F.silu(self.batch_norm(x, valid)))
        return dropout(x, self.dropout, rng)


class FeedForwardModule(Compute, nn.Module):
    """Macaron FFN with swish (``conformer.py:321-370``): LN -> W1 -> swish
    -> dropout -> W2 -> dropout.

    ``fused=True`` (JAX's field, ``conformer.py:337``; default off, and no
    ``ConformerEncoderLayer`` sets it) routes a 3-D input through
    ``ops.fused_ffn.fused_ffn`` with the same parameters, handing it the
    ``nn.Linear`` weights as they are; a training pass draws its B per-row
    dropout seeds from ``rng``. JAX takes its Pallas kernel only while
    ``ffn_fits_vmem`` holds (about 200 rows at C=256, F=2048) and on one
    TPU, and XLA's unfused path otherwise; the port's kernel tiles rows and
    takes any T. Both routes compute the same function. In bf16 the fused
    route hands the kernel x and the weights and biases in bf16 and
    LayerNorm's parameters in fp32 (``conformer.py:359-363``)."""

    def __init__(self, embed_dim: int, ffn_dim: int, dropout: float = 0.0,
                 fused: bool = False):
        super().__init__()
        self.dropout = dropout
        self.fused = fused
        self.layer_norm = layer_norm(embed_dim)
        self.w_1 = Linear(embed_dim, ffn_dim)
        self.w_2 = Linear(ffn_dim, embed_dim)

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.fused and x.dim() == 3:
            seeds = row_seeds(rng, self.dropout, x.shape[0], x.device)
            p = 0.0 if seeds is None else self.dropout
            c = self.compute
            return _ff.fused_ffn(
                c(x), self.layer_norm.weight, self.layer_norm.bias,
                c(self.w_1.weight), c(self.w_1.bias), c(self.w_2.weight),
                c(self.w_2.bias), seeds, p, p, seeds is not None)
        x = dropout(F.silu(self.w_1(self.layer_norm(x))), self.dropout, rng)
        return dropout(self.w_2(x), self.dropout, rng)


class ConformerEncoderLayer(nn.Module):
    """Macaron block (``conformer.py:373-412``)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 depthwise_kernel_size: int = 31, dropout: float = 0.0,
                 attn_dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.ffn1 = FeedForwardModule(embed_dim, ffn_dim, dropout)
        self.self_attn_layer_norm = layer_norm(embed_dim)
        self.self_attn = RelPosMultiHeadAttention(embed_dim, num_heads,
                                                  attn_dropout)
        self.conv_module = ConvolutionModule(embed_dim, depthwise_kernel_size,
                                             dropout)
        self.ffn2 = FeedForwardModule(embed_dim, ffn_dim, dropout)
        self.final_layer_norm = layer_norm(embed_dim)

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x, rng)
        y = self.self_attn(self.self_attn_layer_norm(x),
                           key_padding_mask=pad_mask, rng=rng)
        x = x + dropout(y, self.dropout, rng)
        x = x + self.conv_module(x, pad_mask, rng)
        x = x + 0.5 * self.ffn2(x, rng)
        return self.final_layer_norm(x)


class ConformerEncoder(nn.Module):
    """``S2TConformerEncoder``, rel_pos variant (``conformer.py:415-463``):
    fbank [B, T, 80] + lengths -> states [B, T', C], padding mask [B, T']
    (True = pad) and T' lengths; ``dtype`` is the compute dtype
    (``set_dtype``)."""

    def __init__(self, cfg, dtype: torch.dtype = FP32):
        super().__init__()
        self.scale = 1.0 if cfg.no_scale_embedding else math.sqrt(cfg.embed_dim)
        self.dropout = cfg.dropout
        self.subsample = Conv1dSubsampler(
            cfg.input_feat_dim, cfg.conv_channels, cfg.embed_dim,
            tuple(cfg.conv_kernel_sizes))
        self.linear = Linear(cfg.embed_dim, cfg.embed_dim)
        self.layers = nn.ModuleList(
            ConformerEncoderLayer(cfg.embed_dim, cfg.ffn_dim, cfg.num_heads,
                                  cfg.depthwise_kernel_size, cfg.dropout,
                                  cfg.attn_dropout)
            for _ in range(cfg.num_layers))
        set_dtype(self, dtype)

    def forward(self, fbank: torch.Tensor, lengths: torch.Tensor,
                rng: Optional[torch.Generator] = None):
        x, out_lengths = self.subsample(fbank, lengths)
        T = x.shape[1]
        pad_mask = (torch.arange(T, device=x.device)[None, :]
                    >= out_lengths[:, None])
        x = dropout(self.linear(x * self.scale), self.dropout, rng)
        for layer in self.layers:
            x = layer(x, pad_mask, rng)
        return x.masked_fill(pad_mask[:, :, None], 0.0), pad_mask, out_lengths
