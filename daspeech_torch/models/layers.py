"""Shared building blocks (PyTorch), batch-first ``[B, T, C]``.

Counterpart of ``daspeech_tpu/models/layers.py``. Every LayerNorm uses
eps 1e-6, flax's default (torch's is 1e-5). Attention goes through
``ops.fused_attention``: the packed kernel, or the head-major one for the
long sequences the JAX layer sends there (``packed_route``); both launch
the CUDA kernels for CUDA tensors and take the plain versions for CPU
tensors. A causal attention, or one built with ``fused=False``, takes
JAX's unfused path in plain tensor ops instead.

The compute dtype is flax's ``dtype`` field: ``set_dtype(model, dtype)``
(which the models' ``dtype`` argument calls) sets it on every
:class:`Compute` module of a model. Parameters stay float32 whatever it is.
In bfloat16 each :class:`Linear`, :class:`Conv1d` and :class:`Embedding`
rounds its operands to bf16 and its result once (the product summed in
fp32), then adds its bias in bf16, as flax's ``nn.Dense``/``nn.Conv`` do;
each :class:`LayerNorm` normalizes in fp32 and rounds its output once; the
other tensor ops follow torch's type promotion, which is JAX's (bf16 with
bf16 stays bf16, bf16 with a float32 tensor is float32, a Python float
keeps the tensor's type).

Training mode is an argument, as ``train=True`` is in the JAX modules: a
forward given ``rng`` (a ``torch.Generator`` on the tensors' device) is a
training pass. It draws its dropout masks and the attention kernels'
per-row dropout seeds from ``rng``, in call order, so two passes handed
generators with the same seed drop the same elements; BatchNorm takes batch
statistics. Without ``rng`` a forward is the inference path.

Tensor parallelism (``parallel.partition.tensor_parallel``) leaves each
module its rank's shard of the parameters JAX's rules place over ``model``
and sets ``tp`` (a ``parallel.shard.Axis``) on the modules that hold one:
a :class:`Linear` then runs column-parallel (``tp_mode`` "col": its input
enters through ``shard.copy_to``), row-parallel ("row": its product summed
over the ranks, then the bias) or row-parallel on a replicated input
("row_rep": the rank's slice of the input first); an :class:`Embedding`
holds its rank's rows of the vocabulary; the attention runs its rank's
heads, the FFNs their slice of the inner width. Every dropout draws the
unsharded mask and keeps the rank's slice (:func:`dropout`'s ``shards``),
so that a sharded step drops what one process drops.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from daspeech_torch.ops import fused_attention as _fa
from daspeech_torch.ops.fused_attention import NEG
from daspeech_torch.parallel import shard

LN_EPS = 1e-6
FP32 = torch.float32
BF16 = torch.bfloat16
DTYPES = (FP32, BF16)


class Compute:
    """A module with a compute dtype (flax's ``dtype`` field), float32
    unless :func:`set_dtype` sets it. In float32 a module computes in the
    dtype of its parameters and inputs, as before there was a choice (a
    float64 copy of a model stays float64)."""

    dtype = FP32

    def compute(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in the compute dtype (as it is, in float32 mode)."""
        return t if self.dtype == FP32 else t.to(self.dtype)


def set_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Set the compute dtype of every :class:`Compute` module under
    ``module`` (float32 or bfloat16); returns ``module``."""
    if dtype not in DTYPES:
        raise ValueError(f"compute dtype {dtype} unsupported "
                         f"(float32 or bfloat16)")
    for m in module.modules():
        if isinstance(m, Compute):
            m.dtype = dtype
    return module


class Linear(Compute, nn.Linear):
    """``nn.Dense(dtype=...)``: in bf16, x and the weight rounded to bf16,
    the product summed in fp32 and rounded once, then the bf16 bias added
    in bf16 (flax's ``y += bias`` after the dot). ``tp``/``tp_mode``: its
    tensor-parallel role (module docstring)."""

    tp: Optional[shard.Axis] = None
    tp_mode: str = ""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            if self.tp_mode == "col":
                x = shard.copy_to(x, self.tp)
            else:
                return self._row(x)
        if self.dtype == FP32:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        return y if self.bias is None else y + self.bias.to(self.dtype)

    def _row(self, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel: the rank's partial product (fp32 sums of the
        rounded operands in bf16) summed over the ranks, rounded once,
        then the (replicated) bias."""
        if self.tp_mode == "row_rep":
            x = shard.split(x, self.tp, -1, gathered=True)
        if self.dtype == FP32:
            y = shard.reduce_from(F.linear(x, self.weight), self.tp)
        else:
            y = shard.reduce_from(F.linear(
                x.to(self.dtype).float(),
                self.weight.to(self.dtype).float()), self.tp).to(self.dtype)
        return y if self.bias is None else y + self.compute(self.bias)


class _ComputeConv(Compute):
    """The rounding of :class:`Linear` for a torch conv module: in bf16 the
    input and weight rounded, the product (:meth:`product`, no bias)
    summed in fp32 and rounded once, then the bias in the compute dtype
    added (flax's ``nn.Conv(dtype=...)``)."""

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The conv without its bias, in the compute dtype."""
        return self._conv_forward(x.to(self.dtype),
                                  self.weight.to(self.dtype), None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == FP32:
            return super().forward(x)
        y = self.product(x)
        if self.bias is None:
            return y
        return y + self.bias.to(self.dtype).reshape(-1, *[1] * (y.dim() - 2))


class Conv1d(_ComputeConv, nn.Conv1d):
    """``nn.Conv(dtype=...)`` on [B, C, T]: the rounding of :class:`Linear`."""


class Conv2d(_ComputeConv, nn.Conv2d):
    """``nn.Conv(dtype=...)`` with a 2-D kernel on [B, C, H, W]: the
    rounding of :class:`Linear`."""


class ConvTranspose1d(_ComputeConv, nn.ConvTranspose1d):
    """``ConvTranspose1dTorch(dtype=...)`` (``hifigan.py:372-403``) on
    [B, C, T]: the rounding of :class:`Linear`."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        return F.conv_transpose1d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class LayerNorm(Compute, nn.LayerNorm):
    """``nn.LayerNorm(dtype=...)``: the fp32 layer norm of the input (fp32
    scale and bias), rounded once to the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == FP32:
            return super().forward(x)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class Embedding(Compute, nn.Embedding):
    """``nn.Embed(dtype=...)``: rows of the table in the compute dtype;
    :meth:`attend` is the tied output projection, ``x @ tableᵀ`` with the
    rounding of :class:`Linear`.

    With ``tp`` the table is the rank's rows of the vocabulary (rows
    ``tp.rank * n`` onward, n rows each): a lookup takes the rows it holds
    and sums over the ranks (one rank holds each token); :meth:`attend`
    gives the rank's columns of the logits inside a step's loss
    (``shard.vocab_axis``), the whole logits elsewhere."""

    tp: Optional[shard.Axis] = None

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.compute(super().forward(idx))
        n = self.weight.shape[0]
        local = idx - self.tp.rank * n
        held = (local >= 0) & (local < n)
        rows = F.embedding(local.clamp(0, n - 1), self.weight)
        return self.compute(shard.reduce_from(
            rows * held[..., None].to(rows.dtype), self.tp))

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.compute(x) @ self.compute(self.weight).t()
        logits = (self.compute(shard.copy_to(x, self.tp))
                  @ self.compute(self.weight).t())
        if shard.vocab_axis() is not None:
            return logits
        return shard.gather(logits, self.tp, -1, summed=False)


def layer_norm(dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=LN_EPS)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact erf form, the tanh approximation in half precision
    (``layers.py:19-27``)."""
    if x.dtype in (BF16, torch.float16):
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


ACTIVATIONS = {"relu": F.relu, "gelu": gelu, "swish": F.silu,
               "silu": F.silu, "tanh": torch.tanh}


def dropout(x: torch.Tensor, rate: float, rng: Optional[torch.Generator],
            shards=()) -> torch.Tensor:
    """JAX's u16-threshold dropout (``layers.py:39-71``): keep where a
    16-bit draw is below q = round((1 - rate) * 65536), scale kept values
    by 1 / keep_p with keep_p = q / 65536, that factor rounded to x's
    dtype as JAX rounds it (``jnp.asarray(1 / keep_p, x.dtype)``: 1.109375
    in bf16 at rate 0.1). Off without ``rng``. ``shards``: the ``(dim,
    shard.Axis)`` pairs along which ``x`` is a rank's equal share of the
    unsharded tensor; the draws are then the unsharded tensor's and x keeps
    its slice of them."""
    if rng is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    q = int(round((1.0 - rate) * 65536))
    if q >= 65536:            # rate below 2**-17 rounds to keep-all
        return x
    full, idx = shard.full_shape(x.shape, shards)
    bits = torch.randint(0, 65536, full, generator=rng, device=x.device,
                         dtype=torch.int32)[idx]
    scale = 65536.0 / q
    if x.dtype != FP32:
        scale = torch.tensor(scale, dtype=x.dtype).item()
    return torch.where(bits < q, x * scale, torch.zeros_like(x))


def heads(num_heads: int, tp: Optional[shard.Axis]):
    """(the heads this rank runs, the first of them among the layer's)."""
    if tp is None:
        return num_heads, 0
    return num_heads // tp.size, tp.rank * (num_heads // tp.size)


def tp_shards(tp: Optional[shard.Axis], dim: int):
    """The dropout shards of an activation split over ``tp`` along
    ``dim`` (none without ``tp``)."""
    return () if tp is None else ((dim, tp),)


def row_seeds(rng: Optional[torch.Generator], rate: float, B: int,
              device) -> Optional[torch.Tensor]:
    """[B] int32 per-row seeds of an attention kernel's dropout stream
    (``layers.py:194-196``), or None when the pass drops nothing."""
    if rng is None or rate == 0.0:
        return None
    return torch.randint(-2 ** 31, 2 ** 31, (B,), generator=rng,
                         device=device, dtype=torch.int32)


def make_positions(tokens: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """fairseq ``utils.make_positions``: numbering starts at
    ``padding_idx + 1``; pads keep ``padding_idx``."""
    mask = (tokens != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


class LearnedPositionalEmbedding(nn.Embedding):
    """fairseq learned positional embedding (offset by padding_idx + 1)."""

    def __init__(self, max_positions: int, dim: int, padding_idx: int = 1):
        super().__init__(max_positions + padding_idx + 1, dim)
        self.pad = padding_idx

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(make_positions(tokens, self.pad), self.weight)


def sinusoidal_embedding_table(num_positions: int, dim: int,
                               padding_idx: Optional[int] = 1,
                               device=None) -> torch.Tensor:
    """fairseq ``SinusoidalPositionalEmbedding.get_embedding``."""
    half_dim = dim // 2
    scale = math.log(10000) / (half_dim - 1)
    freq = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                  device=device) * -scale)
    ang = (torch.arange(num_positions, dtype=torch.float32,
                        device=device)[:, None] * freq[None, :])
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    if dim % 2 == 1:
        emb = torch.cat([emb, emb.new_zeros(num_positions, 1)], dim=1)
    if padding_idx is not None:
        emb[padding_idx] = 0
    return emb


class SinusoidalPositionalEmbedding(nn.Module):
    def __init__(self, max_positions: int, dim: int, padding_idx: int = 1):
        super().__init__()
        self.max_positions, self.dim, self.pad = max_positions, dim, padding_idx

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        table = sinusoidal_embedding_table(
            self.max_positions + self.pad + 1, self.dim, self.pad,
            device=tokens.device)
        return F.embedding(make_positions(tokens, self.pad), table)


def padding_bias(key_padding_mask: Optional[torch.Tensor], B: int, Tk: int,
                 device) -> torch.Tensor:
    """[B, Tk] additive column bias: NEG at padded keys, 0 elsewhere. Rows
    whose keys are ALL padding attend uniformly instead of producing NaN
    (``layers.py:182-185``); downstream masks discard them."""
    if key_padding_mask is None:
        return torch.zeros((B, Tk), dtype=torch.float32, device=device)
    all_masked = key_padding_mask.all(dim=-1, keepdim=True)
    kpm = key_padding_mask & ~all_masked
    return torch.where(kpm, NEG, 0.0).to(torch.float32)


class MultiHeadAttention(nn.Module):
    """MHA with an optional key-padding mask (True = pad) and dropout on the
    attention probabilities; ``layers.py:128-237``, with JAX's ``causal``
    and ``fused`` fields.

    ``fused=True`` and ``causal=False`` take the route of
    ``layers.py:164-176``: the packed kernel while ``packed_route(Tq, Tk,
    C, H)`` holds, else the head-major kernel through the [B, T, H, d] ->
    [B, H, T, d] transposes of ``:208-214``. Otherwise (JAX's unfused
    path, ``:215-237``) the scores are an einsum summed in fp32, -inf at
    padded keys (all-padded rows unmasked) and above the diagonal when
    causal, softmax in fp32, the probabilities in the compute dtype, then
    dropout (from ``rng``, as every other site) and the einsum with v.

    With ``tp`` each rank runs its ``H / size`` heads (from head ``h0``):
    q/k/v column-parallel, out_proj row-parallel; the route is decided
    from the layer's whole width, and the kernels and the plain path take
    the rank's heads with their dropout counted from ``h0``."""

    tp: Optional[shard.Axis] = None

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 causal: bool = False, fused: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.causal, self.fused = causal, fused
        self.q_proj = Linear(embed_dim, embed_dim)
        self.k_proj = Linear(embed_dim, embed_dim)
        self.v_proj = Linear(embed_dim, embed_dim)
        self.out_proj = Linear(embed_dim, embed_dim)

    def forward(self, query: torch.Tensor, key: torch.Tensor,
                value: torch.Tensor,
                key_padding_mask: Optional[torch.Tensor] = None,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        B, Tq, C = query.shape
        Tk = key.shape[1]
        d_head = C // self.num_heads
        H, h0 = heads(self.num_heads, self.tp)
        q = self.q_proj(query) * (d_head ** -0.5)
        k = self.k_proj(key)
        v = self.v_proj(value)
        if not self.fused or self.causal:
            out = self._plain(q, k, v, key_padding_mask, rng, H)
            return self.out_proj(out.reshape(B, Tq, H * d_head))
        bias = padding_bias(key_padding_mask, B, Tk, key.device)
        seeds = row_seeds(rng, self.dropout, B, key.device)
        p = 0.0 if seeds is None else self.dropout
        if _fa.packed_route(Tq, Tk, C, self.num_heads):
            out = _fa.fused_attention_packed(q, k, v, bias, H, 1.0, p, seeds,
                                             h0)
        else:
            def to_bhtd(x):
                return x.reshape(B, x.shape[1], H, d_head).transpose(
                    1, 2).contiguous()

            out = _fa.fused_attention(to_bhtd(q), to_bhtd(k), to_bhtd(v),
                                      bias, 1.0, p, seeds, h0)
            out = out.transpose(1, 2).reshape(B, Tq, H * d_head)
        return self.out_proj(out)

    def _plain(self, q, k, v, key_padding_mask, rng, H) -> torch.Tensor:
        """``layers.py:215-235`` on the projected q (scaled), k, v
        [B, T, H·d] -> [B, Tq, H, d]. The scores take fp32 operands (a bf16
        product is exact in fp32, as ``preferred_element_type=float32``
        keeps it); the output is summed in fp32 and rounded once."""
        B, Tq, C = q.shape
        Tk = k.shape[1]

        def split(x):       # [B, T, H, d], bf16 widened to fp32
            x = x.reshape(B, x.shape[1], H, C // H)
            return x.float() if x.dtype == BF16 else x

        scores = torch.einsum("bqhd,bkhd->bhqk", split(q), split(k))
        if key_padding_mask is not None:
            all_masked = key_padding_mask.all(dim=-1, keepdim=True)
            kpm = key_padding_mask & ~all_masked
            scores = scores.masked_fill(kpm[:, None, None, :], -math.inf)
        if self.causal:
            above = torch.ones(Tq, Tk, dtype=torch.bool,
                               device=q.device).triu(1)
            scores = scores.masked_fill(above, -math.inf)
        probs = dropout(torch.softmax(scores, dim=-1).to(q.dtype),
                        self.dropout, rng, tp_shards(self.tp, 1))
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(scores.dtype),
                           split(v))
        return out.to(q.dtype)


class TransformerFFN(nn.Module):
    """fc1 -> activation -> dropout -> fc2 -> dropout; with ``tp`` fc1
    column- and fc2 row-parallel over the inner width."""

    tp: Optional[shard.Axis] = None

    def __init__(self, ffn_dim: int, embed_dim: int, activation: str = "relu",
                 dropout: float = 0.0, activation_dropout: float = 0.0):
        super().__init__()
        self.fc1 = Linear(embed_dim, ffn_dim)
        self.fc2 = Linear(ffn_dim, embed_dim)
        self.act = ACTIVATIONS[activation]
        self.dropout, self.activation_dropout = dropout, activation_dropout

    def forward(self, x: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = dropout(self.act(self.fc1(x)), self.activation_dropout, rng,
                    tp_shards(self.tp, -1))
        return dropout(self.fc2(x), self.dropout, rng)


class TransformerDecoderLayer(nn.Module):
    """Transformer decoder layer (``layers.py:240-321``): post-norm unless
    ``normalize_before``; non-causal self-attention (the NAT decoder) unless
    ``causal`` (the AR text decoder). Both attentions take
    ``fused_attention`` as their ``fused``, as JAX's do."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 activation: str = "gelu", dropout: float = 0.0,
                 attention_dropout: float = 0.0,
                 activation_dropout: float = 0.0,
                 normalize_before: bool = False, causal: bool = False,
                 fused_attention: bool = True):
        super().__init__()
        self.dropout = dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(embed_dim, num_heads,
                                            attention_dropout, causal=causal,
                                            fused=fused_attention)
        self.self_attn_layer_norm = layer_norm(embed_dim)
        self.encoder_attn = MultiHeadAttention(embed_dim, num_heads,
                                               attention_dropout,
                                               fused=fused_attention)
        self.encoder_attn_layer_norm = layer_norm(embed_dim)
        self.ffn = TransformerFFN(ffn_dim, embed_dim, activation, dropout,
                                  activation_dropout)
        self.final_layer_norm = layer_norm(embed_dim)

    def _block(self, x, ln, body):
        """The residual x + body(x), with ``ln`` on body's input (pre-norm)
        or on the sum (post-norm)."""
        if self.normalize_before:
            return x + body(ln(x))
        return ln(x + body(x))

    def forward(self, x: torch.Tensor, self_pad_mask: Optional[torch.Tensor],
                enc_out: Optional[torch.Tensor],
                enc_pad_mask: Optional[torch.Tensor],
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self._block(x, self.self_attn_layer_norm, lambda y: dropout(
            self.self_attn(y, y, y, key_padding_mask=self_pad_mask, rng=rng),
            self.dropout, rng))
        if enc_out is not None:
            x = self._block(x, self.encoder_attn_layer_norm, lambda y: dropout(
                self.encoder_attn(y, enc_out, enc_out,
                                  key_padding_mask=enc_pad_mask, rng=rng),
                self.dropout, rng))
        return self._block(x, self.final_layer_norm,
                           lambda y: self.ffn(y, rng))


def lengths_to_padding_mask(lengths: torch.Tensor, max_len: int
                            ) -> torch.Tensor:
    """[B] -> [B, max_len] bool, True = pad."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            >= lengths[:, None])
