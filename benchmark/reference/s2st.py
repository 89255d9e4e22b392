"""Plain PyTorch reference of the two-pass S2ST model (DASpeech).

Written from the published description of each part, in plain tensor ops,
with no kernel, cache or batching trick of the program under test:

- Conformer encoder (Gulati et al. 2020; fairseq ``S2TConformerEncoder``
  with ``rel_pos`` attention): two stride-2 Conv1d + GLU subsampler,
  scaled input projection, per layer a half-step macaron FFN (LN, Linear,
  swish, Linear), Transformer-XL relative-position self-attention with
  learned biases u and v over an explicit [2T-1] table of sinusoidal
  relative positions, the convolution module (LN, pointwise GLU,
  depthwise conv, BatchNorm with running statistics, swish, pointwise),
  a second half-step FFN and a final LayerNorm;
- the DA-Transformer decoder (Huang et al. 2022): token and learned
  position embeddings, post-norm Transformer decoder layers (GELU), the
  tied output projection and the link predictor: a gated mixture over
  heads of row-softmaxed ``q_h k_hᵀ / sqrt(d)`` over the successors
  ``i < j < graph length``;
- lookahead decoding: every vertex's best token, a greedy walk from
  vertex 0 along ``argmax_j links[i, j] + beta * max log p(v_j)``,
  consecutive duplicate tokens collapsed;
- the FFN adaptor and FastSpeech 2 (Ren et al. 2021) on the path's hidden
  states: FFT blocks (post-norm self-attention, conv FFN), the duration,
  pitch and energy predictors with bucketed embeddings, the length
  regulator and the mel projection;
- HiFi-GAN V1 (Kong et al. 2020): conv_pre, four leaky-ReLU + transposed
  conv levels each followed by the mean of three ResBlock1 stacks, and
  conv_post with tanh.

Weights are read by name from a flat state dict; the names are those of the
checkpoint format the benchmark writes its seeded weights in. LayerNorms
use eps 1e-6 (the recipe's flax port), BatchNorm 1e-5. The module imports
torch alone. Run it with TF32 off (:func:`precision`) for the reference,
and with TF32 on for the control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
BN_EPS = 1e-5
LRELU = 0.1


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls and cuDNN convolutions in TF32 (``tf32``) or full fp32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def lin(x, sd, p, bias=True):
    y = x @ sd[p + ".weight"].t()
    return y + sd[p + ".bias"] if bias else y


def ln(x, sd, p):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"],
                        LN_EPS)


def conv(x, sd, p, stride=1, padding=0, dilation=1, groups=1, bias=True):
    """Conv1d on [B, C, T]."""
    return F.conv1d(x, sd[p + ".weight"], sd[p + ".bias"] if bias else None,
                    stride=stride, padding=padding, dilation=dilation,
                    groups=groups)


def glu(x, dim):
    a, b = x.chunk(2, dim=dim)
    return a * torch.sigmoid(b)


def swish(x):
    return x * torch.sigmoid(x)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def key_mask(scores, key_pad):
    """-inf at padded keys of [B, H, Tq, Tk] scores."""
    return scores.masked_fill(key_pad[:, None, None, :], float("-inf"))


def mha(xq, xkv, sd, p, H, key_pad):
    """Scaled dot-product multi-head attention with a key padding mask."""
    B, Tq, C = xq.shape
    d = C // H
    q = lin(xq, sd, p + ".q_proj").reshape(B, Tq, H, d).transpose(1, 2)
    k = lin(xkv, sd, p + ".k_proj").reshape(B, -1, H, d).transpose(1, 2)
    v = lin(xkv, sd, p + ".v_proj").reshape(B, -1, H, d).transpose(1, 2)
    s = key_mask(q @ k.transpose(-1, -2) / math.sqrt(d), key_pad)
    o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(B, Tq, C)
    return lin(o, sd, p + ".out_proj")


def positions(pad_mask, pad):
    """fairseq positions: 1-based counts of non-pad items, offset by the
    padding index; padding keeps the padding index."""
    keep = (~pad_mask).long()
    return torch.cumsum(keep, dim=1) * keep + pad


def sinusoid_table(n, dim, pad, device):
    """fairseq's sinusoidal table ([sin | cos] halves), row ``pad`` zero."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=device)
                     * -(math.log(10000.0) / (half - 1)))
    ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * freq
    t = torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)
    t[pad] = 0
    return t


# --------------------------------------------------------------- encoder

def relpos_table(T, C, device):
    """Sinusoidal encodings of the relative positions r = T-1 .. -(T-1)
    (row k holds r = T-1-k): channel 2f sin(r w_f), 2f+1 cos(r w_f),
    w_f = 10000^(-2f/C)."""
    r = torch.arange(T - 1, -T, -1, dtype=torch.float32, device=device)
    w = torch.exp(torch.arange(0, C, 2, dtype=torch.float32, device=device)
                  * -(math.log(10000.0) / C))
    pe = torch.zeros(2 * T - 1, C, device=device)
    pe[:, 0::2] = torch.sin(r[:, None] * w)
    pe[:, 1::2] = torch.cos(r[:, None] * w)
    return pe


def relpos_attention(x, sd, p, H, pad):
    """Transformer-XL attention: scores ((q+u)·k + (q+v)·W_p pe(i-j)) /
    sqrt(d), padded keys masked."""
    B, T, C = x.shape
    d = C // H
    q = lin(x, sd, p + ".linear_q").reshape(B, T, H, d)
    k = lin(x, sd, p + ".linear_k").reshape(B, T, H, d)
    v = lin(x, sd, p + ".linear_v").reshape(B, T, H, d)
    P = lin(relpos_table(T, C, x.device), sd, p + ".linear_pos",
            bias=False).reshape(2 * T - 1, H, d)
    qu = q + sd[p + ".pos_bias_u"]
    qv = q + sd[p + ".pos_bias_v"]
    ac = torch.einsum("bihd,bjhd->bhij", qu, k)
    bd_all = torch.einsum("bihd,rhd->bhir", qv, P)          # [B, H, T, 2T-1]
    i = torch.arange(T, device=x.device)
    idx = (T - 1) - i[:, None] + i[None, :]                  # row of r = i-j
    bd = bd_all.gather(3, idx[None, None].expand(B, H, T, T))
    s = key_mask((ac + bd) / math.sqrt(d), pad)
    o = torch.einsum("bhij,bjhd->bihd", torch.softmax(s, dim=-1), v)
    return lin(o.reshape(B, T, C), sd, p + ".linear_out")


def conformer(sd, p, cfg, fbank, lengths):
    """fbank [B, S, F], lengths [B] -> (states [B, T', C] zero at padding,
    padding mask [B, T'])."""
    x = fbank
    n = len(cfg["conv_kernel_sizes"])
    for i in range(n):
        frames = torch.arange(x.shape[1], device=x.device)
        x = x * (frames[None, :] < lengths[:, None])[:, :, None]
        k = cfg["conv_kernel_sizes"][i]
        x = glu(conv(x.transpose(1, 2), sd, f"{p}.subsample.conv.{i}",
                     stride=2, padding=k // 2), dim=1).transpose(1, 2)
        lengths = torch.div(lengths - 1, 2, rounding_mode="floor") + 1
    T = x.shape[1]
    pad = torch.arange(T, device=x.device)[None, :] >= lengths[:, None]
    x = x * (~pad)[:, :, None]
    scale = 1.0 if cfg["no_scale_embedding"] else math.sqrt(cfg["embed_dim"])
    x = lin(x * scale, sd, f"{p}.linear")
    H, K = cfg["num_heads"], cfg["depthwise_kernel_size"]

    def ffn(y, q):
        return lin(swish(lin(ln(y, sd, q + ".layer_norm"), sd, q + ".w_1")),
                   sd, q + ".w_2")

    for layer in range(cfg["num_layers"]):
        q = f"{p}.layers.{layer}"
        x = x + 0.5 * ffn(x, q + ".ffn1")
        x = x + relpos_attention(ln(x, sd, q + ".self_attn_layer_norm"), sd,
                                 q + ".self_attn", H, pad)
        c = q + ".conv_module"
        y = glu(lin(ln(x, sd, c + ".layer_norm"), sd, c + ".pointwise_conv1",
                    bias=False), dim=-1)
        y = y * (~pad)[:, :, None]
        y = F.conv1d(y.transpose(1, 2), sd[c + ".depthwise_conv.weight"],
                     padding=(K - 1) // 2, groups=y.shape[-1]).transpose(1, 2)
        bn = c + ".batch_norm"
        y = ((y - sd[bn + ".running_mean"])
             / torch.sqrt(sd[bn + ".running_var"] + BN_EPS)
             * sd[bn + ".weight"] + sd[bn + ".bias"])
        x = x + lin(swish(y), sd, c + ".pointwise_conv2", bias=False)
        x = x + 0.5 * ffn(x, q + ".ffn2")
        x = ln(x, sd, q + ".final_layer_norm")
    return x.masked_fill(pad[:, :, None], 0.0), pad


# --------------------------------------------------------------- decoder

def dag_decoder(sd, p, cfg, vocab, prev, enc, enc_pad):
    """Graph inputs prev [B, L] -> (logits [B, L, V], links [B, L, L] with
    -inf off the valid successors, features [B, L, D])."""
    padi = vocab["pad"]
    D, H = cfg["embed_dim"], cfg["num_heads"]
    pad = prev == padi
    pos = positions(pad, padi)
    emb = sd[p + ".embed_tokens.weight"]
    x = emb[prev] * math.sqrt(D) + sd[p + ".embed_positions.weight"][pos]
    for layer in range(cfg["num_layers"]):
        q = f"{p}.layers.{layer}"
        x = ln(x + mha(x, x, sd, q + ".self_attn", H, pad), sd,
               q + ".self_attn_layer_norm")
        x = ln(x + mha(x, enc, sd, q + ".encoder_attn", H, enc_pad), sd,
               q + ".encoder_attn_layer_norm")
        x = ln(x + lin(gelu(lin(x, sd, q + ".ffn.fc1")), sd, q + ".ffn.fc2"),
               sd, q + ".final_layer_norm")
    logits = x @ emb.t()
    feats = torch.cat([x, sd[p + ".link_positional.weight"][pos]], dim=-1)
    log_gates = torch.log_softmax(lin(feats, sd, p + ".gate_linear"), dim=-1)
    B, L, _ = x.shape
    d = D // H
    qh = lin(feats, sd, p + ".query_linear").reshape(B, L, H, d)
    kh = lin(feats, sd, p + ".key_linear").reshape(B, L, H, d)
    s = torch.einsum("bihd,bjhd->bhij", qh, kh) / math.sqrt(d)
    n = (~pad).sum(dim=1)
    i = torch.arange(L, device=x.device)
    valid = ((i[None, None, :] > i[None, :, None])
             & (i[None, None, :] < n[:, None, None]))          # [B, L, L]
    s = s.masked_fill(~valid[:, None], float("-inf"))
    logp = torch.log_softmax(s, dim=-1)                        # [B, H, L, L]
    links = torch.logsumexp(logp + log_gates.transpose(1, 2)[..., None],
                            dim=1)
    links = links.masked_fill(~valid, float("-inf"))
    return logits, links, x


def lookahead_walk(tok, score, n, pad):
    """Greedy walk from vertex 0 to vertex n-1 of one graph: ``tok`` [L]
    every vertex's best token, ``score`` [L, L] the hop scores (numpy).
    Returns (tokens, emitting vertices): the first token is vertex 0's, each
    later one a visited vertex whose token differs from the previous
    vertex's and is not padding."""
    hops = score.argmax(axis=1)
    tokens, verts = [int(tok[0])], []
    j = 0
    while j != n - 1:
        nxt = int(hops[j])
        if tok[nxt] != tok[j] and tok[nxt] != pad:
            tokens.append(int(tok[nxt]))
            verts.append(nxt)
        j = nxt
    return tokens, verts


# ------------------------------------------------------------ FastSpeech 2

def fft_layer(x, sd, p, H, K, pad):
    x = ln(x + mha(x, x, sd, p + ".self_attn", H, pad), sd, p + ".layer_norm")
    y = conv(F.relu(conv(x.transpose(1, 2), sd, p + ".ffn.conv1",
                         padding=(K - 1) // 2)),
             sd, p + ".ffn.conv2", padding=(K - 1) // 2).transpose(1, 2)
    return ln(y + x, sd, p + ".ffn.layer_norm")


def variance_predictor(x, sd, p, K):
    y = F.relu(conv(x.transpose(1, 2), sd, p + ".conv1",
                    padding=(K - 1) // 2)).transpose(1, 2)
    y = ln(y, sd, p + ".ln1")
    # the recipe's second conv pads 1 frame whatever its kernel size
    y = F.relu(conv(y.transpose(1, 2), sd, p + ".conv2",
                    padding=1)).transpose(1, 2)
    return lin(ln(y, sd, p + ".ln2"), sd, p + ".proj")[..., 0]


def bucket(values, lo, hi, n_bins):
    """Index of the bucket of ``values`` among ``n_bins - 1`` edges spread
    evenly over [lo, hi]: the number of edges <= value."""
    edges = torch.linspace(lo, hi, n_bins - 1, device=values.device)
    return (values[..., None] >= edges).sum(dim=-1)


def synthesize(sd, cfg, pad_idx, z, zmask, max_mel_len):
    """Path features z [B, N, D] (zmask True = padding) -> (mel [B, M, 80],
    mel lengths [B]): adaptor, FastSpeech 2 encoder, variance adaptor with
    predicted durations, pitch and energy, length regulator, decoder."""
    x = lin(F.relu(lin(z, sd, "adaptor.fc1")), sd, "adaptor.fc2")
    H, K = cfg["encoder_heads"], cfg["fft_kernel_size"]
    tab = sinusoid_table(x.shape[1] + pad_idx + 1, x.shape[-1], pad_idx,
                         x.device)
    x = x + sd["tts.pos_emb_alpha"] * tab[positions(zmask, pad_idx)]
    for layer in range(cfg["encoder_layers"]):
        x = fft_layer(x, sd, f"tts.encoder_fft.{layer}", H, K, zmask)
    va, Kv = "tts.var_adaptor", cfg["var_pred_kernel_size"]
    log_dur = variance_predictor(x, sd, va + ".duration_predictor", Kv)
    dur = torch.clamp(torch.round(torch.exp(log_dur) - 1), min=0).long()
    dur = dur.masked_fill(zmask, 0)
    nb = cfg["var_pred_n_bins"]
    pitch = variance_predictor(x, sd, va + ".pitch_predictor", Kv)
    x = x + sd[va + ".embed_pitch.weight"][
        bucket(pitch, cfg["pitch_min"], cfg["pitch_max"], nb)]
    energy = variance_predictor(x, sd, va + ".energy_predictor", Kv)
    x = x + sd[va + ".embed_energy.weight"][
        bucket(energy, cfg["energy_min"], cfg["energy_max"], nb)]
    # length regulator: frame m copies the token whose duration span
    # covers it; frames past the total are zero
    ends = torch.cumsum(dur, dim=1)                             # [B, N]
    mel_lens = ends[:, -1]
    m = torch.arange(max_mel_len, device=x.device)
    src = (m[None, :, None] >= ends[:, None, :]).sum(dim=-1)    # [B, M]
    src = src.clamp(max=x.shape[1] - 1)
    x = x.gather(1, src[:, :, None].expand(-1, -1, x.shape[-1]))
    dec_pad = m[None, :] >= mel_lens[:, None]
    x = x * (~dec_pad)[:, :, None]
    tab = sinusoid_table(max_mel_len + pad_idx + 1, x.shape[-1], pad_idx,
                         x.device)
    x = x + sd["tts.dec_pos_emb_alpha"] * tab[positions(dec_pad, pad_idx)]
    H = cfg["decoder_heads"]
    for layer in range(cfg["decoder_layers"]):
        x = fft_layer(x, sd, f"tts.decoder_fft.{layer}", H, K, dec_pad)
    return lin(x, sd, "tts.out_proj"), mel_lens


# --------------------------------------------------------------- HiFi-GAN

def hifigan(sd, cfg, mel):
    """mel [B, M, 80] -> waveform [B, M * prod(upsample_rates)]."""
    x = conv(mel.transpose(1, 2), sd, "conv_pre", padding=3)
    nk = len(cfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                   cfg["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(F.leaky_relu(x, LRELU), sd[f"ups.{i}.weight"],
                               sd[f"ups.{i}.bias"], stride=u,
                               padding=(k - u) // 2)
        total = None
        for j, (rk, dils) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                           cfg["resblock_dilation_sizes"])):
            p = f"resblocks.{i * nk + j}"
            y = x
            for t, dl in enumerate(dils):
                h = conv(F.leaky_relu(y, LRELU), sd, f"{p}.convs1.{t}",
                         padding=(rk - 1) // 2 * dl, dilation=dl)
                y = y + conv(F.leaky_relu(h, LRELU), sd, f"{p}.convs2.{t}",
                             padding=(rk - 1) // 2)
            total = y if total is None else total + y
        x = total / nk
    # the published generator's last activation takes torch's default slope
    x = conv(F.leaky_relu(x, 0.01), sd, "conv_post", padding=3)
    return torch.tanh(x)[:, 0]


# ------------------------------------------------------------- the model

class S2ST:
    """The whole two-pass model over one padded batch."""

    def __init__(self, sd: Dict[str, torch.Tensor], cfg: dict):
        self.sd = sd
        self.model = cfg["model"]
        self.voc = cfg["vocoder"]
        self.vocab = self.model["dag"]["vocab"]
        self.beta = cfg["decode"]["beta"]

    @torch.no_grad()
    def decoder_pass(self, fbank, src_lengths, prev):
        """(logits, links, features) of the batch."""
        dag = self.model["dag"]
        enc, enc_pad = conformer(self.sd, "dag.encoder", dag["encoder"],
                                 fbank, src_lengths)
        if "dag.enc_proj.weight" in self.sd:
            enc = lin(enc, self.sd, "dag.enc_proj")
        return dag_decoder(self.sd, "dag.decoder", dag["decoder"],
                           self.vocab, prev, enc, enc_pad)

    def hop_scores(self, logits, links):
        """(best token [B, L], its log-prob [B, L], hop scores [B, L, L])
        as float64 numpy arrays."""
        logp = torch.log_softmax(logits, dim=-1)
        best, tok = logp.max(dim=-1)
        score = links + self.beta * best[:, None, :]
        return (tok.cpu().numpy(), logp.double().cpu().numpy(),
                score.double().cpu().numpy())

    @torch.no_grad()
    def synthesize_paths(self, feats, paths: List[List[int]], max_mel_len):
        """Mel of each row along its emitting vertices ``paths[b]``."""
        B, L, D = feats.shape
        z = feats.new_zeros(B, L, D)
        zmask = torch.ones(B, L, dtype=torch.bool, device=feats.device)
        for b, verts in enumerate(paths):
            n = min(len(verts), L)
            if n:
                idx = torch.as_tensor(verts[:n], device=feats.device)
                z[b, :n] = feats[b, idx]
                zmask[b, :n] = False
        return synthesize(self.sd, self.model["tts"], self.vocab["pad"], z,
                          zmask, max_mel_len)

    @torch.no_grad()
    def vocode(self, mel, rows=8):
        """Waveforms, ``rows`` utterances at a time."""
        return torch.cat([hifigan(self.sd, self.voc, mel[i:i + rows])
                          for i in range(0, mel.shape[0], rows)])

    def serve(self, fbank, src_lengths, prev, max_mel_len):
        """The reference put in the program's place: its own lookahead
        decode, then speech along its own paths. Returns what a served
        batch returns (tokens, emitting vertices, mel, waveform)."""
        logits, links, feats = self.decoder_pass(fbank, src_lengths, prev)
        tok, _, score = self.hop_scores(logits, links)
        n = (prev != self.vocab["pad"]).sum(dim=1).cpu().numpy()
        walks = [lookahead_walk(tok[b], score[b], int(n[b]),
                                self.vocab["pad"])
                 for b in range(prev.shape[0])]
        mel, mel_lens = self.synthesize_paths(feats, [w[1] for w in walks],
                                              max_mel_len)
        wav = self.vocode(mel)
        hop = int(np.prod(self.voc["upsample_rates"]))
        out = []
        for b, (tokens, verts) in enumerate(walks):
            m = int(mel_lens[b])
            out.append({"tokens": np.asarray(tokens), "vertices": verts,
                        "feature": mel[b, :m].cpu().numpy(),
                        "waveform": wav[b, :m * hop].cpu().numpy()})
        return out
