"""Operations the two-pass S2ST model needs for one utterance.

Every product and convolution counts 2·m·n·k; elementwise work, norms,
softmaxes and gathers count nothing. Work is counted at the utterance's own
lengths, not at its batch's padded shape: what the input needs, so that a
share of a peak never counts padding as work.

Sizes of one utterance: ``S`` fbank frames, ``L`` graph vertices, ``N``
emitted path features (tokens after the first), ``M`` mel frames.
"""

from __future__ import annotations

from typing import Dict


def subsampled(S: int, n_convs: int) -> int:
    """Frames after ``n_convs`` stride-2 convolutions."""
    for _ in range(n_convs):
        S = (S - 1) // 2 + 1
    return S


def conformer_flops(enc: dict, S: int) -> int:
    C, F = enc["embed_dim"], enc["ffn_dim"]
    ks = enc["conv_kernel_sizes"]
    total, cin, T = 0, enc["input_feat_dim"], S
    for i, k in enumerate(ks):
        cout = enc["conv_channels"] if i < len(ks) - 1 else 2 * C
        T = (T - 1) // 2 + 1
        total += 2 * T * cin * cout * k
        cin = cout // 2
    total += 2 * T * C * C                              # input projection
    per_layer = (
        2 * (2 * T * C * F * 2)                         # two macaron FFNs
        + 4 * 2 * T * C * C                             # q, k, v, out
        + 2 * (2 * T - 1) * C * C                       # W_p pe(r), all r
        + 2 * T * T * C                                 # (q+u) k
        + 2 * T * T * C                                 # (q+v) W_p pe(i-j)
        + 2 * T * T * C                                 # probs v
        + 2 * T * C * 2 * C                             # pointwise GLU
        + 2 * T * C * enc["depthwise_kernel_size"]      # depthwise
        + 2 * T * C * C)                                # pointwise
    return total + enc["num_layers"] * per_layer


def dag_flops(dec: dict, vocab_size: int, enc_dim: int, T: int,
              L: int) -> int:
    """Decoder layers over L vertices attending T encoder frames, the
    vocabulary projection and the link predictor (scores over the
    L (L - 1) / 2 forward pairs)."""
    D, F, H = dec["embed_dim"], dec["ffn_dim"], dec["num_heads"]
    total = 2 * T * enc_dim * D if enc_dim != D else 0      # enc_proj
    per_layer = (4 * 2 * L * D * D + 2 * 2 * L * L * D      # self-attention
                 + 2 * 2 * L * D * D + 2 * 2 * T * D * D    # cross q/out, k/v
                 + 2 * 2 * L * T * D                        # cross scores
                 + 2 * 2 * L * D * F)                       # FFN
    total += dec["num_layers"] * per_layer
    total += 2 * L * D * vocab_size
    parts = 2                                               # feature:position
    total += 2 * 2 * L * parts * D * D + 2 * L * parts * D * H
    total += 2 * (L * (L - 1) // 2) * D
    return total


def fastspeech2_flops(tts: dict, dag_dim: int, adaptor_dim: int, N: int,
                      M: int) -> int:
    """Adaptor and encoder over N path features, variance predictors, and
    the decoder and mel projection over M frames."""
    C, F, K = (tts["encoder_embed_dim"], tts["fft_hidden_dim"],
               tts["fft_kernel_size"])

    def fft(T):
        return (4 * 2 * T * C * C + 2 * 2 * T * T * C
                + 2 * 2 * T * C * F * K)

    Hv, Kv = tts["var_pred_hidden_dim"], tts["var_pred_kernel_size"]
    var = 3 * (2 * N * C * Hv * Kv + 2 * N * Hv * Hv * Kv + 2 * N * Hv)
    return (2 * N * dag_dim * adaptor_dim + 2 * N * adaptor_dim * C
            + tts["encoder_layers"] * fft(N) + var
            + tts["decoder_layers"] * fft(M)
            + 2 * M * C * tts["output_frame_dim"])


def hifigan_flops(voc: dict, M: int) -> int:
    ch = voc["upsample_initial_channel"]
    total = 2 * M * voc["num_mels"] * ch * 7
    T = M
    for u, k in zip(voc["upsample_rates"], voc["upsample_kernel_sizes"]):
        out = ch // 2
        total += 2 * T * ch * out * k           # each input frame, k taps
        T *= u
        ch = out
        for rk, dils in zip(voc["resblock_kernel_sizes"],
                            voc["resblock_dilation_sizes"]):
            total += len(dils) * 2 * (2 * T * ch * ch * rk)
    return total + 2 * T * ch * 1 * 7


def utterance_flops(cfg: dict, S: int, L: int, N: int,
                    M: int) -> Dict[str, int]:
    """Operations of one served utterance by stage."""
    m, dag = cfg["model"], cfg["model"]["dag"]
    T = subsampled(S, len(dag["encoder"]["conv_kernel_sizes"]))
    return {
        "decode": conformer_flops(dag["encoder"], S) + dag_flops(
            dag["decoder"], dag["vocab"]["size"],
            dag["encoder"]["embed_dim"], T, L),
        "synth": fastspeech2_flops(m["tts"], dag["decoder"]["embed_dim"],
                                   m["adaptor_ffn_dim"], N, M),
        "vocode": hifigan_flops(cfg["vocoder"], M),
    }
