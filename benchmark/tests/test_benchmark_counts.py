"""The benchmark's operation and byte counts against hand-worked shapes."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from benchmark.counts import ops, s2st  # noqa: E402

NEG = -1e30


def test_subsampled_lengths():
    # (S - 1) // 2 + 1 twice: 100 -> 50 -> 25, 7 -> 4 -> 2
    assert s2st.subsampled(100, 2) == 25
    assert s2st.subsampled(7, 2) == 2


def test_conformer_one_layer():
    enc = {"embed_dim": 4, "ffn_dim": 8, "num_heads": 2,
           "conv_kernel_sizes": [3], "conv_channels": 6,
           "input_feat_dim": 2, "depthwise_kernel_size": 3,
           "num_layers": 1}
    # S = 5 -> T = 3; one conv of 2 -> 2C = 8 channels, k 3: 2*3*2*8*3
    sub = 2 * 3 * 2 * 8 * 3
    proj = 2 * 3 * 4 * 4
    layer = (2 * (2 * 3 * 4 * 8 * 2)      # FFNs
             + 4 * 2 * 3 * 16             # q k v out
             + 2 * 5 * 16                 # W_p over the 2T-1 = 5 offsets
             + 3 * (2 * 9 * 4)            # content, position, value
             + 2 * 3 * 4 * 8              # pointwise GLU
             + 2 * 3 * 4 * 3              # depthwise
             + 2 * 3 * 16)                # pointwise
    assert s2st.conformer_flops(enc, 5) == sub + proj + layer


def test_dag_decoder_counts():
    dec = {"embed_dim": 4, "ffn_dim": 8, "num_heads": 2, "num_layers": 1}
    T, L, V = 3, 5, 7
    want = (2 * T * 2 * 4                          # enc_proj 2 -> 4
            + 4 * 2 * L * 16 + 2 * 2 * L * L * 4   # self-attention
            + 2 * 2 * L * 16 + 2 * 2 * T * 16      # cross projections
            + 2 * 2 * L * T * 4                    # cross scores
            + 2 * 2 * L * 4 * 8                    # FFN
            + 2 * L * 4 * V                        # vocabulary
            + 2 * 2 * L * 8 * 4 + 2 * L * 8 * 2    # query, key, gates
            + 2 * 10 * 4)                          # 10 forward pairs
    assert s2st.dag_flops(dec, V, 2, T, L) == want


def test_hifigan_counts():
    voc = {"upsample_initial_channel": 4, "num_mels": 2,
           "upsample_rates": [2], "upsample_kernel_sizes": [4],
           "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3]]}
    M = 5
    want = (2 * M * 2 * 4 * 7          # conv_pre
            + 2 * M * 4 * 2 * 4        # transposed conv 4 -> 2, 4 taps
            + 2 * 2 * (2 * 10 * 2 * 2 * 3)   # two dilations, two convs
            + 2 * 10 * 2 * 7)          # conv_post
    assert s2st.hifigan_flops(voc, M) == want


def test_fastspeech2_counts():
    tts = {"encoder_embed_dim": 4, "fft_hidden_dim": 8, "fft_kernel_size": 3,
           "var_pred_hidden_dim": 4, "var_pred_kernel_size": 3,
           "encoder_layers": 1, "decoder_layers": 1, "output_frame_dim": 2}
    N, M = 3, 6

    def fft(T):
        return 4 * 2 * T * 16 + 2 * 2 * T * T * 4 + 2 * 2 * T * 4 * 8 * 3

    var = 3 * (2 * N * 4 * 4 * 3 + 2 * N * 4 * 4 * 3 + 2 * N * 4)
    want = (2 * N * 6 * 5 + 2 * N * 5 * 4 + fft(N) + var + fft(M)
            + 2 * M * 4 * 2)
    assert s2st.fastspeech2_flops(tts, 6, 5, N, M) == want


def test_attention_counts_follow_valid_keys():
    q = torch.zeros(2, 3, 4)
    k = v = torch.zeros(2, 5, 4)
    bias = torch.zeros(2, 5)
    bias[0, 3:] = NEG                      # row 0 attends 3 keys, row 1 5
    flops, nbytes = ops.attention_packed(q, k, v, bias, 2)
    assert flops == 4 * 3 * 4 * (3 + 5)
    assert nbytes == 4 * (24 + 40 + 40 + 10 + 24)
    hq = torch.zeros(2, 2, 3, 2)
    hk = torch.zeros(2, 2, 5, 2)
    assert ops.attention_head_major(hq, hk, hk, bias)[0] == \
        4 * 3 * 2 * 2 * 8
    all_masked = torch.full((1, 5), NEG)
    assert ops.valid_keys(all_masked).tolist() == [5]


def test_relpos_and_links_counts():
    q = k = v = torch.zeros(1, 3, 4)
    a = torch.zeros(1, 3, 2 * 6)
    e = torch.zeros(3, 6)
    bias = torch.zeros(1, 3)
    flops, nbytes = ops.attention_relpos(q, k, v, a, e, bias, 2)
    assert flops == 3 * (2 * 4 + 2 * 12 + 2 * 4) * 3
    assert nbytes == 4 * (12 * 3 + 36 + 18 + 3 + 12)
    lq = torch.zeros(2, 5, 4)
    gates = torch.zeros(2, 5, 2)
    n = torch.tensor([5, 3])
    flops, nbytes = ops.extract_links(lq, lq, gates, n, 2, 0.5, None)
    assert flops == 2 * (10 + 3) * 4
    assert nbytes == 4 * (40 + 40 + 20) + 8 * 2 + 2 * 25 * 4


def test_bound_takes_the_larger():
    assert ops.bound_s(10, 1, 10.0, 10.0) == 1.0
    assert ops.bound_s(1, 30, 10.0, 10.0) == 3.0
