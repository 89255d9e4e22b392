"""A tiny S2ST cell for CPU tests: the cell's files with small widths,
few layers and a short test split, held to the real cell's limits."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent


def tiny_cell() -> dict:
    cfg = json.loads((BENCH / "configs" / "daspeech-s2st-fr-en.json")
                     .read_text())
    wl = json.loads((BENCH / "workloads" / "s2st-serve.json").read_text())
    m = cfg["model"]
    m["dag"]["vocab"]["size"] = 24
    m["dag"]["encoder"].update(embed_dim=32, ffn_dim=64, num_layers=2,
                               num_heads=2, conv_channels=32,
                               depthwise_kernel_size=5)
    m["dag"]["decoder"].update(embed_dim=32, ffn_dim=64, num_layers=1,
                               num_heads=2, max_target_positions=256)
    m["tts"].update(encoder_layers=1, decoder_layers=1, encoder_embed_dim=16,
                    decoder_embed_dim=16, encoder_heads=2, decoder_heads=2,
                    fft_hidden_dim=32, fft_kernel_size=3,
                    var_pred_hidden_dim=16)
    m["adaptor_ffn_dim"] = 32
    cfg["vocoder"].update(upsample_initial_channel=32,
                          resblock_kernel_sizes=[3],
                          resblock_dilation_sizes=[[1, 3]])
    wl["traffic"].update(utterances=12, median_s=1.5, sigma=0.3, min_s=1.0,
                         max_s=2.5, max_tokens=900, num_buckets=2)
    wl["trace"]["profiled_batches"] = 1
    return {"entry": {"name": "s2st-serve", "chips": 1}, "workload": wl,
            "config": cfg, "end_to_end": [], "per_layer": []}

