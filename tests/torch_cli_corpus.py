"""The tiny on-disk corpus and the train CLI's arguments shared by the
port's CLI tests (``tests/test_torch_*_cli.py``, ``test_torch_ddp.py``).
Importing it loads no jax: the data-parallel tests' spawned ranks import
it."""

import csv
from pathlib import Path

import numpy as np
import yaml

# tests/test_cli.py's TINY_MODEL / TINY_S2S widths, every dropout rate 0
TINY_ENCODER = {"embed_dim": 16, "ffn_dim": 32, "num_layers": 1,
                "num_heads": 2, "conv_channels": 32,
                "depthwise_kernel_size": 7}
TINY_DECODER = {"embed_dim": 16, "ffn_dim": 32, "num_layers": 1,
                "num_heads": 2, "max_target_positions": 64}
TINY_TTS = {"encoder_layers": 1, "encoder_embed_dim": 16,
            "encoder_heads": 2, "decoder_layers": 1,
            "decoder_embed_dim": 16, "decoder_heads": 2,
            "fft_hidden_dim": 32, "var_pred_hidden_dim": 16,
            "var_pred_n_bins": 8}
TINY_ADAPTOR_FFN = 32
LR = 1e-3

S2T_YAML = {
    "encoder": {**TINY_ENCODER, "dropout": 0.0, "attn_dropout": 0.0},
    "decoder": {**TINY_DECODER, "dropout": 0.0, "attn_dropout": 0.0,
                "activation_dropout": 0.0},
}
TTS_YAML = {**TINY_TTS, "dropout": 0.0, "attention_dropout": 0.0,
            "var_pred_dropout": 0.0, "pitch_min": 0.0, "pitch_max": 300.0,
            "energy_min": 0.0, "energy_max": 50.0}
S2S_YAML = {"dag": S2T_YAML, "tts": TTS_YAML,
            "adaptor_ffn_dim": TINY_ADAPTOR_FFN,
            "adaptor_dropout": 0.0}
# tests/test_cli_ar.py's TINY_AR_TTS / TINY_MDEC, dropout 0
AR_TTS_YAML = {"embed_dim": 16, "ffn_dim": 32, "encoder_layers": 1,
               "decoder_layers": 1, "num_heads": 2, "prenet_dim": 16,
               "dropout": 0.0}
MDEC_YAML = {"encoder_embed_dim": 16, "encoder_layers": 1,
             "encoder_heads": 2, "mt_embed_dim": 16, "mt_layers": 1,
             "mt_heads": 2, "ffn_dim": 32, "synth_encoder_layers": 1,
             "tts_decoder_layers": 1, "prenet_dim": 16,
             "conv_channels": 16, "depthwise_kernel_size": 7,
             "dropout": 0.0}
YAMLS = {"nat_dag_loss": S2T_YAML, "s2s_dag_fastspeech2_loss": S2S_YAML,
         "fastspeech2": TTS_YAML, "tts_transformer": AR_TTS_YAML,
         "s2s_multidecoder": MDEC_YAML}
TASKS = {"nat_dag_loss": "nat_speech_to_text",
         "s2s_dag_fastspeech2_loss": "nat_speech_to_speech",
         "fastspeech2": "text_to_speech",
         "tts_transformer": "text_to_speech",
         "s2s_multidecoder": "nat_speech_to_speech"}


def _bin_centres(rng, lo, hi, n, n_bins):
    edges = np.linspace(lo, hi, n_bins - 1)
    i = rng.integers(0, n_bins - 2, size=n)
    return (edges[i] + edges[i + 1]) / 2


def write_corpus(root: Path, n: int = 12, seed: int = 0,
                 splits=("train", "dev", "test")):
    """One data directory that the three tasks read: ``make_dataset``'s
    S2ST rows (fbank and mel zips, 2-5 phonemes, durations 1-4), the mel
    also as the TTS task's ``audio``, pitch and energy at bucket centres
    of ``TTS_YAML``'s ranges; the same rows in every split. Writes the
    model YAMLs beside it."""
    from test_data import make_dataset

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    d, rows, _ = make_dataset(root, rng, n=n, s2s=True)
    nb = TINY_TTS["var_pred_n_bins"]
    for r in rows:
        k = len(r["duration"].split())
        r["pitch"] = " ".join(f"{x:.6f}" for x in _bin_centres(
            rng, TTS_YAML["pitch_min"], TTS_YAML["pitch_max"], k, nb))
        r["energy"] = " ".join(f"{x:.6f}" for x in _bin_centres(
            rng, TTS_YAML["energy_min"], TTS_YAML["energy_max"], k, nb))
        r["audio"], r["n_frames"] = r["tgt_audio"], r["tgt_n_frames"]
    for split in splits:
        with open(root / f"{split}.tsv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
            w.writeheader()
            w.writerows(rows)
    d.save(root / "vocab.txt")
    for crit, tree in YAMLS.items():
        (root / f"{crit}.yaml").write_text(yaml.safe_dump(tree))
    return d


def cli_args(root: Path, crit: str, save: str, *extra):
    """The CLI's arguments for ``crit`` on the corpus at ``root``: batches
    of 4 utterances (3 an epoch), GLAT p 0, ``--device cpu``."""
    return [str(root), "--task", TASKS[crit], "--criterion", crit,
            "--device", "cpu", "--model-yaml", str(root / f"{crit}.yaml"),
            "--save-dir", str(root / save), "--max-tokens", "256",
            "--max-sentences", "4", "--num-buckets", "1",
            "--max-source-positions", "100", "--max-target-positions", "32",
            "--lr", str(LR), "--warmup-updates", "2", "--glat-p", "0",
            "--log-interval", "1", "--validate-interval-updates", "1000",
            *extra]
