"""HiFi-GAN vocoder training CLI, on the card.

Counterpart of ``daspeech_tpu/cli/train_vocoder.py`` (a rebuild of
hifi-gan's ``train.py``): random waveform segments of ``--segment-size``
samples, their log-mel on the card (``train.vocoder_train.make_mel_fn``),
one discriminator then one generator update each
(``VocoderTrainer``, HiFi-GAN config_v1 against MPD + MSD). Data: a TSV
with columns ``id`` and ``audio``, a WAV path or a zip-packed ``.npy``
waveform (``file.zip:offset:len``)::

  python -m daspeech_torch.cli.train_vocoder DATA.tsv \\
      --save-dir checkpoints/hifigan --max-update 100000

Checkpoints go through ``CheckpointManager(keep_last=3)``; ``generate
--vocoder-checkpoint DIR`` loads the latest. The JAX CLI's jit options
``--fused-step``, ``--gen-fold`` and ``--compilation-cache-dir`` are not
accepted: eager PyTorch runs the same two halves either way. It runs on ``--device`` (default ``cuda``) and exits non-zero when that
device is missing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from daspeech_torch.cli.generate import read_wav, resolve_device
from daspeech_torch.cli.train import PendingMetrics
from daspeech_torch.config import HiFiGANConfig
from daspeech_torch.data.datasets import load_tsv
from daspeech_torch.data.prefetch import consume, to_device
from daspeech_torch.train.checkpoint import CheckpointManager
from daspeech_torch.train.metrics import JsonProgressLogger, MetricsAggregator
from daspeech_torch.train.vocoder_train import VocoderTrainer, make_mel_fn


def load_waveform(path: str) -> np.ndarray:
    if str(path).endswith(".wav"):
        wav, _ = read_wav(path)
        return wav
    from daspeech_torch.data.audio_utils import get_features_or_waveform

    return np.asarray(get_features_or_waveform(path)).reshape(-1)


def parse_args(argv=None):
    p = argparse.ArgumentParser("daspeech-torch-train-vocoder")
    p.add_argument("data", help="TSV with id/audio columns")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; without a card, pass "
                        "--device cpu (the default never falls back)")
    p.add_argument("--save-dir", default="checkpoints/hifigan")
    p.add_argument("--max-update", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--segment-size", type=int, default=8192)
    p.add_argument("--sample-rate", type=int, default=22050)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--save-interval-updates", type=int, default=5000)
    p.add_argument("--seed", type=int, default=1234)
    return p.parse_args(argv)


def main(argv=None, *, on_update=None) -> int:
    """Run the CLI; ``on_update(state, update, metrics)`` is called after
    each update (for in-process callers that inspect the run)."""
    args = parse_args(argv)
    device = resolve_device(args.device, prog="train_vocoder")
    cfg = HiFiGANConfig()
    wavs = [load_waveform(r["audio"]) for r in load_tsv(args.data)]
    wavs = [w for w in wavs if len(w) >= args.segment_size]
    if not wavs:
        raise SystemExit("no waveforms longer than segment_size")
    seg_frames = args.segment_size // cfg.hop_size

    mel_fn = make_mel_fn(sample_rate=args.sample_rate,
                         hop_length=cfg.hop_size, num_mels=cfg.num_mels,
                         device=device)
    trainer = VocoderTrainer(cfg, mel_fn=mel_fn, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(args.seed))
    ckpt = CheckpointManager(args.save_dir, keep_last=3)
    rng = np.random.default_rng(args.seed)
    logger = JsonProgressLogger(log_interval=args.log_interval,
                                tag="vocoder")
    agg = MetricsAggregator()
    pending = PendingMetrics(device)

    def flush():
        rows, _ = pending.fetch()
        for r in rows:
            for k, v in r.items():
                agg.log_scalar(k, v)
            agg.log_speed("ups")
        out = agg.get_smoothed_values()
        agg.reset()
        return out

    stats = {}
    while state.step < args.max_update:
        segs = []
        for _ in range(args.batch_size):
            w = wavs[rng.integers(len(wavs))]
            start = rng.integers(0, len(w) - args.segment_size + 1)
            segs.append(w[start: start + args.segment_size])
        wav_b = consume(to_device({"wav": np.stack(segs)}, device))["wav"]
        with torch.no_grad():
            mel_b = mel_fn(wav_b)[:, :seg_frames]
        t0 = pending.mark()
        state, metrics = trainer.train_step(state, mel_b, wav_b)
        pending.add(metrics, t0, pending.mark())
        update = state.step
        if on_update is not None:
            on_update(state, update, metrics)
        if update % args.log_interval == 0:
            stats = flush()
            logger.log(stats, update)
        if update % args.save_interval_updates == 0:
            ckpt.save(state, update, blocking=False)
    ckpt.save(state, state.step)
    if pending.metrics:
        stats = flush()
    logger.print({"done": True, **stats}, state.step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
