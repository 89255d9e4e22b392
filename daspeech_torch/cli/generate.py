"""Generation CLI: decode a split to phonemes, mel features and (with a
vocoder) waveforms, on the card.

Counterpart of ``daspeech_tpu/cli/generate.py`` (a rebuild of
``DASpeech/generator/generate_features.py`` + ``hifi-gan/inference_e2e.py``)
for its non-autoregressive routes: two-pass S2ST (``nat_speech_to_speech``,
the default), S2TT (``nat_speech_to_text``) and FastSpeech 2 alone
(``--generator-type nat_tts`` or ``--task text_to_speech``)::

  python -m daspeech_torch.cli.generate DATA --checkpoint-dir DIR \\
      [--average-last-n N] --results-path results/ \\
      [--vocoder-checkpoint VDIR | --vocoder-torch G.pt]

The weights come from a port checkpoint directory (``--checkpoint-dir``,
written by ``daspeech_torch.train.checkpoint.CheckpointManager``) or a
released fairseq ``.pt`` (``--model-torch``); the vocoder from a port
``VocoderTrainer`` checkpoint directory or a hifi-gan generator ``.pt``.
It runs on ``--device`` (default ``cuda``) and exits non-zero when that
device is missing: it never falls back to the CPU on its own. Outputs:
``hypos.txt``, ``feat/<id>.npy`` ([80, T]), ``wav/<id>_pred.wav``, and as
the last line of standard output ``{"generated": n, "results": DIR}``.

Batches are the task's buckets, collated without padding the batch axis to
the bucket's size (the card needs no fixed batch shape).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import wave
from pathlib import Path

import numpy as np
import torch

from daspeech_torch.config import (
    DAGModelConfig,
    DecodeConfig,
    FastSpeech2Config,
    HiFiGANConfig,
    S2SModelConfig,
    from_dict,
)
from daspeech_torch.tasks import (
    NATSpeechToSpeechTask,
    NATSpeechToTextTask,
    TaskConfig,
    TextToSpeechTask,
)
from daspeech_torch.train.checkpoint import (
    CheckpointManager,
    average_checkpoints,
)

# the autoregressive generators, not ported yet (refused)
AR_GENERATORS = ("at_tts", "at_s2s")
NOT_PORTED = "is not ported yet (ROADMAP Queue 1 {item})"


def write_wav(path, wav: np.ndarray, sample_rate: int = 22050):
    """int16 WAV writer (``inference_e2e.py`` uses scipy.io.wavfile; the
    stdlib ``wave`` module avoids that dependency)."""
    data = np.clip(wav, -1.0, 1.0)
    data = (data * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(data.tobytes())


def read_wav(path):
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        data = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)
    return data.astype(np.float32) / 32767.0, sr


def parse_args(argv=None):
    p = argparse.ArgumentParser("daspeech-torch-generate")
    p.add_argument("data")
    p.add_argument("--task", default="nat_speech_to_speech",
                   choices=["nat_speech_to_text", "nat_speech_to_speech",
                            "text_to_speech"])
    p.add_argument("--generator-type", default="auto",
                   choices=["auto", "nat_s2s", "nat_tts", *AR_GENERATORS],
                   help="nat_s2s = two-pass DAG+TTS (the S2S task's "
                        "default), nat_tts = FastSpeech2-only phoneme->mel "
                        "(the text_to_speech task); at_tts and at_s2s are "
                        "not ported yet and raise")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; without a card, pass "
                        "--device cpu (the default never falls back)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint directory of "
                        "daspeech_torch.train.checkpoint.CheckpointManager")
    p.add_argument("--average-last-n", type=int, default=0,
                   help="average the parameters of the last N checkpoints "
                        "before decoding (scripts/average_checkpoints.py)")
    p.add_argument("--model-torch", default=None,
                   help="released DASpeech fairseq .pt to load directly "
                        "(encoder./decoder.[/adaptor./tts.] model state "
                        "dict; s2s_conformer_dag_fastspeech2.py:43-100)")
    p.add_argument("--model-yaml", default=None)
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--results-path", default="results")
    p.add_argument("--decode-strategy", default="lookahead")
    p.add_argument("--decode-beta", type=float, default=1.0)
    p.add_argument("--decode-viterbibeta", type=float, default=1.0)
    p.add_argument("--decode-alpha", type=float, default=1.1,
                   help="beam-search length penalty")
    p.add_argument("--decode-top-cand-n", type=int, default=5)
    p.add_argument("--decode-beamsize", type=int, default=100)
    p.add_argument("--decode-top-p", type=float, default=0.9)
    p.add_argument("--decode-dedup", action="store_true")
    p.add_argument("--max-output-length", type=int, default=None)
    p.add_argument("--length-beam", type=int, default=1,
                   help="NAT length beam: decode N graph sizes around "
                        "lambda*src_len, keep the best mean-logprob "
                        "candidate (s2t_nat_generator.py:59-76)")
    p.add_argument("--reranker-dir", default=None,
                   help="an AR reranker for the length beam; not ported "
                        "yet, raises")
    p.add_argument("--iter-decode-max-iter", type=int, default=0,
                   help="iterative refinement: feed decoded tokens back "
                        "as the next graph input for up to N extra "
                        "passes (s2t_nat_generator.py:120-215)")
    p.add_argument("--iter-decode-force-max-iter", action="store_true")
    p.add_argument("--src-upsample-scale", type=float, default=0.5)
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--max-mel-len", type=int, default=1024)
    p.add_argument("--vocoder-checkpoint", default=None,
                   help="checkpoint directory of a "
                        "daspeech_torch.train.VocoderTrainer run")
    p.add_argument("--vocoder-torch", default=None,
                   help="hifi-gan generator .pt (weight-normed) to load "
                        "(the reference's VCTK_V1 release format)")
    p.add_argument("--vocoder-type", default="auto",
                   choices=["auto", "hifigan", "griffin_lim"],
                   help="auto = hifigan when a checkpoint is given; "
                        "griffin_lim is not ported yet and raises")
    p.add_argument("--vocoder-quant", default="none",
                   choices=["none", "bf16", "int8", "int8-skip1"],
                   help="only none (fp32) is ported; the others raise")
    p.add_argument("--vocoder-chunk", type=int, default=0,
                   help="vocode in exact windows of N mel frames "
                        "(+receptive-field halo) instead of one shot "
                        "(models/hifigan.py::vocode_chunked); 0 = one-shot")
    p.add_argument("--gcmvn-stats", default=None,
                   help="gcmvn_stats.npz for mel denormalization")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Raise for the options whose modules are not ported, naming their
    ROADMAP item."""
    if args.generator_type in AR_GENERATORS:
        raise NotImplementedError(
            f"--generator-type {args.generator_type} "
            + NOT_PORTED.format(item="#6"))
    if args.reranker_dir:
        raise NotImplementedError("--reranker-dir "
                                  + NOT_PORTED.format(item="#6"))
    if args.vocoder_type == "griffin_lim":
        raise NotImplementedError("--vocoder-type griffin_lim "
                                  + NOT_PORTED.format(item="#6"))
    if args.vocoder_quant != "none":
        raise NotImplementedError(f"--vocoder-quant {args.vocoder_quant} "
                                  + NOT_PORTED.format(item="#5"))


def resolve_device(name: str, prog: str = "generate") -> torch.device:
    """The device to run on; a CUDA device that is missing ends the run
    (exit code 1) before anything is written."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: --device {name}, but no CUDA device is "
                         "available; pass --device cpu to run on the CPU")
    return device


def build_model_cfg(criterion: str, model_yaml, vocab):
    """The model config of a criterion, from ``model_yaml`` (a YAML of the
    config's fields) or the defaults, with the task's vocabulary stamped in
    (``daspeech_tpu/cli/train.py:209-240``). The NAT criteria only."""
    if criterion in ("tts_transformer", "s2s_multidecoder"):
        raise NotImplementedError(f"the {criterion} model "
                                  + NOT_PORTED.format(item="#6"))
    cls = {"fastspeech2": FastSpeech2Config,
           "s2s_dag_fastspeech2_loss": S2SModelConfig}.get(
        criterion, DAGModelConfig)
    if model_yaml:
        import yaml

        cfg = from_dict(cls, yaml.safe_load(Path(model_yaml).read_text()))
    else:
        cfg = cls()
    if cls is FastSpeech2Config:
        return cfg
    if cls is S2SModelConfig:
        return dataclasses.replace(
            cfg, dag=dataclasses.replace(cfg.dag, vocab=vocab))
    return dataclasses.replace(cfg, vocab=vocab)


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    if args.generator_type == "nat_tts" or args.task == "text_to_speech":
        return _generate_tts(args, device)
    from daspeech_torch.models import (S2SConformerDAGFastSpeech2,
                                       S2TConformerDAG)

    is_s2s = args.task == "nat_speech_to_speech"
    task_cls = NATSpeechToSpeechTask if is_s2s else NATSpeechToTextTask
    task = task_cls.setup_task(TaskConfig(
        data_dir=args.data, max_tokens=args.max_tokens))
    task.load_dataset(args.gen_subset,
                      upsample_scale=args.src_upsample_scale)
    criterion = "s2s_dag_fastspeech2_loss" if is_s2s else "nat_dag_loss"
    model_cfg = build_model_cfg(criterion, args.model_yaml, task.vocab)
    model = (S2SConformerDAGFastSpeech2(model_cfg) if is_s2s
             else S2TConformerDAG(model_cfg))
    if args.model_torch:
        load_fairseq_(model, args.model_torch, model_cfg, is_s2s)
    elif args.checkpoint_dir:
        restore_model_(model, args.checkpoint_dir, args.average_last_n)
    else:
        raise SystemExit("need --checkpoint-dir or --model-torch")
    model.to(device).eval()
    it = task.get_batch_iterator(args.gen_subset,
                                 upsample_scale=args.src_upsample_scale)
    vocoder, gcmvn = load_vocoder_and_gcmvn(args, task, device)
    decode_cfg = DecodeConfig(
        strategy=args.decode_strategy, beta=args.decode_beta,
        viterbibeta=args.decode_viterbibeta, alpha=args.decode_alpha,
        top_cand_n=args.decode_top_cand_n, beamsize=args.decode_beamsize,
        top_p=args.decode_top_p, dedup=args.decode_dedup,
        max_output_length=args.max_output_length,
        length_beam=args.length_beam,
        iter_decode_max_iter=args.iter_decode_max_iter,
        iter_decode_force_max_iter=args.iter_decode_force_max_iter)
    if is_s2s:
        gen = task.build_generator(model, decode_cfg,
                                   max_mel_len=args.max_mel_len,
                                   vocoder=vocoder, gcmvn=gcmvn)
    else:
        gen = task.build_generator(model, decode_cfg)
    return emit_outputs(
        it, gen, Path(args.results_path),
        hypo_line=lambda utt_id, h:
            f"{utt_id}\t{task.tgt_dict.string(h['tokens'])}\n")


def load_fairseq_(model, path, model_cfg, is_s2s: bool) -> None:
    """Load a released fairseq ``.pt`` into ``model`` (every tensor)."""
    from daspeech_torch.train.fairseq_import import (
        import_s2s_daspeech, import_s2t_conformer_dag, load_pt)

    ckpt = load_pt(path)
    sd = ckpt.get("model", ckpt)
    dag_cfg = model_cfg.dag if is_s2s else model_cfg
    layers = dict(enc_layers=dag_cfg.encoder.num_layers,
                  dec_layers=dag_cfg.decoder.num_layers,
                  tied_embeddings=dag_cfg.decoder.share_input_output_embed)
    tensors = (import_s2s_daspeech(sd, tts_cfg=model_cfg.tts, **layers)
               if is_s2s else import_s2t_conformer_dag(sd, **layers))
    model.load_state_dict(tensors)
    print(f"imported torch checkpoint {path}", file=sys.stderr)


def restore_model_(model, checkpoint_dir, average_last_n: int = 0) -> None:
    """Load the latest checkpoint of ``checkpoint_dir`` into ``model``;
    with ``average_last_n > 1`` its parameters are the average of the last
    N checkpoints' (BatchNorm statistics stay the latest's, as in the JAX
    CLI)."""
    ckpt = CheckpointManager(checkpoint_dir)
    data = ckpt.restore()
    if data is None:
        raise SystemExit(f"no checkpoint found in {checkpoint_dir}")
    model.load_state_dict(data["model"])
    if average_last_n > 1:
        avg = average_checkpoints(
            ckpt, last_n=average_last_n,
            keys=[n for n, _ in model.named_parameters()])
        model.load_state_dict(avg, strict=False)


def _generate_tts(args, device):
    """``--generator-type nat_tts``: FastSpeech2-only phoneme->mel(->wav)
    over the stage-2 ``text_to_speech`` checkpoints
    (``generate_features.py:62-74`` nat_tts branch)."""
    from daspeech_torch.models import FastSpeech2Encoder

    task = TextToSpeechTask.setup_task(TaskConfig(data_dir=args.data))
    task.load_dataset(args.gen_subset)
    vocab = task.vocab
    model_cfg = build_model_cfg("fastspeech2", args.model_yaml, vocab)
    model = FastSpeech2Encoder(model_cfg, vocab_size=vocab.size,
                               pad=vocab.pad)
    if not args.checkpoint_dir:
        raise SystemExit("nat_tts needs --checkpoint-dir (a FastSpeech 2 "
                         "pretraining checkpoint)")
    restore_model_(model, args.checkpoint_dir, args.average_last_n)
    model.to(device).eval()
    vocoder, gcmvn = load_vocoder_and_gcmvn(args, task, device)
    gen = task.build_generator(model, max_mel_len=args.max_mel_len,
                               vocoder=vocoder, gcmvn=gcmvn)
    return emit_outputs(task.get_batch_iterator(args.gen_subset), gen,
                        Path(args.results_path))


def emit_outputs(it, gen, out_dir: Path, hypo_line=None):
    """The batch loop (``generate_features.py:87-133``): per utterance a
    ``hypos.txt`` line (given ``hypo_line``), its mel transposed to
    [80, T] under ``feat/`` and, with a vocoder, its wav under ``wav/``."""
    (out_dir / "feat").mkdir(parents=True, exist_ok=True)
    hypos_file = (out_dir / "hypos.txt").open("w") if hypo_line else None
    n = 0
    for spec, idxs in it.batches_for_epoch(0):
        hypos = gen.generate(it.collate(spec, idxs, pad_last=False))
        for i, local in enumerate(idxs):
            utt_id = it.dataset.rows[local]["id"]
            h = hypos[i]
            if hypos_file is not None:
                hypos_file.write(hypo_line(utt_id, h))
            if "feature" in h:
                np.save(out_dir / "feat" / f"{utt_id}.npy",
                        np.asarray(h["feature"]).T)
            if "waveform" in h:
                (out_dir / "wav").mkdir(exist_ok=True)
                write_wav(out_dir / "wav" / f"{utt_id}_pred.wav",
                          np.asarray(h["waveform"]))
            n += 1
    if hypos_file is not None:
        hypos_file.close()
    print(json.dumps({"generated": n, "results": str(out_dir)}))
    return 0


def load_vocoder_and_gcmvn(args, task, device):
    """(vocoder or None, gcmvn or None): the HiFi-GAN generator from
    ``--vocoder-torch`` or ``--vocoder-checkpoint`` on ``device``, and the
    gcmvn stats from ``--gcmvn-stats``, else from config.yaml's
    ``global_cmvn`` (``data_cfg.py:179-182``)."""
    cfg_voc_type = (task.data_cfg.vocoder.get("type")
                    if task.data_cfg is not None else None)
    has_ckpt = bool(args.vocoder_torch or args.vocoder_checkpoint)
    if (args.vocoder_type == "auto" and cfg_voc_type == "griffin_lim"
            and not has_ckpt):
        raise NotImplementedError("the data config's griffin_lim vocoder "
                                  + NOT_PORTED.format(item="#6"))
    vocoder = None
    if has_ckpt:
        from daspeech_torch.models import HiFiGANGenerator

        hifi_cfg = HiFiGANConfig()
        vocoder = HiFiGANGenerator(hifi_cfg, serve_chunk=args.vocoder_chunk)
        if args.vocoder_torch:
            from daspeech_torch.train.fairseq_import import (import_hifigan,
                                                             load_pt)

            sd = load_pt(args.vocoder_torch)
            vocoder.load_state_dict(import_hifigan(sd.get("generator", sd),
                                                   hifi_cfg))
        else:
            data = CheckpointManager(args.vocoder_checkpoint).restore()
            if data is None:
                raise SystemExit("no vocoder checkpoint found in "
                                 f"{args.vocoder_checkpoint}")
            vocoder.load_state_dict(data["gen"])
        vocoder.to(device).eval()

    gcmvn_path = args.gcmvn_stats
    if gcmvn_path is None and task.data_cfg is not None:
        gcmvn_path = task.data_cfg.global_cmvn_stats_npz
    gcmvn = None
    if gcmvn_path:
        from daspeech_torch.data.transforms import GlobalCMVN

        gcmvn = GlobalCMVN(stats_npz_path=gcmvn_path)
    return vocoder, gcmvn


if __name__ == "__main__":
    sys.exit(main())
