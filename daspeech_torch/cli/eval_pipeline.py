"""End-to-end evaluation pipeline, on the card.

Counterpart of ``daspeech_tpu/cli/eval_pipeline.py`` (a rebuild of
``test_scripts/generate.fr-en.lookahead.vctk.sh``, 5 stages) as one entry
point:

  1. average the last-N checkpoints          (scripts/average_checkpoints.py)
  2. decode the test split to mel + wav      (generate_features.py + HiFi-GAN)
  3. waveforms are written as {id}_pred.wav  (convert_id.py naming)
  4. transcribe with wav2vec2 CTC            (asr_bleu)
  5. sacrebleu vs the reference texts

  python -m daspeech_torch.cli.eval_pipeline DATA \\
      --checkpoint-dir ckpts --vocoder-checkpoint voc_ckpts \\
      --average-last-n 5 --results-path results/

Stages 1-3 are the port's generate CLI. Without the ASR model in the local
cache the last line reads ``"asr_bleu": null`` with a note, as in JAX. It
runs on ``--device`` (default ``cuda``) and exits non-zero when that device
is missing.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from daspeech_torch.cli.generate import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser("daspeech-torch-eval-pipeline")
    p.add_argument("data")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; without a card, pass "
                        "--device cpu (the default never falls back)")
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--results-path", default="results")
    p.add_argument("--decode-strategy", default="lookahead")
    p.add_argument("--decode-beta", type=float, default=1.0)
    p.add_argument("--decode-viterbibeta", type=float, default=1.0)
    p.add_argument("--average-last-n", type=int, default=5)
    p.add_argument("--vocoder-checkpoint", default=None)
    p.add_argument("--vocoder-torch", default=None)
    p.add_argument("--vocoder-type", default="auto",
                   choices=["auto", "hifigan", "griffin_lim"],
                   help="griffin_lim is not ported yet and raises "
                        "(cli.generate --vocoder-type)")
    p.add_argument("--gcmvn-stats", default=None)
    p.add_argument("--model-yaml", default=None)
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--max-mel-len", type=int, default=1024)
    p.add_argument("--asr-model", default=None,
                   help="HF wav2vec2 CTC id (must be in the local cache)")
    p.add_argument("--target-lang", default="en",
                   help="target language: picks the per-language ASR model "
                        "and BLEU tokenizer (asr_model_cfgs.json table)")
    p.add_argument("--skip-asr", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device, prog="eval_pipeline")
    out_dir = Path(args.results_path)

    # stages 1-3: averaged-checkpoint decode + vocoding via the generate CLI
    from daspeech_torch.cli.generate import main as gen_main

    gen_args = [
        args.data, "--task", "nat_speech_to_speech",
        "--device", args.device,
        "--checkpoint-dir", args.checkpoint_dir,
        "--gen-subset", args.gen_subset,
        "--results-path", str(out_dir),
        "--decode-strategy", args.decode_strategy,
        "--decode-beta", str(args.decode_beta),
        "--decode-viterbibeta", str(args.decode_viterbibeta),
        "--max-tokens", str(args.max_tokens),
        "--max-mel-len", str(args.max_mel_len),
        "--average-last-n", str(args.average_last_n),
    ]
    for flag, v in (("--model-yaml", args.model_yaml),
                    ("--vocoder-checkpoint", args.vocoder_checkpoint),
                    ("--vocoder-torch", args.vocoder_torch),
                    ("--gcmvn-stats", args.gcmvn_stats)):
        if v:
            gen_args += [flag, v]
    if args.vocoder_type != "auto":
        gen_args += ["--vocoder-type", args.vocoder_type]
    rc = gen_main(gen_args)
    if rc:
        return rc

    result = {"results": str(out_dir)}

    # stages 4-5: ASR-BLEU over the generated waveforms
    if not args.skip_asr:
        from daspeech_torch.data.datasets import load_tsv
        from daspeech_torch.eval import asr_available, compute_asr_bleu
        from daspeech_torch.eval.asr_bleu import asr_model_for_lang

        model_name = args.asr_model or asr_model_for_lang(args.target_lang)
        if not asr_available(model_name):
            print(json.dumps({**result, "asr_bleu": None,
                              "note": f"ASR model {model_name} not in local "
                                      "cache (it is loaded from there only)"}))
            return 0
        rows = load_tsv(Path(args.data) / f"{args.gen_subset}.tsv")
        refs, wavs = [], []
        for r in rows:
            wav = out_dir / "wav" / f"{r['id']}_pred.wav"
            if wav.exists():
                wavs.append(wav)
                refs.append(r.get("tgt_ref") or r.get("tgt_text", ""))
        score = compute_asr_bleu(wavs, refs, model_name=model_name,
                                 lang=args.target_lang, device=args.device)
        result["asr_bleu"] = round(score["bleu"], 2)

    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
