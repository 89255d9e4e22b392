"""Checkpoint-in parity harness, on the card: one command from released
PyTorch checkpoints + a CVSS-C manifest to mel-MSE / token-match /
ASR-BLEU-delta numbers against reference-generated artifacts.

Counterpart of ``daspeech_tpu/cli/parity.py``; it runs on ``--device``
(default ``cuda``) and exits non-zero when that device is missing.

The reference pipeline (``test_scripts/generate.fr-en.lookahead.vctk.sh``)
dumps per-utterance mel features to ``feat/{id}.npy`` (transposed [80, T])
and waveforms to ``*_pred.wav``; this tool (1) runs OUR generation from the
same torch checkpoint over the same manifest (via ``cli.generate
--model-torch``), then (2) compares the two result trees:

  python -m daspeech_torch.cli.parity DATA \
      --model-torch daspeech_fr_en.pt --vocoder-torch VCTK_V1 \
      --reference-results ref_results/ --results-path ours/ \
      --decode-strategy lookahead --target-lang en

Emits one JSON line: token exact-match rate + corpus token accuracy over
hypos.txt, per-utterance mel MSE / frame-count agreement over feat/*.npy,
and (when both sides have wavs and the ASR model is cached locally)
ASR-BLEU for both plus the delta — the BASELINE.json "within 0.2" check.

If ``--reference-results`` is omitted, only OUR metrics are produced
(generation + optional ASR-BLEU), which still yields the absolute numbers
to cite. Ref: ``s2s_nat_generator.py:49-285``, ``compute_asr_bleu.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from daspeech_torch.cli.generate import read_wav, resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser("daspeech-torch-parity")
    p.add_argument("data")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; without a card, pass "
                        "--device cpu (the default never falls back)")
    p.add_argument("--model-torch", default=None,
                   help="released DASpeech .pt (fed to cli.generate)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="port checkpoint dir (alternative to .pt)")
    p.add_argument("--vocoder-torch", default=None)
    p.add_argument("--vocoder-checkpoint", default=None)
    p.add_argument("--reference-results", default=None,
                   help="reference results dir (feat/*.npy [+ hypos.txt]"
                        " [+ wav/ or *_pred.wav]) to compare against")
    p.add_argument("--results-path", default="parity_results")
    p.add_argument("--skip-generate", action="store_true",
                   help="reuse an existing --results-path")
    p.add_argument("--gen-subset", default="test")
    p.add_argument("--task", default="nat_speech_to_speech")
    p.add_argument("--decode-strategy", default="lookahead")
    p.add_argument("--decode-beta", type=float, default=1.0)
    p.add_argument("--decode-viterbibeta", type=float, default=1.0)
    p.add_argument("--src-upsample-scale", type=float, default=0.5)
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--max-mel-len", type=int, default=1024)
    p.add_argument("--model-yaml", default=None)
    p.add_argument("--gcmvn-stats", default=None)
    p.add_argument("--target-lang", default="en")
    p.add_argument("--skip-asr", action="store_true")
    return p.parse_args(argv)


def _find_wavs(root: Path):
    """Map utt id -> wav path under a results tree (our ``wav/{id}_pred.wav``
    or the reference's flat ``{id}_generated_e2e.wav`` / ``{id}_pred.wav``)."""
    out = {}
    for pat, strip in (("wav/*_pred.wav", "_pred"),
                       ("*_pred.wav", "_pred"),
                       ("*_generated_e2e.wav", "_generated_e2e")):
        for f in root.glob(pat):
            out.setdefault(f.stem[: -len(strip)], f)
    return out


def _read_hypos(path: Path):
    out = {}
    if path.exists():
        for line in path.read_text().splitlines():
            utt, _, text = line.partition("\t")
            out[utt] = text.strip()
    return out


def compare_trees(ours: Path, ref: Path):
    """Token / mel agreement between two result trees."""
    rec = {}
    h_ours = _read_hypos(ours / "hypos.txt")
    h_ref = _read_hypos(ref / "hypos.txt")
    common = sorted(set(h_ours) & set(h_ref))
    if common:
        exact = sum(h_ours[u] == h_ref[u] for u in common)
        num = den = 0
        for u in common:
            a, b = h_ours[u].split(), h_ref[u].split()
            den += max(len(a), len(b))
            num += sum(x == y for x, y in zip(a, b))
        rec["token_utts"] = len(common)
        rec["token_exact_match"] = round(exact / len(common), 4)
        rec["token_accuracy"] = round(num / max(den, 1), 4)

    ours_feat = {f.stem: f for f in (ours / "feat").glob("*.npy")} \
        if (ours / "feat").is_dir() else {}
    ref_feat = {f.stem: f for f in (ref / "feat").glob("*.npy")} \
        if (ref / "feat").is_dir() else {}
    common = sorted(set(ours_feat) & set(ref_feat))
    if common:
        mses, len_match = [], 0
        for u in common:
            a, b = np.load(ours_feat[u]), np.load(ref_feat[u])
            if a.shape[0] != 80:
                a = a.T
            if b.shape[0] != 80:
                b = b.T
            n = min(a.shape[1], b.shape[1])
            if n:
                mses.append(float(np.mean((a[:, :n] - b[:, :n]) ** 2)))
            len_match += a.shape[1] == b.shape[1]
        rec["mel_utts"] = len(common)
        rec["mel_mse"] = round(float(np.mean(mses)), 6) if mses else None
        rec["mel_frames_match"] = round(len_match / len(common), 4)
    return rec


def asr_bleu_for(root: Path, refs_by_id, lang: str, device: str = "cuda"):
    """Transcribe a result tree's wavs on ``device`` and score corpus BLEU
    (13a, the reference-compatible tokenizer) against the manifest
    targets."""
    from daspeech_torch.eval import asr_available
    from daspeech_torch.eval.asr_bleu import (
        Wav2Vec2Transcriber, asr_model_for_lang, corpus_bleu)

    model_name = asr_model_for_lang(lang)
    if not asr_available(model_name):
        return None, f"ASR model {model_name} not in local cache"
    wavs = _find_wavs(root)
    ids = sorted(set(wavs) & set(refs_by_id))
    if not ids:
        return None, "no wavs matching manifest ids"
    tr = Wav2Vec2Transcriber(model_name, device)
    hyps = []
    for u in ids:
        wav, sr = read_wav(wavs[u])
        hyps.append(tr.transcribe(wav, sr))
    # 13a for every language = the reference's scoring, so deltas are
    # comparable to reference-reported numbers
    return corpus_bleu(hyps, [refs_by_id[u] for u in ids], lang,
                       tokenizer="13a"), None


def main(argv=None):
    args = parse_args(argv)
    resolve_device(args.device, prog="parity")
    out_dir = Path(args.results_path)

    if not args.skip_generate:
        from daspeech_torch.cli import generate as gen

        gen_args = [args.data, "--task", args.task, "--device", args.device,
                    "--gen-subset", args.gen_subset,
                    "--results-path", str(out_dir),
                    "--decode-strategy", args.decode_strategy,
                    "--decode-beta", str(args.decode_beta),
                    "--decode-viterbibeta", str(args.decode_viterbibeta),
                    "--src-upsample-scale", str(args.src_upsample_scale),
                    "--max-tokens", str(args.max_tokens),
                    "--max-mel-len", str(args.max_mel_len)]
        for flag, v in (("--model-torch", args.model_torch),
                        ("--checkpoint-dir", args.checkpoint_dir),
                        ("--vocoder-torch", args.vocoder_torch),
                        ("--vocoder-checkpoint", args.vocoder_checkpoint),
                        ("--model-yaml", args.model_yaml),
                        ("--gcmvn-stats", args.gcmvn_stats)):
            if v:
                gen_args += [flag, str(v)]
        rc = gen.main(gen_args)
        if rc not in (0, None):
            return rc

    rec = {"results": str(out_dir)}
    if args.reference_results:
        rec.update(compare_trees(out_dir, Path(args.reference_results)))

    if not args.skip_asr:
        from daspeech_torch.data.datasets import load_tsv

        rows = load_tsv(Path(args.data) / f"{args.gen_subset}.tsv")
        refs_by_id = {r["id"]: r.get("tgt_text", "") for r in rows}
        bleu, note = asr_bleu_for(out_dir, refs_by_id, args.target_lang,
                                  args.device)
        if bleu is None:
            rec["asr_note"] = note
        else:
            rec["asr_bleu_ours"] = round(bleu, 2)
        if args.reference_results and bleu is not None:
            ref_bleu, ref_note = asr_bleu_for(
                Path(args.reference_results), refs_by_id, args.target_lang,
                args.device)
            if ref_bleu is not None:
                rec["asr_bleu_ref"] = round(ref_bleu, 2)
                rec["asr_bleu_delta"] = round(bleu - ref_bleu, 2)

    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
