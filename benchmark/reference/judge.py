"""Judge served S2ST batches against the plain reference.

A served batch is judged on what it returned for each utterance: its
tokens, the graph vertices that emitted them, its mel and its waveform.
The reference runs the whole model over the same inputs with the same
weights and reads:

- ``decision_gap``: the widest gap by which a served decision lies below
  the reference's best, over two kinds of decision. A token: the
  log-probability of a served token below the reference's best token at
  the vertex that emitted it. A hop: 0 where every vertex that emitted a
  served token lies on the path of the reference's own hops; else, where
  the served path first leaves it, the least gap by which a hop off the
  path lies below the reference's best hop (a lower bound of the served
  hop's gap);
- ``mel_err`` and ``wav_err``: the largest absolute difference between the
  served mel (waveform) and the reference's, which synthesises along the
  served path, over the batch's largest reference magnitude;
- ``len_mismatch``: utterances whose mel length differs from the
  reference's; ``missing``: utterances with no answer.

Every reading is the worst over the judged batches.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.s2st import S2ST

READINGS = ("decision_gap", "mel_err", "wav_err", "len_mismatch",
            "missing")


def walk(score, n):
    """The vertices the reference's hops visit from vertex 0 to n - 1."""
    hops = score.argmax(axis=1)
    path = [0]
    while path[-1] != n - 1:
        path.append(int(hops[path[-1]]))
    return path


def first_divergence_gap(score, verts, n):
    """0 where every served emitting vertex lies on the reference's path
    (whatever the tokens decided about emitting); else, at the first served
    vertex e off that path, the smallest reference regret
    ``max_j score[c, j] - score[c, q]`` of a hop that could have left the
    path: from a path vertex c between the previous served vertex and e,
    to a vertex q in (c, e] off the path. The served hop was one of them,
    so this bounds its gap from below."""
    path = walk(score, n)
    on = set(path)
    prev = 0
    for e in verts:
        if e in on:
            prev = e
            continue
        best = math.inf
        for c in path:
            if prev <= c < e:
                q = np.arange(c + 1, e + 1)
                q = q[[int(x) not in on for x in q]]
                s = score[c, q]
                s = s[np.isfinite(s)]
                if s.size:
                    best = min(best, float(score[c].max() - s.max()))
        return best
    return 0.0


def judge_batch(ref: S2ST, batch: Dict[str, torch.Tensor],
                served: List[dict], max_mel_len: int) -> Dict[str, float]:
    """Readings of one served batch (``served[b]`` has ``tokens``,
    ``vertices``, ``feature`` and ``waveform``, or is None)."""
    pad = ref.vocab["pad"]
    logits, links, feats = ref.decoder_pass(
        batch["fbank"], batch["src_lengths"], batch["prev_output_tokens"])
    _, logp, score = ref.hop_scores(logits, links)
    del logits, links
    n = (batch["prev_output_tokens"] != pad).sum(dim=1).cpu().numpy()
    r = dict.fromkeys(READINGS, 0.0)
    paths = []
    for b, hyp in enumerate(served):
        if hyp is None:
            r["missing"] += 1
            paths.append([])
            continue
        t = [int(x) for x in hyp["tokens"]]
        verts = [int(v) for v in hyp["vertices"]]
        paths.append(verts)
        if len(t) != len(verts) + 1 or any(
                not 0 < v < n[b] for v in verts):
            r["decision_gap"] = math.inf
            continue
        best = logp[b].max(axis=1)
        gap = first_divergence_gap(score[b], verts, int(n[b]))
        for v, tk in zip([0] + verts, t):
            gap = max(gap, float(best[v] - logp[b, v, tk]))
        r["decision_gap"] = max(r["decision_gap"], gap)
    mel, mel_lens = ref.synthesize_paths(feats, paths, max_mel_len)
    wav = ref.vocode(mel)
    hop = wav.shape[1] // mel.shape[1]
    mel_diff = wav_diff = 0.0
    mel_scale = wav_scale = 0.0
    for b, hyp in enumerate(served):
        if hyp is None:
            continue
        m = min(int(mel_lens[b]), max_mel_len)
        want_mel = mel[b, :m].cpu().numpy()
        want_wav = wav[b, :m * hop].cpu().numpy()
        mel_scale = max(mel_scale, float(np.abs(want_mel).max(initial=0.0)))
        wav_scale = max(wav_scale, float(np.abs(want_wav).max(initial=0.0)))
        got_mel, got_wav = hyp["feature"], hyp["waveform"]
        if got_mel.shape != want_mel.shape or got_wav.shape != want_wav.shape:
            r["len_mismatch"] += 1
            continue
        mel_diff = max(mel_diff, float(np.abs(got_mel - want_mel).max(
            initial=0.0)))
        wav_diff = max(wav_diff, float(np.abs(got_wav - want_wav).max(
            initial=0.0)))
    r["mel_err"] = mel_diff / max(mel_scale, 1e-30)
    r["wav_err"] = wav_diff / max(wav_scale, 1e-30)
    return r


def worst(readings: List[Dict[str, float]]) -> Dict[str, float]:
    """The worst of each reading over batches."""
    return {k: max((r[k] for r in readings), default=0.0) for k in READINGS}
