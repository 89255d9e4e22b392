"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from ``daspeech_torch/csrc`` with nvcc;
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the shapes the serving path gives it (max abs error <= 1e-4; for links
   also the identical -inf pattern), with median CUDA-event times of both;
4. end-to-end phase: the two-pass S2ST serving path
   (``daspeech_torch.decode.generator.S2SNATGenerator``) at the recipe's
   full width (Conformer 12Lx256d, DAG decoder 4Lx512d, FastSpeech 2
   4+4Lx256d, HiFi-GAN config_v1) with random weights from a seed, on two
   batches; checks finite outputs, waveform lengths, that every kernel was
   launched by that run, and that a CPU run of each batch (plain versions)
   agrees;
5. where the time goes, per batch: the median host-clock time of each
   sub-stage of ``generate()``, audio seconds per wall second, and one
   ``generate()`` under ``torch.profiler`` (device busy share of the wall
   time, the costliest kernels; the trace goes to ``build/profile/``).

The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it holds the kernels' JSON summary, and the nvidia-smi line
comes before that. Any failed check raises. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

TOL_KERNEL = 1e-4
TOL_MEL = 1e-2
MARGIN = 1e-4
SEED = 0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn) -> float:
    """Median CUDA-event time of ``fn()`` in ms over 20 calls, after 3
    warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def _randn(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).cuda()


def _key_bias(B, Tk, g):
    """[B, Tk] padding bias: each row keeps a random prefix of >= Tk/2
    keys."""
    from daspeech_torch.ops.fused_attention import NEG

    keep = torch.randint(Tk // 2, Tk + 1, (B,), generator=g)
    keep[0] = Tk
    pad = torch.arange(Tk)[None, :] >= keep[:, None]
    return torch.where(pad, NEG, 0.0).float().cuda()


def kernel_phase():
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_links as fl
    from daspeech_torch.ops import fused_relpos as fr

    g = torch.Generator().manual_seed(SEED)
    cases = {"fused_attention_packed": [], "fused_extract_links": [],
             "fused_attention_relpos": []}

    def record(name, shape, err, run_kernel, run_plain):
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        cases[name].append({"shape": shape, "max_abs_err": err, "ms": ms,
                            "plain_ms": plain_ms})
        log(f"  {name} {shape}: max_abs_err {err:.3g}  kernel {ms:.4f} ms"
            f"  plain {plain_ms:.4f} ms")
        if not err <= TOL_KERNEL:
            raise AssertionError(f"{name} {shape}: max abs err {err} > "
                                 f"{TOL_KERNEL}")

    # decoder self-attention, cross-attention (Tk = T') and FastSpeech 2
    # self-attention, for batch A and then batch B (1040 mel frames: where
    # the JAX layer leaves the packed kernel for the head-major one)
    for (B, Tq, Tk, C, H) in ((8, 240, 240, 512, 8), (8, 240, 120, 512, 8),
                              (8, 416, 416, 256, 4), (2, 600, 600, 512, 8),
                              (2, 600, 300, 512, 8), (2, 1040, 1040, 256, 4)):
        q = _randn(g, B, Tq, C, scale=(C // H) ** -0.5)
        k, v = _randn(g, B, Tk, C), _randn(g, B, Tk, C)
        bias = _key_bias(B, Tk, g)
        got = fa.fused_attention_packed(q, k, v, bias, H)
        want = fa.attention_plain(q, k, v, bias, H)
        err = (got - want).abs().max().item()
        record("fused_attention_packed", f"q[{B},{Tq},{C}] kv_T={Tk} H={H}",
               err, lambda: fa.fused_attention_packed(q, k, v, bias, H),
               lambda: fa.attention_plain(q, k, v, bias, H))

    for (B, L, C, H) in ((8, 240, 512, 8), (8, 600, 512, 8)):
        q, k = _randn(g, B, L, C), _randn(g, B, L, C)
        gates = torch.log_softmax(_randn(g, B, L, H), dim=-1)
        ol = torch.randint(L // 2, L + 1, (B,), generator=g)
        ol[0] = L
        ol = ol.cuda()
        sc = 1.0 / math.sqrt(C // H)
        got = fl.fused_extract_links(q, k, gates, ol, H, sc, None)
        want = fl.links_plain(q, k, gates, ol, H, sc, None)
        finite = torch.isfinite(want)
        if not torch.equal(torch.isfinite(got), finite) or not bool(
                (got[~finite] == -math.inf).all()):
            raise AssertionError(f"links [{B},{L}]: -inf pattern differs")
        err = (got[finite] - want[finite]).abs().max().item()
        record("fused_extract_links", f"[{B},{L}] C={C} H={H}", err,
               lambda: fl.fused_extract_links(q, k, gates, ol, H, sc, None),
               lambda: fl.links_plain(q, k, gates, ol, H, sc, None))

    for (B, T, C, H) in ((8, 120, 256, 4), (8, 300, 256, 4)):
        q, k, v = (_randn(g, B, T, C) for _ in range(3))
        a = _randn(g, B, T, H * C, scale=0.3)
        e = fr.relpos_basis(T, C, device="cuda")[2].contiguous()
        bias = _key_bias(B, T, g)
        sc = 1.0 / math.sqrt(C // H)
        got = fr.fused_attention_relpos(q, k, v, a, e, bias, H, sc)
        want = fr.relpos_plain(q, k, v, a, e, bias, H, sc)
        err = (got - want).abs().max().item()
        record("fused_attention_relpos", f"[{B},{T},{C}] H={H}", err,
               lambda: fr.fused_attention_relpos(q, k, v, a, e, bias, H, sc),
               lambda: fr.relpos_plain(q, k, v, a, e, bias, H, sc))
    torch.cuda.synchronize()
    return cases


# ---------------------------------------------------------------------------
# end-to-end phase
# ---------------------------------------------------------------------------

def init_random_(module: torch.nn.Module, seed: int):
    """Random weights from a seed, as ``bench.py``'s ``fast_init``: norm
    scales, alphas and running variances 1, biases and running means 0,
    every other tensor N(0, 0.05)."""
    from daspeech_torch.models.conformer import MaskedBatchNorm

    norms = (torch.nn.LayerNorm, MaskedBatchNorm)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if (leaf == "running_var" or "alpha" in leaf
                    or (leaf == "weight" and isinstance(owner, norms))):
                t.fill_(1.0)
            elif leaf in ("bias", "running_mean"):
                t.zero_()
            else:
                t.copy_(torch.randn(t.shape, generator=g) * 0.05)
    return module


def shape_random_decoder_(model, seed: int):
    """Random weights decode every utterance to one or two tokens: the
    graph's input tokens are all <unk>, so every vertex predicts the same
    token, and the links jump from the first vertex to the last. Give the
    decoder what a trained one has instead. The <unk> row of the (tied)
    token embedding is zero, the learned position embeddings are drawn
    N(0, 1) and the cross-attention output projections are scaled by 1/4
    (random encoder states are nearly constant over time, and at full
    strength that constant swamps the vertex features), so the vertices'
    features, and their tokens, differ. The link
    predictor gets a preference for hops of HOP = 4 vertices: the first
    2 * n_freq channels of each head's positional features hold
    cos/sin(w_f * v) of the vertex index v (periods 8 to 2048), and the
    matching query rows rotate them by w_f * HOP, so that per head
    q_i . k_j = a^2 * sum_f cos(w_f * (j - i - HOP)), which peaks at
    j = i + HOP and falls by SHARPNESS = 2 (after the 1/sqrt(dk) scale) one
    vertex either side. The decoded path then moves about HOP vertices per
    step and emits ~L / HOP tokens: ~60 for the 240-vertex graph of 4.8 s
    of speech, about a phoneme every 80 ms. All values stay O(1), so the
    GPU and CPU runs see the same decisions."""
    hop, sharpness = 4, 2.0
    dec = model.dag.decoder
    D = dec.embed_tokens.embedding_dim
    H = dec.num_heads
    dk = D // H
    n_freq = min(16, dk // 4)              # half of each head stays random
    w = 2 * math.pi / (8.0 * 256.0 ** (torch.arange(n_freq) / (n_freq - 1)))
    a = math.sqrt(sharpness * math.sqrt(dk) / float((1 - torch.cos(w)).sum()))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        dec.embed_tokens.weight[model.cfg.dag.vocab.unk] = 0
        E = dec.embed_positions.weight
        E.copy_(torch.randn(E.shape, generator=g))
        for layer in dec.layers:
            layer.encoder_attn.out_proj.weight.mul_(0.25)
        P = dec.link_positional.weight             # row = vertex + pad + 1
        v = (torch.arange(P.shape[0]) - (dec.pad + 1)).float()
        P[:, 0:2 * n_freq:2] = torch.cos(v[:, None] * w)
        P[:, 1:2 * n_freq:2] = torch.sin(v[:, None] * w)
        Wq, Wk = dec.query_linear.weight, dec.key_linear.weight  # [D, 2D]
        c, s = torch.cos(w * hop), torch.sin(w * hop)
        for h in range(H):
            r = h * dk
            for W, lin in ((Wq, dec.query_linear), (Wk, dec.key_linear)):
                W[r:r + 2 * n_freq] = 0
                lin.bias[r:r + 2 * n_freq] = 0
            for f in range(n_freq):
                rc, rs = r + 2 * f, r + 2 * f + 1
                pc, ps = D + 2 * f, D + 2 * f + 1
                Wq[rc, pc], Wq[rc, ps] = a * c[f], -a * s[f]   # cos(w(v+hop))
                Wq[rs, pc], Wq[rs, ps] = a * s[f], a * c[f]    # sin(w(v+hop))
                Wk[rc, pc], Wk[rs, ps] = a, a                  # cos, sin(w v)
    return model


def make_batch(B, S, cfg, seed):
    from daspeech_torch.models import graph_lengths, initialize_output_tokens

    rng = np.random.default_rng(seed)
    lens = torch.full((B,), S, dtype=torch.long)
    prev = initialize_output_tokens(
        graph_lengths(lens, cfg.dag.decoder.src_upsample_scale,
                      cfg.dag.decoder.max_target_positions),
        S // 2, cfg.dag.vocab)
    return {"fbank": rng.normal(size=(B, S, 80)).astype(np.float32),
            "src_lengths": lens.numpy(),
            "prev_output_tokens": prev.numpy()}


def durations_to_fill(gen, batch):
    """(n, d): the longest decoded path n of ``batch`` and the d = M // n
    frames per token with which that utterance fills the mel bucket M."""
    with torch.inference_mode():
        res, _, _ = gen.decode(*gen.to_device(batch))
        n = int(res.feat_lengths.max().item())
    return n, max(1, gen.max_mel_len // max(n, 1))


def set_durations_(model, frames: int):
    """Random weights make predicted durations collapse to ~0 frames
    (bench.py:21-24). Zero the duration predictor's projection and set its
    output bias to log(1 + frames), so that every token lasts ``frames``
    frames."""
    proj = model.tts.var_adaptor.duration_predictor.proj
    with torch.no_grad():
        proj.weight.zero_()
        proj.bias.fill_(math.log(1.0 + frames))


def path_margin(logits, links, ol, b, upto_vertex, beta=1.0):
    """Smallest top-2 margin, along sample b's CPU decode path up to
    ``upto_vertex``, of the vertex token log-probs and the lookahead hop
    scores: how close the decision there was to a tie."""
    logp = torch.log_softmax(logits[b].float(), dim=-1)
    top_tok = logp.topk(2, dim=-1).values
    score = links[b] + beta * logp.max(dim=-1).values[None, :]
    top_hop = score.topk(2, dim=-1).values
    j, margin = 0, math.inf
    while True:
        margin = min(margin, float(top_tok[j, 0] - top_tok[j, 1]))
        if j == upto_vertex or j >= int(ol[b]) - 1:
            return margin
        margin = min(margin, float(top_hop[j, 0] - top_hop[j, 1]))
        j = int(score[j].argmax())


def compare_tokens(gen_cpu, batch, hyp_gpu, hyp_cpu):
    """Tokens must agree; where a sample differs, the decision that split
    them must have been a near tie (top-2 margin < MARGIN)."""
    from daspeech_torch.decode.dag_decode import greedy_or_lookahead_decode

    worst = None
    for b, (hg, hc) in enumerate(zip(hyp_gpu, hyp_cpu)):
        tg, tc = hg["tokens"], hc["tokens"]
        if np.array_equal(tg, tc):
            continue
        n = min(len(tg), len(tc))
        s = int(np.argmax(tg[:n] != tc[:n])) if (tg[:n] != tc[:n]).any() \
            else n
        with torch.inference_mode():
            fbank, lens, prev = gen_cpu.to_device(batch)
            enc, enc_pad, _ = gen_cpu.model.encode(fbank, lens)
            logits, links, _ = gen_cpu.model.decode(prev, enc, enc_pad)
            ol = (prev != gen_cpu.vocab.pad).sum(1)
            res = greedy_or_lookahead_decode(logits, links, ol,
                                             gen_cpu.vocab.pad)
            v = int(res.feat_idx[b, s]) if s > 0 else 0
            m = path_margin(logits, links, ol, b, v)
        log(f"  sample {b}: tokens differ from slot {s}; top-2 margin on "
            f"the path there {m:.3g}")
        if not m < MARGIN:
            raise AssertionError(f"sample {b}: tokens differ at slot {s} "
                                 f"with top-2 margin {m} >= {MARGIN}")
        worst = m
    return worst


def e2e_phase():
    from daspeech_torch.config import (DAGModelConfig, DecodeConfig,
                                       HiFiGANConfig, S2SModelConfig,
                                       VocabConfig)
    from daspeech_torch.decode import S2SNATGenerator
    from daspeech_torch.models import (HiFiGANGenerator,
                                       S2SConformerDAGFastSpeech2)
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_links as fl
    from daspeech_torch.ops import fused_relpos as fr

    # the recipe's widths with the phoneme vocab rounded to 128, as bench.py
    cfg = S2SModelConfig(dag=DAGModelConfig(vocab=VocabConfig(size=128)))
    voc_cfg = HiFiGANConfig()
    model_cpu = shape_random_decoder_(
        init_random_(S2SConformerDAGFastSpeech2(cfg), SEED), SEED)
    voc_cpu = init_random_(HiFiGANGenerator(voc_cfg), SEED + 1)
    for m in (model_cpu, voc_cpu):
        m.eval().requires_grad_(False)
    model = copy.deepcopy(model_cpu).cuda()
    voc = copy.deepcopy(voc_cpu).cuda()
    decode_cfg = DecodeConfig()

    batch_a = make_batch(8, 480, cfg, SEED)
    batch_b = make_batch(2, 1200, cfg, SEED + 1)
    gen_a = S2SNATGenerator(model, cfg.dag.vocab, decode_cfg, max_mel_len=416,
                            vocoder=voc)
    gen_b = S2SNATGenerator(model, cfg.dag.vocab, decode_cfg,
                            max_mel_len=1040, vocoder=voc)

    # durations are set per batch before each batch's served run (they are
    # a property of the random weights, not of the serving path)
    n_a, d_a = durations_to_fill(gen_a, batch_a)
    n_b, d_b = durations_to_fill(gen_b, batch_b)
    log(f"  durations: batch A {d_a} frames/token (longest path {n_a}), "
        f"batch B {d_b} (longest path {n_b})")

    wrappers = (fa.fused_attention_packed, fl.fused_extract_links,
                fr.fused_attention_relpos)
    # --- the main path's run: counters from 0, both batches served once
    for w in wrappers:
        w.launches = 0
    set_durations_(model, d_a)
    hyp_a = gen_a.generate(batch_a)
    set_durations_(model, d_b)
    hyp_b = gen_b.generate(batch_b)
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    log(f"  launches in the served run: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched by the main path")

    for tag, hyps, M in (("A", hyp_a, 416), ("B", hyp_b, 1040)):
        log(f"  batch {tag}: tokens/utt "
            f"{[len(h['tokens']) for h in hyps]}, mel frames "
            f"{[h['feature'].shape[0] for h in hyps]}")
        # random weights may decode an utterance to one token, which has
        # no feature to synthesize from: an empty mel is a valid result,
        # but most of the batch must carry audio
        if sum(h["feature"].shape[0] > 0 for h in hyps) * 2 < len(hyps):
            raise AssertionError(f"batch {tag}: most mels are empty")
        for b, h in enumerate(hyps):
            mel_len = h["feature"].shape[0]
            if not (mel_len <= M and h["feature"].shape[1] == 80):
                raise AssertionError(
                    f"batch {tag}[{b}]: mel {h['feature'].shape}")
            if len(h["waveform"]) != mel_len * 256:
                raise AssertionError(f"batch {tag}[{b}]: {len(h['waveform'])}"
                                     f" samples for {mel_len} frames")
            for key in ("feature", "waveform"):
                if not np.isfinite(h[key]).all():
                    raise AssertionError(f"batch {tag}[{b}]: non-finite "
                                         f"{key}")

    # --- each batch again on the CPU (plain versions), same weights
    for tag, batch, hyps, M, d in (("A", batch_a, hyp_a, 416, d_a),
                                   ("B", batch_b, hyp_b, 1040, d_b)):
        set_durations_(model_cpu, d)
        gen_cpu = S2SNATGenerator(model_cpu, cfg.dag.vocab, decode_cfg,
                                  max_mel_len=M, vocoder=voc_cpu)
        t0 = time.perf_counter()
        hyp_cpu = gen_cpu.generate(batch, generate_waveform=False)
        cpu_s = time.perf_counter() - t0
        margin = compare_tokens(gen_cpu, batch, hyps, hyp_cpu)
        mel_err = 0.0
        for hg, hc in zip(hyps, hyp_cpu):
            if np.array_equal(hg["tokens"], hc["tokens"]):
                if hg["feature"].shape != hc["feature"].shape:
                    raise AssertionError(f"batch {tag}: mel lengths differ "
                                         "between GPU and CPU")
                if hg["feature"].size:
                    mel_err = max(mel_err, float(
                        np.abs(hg["feature"] - hc["feature"]).max()))
        log(f"  GPU vs CPU batch {tag}: tokens "
            f"{'identical' if margin is None else 'near-tie differences'}, "
            f"mel max abs diff {mel_err:.3g} (CPU run {cpu_s:.1f} s)")
        if not mel_err <= TOL_MEL:
            raise AssertionError(f"batch {tag}: mel differs from the CPU run "
                                 f"by {mel_err}")

    # --- where the time goes, per batch
    for tag, gen, batch, hyps, d in (("A", gen_a, batch_a, hyp_a, d_a),
                                     ("B", gen_b, batch_b, hyp_b, d_b)):
        set_durations_(model, d)
        med = sub_stage_ms(gen, batch)
        audio_s = sum(h["feature"].shape[0] for h in hyps) * 256 / 22050.0
        stage1 = sum(med[k] for k in ("encode", "decoder+links", "lookahead",
                                      "gather"))
        log(f"  batch {tag} sub-stages (median of 5, ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in med.items()))
        log(f"  batch {tag} stages (ms): encoder+decoder+decode {stage1:.3f}, "
            f"FastSpeech 2 {med['fastspeech2']:.3f}, vocoder "
            f"{med['vocoder']:.3f}; generate() {med['generate']:.3f} ms for "
            f"{audio_s:.2f} s of audio = "
            f"{audio_s / (med['generate'] / 1e3):.1f} audio-s per wall-s")
        device_busy(gen, batch, tag)
    return launches


def sub_stage_ms(gen, batch, reps=5):
    """Median host-clock ms of each step of ``gen.generate(batch)``, each
    closed by a synchronize, and of a whole ``generate()``; the first of
    ``reps + 1`` rounds is a warm-up."""
    from daspeech_torch.decode.dag_decode import (gather_path_features,
                                                  greedy_or_lookahead_decode)

    model, pad, cfg = gen.model, gen.vocab.pad, gen.cfg
    names = ("encode", "decoder+links", "lookahead", "gather", "fastspeech2",
             "vocoder", "d2h+hyps", "generate")
    times = {k: [] for k in names}
    with torch.inference_mode():
        for rep in range(reps + 1):
            torch.cuda.synchronize()
            ts = [time.perf_counter()]

            def mark():
                torch.cuda.synchronize()
                ts.append(time.perf_counter())

            fbank, lens, prev = gen.to_device(batch)
            enc, enc_pad, _ = model.encode(fbank, lens)
            mark()
            logits, links, feats = model.decode(prev, enc, enc_pad)
            mark()
            res = greedy_or_lookahead_decode(
                logits, links, (prev != pad).sum(1), pad, cfg.beta,
                lookahead=cfg.strategy == "lookahead")
            mark()
            z, zmask = gather_path_features(feats, res, skip_first=True)
            mark()
            mel, mel_lens = gen.synthesize(z, zmask)
            mark()
            wav = gen.vocode(mel)
            mark()
            gen._hypotheses(res, mel, mel_lens, wav)
            ts.append(time.perf_counter())
            gen.generate(batch)
            ts.append(time.perf_counter())
            if rep:
                for k, a, b in zip(names, ts[:-1], ts[1:]):
                    times[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def device_busy(gen, batch, tag):
    """One ``generate()`` under ``torch.profiler``: the device's busy time
    (union of kernel intervals) against the wall time, and the kernels that
    took the most device time. The trace goes to ``build/profile/``."""
    from torch.profiler import ProfilerActivity, profile

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(out_dir, f"trace_batch{tag}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    if not events:
        log(f"  batch {tag} profiled generate(): wall {wall:.2f} ms; the "
            "profiler saw no kernels, device busy not measured")
        return
    busy, end = 0.0, -1.0
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    busy /= 1e3
    log(f"  batch {tag} profiled generate(): wall {wall:.2f} ms, "
        f"{len(events)} kernels, device busy {busy:.2f} ms "
        f"({busy / wall:.3f} of wall)")
    by_name = {}
    for e in events:
        n = by_name.setdefault(e["name"][:100], [0, 0.0])
        n[0] += 1
        n[1] += e["dur"] / 1e3
    for name, (count, ms) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:12]:
        log(f"    {ms:9.3f} ms {count:6d}x  {name}")


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 1
    if torch.cuda.device_count() != 1:
        log("chip_smoke: drives one card; make one visible with "
            "CUDA_VISIBLE_DEVICES")
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import daspeech_torch  # noqa: F401  (sets the TF32 flags off)
    from daspeech_torch.ops import _build

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("importing daspeech_torch left TF32 on")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    built = _build.build()
    log(f"kernels built in {built.seconds:.1f} s -> {built.path}")
    if built.ptxas:
        log(built.ptxas.strip())
    _build.library()

    log("kernel phase:")
    cases = kernel_phase()
    log("end-to-end phase:")
    launches = e2e_phase()

    sources = {"fused_attention_packed": (
                   "daspeech_torch/csrc/fused_attention.cu",
                   "daspeech_tpu/ops/fused_attention.py:522"),
               "fused_extract_links": (
                   "daspeech_torch/csrc/fused_links.cu",
                   "daspeech_tpu/ops/fused_links.py:141"),
               "fused_attention_relpos": (
                   "daspeech_torch/csrc/fused_relpos.cu",
                   "daspeech_tpu/ops/fused_relpos.py:373")}
    kernels = []
    for name, shapes in cases.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": shapes[0]["ms"], "plain_ms": shapes[0]["plain_ms"],
            "shapes": shapes})
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "daspeech_tpu"))
    if foreign:
        raise AssertionError(f"the port imported {foreign}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
