"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--parent DIR]

(``--parent DIR``: another checkout of the repository, typically the parent
commit unpacked with ``git archive``; its kernels are built too, and the
kernel phase times the rows of the kernels redesigned since (the training
forward of #1, #2, #3 and #5, the link extraction #4 forward and backward,
the DP #8 and the Viterbi #9, the fused FFN #6 forward and backward and
the MRF level #7) with its library as well, on the same inputs in the same
process.)

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from ``daspeech_torch/csrc`` with nvcc
   (one process per source, started together);
3. kernel phase: every kernel against its plain PyTorch version on the card,
   at the shapes the serving and training paths give it (forward and, for
   the training paths, backward with dropout on the same Philox bits; max
   abs error <= 1e-4; the DP's log-probabilities against the plain loop in
   float64, within 2 sqrt(T) ulp of the largest magnitude, over four
   shapes and four seeds; Viterbi paths equal; the DP and the Viterbi at
   the shapes of S2TT, J, J-long and the L cap, each row with its launch's
   cluster size, threads, shared memory, the clusters the card holds at
   once and the µs a step; attention #1, #2, #3 and #5
   (the backward and the inference forward on the tensor cores; the
   training forward, which saves the softmax statistics, on the fp32 FMA
   pipes, attention_fma.cuh's register-tiled kernel, #3 in its full-bias
   mode; at each training shape both forwards are timed): the head-major
   kernel
   against the packed one at a shape both take, <= 1e-6, each backward
   bit-identical over two runs, HMMA instructions in the tensor-core
   kernels' SASS (cuobjdump), FFMA and no HMMA in the FMA kernel's, no
   spills in its ptxas report, and only their own kernels in a profile of
   their forward and backward (16 kernels for #1, #2, #5 and #3; no SIMT
   attention forward in the library); the link extraction #4 at serving
   A's and B's graphs (forward) and at cell T's and J-long's (forward and
   backward; its forward on the FMA pipes, its backward on the tensor
   cores, HMMA in its SASS), the same -inf pattern as plain; the
   fused FFN
   #6 at cell T's encoder and serving A's and B's, its weight gradients
   bit-identical over two runs, its backward against autograd of the plain
   forward (the same masks) and its drop fraction within 1% of p, beside
   the unfused module (LayerNorm, two ``F.linear``, SiLU and dropout;
   forward, and its autograd backward); the MRF level #7 at serving A's
   levels 1-3, B's level 1 and a chunk window, at every tile, against the
   plain ``F.conv1d`` chain (which is also its library time, cuDNN) and at
   the window against float64; HMMA in the SASS of #6's and #7's kernels
   and no spills in their ptxas report; the
   full-bias attention #3 at three shapes with a fully masked row, and
   against the head-major kernel on a column bias, <= 1e-4), with median
   CUDA-event times of the kernel, the plain version and, for attention,
   ``scaled_dot_product_attention`` with dropout at the same rate (timed
   here, used nowhere in the port; for the rel-pos #5 on the extended
   operands [q_u | a] and [k | e], whose concatenation is timed apart),
   the parent tree's kernel with ``--parent``, and the least time the
   card could take (bytes over 3.35 TB/s, or operations over the rate of
   their kind: matrix products at fp32 accuracy over 165 TFLOP/s, the
   3xTF32 rate of the tensor cores, and the DP's and Viterbi's over 67
   TFLOP/s of fp32 FMA);
4. serving phase: the two-pass S2ST serving path
   (``daspeech_torch.decode.generator.S2SNATGenerator``) at the recipe's
   full width (Conformer 12Lx256d, DAG decoder 4Lx512d, FastSpeech 2
   4+4Lx256d, HiFi-GAN config_v1) with random weights from a seed, on two
   batches; checks finite outputs, waveform lengths, that every kernel of
   the path was launched by that run (batch B's 1040-frame FastSpeech 2
   decoder takes the head-major attention), and that a CPU run of each
   batch (plain versions) agrees; per batch, the median host-clock time of
   each sub-stage of ``generate()``, audio seconds per wall second, and
   one ``generate()`` under ``torch.profiler``;
5. S2TT training phase: the DAG step (``daspeech_torch.train.make_train_step``
   over ``daspeech_torch.losses.nat_dag_loss``) on bench.py config 5's
   batch (B=80, 480 frames, 240 vertices, 64 target tokens): one step on
   the card against one on the CPU (dropout 0, GLAT p=0, 8 utterances),
   the kernel path against the plain path on the card (dropout 0.1, GLAT
   p=0.5), 13 timed updates (the run whose launch counts are read: every
   kernel must have run; the attention forwards' training launches counted
   apart), sub-stages, the device busy share of one profiled update (whose
   attention forwards must all be the FMA training forward or the
   tensor-core kernels),
   peak memory, and 30 updates on one batch that must bring the loss down;
6. joint S2ST training phase (``s2s_dag_fastspeech2_loss``): card-vs-CPU
   steps at B=4 (``expect`` and ``argmax``), the kernel path against the
   plain path at J-long with dropout on, 13 timed updates with sub-stages,
   busy share and peak memory at J (bench.py's joint batch) and J-long (14
   utterances of 14 s), checking the head-major kernel's launches per
   update (0 at J, 12 forward and 8 backward at J-long) and that every DP
   and Viterbi launch at J-long ran on a cluster of more than one block, a
   frozen-DAG step
   (every DAG and encoder gradient exactly 0), and 30 updates that must
   end at <= 0.9 of the first loss;
7. FastSpeech 2 pretraining phase (``fastspeech2_criterion``): a
   card-vs-CPU step at B=4, 7 updates (5 timed) at B=14, 1040 frames, and
   the device busy share of one profiled update (with --parent also with
   the parent tree's kernels, in turns);
8. vocoder-mode phase, HiFi-GAN config_v1 (random weights scaled by their
   fan-in) on serving A's and B's mels: ``fused_mrf=True`` (the run whose launch
   count of the MRF kernel is read: 3 per batch) against the default mode
   (<= 1e-4), each mode's vocoder ms; exact chunked vocoding
   (``serve_chunk=64``, B=1) against one-shot in its own mode (<= 1e-5) and
   the default one-shot (<= 1e-4), its first-chunk latency and whole
   time, once with ``fused_mrf=True``; ResBlock type 2
   at hifi-gan's config_v3 widths, one-shot and chunked, against a B=1 CPU
   run (<= 2.5e-4);
9. TTS phase: ``NonAutoregressiveSpeechGenerator`` (FastSpeech 2 4+4Lx256d
   on phonemes, vocab 128, then config_v1) on 8 utterances of 52 phonemes
   (416 frames) and 2 of 130 (1040 frames: the decoder takes the
   head-major attention), each mel against a CPU run (<= 1e-3), ms per
   batch, audio seconds per wall second and the device busy share of one
   profiled batch (with --parent also with the parent tree's kernels, as
   the pretraining phase's);
10. alternates phase: the two verified alternate backends, as the JAX
   package exposes them. ``FeedForwardModule(fused=True)`` set on every
   encoder layer of the S2TT model of phase 5: its step against the
   unfused one at dropout 0 and GLAT p=0 (loss 1e-4, gradients 1e-3 of their
   norm), 24 forward and 24 backward fused-FFN launches per update
   (asserted), and 13 updates (10 timed) each way at cell T;
   ``fused_attention_full_bias`` on an ALiBi-style bias [8, 8, 240, 64],
   forward and backward against the plain version, and its profile (the
   training forward the FMA kernel's). Both kernels launch 0 times on every
   other path (asserted);
11. decode-strategy phase, on the serving phase's model and batches:
   ``S2SNATGenerator`` under ``viterbi`` and ``jointviterbi`` at serving A
   and B (B's FastSpeech 2 takes #2), ``S2TNATGenerator`` under
   ``beamsearch`` at the reference's defaults (beamsize 100, top_cand_n 5,
   top_p 0.9, alpha 1.1), lookahead with ``length_beam=3`` and with
   ``iter_decode_max_iter=2``, at A: each run's launches of #1, #2, #4 and
   #5 (the length beam's encoder and decoder once, asserted), tokens
   against a CPU run of the same weights (a row that differs must be a
   near tie of the CPU's own scores of the two hypotheses, within 1e-4),
   mel within 1e-2, the decode stage's median host ms of 5 and its device
   kernels under ``torch.profiler``;
12. vocoder-training phase (``VocoderTrainer``, HiFi-GAN config_v1 against
   MPD + MSD, fp32): one D + G update on the card against one on the CPU
   at B=2 (losses within 1e-4 relative, gradients within 1e-3 of their
   norm), 3 warm-up and 10 timed updates at B=16 x 8192 samples (D and G
   halves apart, IQR), peak memory, the device busy share of one profiled
   update, and 30 updates on one batch that must bring the mel loss to
   <= 0.9 of its first value;
13. runtime phase: a CVSS-style data directory written to disk (80
   utterances of 440-520 fbank frames and 4 of 1200 in a stored zip,
   vocab 128, target mels with durations that sum to their length, pitch
   and energy); the joint model at config J trained for 8 updates through
   ``NATSpeechToSpeechTask.get_batch_iterator`` -> ``prefetch_epoch``
   (collated and moved to the card on the producer thread) ->
   ``make_train_step`` (the run whose launches are read), logged through
   ``MetricsAggregator`` + ``JsonProgressLogger`` and saved through
   ``CheckpointManager(keep_last=2)`` every 2 updates; a fresh model and
   optimizer restored from update 4's checkpoint and resumed at its saved
   iterator position must reproduce updates 5-8 bit for bit (both runs in
   torch's deterministic mode) and collate none of the skipped batches;
   the last 2 checkpoints averaged; the generate CLI
   (``daspeech_torch.cli.generate.main``, in-process) over the data
   directory from a checkpoint of the serving phase's model and a
   ``VocoderTrainer`` checkpoint: its tokens equal those of the in-process
   ``S2SNATGenerator`` on the CLI's own batches (features within 1e-5), and
   a CPU run of the CLI on 2 utterances (tokens by the near-tie rule,
   features within 1e-2); it prints the data wait, collate, checkpoint and
   CLI numbers, each beside the card's name and power limit. The data and
   checkpoints live under ``build/`` and are deleted at the end. The
   training loop is the train CLI's (``cli.train.train_loop``);
14. CLI phase, on the runtime phase's data (plus ``train_long``, all 84
   utterances; ``dev``, 8; a vocoder TSV of 16 synthetic waveforms of
   26624 samples, written with ``preprocess.prep_data``) at the recipe's
   widths: ``daspeech_torch.cli.train.main`` in-process for stage 1
   (S2TT, 6 updates, saves at 3 and 6, ``--encoder-freezing-updates 2
   --weight-decay 0``: the encoder unchanged with zero Adam moments
   through update 2, moved by update 3), stage 2 (FastSpeech 2, 4
   updates) and stage 3 (joint ``expect`` from stages 1 and 2, 6 updates
   over the long bucket too, validating and saving every 3: the train
   kernels #1, #4, #5, #8, #9 and their backwards on every update, the
   head-major #2 forward and backward on the 1216-frame bucket's and on
   no other; its first update's loss equal to an in-process
   ``make_train_step`` update within 1e-5; the run whose launches are read
   as ``cli_train``), stage 3 ``--restore`` to 9 (its stderr names step 6
   and the saved position), stage 3 under ``torch.distributed.run
   --nproc_per_node 1`` (NCCL: update 1's loss equal, the gradient
   all-reduce and 24 BatchNorm reductions run), ``cli.train_vocoder`` (20
   updates at B=16 x 8192), ``cli.eval_pipeline --skip-asr
   --average-last-n 2`` over stage 3's last two checkpoints (shaped as the
   serving phase's decoder) with the vocoder CLI's checkpoint,
   ``cli.parity --skip-generate`` against ``cli.generate`` with the same
   arguments (tokens and mels equal), the pipeline's ASR stage
   (``"asr_bleu": null`` and its note without the model), and every batch
   of one epoch through the pinned copy against its numpy collate, bit
   for bit, timed against a plain ``.to(device)``; it prints the update
   ms, data wait, h2d, ``input_wait_frac``, save s and peak memory of
   each stage, each beside the card's name and power limit.

Traces go to ``build/profile/``. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the kernels'
JSON summary, and the nvidia-smi line comes before that. Any failed check
raises, a card-vs-CPU step's after the last phase (the phases after it
still run and report), and the script then exits non-zero and prints no
result, as it does without a CUDA device.
"""

from __future__ import annotations

import copy
import functools
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

TOL_KERNEL = 1e-4
TOL_ROUTES = 1e-6         # head-major against packed kernel, same shape
TOL_MEL = 1e-2
MARGIN = 1e-4
SEED = 0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cuda_ms(fn, reps=20, warm=3) -> float:
    """Median CUDA-event time of ``fn()`` in ms over ``reps`` calls, after
    ``warm`` warm-up calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
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

# H100 SXM peaks: the bound of a kernel takes its operations at the rate of
# their kind. Matrix products at fp32 accuracy run on the tensor cores as
# 3xTF32 (three TF32 products each, 495 TFLOP/s dense), so 165 TFLOP/s;
# the DP's and Viterbi's additions and maxima run on the fp32 pipes.
PEAK_FLOPS_FP32 = 67e12   # fp32 outside the tensor cores
PEAK_FLOPS_MMA = 495e12 / 3
PEAK_BYTES = 3.35e12      # HBM3
F32 = 4

# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "fused_attention_packed": ("daspeech_torch/csrc/fused_attention.cu",
                               "daspeech_tpu/ops/fused_attention.py:522"),
    "fused_extract_links": ("daspeech_torch/csrc/fused_links.cu",
                            "daspeech_tpu/ops/fused_links.py:141"),
    "fused_attention_relpos": ("daspeech_torch/csrc/fused_relpos.cu",
                               "daspeech_tpu/ops/fused_relpos.py:373"),
    "dag_loss_forward": ("daspeech_torch/csrc/dag_fb.cu",
                         "daspeech_tpu/ops/dag_pallas.py:108"),
    "dag_best_alignment": ("daspeech_torch/csrc/dag_viterbi.cu",
                           "daspeech_tpu/ops/dag_pallas.py:285"),
    "fused_attention_packed_bwd": ("daspeech_torch/csrc/fused_attention.cu",
                                   "daspeech_tpu/ops/fused_attention.py:324"),
    "fused_attention_relpos_bwd": ("daspeech_torch/csrc/fused_relpos.cu",
                                   "daspeech_tpu/ops/fused_relpos.py:125"),
    "fused_extract_links_bwd": ("daspeech_torch/csrc/fused_links.cu",
                                "daspeech_tpu/ops/fused_links.py:91"),
    "fused_attention": ("daspeech_torch/csrc/fused_attention.cu",
                        "daspeech_tpu/ops/fused_attention.py:189"),
    "fused_attention_bwd": ("daspeech_torch/csrc/fused_attention.cu",
                            "daspeech_tpu/ops/fused_attention.py:103"),
    "mrf_level": ("daspeech_torch/csrc/fused_mrf.cu",
                  "daspeech_tpu/ops/fused_mrf.py:156"),
    "fused_ffn": ("daspeech_torch/csrc/fused_ffn.cu",
                  "daspeech_tpu/ops/fused_ffn.py:175"),
    "fused_ffn_bwd": ("daspeech_torch/csrc/fused_ffn.cu",
                      "daspeech_tpu/ops/fused_ffn.py:84"),
    "fused_attention_full_bias": ("daspeech_torch/csrc/fused_attention.cu",
                                  "daspeech_tpu/ops/fused_attention.py:673"),
    "fused_attention_full_bias_bwd": (
        "daspeech_torch/csrc/fused_attention.cu",
        "daspeech_tpu/ops/fused_attention.py:600"),
}
# The DP is held against its plain loop run in float64 (dp_numerics). The
# plain loop (and the JAX scan) shifts each step by the previous row's
# maximum, so in fp32 a term more than ~87 nats below that shift
# underflows, and an entry whose mass comes through such terms comes out
# too small; the loss spreads to later steps, and the wider the links'
# spread, the closer to the row's maximum. On H100 readings over 24 cases
# (T = 64) both fp32 versions sat up to 9 nats off float64 at 40-80 nats
# below the row's maximum, and within 4.6 ulp of the largest magnitude
# closer to it; at J-long's T = 128 the fp32 loop is off by nats within 20
# of it, where the row's maximum sits on the graph's last vertex, which
# links nowhere. The kernel takes each log-sum-exp online, shifted by its
# own running maximum (csrc/dag_common.cuh), and loses no such term.
# So the kernel is held (a) within DP_NEGLIGIBLE nats of the row's maximum
# (e^-20 of the row's mass, under fp32's rounding of its sum) to 2 sqrt(T)
# ulp of the largest magnitude (each step rounds by ~1 ulp, a random walk
# over T steps; the limit is twice that), and (b) in every band of
# DP_BANDS to no more than the fp32 loop's error there plus that limit.
DP_NEGLIGIBLE = 20.0
DP_BANDS = (0, 20, 40, 60, 70, 80)
DP_SHAPES = ((80, 64, 240), (16, 64, 600), (4, 64, 1024), (14, 128, 700))
DP_SEEDS = (0, 1, 2, 3)
# the kernels each path must launch (the serving run's batch B takes the
# head-major attention in FastSpeech 2's decoder, at 1040 mel frames)
SERVING_KERNELS = ("fused_attention_packed", "fused_extract_links",
                   "fused_attention_relpos", "fused_attention")
TRAIN_KERNELS = ("fused_attention_packed", "fused_extract_links",
                 "fused_attention_relpos", "dag_loss_forward",
                 "dag_best_alignment", "fused_attention_packed_bwd",
                 "fused_attention_relpos_bwd", "fused_extract_links_bwd")
JOINT_KERNELS = TRAIN_KERNELS + ("fused_attention", "fused_attention_bwd")
# the verified alternate backends (#6, #3): only the alternates phase runs them
ALTERNATE_KERNELS = ("fused_ffn", "fused_ffn_bwd", "fused_attention_full_bias",
                     "fused_attention_full_bias_bwd")


def launch_counters():
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from daspeech_torch.ops import dag_kernels as dk
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_ffn as ff
    from daspeech_torch.ops import fused_links as fl
    from daspeech_torch.ops import fused_mrf as fm
    from daspeech_torch.ops import fused_relpos as fr

    return {"fused_attention_packed": fa.fused_attention_packed,
            "fused_extract_links": fl.fused_extract_links,
            "fused_attention_relpos": fr.fused_attention_relpos,
            "dag_loss_forward": dk.dag_loss_forward_kernel,
            "dag_best_alignment": dk.dag_best_alignment_kernel,
            "fused_attention_packed_bwd": fa.attention_bwd_kernel,
            "fused_attention_relpos_bwd": fr.relpos_bwd_kernel,
            "fused_extract_links_bwd": fl.links_bwd_kernel,
            "fused_attention": fa.fused_attention,
            "fused_attention_bwd": fa.attention_hm_bwd_kernel,
            "mrf_level": fm.mrf_level,
            "fused_ffn": ff.ffn_fwd_kernel,
            "fused_ffn_bwd": ff.ffn_bwd_kernel,
            "fused_attention_full_bias": fa.attention_fb_fwd_kernel,
            "fused_attention_full_bias_bwd": fa.attention_fb_bwd_kernel}


# the forward wrappers that count their training launches (the FMA
# training forward, which writes the softmax statistics) apart, in
# ``train_launches``; read as "<name> training"
TRAIN_FORWARDS = ("fused_attention_packed", "fused_attention",
                  "fused_attention_relpos")


def reset_launches():
    for w in launch_counters().values():
        w.launches = 0
        if hasattr(w, "train_launches"):
            w.train_launches = 0
        if hasattr(w, "cluster_launches"):
            w.cluster_launches.clear()


def read_launches():
    counters = launch_counters()
    launches = {n: w.launches for n, w in counters.items()}
    launches.update({f"{n} training": counters[n].train_launches
                     for n in TRAIN_FORWARDS})
    return launches


def training_forwards_per_update(launches, n_updates, tag):
    """Log the attention forwards' launches per update, training (the FMA
    forward) and inference apart."""
    log(f"  {tag}: attention forward launches per update, training / "
        "inference: " + ", ".join(
            f"{n} {launches[f'{n} training'] / n_updates:g} / "
            f"{(launches[n] - launches[f'{n} training']) / n_updates:g}"
            for n in TRAIN_FORWARDS))


def bound(flops, nbytes, rate=PEAK_FLOPS_MMA):
    """(bound_ms, bound_by): the least time for this work on the card, its
    operations at ``rate`` (matrix products by default)."""
    t_ops, t_bytes = flops / rate, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _randn(g, *shape, scale=1.0):
    return (torch.randn(*shape, generator=g) * scale).cuda()


def _key_bias(B, Tk, g, all_padded_row=False):
    """[B, Tk] padding bias: each row keeps a random prefix of >= Tk/2
    keys; with ``all_padded_row`` the last row keeps none."""
    from daspeech_torch.ops.fused_attention import NEG

    keep = torch.randint(Tk // 2, Tk + 1, (B,), generator=g)
    keep[0] = Tk
    if all_padded_row:
        keep[-1] = 0
    pad = torch.arange(Tk)[None, :] >= keep[:, None]
    return torch.where(pad, NEG, 0.0).float().cuda()


def _seeds(g, B):
    return torch.randint(-2 ** 31, 2 ** 31, (B,), generator=g,
                         dtype=torch.int32).cuda()


def _max_err(got, want):
    if isinstance(got, (tuple, list)):
        return max(_max_err(a, b) for a, b in zip(got, want))
    return (got - want).abs().max().item()


def _finite_err(got, want, what):
    """Max abs difference over the finite entries; the -inf pattern must
    be the same."""
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin) or not torch.equal(
            got[~fin], want[~fin]):
        raise AssertionError(f"{what}: -inf pattern differs")
    return (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0


def dp_diff(got, want, what, window=DP_NEGLIGIBLE):
    """|got - want| (float64) of two [B, T, L] (or [B]) log-probability
    tensors over the entries within ``window`` nats of their row's maximum
    in ``want`` (inf where ``got`` is -inf there: all its terms
    underflowed), 0 elsewhere, and each entry's distance below that
    maximum. ``got`` may have no mass where ``want`` has none."""
    got, want = got.double(), want.double()
    fin_w, fin_g = torch.isfinite(want), torch.isfinite(got)
    if bool((fin_g & ~fin_w).any()) or not torch.equal(
            got[~fin_g & ~fin_w], want[~fin_g & ~fin_w]):
        raise AssertionError(f"{what}: mass where the reference has none")
    if got.dim() == 1:
        rowmax = torch.where(fin_w, want, 0.0)
    else:
        rowmax = torch.where(fin_w, want, -math.inf).amax(dim=-1,
                                                          keepdim=True)
        rowmax = torch.where(torch.isfinite(rowmax), rowmax, 0.0)
    gap = torch.where(fin_w, rowmax - want, math.inf)
    keep = gap <= window
    d = torch.where(fin_g, (got - want).abs(), math.inf)
    return torch.where(keep, d, 0.0), torch.where(keep, gap, 0.0)


def dp_err(got, want, what):
    """Max of :func:`dp_diff` over the pairs (logprob, alpha, beta)."""
    return max(float(dp_diff(x, y, what)[0].max())
               for x, y in zip(got, want))


def ulp32(x: float) -> float:
    """The spacing of fp32 numbers at magnitude x (> 0)."""
    return 2.0 ** (math.floor(math.log2(x)) - 23)


def dp_tol(T: int, big: float) -> float:
    """2 sqrt(T) ulp of the largest magnitude (see DP_NEGLIGIBLE)."""
    return 2.0 * math.sqrt(T) * ulp32(max(big, 1.0))


def dp_numerics():
    """The alpha/beta kernel and the fp32 plain loop, each against the plain
    loop in float64 on the same inputs, over DP_SHAPES x DP_SEEDS: the
    largest error in each band of DP_BANDS (nats below the entry's row
    maximum). Returns the kernel's worst error over its bound (a) and (b)
    (see DP_NEGLIGIBLE)."""
    from daspeech_torch.ops import dag_kernels as dk
    from daspeech_torch.ops import dag_ref as dr

    def band_errs(got, want, what):
        out = [0.0] * (len(DP_BANDS) - 1)
        for x, y in zip(got, want):
            d, gap = dp_diff(x, y, what, window=DP_BANDS[-1])
            for k, (lo, hi) in enumerate(zip(DP_BANDS[:-1], DP_BANDS[1:])):
                sel = (gap >= lo) & (gap < hi)
                out[k] = max(out[k], float(torch.where(sel, d, 0.0).max()))
        return out

    bands = ", ".join(f"{lo}-{hi}" for lo, hi in zip(DP_BANDS[:-1],
                                                      DP_BANDS[1:]))
    log(f"  alpha/beta against float64, max abs error by nats below the row "
        f"max ({bands})")
    worst = 0.0
    for (B, T, L) in DP_SHAPES:
        for seed in DP_SEEDS:
            g = torch.Generator().manual_seed(seed)
            match, links, ol, tl = train_dp_inputs(g, B, T, L)
            exact = dr.dag_loss_forward_plain(match.double(), links.double(),
                                              ol, tl)
            kern = dk.dag_loss_forward_kernel(match, links, ol, tl)
            plain = dr.dag_loss_forward_plain(match, links, ol, tl)
            what = f"dag [{B},{T},{L}] seed {seed}"
            big = max(float(torch.where(torch.isfinite(y), y, 0.0).abs().max())
                      for y in exact)
            tol = dp_tol(T, big)
            e_k = dp_err(kern, exact, what)
            b_k, b_p = band_errs(kern, exact, what), band_errs(plain, exact,
                                                               what)
            fmt = lambda xs: " ".join(f"{x:.3g}" for x in xs)  # noqa: E731
            log(f"  {what}: |x| <= {big:.1f} (ulp {ulp32(big):.3g}); kernel "
                f"{fmt(b_k)}; fp32 plain {fmt(b_p)}; kernel within "
                f"{DP_NEGLIGIBLE:g} nats {e_k:.3g} (<= {tol:.3g})")
            worst = max(worst, e_k / tol,
                        *((k - p) / tol for k, p in zip(b_k, b_p)))
    return worst


# the DP's and Viterbi's rows of the kernel phase: [B, T, L] of S2TT (T), J,
# J-long and the recipe's L cap
DP_KERNEL_SHAPES = ((80, 64, 240), (40, 64, 240), (14, 128, 700),
                    (4, 64, 1024))


def dp_cluster_row(row, name, match, steps):
    """Add the launch's cluster plan, the clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``) and the µs a step (the kernel's
    time over the longest chain of steps) to a kernel-phase row, and log
    them."""
    from daspeech_torch.ops import dag_kernels as dk

    cs = dk.plan_for(name, match)
    threads, smem = dk.block_shape(match.shape[-1], cs)
    row.update(cluster_size=cs, threads=threads, smem_bytes=smem,
               max_active_clusters=dk.max_active_clusters(name, match),
               us_per_step=row["ms"] * 1e3 / max(steps, 1),
               was_us_per_step=(None if row["was_ms"] is None
                                else row["was_ms"] * 1e3 / max(steps, 1)))
    log(f"  {name} {row['shape']}: cluster of {cs} blocks x {threads} "
        f"threads, {smem} B shared memory, {row['max_active_clusters']} "
        f"clusters resident at most, {match.shape[0]} launched; "
        f"{row['us_per_step']:.2f} us a step over {steps} steps"
        + ("" if row["was_us_per_step"] is None
           else f" (parent tree {row['was_us_per_step']:.2f})"))


MRF_KERNELS, MRF_DILATIONS = (3, 7, 11), ((1, 3, 5),) * 3
# [B, C, T] of a config_v1 MRF level: serving A (8 x 416 mel frames) at
# levels 1-3, serving B (2 x 1040) at level 1, a chunk window (1 x 94)
MRF_SHAPES = ((8, 128, 26624), (8, 64, 53248), (8, 32, 106496),
              (2, 128, 66560), (1, 128, 6016))


def mrf_inputs(g, B, C, T):
    """x ~ N(0, 1) [B, C, T] and a level's stacked weights: each conv's taps
    N(0, 1 / (k C)) and biases N(0, 0.1), which keep the level's output of
    order 1."""
    n_dil = len(MRF_DILATIONS[0])
    W = torch.cat([torch.randn(k, C, C, generator=g) / math.sqrt(k * C)
                   for k in MRF_KERNELS for _ in range(2 * n_dil)])
    bias = torch.randn(2 * n_dil * len(MRF_KERNELS), C, generator=g) * 0.1
    return _randn(g, B, C, T), W.cuda(), bias.cuda()


def bit_identical(name, shape, got, again):
    """Two runs of a backward must give the same bits (no atomics)."""
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"  {name} {shape}: two runs bit-identical: {same}")
    if not same:
        raise AssertionError(f"{name} {shape}: two runs differ")


def profiled_kernels(fn, tag):
    """The device kernels (chrome-trace events) of one ``fn()`` under
    ``torch.profiler``, and its wall time in ms; the trace goes to
    ``build/profile/trace_<tag>.json``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = os.path.join(profile_dir(), f"trace_{tag.replace(' ', '_')}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    return events, wall


def relpos_sdpa_operands(q, k, v, a, e, bias, H):
    """The rel-pos attention's operands for one
    ``scaled_dot_product_attention`` call (#5's library yardstick): per
    head, the extended query [q_u | a] (depth 64 + 256) and key [k | e]
    (``e`` broadcast over batch rows and heads), v, and the column bias as
    an additive mask."""
    B, T, _ = q.shape

    def heads(x):
        return x.reshape(B, T, H, -1).transpose(1, 2)

    q_ext = torch.cat([heads(q), heads(a)], dim=-1)
    k_ext = torch.cat([heads(k), e.expand(B, H, T, e.shape[-1])], dim=-1)
    return q_ext, k_ext, heads(v), bias[:, None, None, :]


def relpos_sdpa(q_ext, k_ext, v, mask, sm_scale, p=0.0):
    """softmax(q_ext k_extᵀ·sm_scale + mask) v: [B, H, T, 64]."""
    return torch.nn.functional.scaled_dot_product_attention(
        q_ext, k_ext, v, attn_mask=mask, dropout_p=p, scale=sm_scale)


# the kernels of attention_tc.cuh: #1's and #2's inference forward and
# backward; #3's and #5's inference forward, and the dS and gradient
# kernels of their backward (the chunked-score kernels)
TC_KERNELS = ("attn_tc_fwd_kernel", "attn_tc_bwd_dq_kernel",
              "attn_tc_bwd_dkdv_kernel", "attn_tc_chunk_fwd_kernel",
              "attn_tc_chunk_ds_kernel", "attn_tc_grad_kernel")
# every attention training forward: attention_fma.cuh's register-tiled
# kernel on the fp32 FMA pipes (instance <1,0>: #1 and #2, <5,0>: #5,
# <1,1>: #3's full-bias mode), and the merge of its key split
FMA_FORWARD = "attn_fma_fwd_kernel"
FMA_KERNELS = (FMA_FORWARD, "attn_fma_combine_kernel")
FMA_INSTANCES = ("<1,0>", "<5,0>", "<1,1>")
# the link extraction's kernels (#4): forward on the FMA pipes, backward on
# the tensor cores
LINKS_FMA = ("links_lse_kernel", "links_fold_kernel")
LINKS_TC = ("links_bwd_dq_kernel", "links_bwd_dk_kernel")
# the kernels of gemm_tc.cuh's tiles (tensor cores): the MRF level's conv
# (#7) and the fused FFN's forward, backward rows and weight gradients (#6)
GEMM_TC = ("mrf_conv_kernel", "ffn_fwd_kernel", "ffn_bwd_rows_kernel",
           "ffn_wgrad_kernel")
# rows also timed with the parent tree's library when one is given
# (--parent): every row of a name, or " training": its training-forward
# rows
REDESIGNED = ("fused_attention_packed training", "fused_attention training",
              "fused_attention_relpos training",
              "fused_attention_full_bias training", "fused_extract_links",
              "fused_extract_links_bwd", "dag_loss_forward",
              "dag_best_alignment", "fused_ffn", "fused_ffn_bwd", "mrf_level")
PARENT = {}               # "lib": the parent tree's kernel library
# (tag, fn): calls whose device time the kernel phase splits by kernel at
# its end (kernel_split), after the profile of attention_launch_path
SPLITS = []


class parent_library:
    """Within the block the wrappers launch the parent tree's kernels: the
    same wrappers call the same C entry points in its library."""

    def __enter__(self):
        from daspeech_torch.ops import _build

        self.build, self.own = _build, _build.library
        _build.library = lambda: PARENT["lib"]

    def __exit__(self, *exc):
        self.build.library = self.own


def parent_ms(fn):
    """``cuda_ms(fn)`` with the parent tree's kernel library."""
    with parent_library():
        return cuda_ms(fn)


def parent_mrf_level(x, W, bias, kernel_sizes, dilations):
    """The parent tree's MRF level at its own tile choice (the same
    wrapper, the parent's entry point)."""
    from daspeech_torch.ops import fused_mrf as fm

    with parent_library():
        return fm.mrf_level_kernel(x, W, bias, kernel_sizes, dilations)


def attention_wrapper_calls(q, k, v, do, bias, seeds, H, p, heads):
    """A function that calls #1's and #2's inference forward, training
    forward and backward wrappers (1 + 1 + 2 kernels each)."""
    from daspeech_torch.ops import fused_attention as fa

    qh, kh, vh, dh = (heads(x) for x in (q, k, v, do))

    def run():
        fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds)
        out, st = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds,
                                          with_stats=True)
        fa.attention_bwd_kernel(q, k, v, bias, out, st, do, H, 1.0, p, seeds)
        fa.attention_hm_fwd_kernel(qh, kh, vh, bias, 1.0, p, seeds)
        out, st = fa.attention_hm_fwd_kernel(qh, kh, vh, bias, 1.0, p, seeds,
                                             with_stats=True)
        fa.attention_hm_bwd_kernel(qh, kh, vh, bias, out, st, dh, 1.0, p,
                                   seeds)

    return run


def attention_launch_path(run, n_kernels, n_fma, what):
    """The attention wrappers called by ``run()`` launch their own kernels
    and no library's (no SDPA, cuBLAS or cuDNN): a profile of one
    ``run()`` holds exactly ``n_kernels`` kernels, each one of
    attention_tc.cuh's or the FMA training forward, ``n_fma`` of them the
    FMA forward."""
    run()
    events, _ = profiled_kernels(run, f"attention_launch_path {what}")
    names = sorted({e["name"] for e in events})
    log(f"  {what} forward and backward, profiled: {len(events)} kernels: "
        f"{names}")
    if not events:
        log("  the profiler saw no kernels: launch path not checked")
        return
    foreign = [n for n in names if not any(
        t in n for t in (*TC_KERNELS, FMA_FORWARD))]
    fma = sum(FMA_FORWARD in e["name"] for e in events)
    if foreign or len(events) != n_kernels or fma != n_fma:
        raise AssertionError(f"{what} launch path ran {names} "
                             f"({len(events)} kernels, not {n_kernels}; "
                             f"{fma} FMA forwards, not {n_fma})")


def kernel_split(fn, tag, reps=3):
    """The device ms of each kernel of one ``fn()``: ``reps`` calls under
    the profiler after a warm one, the mean per call by kernel name (the
    card's own time, without the host's launch overhead that ``cuda_ms``
    includes)."""
    import re

    fn()
    events, _ = profiled_kernels(lambda: [fn() for _ in range(reps)],
                                 f"split {tag}")
    by = {}
    for e in events:
        m = re.search(r"(\w+_kernel)\b", e["name"])
        name = m.group(1) if m else e["name"][:60]
        by[name] = by.get(name, 0.0) + e["dur"] / 1e3 / reps
    log(f"  {tag}: device ms by kernel "
        + ", ".join(f"{n} {ms:.4f}" for n, ms in by.items())
        + f"; sum {sum(by.values()):.4f}" if by else
        f"  {tag}: the profiler saw no kernels")


def sass_counts(lib_path):
    """HMMA (tensor-core) and FFMA (fp32 FMA) instructions per kernel of
    attention_tc.cuh, of the FMA forward, of the link extraction and of
    #6's and #7's kernels (gemm_tc.cuh's tiles) in the built library's SASS
    (``cuobjdump -sass``), a template kernel's
    instances apart (``attn_tc_chunk_fwd_kernel<5,0>``: #5's, ``<1,1>``:
    #3's; ``attn_fma_fwd_kernel<1,0>``: #1's and #2's, ``<5,0>``: #5's,
    ``<1,1>``: #3's); None without cuobjdump."""
    import re
    import shutil

    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = next((c for c in (os.path.join(cuda_home, "bin", "cuobjdump"),
                             shutil.which("cuobjdump"))
                 if c and os.path.exists(c)), None)
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = next((t for t in (*TC_KERNELS, FMA_FORWARD, *LINKS_FMA,
                                     *LINKS_TC, *GEMM_TC)
                         if t in m.group(1)), None)
            inst = re.search(r"kernelI((?:L[a-z]\d+E)+)E", m.group(1))
            if name and inst:
                name += "<" + ",".join(re.findall(r"L[a-z](\d+)E",
                                                  inst.group(1))) + ">"
            if name:
                counts[name] = {"HMMA": 0, "FFMA": 0}
        elif name:
            for op in re.findall(r"\b(HMMA|FFMA)\b", line):
                counts[name][op] += 1
    return counts


def no_spills(ptxas, name, n_instances):
    """The instances of kernel ``name`` in nvcc's -Xptxas -v report: there
    must be ``n_instances``, each using no more than 255 registers and
    spilling nothing."""
    import re

    lines = ptxas.splitlines()
    found = 0
    for i, line in enumerate(lines):
        if "entry function" not in line or name not in line:
            continue
        found += 1
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", info)
        log(f"  {name} instance {found}: {regs.group(1)} registers, "
            f"spill stores/loads {spill.group(1)}/{spill.group(2)} bytes")
        if int(regs.group(1)) > 255 or spill.group(1) != "0" \
                or spill.group(2) != "0":
            raise AssertionError(f"{name} spills: {info}")
    if found != n_instances:
        raise AssertionError(f"{found} instances of {name} in the ptxas "
                             f"report, not {n_instances}")


# instances of each kernel checked for spills: the FMA forward's three,
# the MRF conv's six (32, 64 and 128 channels x 64 and 128 frames)
SPILL_CHECKED = {FMA_FORWARD: len(FMA_INSTANCES), "mrf_conv_kernel": 6,
                 "ffn_fwd_kernel": 1, "ffn_bwd_rows_kernel": 1,
                 "ffn_wgrad_kernel": 1}


def kernel_phase():
    from daspeech_torch.ops import dag_kernels as dk
    from daspeech_torch.ops import dag_ref as dr
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_links as fl
    from daspeech_torch.ops import fused_mrf as fm
    from daspeech_torch.ops import fused_relpos as fr

    g = torch.Generator().manual_seed(SEED)
    cases = {name: [] for name in KERNELS}

    def record(name, shape, err, run_kernel, run_plain, flops, nbytes,
               run_library=None, tol=TOL_KERNEL, rate=PEAK_FLOPS_MMA,
               run_parent=None, **extra):
        """One row: the kernel's, the plain version's and the library's
        ms, and with --parent the parent tree's (``run_parent``; None: the
        same call with the parent's library; False: none)."""
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        lib_ms = cuda_ms(run_library) if run_library is not None else None
        training = shape.endswith(" training")
        fma_row = f"{name} training" in REDESIGNED and training
        redesigned = fma_row or name in REDESIGNED
        was = None
        if PARENT and redesigned and run_parent is not False:
            was = (cuda_ms(run_parent) if run_parent is not None
                   else parent_ms(run_kernel))
        b_ms, b_by = bound(flops, nbytes, rate)
        if fma_row:
            # the FMA forward's own ceiling: its products at the fp32 FMA
            # pipes' rate
            extra["fma_bound_ms"] = bound(flops, nbytes, PEAK_FLOPS_FP32)[0]
        cases[name].append({"shape": shape, "max_abs_err": err, "tol": tol,
                            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": lib_ms,
                            "was_ms": was, **extra})
        tf = lambda t: f" ({flops / t / 1e9:.1f} TFLOP/s)"  # noqa: E731
        log(f"  {name} {shape}: max_abs_err {err:.3g} (<= {tol})  kernel "
            f"{ms:.4f} ms{tf(ms)}"
            + ("" if was is None else f"  parent tree {was:.4f} ms")
            + f"  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms "
            f"({b_by})"
            + ("" if not fma_row
               else f"  FMA-pipe bound {extra['fma_bound_ms']:.4f} ms")
            + "  library "
            + ("none" if lib_ms is None else f"{lib_ms:.4f} ms{tf(lib_ms)}"))
        if not err <= tol:
            raise AssertionError(f"{name} {shape}: max abs err {err} > {tol}")
        return cases[name][-1]

    def sdpa(q, k, v, bias, H, p):
        """The one PyTorch call for the same function (timed here only),
        with its own dropout draws at the same rate."""
        B, Tq, C = q.shape

        def h4(x):
            return x.reshape(B, x.shape[1], H, C // H).transpose(1, 2)

        return torch.nn.functional.scaled_dot_product_attention(
            h4(q), h4(k), h4(v), attn_mask=bias[:, None, None, :],
            dropout_p=p, scale=1.0)

    # --- attention: the serving shapes of batches A and B (forward), then
    # the training shapes (decoder self- and cross-attention at B = 80),
    # forward and backward with dropout 0.1, and the self-attention shape
    # again at p = 0 (what the Philox draws cost)
    for (B, Tq, Tk, C, H, p, train) in ((8, 240, 240, 512, 8, 0.0, False),
                                        (8, 240, 120, 512, 8, 0.0, False),
                                        (8, 416, 416, 256, 4, 0.0, False),
                                        (2, 600, 600, 512, 8, 0.0, False),
                                        (2, 600, 300, 512, 8, 0.0, False),
                                        (2, 1040, 1040, 256, 4, 0.0, False),
                                        (80, 240, 240, 512, 8, 0.1, True),
                                        (80, 240, 120, 512, 8, 0.1, True),
                                        (80, 240, 240, 512, 8, 0.0, True)):
        d = C // H
        q = _randn(g, B, Tq, C, scale=d ** -0.5)
        k, v = _randn(g, B, Tk, C), _randn(g, B, Tk, C)
        bias = _key_bias(B, Tk, g)
        seeds = _seeds(g, B) if p else None
        shape = f"q[{B},{Tq},{C}] kv_T={Tk} H={H} p={p}"
        # training asks for the statistics (the FMA forward), inference
        # does not (the tensor-core forward); at a training shape both run
        for stats_on in ((False, True) if train else (False,)):
            out, stats = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p,
                                                 seeds, with_stats=stats_on)
            record("fused_attention_packed",
                   shape + (" training" if stats_on else ""),
                   _max_err(out, fa.attention_plain(q, k, v, bias, H, 1.0, p,
                                                    seeds)),
                   lambda: fa.attention_fwd_kernel(
                       q, k, v, bias, H, 1.0, p, seeds, with_stats=stats_on),
                   lambda: fa.attention_plain(q, k, v, bias, H, 1.0, p,
                                              seeds),
                   4 * B * H * Tq * Tk * d,
                   (2 * B * Tq * C + 2 * B * Tk * C + B * Tk) * F32,
                   lambda: sdpa(q, k, v, bias, H, p))
        if not train:
            continue
        do = _randn(g, B, Tq, C)
        got = fa.attention_bwd_kernel(q, k, v, bias, out, stats, do, H, 1.0,
                                      p, seeds)
        want = fa.attention_bwd_plain(q, k, v, bias, do, H, 1.0, p, seeds)
        bit_identical("fused_attention_packed_bwd", shape, got,
                      fa.attention_bwd_kernel(q, k, v, bias, out, stats, do,
                                              H, 1.0, p, seeds))
        qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
        o_lib = sdpa(qr, kr, vr, bias, H, p)
        do4 = do.reshape(B, Tq, H, d).transpose(1, 2)
        # five products (s recomputed, dO·Vᵀ, dV, dQ, dK); q, k, v, bias
        # and dout read, dq, dk, dv written
        record("fused_attention_packed_bwd", shape, _max_err(got, want),
               lambda: fa.attention_bwd_kernel(q, k, v, bias, out, stats, do,
                                               H, 1.0, p, seeds),
               lambda: fa.attention_bwd_plain(q, k, v, bias, do, H, 1.0, p,
                                              seeds),
               10 * B * H * Tq * Tk * d,
               (3 * B * Tq * C + 4 * B * Tk * C + B * Tk) * F32,
               lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do4,
                                           retain_graph=True))

    # --- head-major attention (#2): the joint step's long utterances
    # (J-long: FastSpeech 2's decoder at 1040 frames, p = 0; the DAG
    # decoder's self-attention at 700 vertices, p = 0.1), serving batch B's
    # FastSpeech 2 decoder (forward), and a batch with a fully padded row
    def sdpa_hm(q, k, v, bias, p):
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias[:, None, None, :], dropout_p=p,
            scale=1.0)

    for (B, H, Tq, Tk, p, train, padded) in (
            (14, 4, 1040, 1040, 0.0, True, False),
            (14, 8, 700, 700, 0.1, True, False),
            (2, 4, 1040, 1040, 0.0, False, False),
            (4, 4, 1040, 1040, 0.1, True, True)):
        d = fa.HEAD_DIM
        q = _randn(g, B, H, Tq, d, scale=d ** -0.5)
        k, v = _randn(g, B, H, Tk, d), _randn(g, B, H, Tk, d)
        bias = _key_bias(B, Tk, g, all_padded_row=padded)
        seeds = _seeds(g, B) if p else None
        shape = (f"[{B},{H},{Tq},{d}] kv_T={Tk} p={p}"
                 + (" last row padded" if padded else ""))
        for stats_on in ((False, True) if train else (False,)):
            out, stats = fa.attention_hm_fwd_kernel(
                q, k, v, bias, 1.0, p, seeds, with_stats=stats_on)
            record("fused_attention",
                   shape + (" training" if stats_on else ""),
                   _max_err(out, fa.attention_hm_plain(q, k, v, bias, 1.0, p,
                                                       seeds)),
                   lambda: fa.attention_hm_fwd_kernel(
                       q, k, v, bias, 1.0, p, seeds, with_stats=stats_on),
                   lambda: fa.attention_hm_plain(q, k, v, bias, 1.0, p,
                                                 seeds),
                   4 * B * H * Tq * Tk * d,
                   (2 * B * H * Tq * d + 2 * B * H * Tk * d + B * Tk) * F32,
                   lambda: sdpa_hm(q, k, v, bias, p))
        if not train:
            continue
        do = _randn(g, B, H, Tq, d)
        got = fa.attention_hm_bwd_kernel(q, k, v, bias, out, stats, do, 1.0,
                                         p, seeds)
        want = fa.attention_hm_bwd_plain(q, k, v, bias, do, 1.0, p, seeds)
        bit_identical("fused_attention_bwd", shape, got,
                      fa.attention_hm_bwd_kernel(q, k, v, bias, out, stats,
                                                 do, 1.0, p, seeds))
        qr, kr, vr = (x.detach().requires_grad_(True) for x in (q, k, v))
        o_lib = sdpa_hm(qr, kr, vr, bias, p)
        record("fused_attention_bwd", shape, _max_err(got, want),
               lambda: fa.attention_hm_bwd_kernel(q, k, v, bias, out, stats,
                                                  do, 1.0, p, seeds),
               lambda: fa.attention_hm_bwd_plain(q, k, v, bias, do, 1.0, p,
                                                 seeds),
               10 * B * H * Tq * Tk * d,
               (3 * B * H * Tq * d + 4 * B * H * Tk * d + B * Tk) * F32,
               lambda: torch.autograd.grad(o_lib, (qr, kr, vr), do,
                                           retain_graph=True))
    # at a shape both routes take, #2 drops what #1 drops and agrees with it
    B, H, T, p = 8, 4, 416, 0.1
    q = _randn(g, B, T, H * 64, scale=0.125)
    k, v, do = (_randn(g, B, T, H * 64) for _ in range(3))
    bias = _key_bias(B, T, g, all_padded_row=True)
    seeds = _seeds(g, B)
    heads = lambda x: x.reshape(B, T, H, 64).transpose(1, 2).contiguous()  # noqa: E731,E501
    out, st = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds,
                                      with_stats=True)
    out_h, st_h = fa.attention_hm_fwd_kernel(heads(q), heads(k), heads(v),
                                             bias, 1.0, p, seeds,
                                             with_stats=True)
    err = max(_max_err(heads(out), out_h), _max_err(
        [heads(x) for x in fa.attention_bwd_kernel(q, k, v, bias, out, st,
                                                   do, H, 1.0, p, seeds)],
        fa.attention_hm_bwd_kernel(heads(q), heads(k), heads(v), bias,
                                   out_h, st_h, heads(do), 1.0, p, seeds)))
    log(f"  fused_attention vs fused_attention_packed [{B},{H},{T},64] "
        f"p={p}: max abs diff {err:.3g} (<= {TOL_ROUTES}), forward and "
        "backward")
    if not err <= TOL_ROUTES:
        raise AssertionError(f"head-major and packed kernels differ by {err}")
    run_1_2 = attention_wrapper_calls(q, k, v, do, bias, seeds, H, p, heads)

    # --- link extraction: serving batches A and B (forward), then the
    # training shapes of cell T and J-long, forward and backward; the work
    # is the valid transitions (j > i, j < out_len) of these graphs
    for (B, L, C, H, train) in ((8, 240, 512, 8, False),
                                (8, 600, 512, 8, False),
                                (80, 240, 512, 8, True),
                                (14, 700, 512, 8, True)):
        dkh = C // H
        q, k = _randn(g, B, L, C, scale=0.5), _randn(g, B, L, C)
        gates = torch.log_softmax(_randn(g, B, L, H), dim=-1)
        ol = torch.randint(L // 2, L + 1, (B,), generator=g)
        ol[0] = L
        n_valid = int(sum(int(n) * (int(n) - 1) // 2 for n in ol))
        ol = ol.cuda()
        sc = 1.0 / math.sqrt(dkh)
        shape = f"[{B},{L}] C={C} H={H}"
        links, lse = fl.links_fwd_kernel(q, k, gates, ol, H, sc, None,
                                         with_lse=train)
        want = fl.links_plain(q, k, gates, ol, H, sc, None)
        record("fused_extract_links", shape,
               _finite_err(links, want, f"links {shape}"),
               lambda: fl.links_fwd_kernel(q, k, gates, ol, H, sc, None),
               lambda: fl.links_plain(q, k, gates, ol, H, sc, None),
               2 * n_valid * H * dkh,
               (2 * B * L * C + B * L * H + B * L * L) * F32)
        if not train:
            continue
        dlinks = _randn(g, B, L, L)
        SPLITS.extend([
            (f"fused_extract_links {shape}", functools.partial(
                fl.links_fwd_kernel, q, k, gates, ol, H, sc, None)),
            (f"fused_extract_links_bwd {shape}", functools.partial(
                fl.links_bwd_kernel, q, k, gates, ol, links, lse, dlinks, H,
                sc, None))])
        got = fl.links_bwd_kernel(q, k, gates, ol, links, lse, dlinks, H, sc,
                                  None)
        want = fl.links_bwd_plain(q, k, gates, ol, dlinks, H, sc, None)
        # three products over the valid transitions (s, dq, dk); q, k,
        # gates and dlinks read, dq, dk, dgates written
        record("fused_extract_links_bwd", shape, _max_err(got, want),
               lambda: fl.links_bwd_kernel(q, k, gates, ol, links, lse,
                                           dlinks, H, sc, None),
               lambda: fl.links_bwd_plain(q, k, gates, ol, dlinks, H, sc,
                                          None),
               6 * n_valid * H * dkh,
               (4 * B * L * C + 2 * B * L * H + B * L * L) * F32)

    # --- rel-pos attention (#5): serving batches A and B (forward), then
    # the training shape, the T' >= 256 regime and J-long's encoder (14
    # utterances of 14 s), forward and backward with dropout 0.1; the
    # inference forward on the tensor cores, the training forward
    # (statistics) on the FMA kernel. The library yardstick is SDPA
    # on the extended operands [q_u | a], [k | e] (relpos_sdpa), built
    # outside the timed call
    for (B, T, C, H, p) in ((8, 120, 256, 4, 0.0), (8, 300, 256, 4, 0.0),
                            (80, 120, 256, 4, 0.1), (8, 300, 256, 4, 0.1),
                            (14, 350, 256, 4, 0.1)):
        P = fr.POS_DIM
        d = C // H
        q, k, v = (_randn(g, B, T, C, scale=0.5) for _ in range(3))
        a = _randn(g, B, T, H * P, scale=0.1)
        e = fr.relpos_basis(T, P, device="cuda")[2].contiguous()
        bias = _key_bias(B, T, g)
        seeds = _seeds(g, B) if p else None
        sc = 1.0 / math.sqrt(d)
        shape = f"[{B},{T},{C}] H={H} p={p}"
        ops = relpos_sdpa_operands(q, k, v, a, e, bias, H)
        prep_ms = cuda_ms(lambda: relpos_sdpa_operands(q, k, v, a, e, bias,
                                                       H))
        log(f"  fused_attention_relpos {shape}: SDPA's operands [q_u | a], "
            f"[k | e] concatenated in {prep_ms:.4f} ms (outside its time)")
        want = fr.relpos_plain(q, k, v, a, e, bias, H, sc, p, seeds)
        for stats_on in ((False, True) if p else (False,)):
            out, stats = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, sc, p,
                                              seeds, with_stats=stats_on)
            record("fused_attention_relpos",
                   shape + (" training" if stats_on else ""),
                   _max_err(out, want),
                   lambda: fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, sc,
                                                p, seeds,
                                                with_stats=stats_on),
                   lambda: fr.relpos_plain(q, k, v, a, e, bias, H, sc, p,
                                           seeds),
                   2 * B * H * T * T * (2 * d + P),
                   (4 * B * T * C + B * T * H * P + T * P + B * T) * F32,
                   lambda: relpos_sdpa(*ops, sc, p),
                   library_prep_ms=prep_ms)
        if not p:
            continue
        do = _randn(g, B, T, C)
        got = fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, stats, do, H,
                                   sc, p, seeds)
        want = fr.relpos_bwd_plain(q, k, v, a, e, bias, do, H, sc, p, seeds)
        bit_identical("fused_attention_relpos_bwd", shape, got,
                      fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, stats,
                                           do, H, sc, p, seeds))
        leaves = [x.detach().requires_grad_(True) for x in ops[:3]]
        o_lib = relpos_sdpa(*leaves, ops[3], sc, p)
        do4 = do.reshape(B, T, H, d).transpose(1, 2)
        # products: s (depth d + P), dO·Vᵀ, dV, dQ, dK (depth d), dA (P)
        record("fused_attention_relpos_bwd", shape, _max_err(got, want),
               lambda: fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, stats,
                                            do, H, sc, p, seeds),
               lambda: fr.relpos_bwd_plain(q, k, v, a, e, bias, do, H, sc, p,
                                           seeds),
               2 * B * H * T * T * (5 * d + 2 * P),
               (7 * B * T * C + 2 * B * T * H * P + T * P + B * T) * F32,
               lambda: torch.autograd.grad(o_lib, leaves, do4,
                                           retain_graph=True),
               library_prep_ms=prep_ms)
        del ops, leaves, o_lib

    # --- the DAG DP and Viterbi at the shapes of S2TT (T), J, J-long and
    # the recipe's L cap, each on its cluster plan; the work is the finite
    # transitions, for the steps each sweep computes (alpha all T - 1, beta
    # and Viterbi up to target_len - 1)
    for (B, T, L) in DP_KERNEL_SHAPES:
        match, links, ol, tl = train_dp_inputs(g, B, T, L)
        n_links = torch.isfinite(links).sum(dim=(1, 2)).cpu()
        steps = (tl.cpu() - 1).clamp(min=0)
        shape = f"[{B},{T},{L}]"
        # held against the plain loop run in float64 on the same inputs, so
        # that the error is the kernel's own rounding (dp_numerics)
        got = dk.dag_loss_forward_kernel(match, links, ol, tl)
        want = dr.dag_loss_forward_plain(match.double(), links.double(), ol,
                                         tl)
        err = dp_err(got, want, f"dag {shape}")
        big = max(float(torch.where(torch.isfinite(y), y, 0.0).abs().max())
                  for y in want)
        row = record("dag_loss_forward", shape, err,
                     lambda: dk.dag_loss_forward_kernel(match, links, ol, tl),
                     lambda: dr.dag_loss_forward_plain(match, links, ol, tl),
                     2 * int((n_links * (T - 1 + steps)).sum()),
                     (3 * B * T * L + B * L * L + 2 * B) * F32,
                     tol=dp_tol(T, big), rate=PEAK_FLOPS_FP32)
        dp_cluster_row(row, "dag_loss_forward", match, T - 1)
        got = dk.dag_best_alignment_kernel(match, links, ol, tl)
        want = dr.dag_best_alignment_plain(match, links, ol, tl)
        n_diff = int((got != want).sum())
        log(f"  dag_best_alignment {shape}: {n_diff} path entries differ")
        row = record("dag_best_alignment", shape, float(n_diff),
                     lambda: dk.dag_best_alignment_kernel(match, links, ol,
                                                          tl),
                     lambda: dr.dag_best_alignment_plain(match, links, ol, tl),
                     2 * int((n_links * steps).sum()),
                     (B * T * L + B * L * L + B * L + 2 * B) * F32, tol=0.0,
                     rate=PEAK_FLOPS_FP32)
        dp_cluster_row(row, "dag_best_alignment", match, int(steps.max()))
        del match, links, got, want
    # --- the HiFi-GAN MRF level (#7, three ResBlock1 of kernels 3/7/11,
    # dilations 1/3/5): serving A's levels 1-3, batch B's level 1, and one
    # chunk window of 64 + 2 * 15 mel frames at level 1, each with the tile
    # the wrapper picks (its row also with the plain F.conv1d chain as the
    # library time, cuDNN's, and the parent's kernel), then with the
    # others; the work is the 126 taps of C x C products at every frame
    dev = torch.device("cuda")
    for B, C, T in MRF_SHAPES:
        x, W, bias = mrf_inputs(g, B, C, T)
        args = (x, W, bias, MRF_KERNELS, MRF_DILATIONS)
        picked = fm.pick_tile(B, T, dev)
        want = fm.mrf_level_ref(*args)
        log(f"  mrf_level [{B},{C},{T}]: output std {want.std().item():.3f}")
        for tile in (picked, *(t for t in fm.TILES if t != picked)):
            got = fm.mrf_level_kernel(*args, tile)
            shape = (f"[{B},{C},{T}] tile {tile}"
                     + (" (picked)" if tile == picked else ""))
            if B == 1:
                # each version's own rounding, against float64
                exact = fm.mrf_level_ref(*(t.double() for t in args[:3]),
                                         MRF_KERNELS, MRF_DILATIONS)
                log(f"  mrf_level {shape} against float64: kernel "
                    f"{_max_err(got.double(), exact):.3g}, plain "
                    f"{_max_err(want.double(), exact):.3g}")
            record("mrf_level", shape, _max_err(got, want),
                   lambda: fm.mrf_level_kernel(*args, tile),
                   lambda: fm.mrf_level_ref(*args),
                   2 * B * T * C * C * W.shape[0],
                   (2 * B * C * T + W.numel() + bias.numel()) * F32,
                   (lambda: fm.mrf_level_ref(*args)) if tile == picked
                   else None,
                   run_parent=((lambda: parent_mrf_level(*args))
                               if tile == picked else False))
            del got
        del x, args, want
    alternate_kernel_cases(g, record)
    run_5_3 = chunked_wrapper_calls(g)
    # twelve wrapper calls: the inference forward, the training forward
    # and the backward of #1, #2, #5 and #3, 1 + 1 + 2 kernels each. One
    # profile of all of them: the first profiler session of the run (a
    # later session lost the first kernels it should have seen)
    attention_launch_path(lambda: (run_1_2(), run_5_3()), 16, 4,
                          "#1, #2, #5 and #3")
    for tag, fn in SPLITS:
        kernel_split(fn, tag)
    SPLITS.clear()
    worst = dp_numerics()
    if not worst <= 1.0:
        raise AssertionError(f"alpha/beta kernel off float64 by {worst:.3g}"
                             " times its bound")
    torch.cuda.synchronize()
    return cases


# [B, T', dropout] of the fused FFN: the S2TT cell T's encoder, serving A's
# and serving B's (T' = 300: JAX's gate sends this to XLA, the port's row
# tiles take it)
FFN_SHAPES = ((80, 120, 0.1), (8, 120, 0.0), (2, 300, 0.0))
FFN_DIM = 2048
# [B, H, T, p] of the full-bias attention: the Conformer rel-pos shape it
# once served (a pad mask on the last keys and one fully masked row), a
# long utterance, and the joint step's long DAG decoder (bias4 219 MB)
FB_SHAPES = ((80, 4, 120, 0.1), (2, 4, 300, 0.0), (14, 8, 700, 0.1))


def ffn_params(g, C, Fd):
    """LayerNorm scale 1 + N(0, 0.1) and shift N(0, 0.1), w_1.weight
    [F, C] and w_2.weight [C, F] N(0, 1 / fan_in), biases N(0, 0.1)."""
    return (1.0 + _randn(g, C, scale=0.1), _randn(g, C, scale=0.1),
            _randn(g, Fd, C, scale=C ** -0.5), _randn(g, Fd, scale=0.1),
            _randn(g, C, Fd, scale=Fd ** -0.5), _randn(g, C, scale=0.1))


def ffn_unfused(x, gamma, beta, w1, b1, w2, b2, p):
    """The unfused module's computation (``FeedForwardModule(fused=False)``:
    LayerNorm, ``F.linear``, SiLU, dropout, ``F.linear``, dropout with
    PyTorch's own draws at rate p): #6's library time, forward and autograd
    backward, timed here only."""
    F_ = torch.nn.functional
    h = F_.silu(F_.linear(F_.layer_norm(x, x.shape[-1:], gamma, beta, 1e-6),
                          w1, b1))
    return F_.dropout(F_.linear(F_.dropout(h, p), w2, b2), p)


def full_bias4(g, B, H, Tq, Tk, masked_row):
    """Random scores N(0, 1) plus a [B, Tk] pad mask of -1e30 on each row's
    last keys; with ``masked_row`` one query row of the last batch row is
    masked everywhere."""
    bias = _randn(g, B, H, Tq, Tk) + _key_bias(B, Tk, g)[:, None, None, :]
    if masked_row:
        bias[-1, 0, Tq // 2] = -1e30
    return bias.contiguous()


def alternate_kernel_cases(g, record):
    """The fused FFN (#6) and the full-bias attention (#3) against their
    plain versions, forward and backward with dropout on; the FFN's weight
    gradients over two runs, its drop fractions; #3 against #2 on a column
    bias."""
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_ffn as ff
    from daspeech_torch.ops import philox

    C, Fd = ff.WIDTH, FFN_DIM
    for (B, T, p) in FFN_SHAPES:
        N = B * T
        x = _randn(g, B, T, C)
        params = ffn_params(g, C, Fd)
        seeds = _seeds(g, B) if p else None
        args = (x, *params, seeds, p, p)
        shape = f"x[{B},{T},{C}] F={Fd} p={p}"
        out = ff.ffn_fwd_kernel(*args)
        record("fused_ffn", shape, _max_err(out, ff.ffn_plain(*args)),
               lambda: ff.ffn_fwd_kernel(*args), lambda: ff.ffn_plain(*args),
               4 * N * C * Fd, (2 * N * C + 2 * C * Fd + Fd + 3 * C) * F32,
               lambda: ffn_unfused(x, *params, p))
        # a mean loss's cotangent: the weight gradients, sums over the N
        # rows, stay of order 1
        do = _randn(g, B, T, C, scale=N ** -0.5)
        bargs = (x, *params, do, seeds, p, p)
        got = ff.ffn_bwd_kernel(*bargs)
        lib = [t.detach().requires_grad_(True) for t in (x, *params)]
        o_lib = ffn_unfused(*lib, p)
        if p:
            # the device time of each kernel of the forward and backward
            SPLITS.extend([
                (f"fused_ffn {shape}", functools.partial(ff.ffn_fwd_kernel,
                                                         *args)),
                (f"fused_ffn_bwd {shape}",
                 functools.partial(ff.ffn_bwd_kernel, *bargs))])
        record("fused_ffn_bwd", shape,
               _max_err(got, ff.ffn_bwd_plain(*bargs)),
               lambda: ff.ffn_bwd_kernel(*bargs),
               lambda: ff.ffn_bwd_plain(*bargs),
               10 * N * C * Fd,
               (3 * N * C + 4 * C * Fd + 2 * Fd + 6 * C) * F32,
               lambda: torch.autograd.grad(o_lib, lib, do,
                                           retain_graph=True))
        del lib, o_lib
        if not p:
            continue
        again = ff.ffn_bwd_kernel(*bargs)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        # forward and backward masks: the kernel's backward against
        # autograd through the plain forward, which draws the forward's masks
        ins = [t.detach().requires_grad_(True) for t in (x, *params)]
        auto = torch.autograd.grad(ff.ffn_plain(*ins, seeds, p, p), ins, do)
        e_auto = _max_err(got, auto)
        frac1 = float((philox.ffn_keep(seeds, T, Fd, 1, p) == 0).float()
                      .mean())
        frac2 = float((out == 0).float().mean())
        log(f"  fused_ffn {shape}: two backward runs bit-identical: {same}; "
            f"kernel backward vs autograd of the plain forward {e_auto:.3g}"
            f" (<= {TOL_KERNEL}); drop fraction site 1 {frac1:.5f}, site 2 "
            f"(zeros of the kernel's output) {frac2:.5f} (p = {p}, within "
            f"1% of p)")
        if not (same and e_auto <= TOL_KERNEL
                and abs(frac1 - p) <= 0.01 * p and abs(frac2 - p) <= 0.01 * p):
            raise AssertionError(f"fused_ffn {shape}: determinism, masks or "
                                 "drop fraction wrong")
        del got, again, auto, ins

    def sdpa(q, k, v, bias4, sc, p):
        """The one PyTorch call for the same function (timed here only),
        with its own dropout draws at the same rate."""
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias4, dropout_p=p, scale=sc)

    d = fa.HEAD_DIM
    sc = d ** -0.5
    for (B, H, T, p) in FB_SHAPES:
        q, k, v = (_randn(g, B, H, T, d) for _ in range(3))
        bias4 = full_bias4(g, B, H, T, T, masked_row=True)
        seed = _seeds(g, 1) if p else None
        shape = (f"[{B},{H},{T},{d}] bias4 [{B},{H},{T},{T}] p={p}, "
                 "one row masked")
        # the inference forward on the tensor cores, the training forward
        # (statistics) on the FMA kernel's full-bias mode
        want = fa.attention_full_bias_plain(q, k, v, bias4, sc, p, seed)
        if (B, H, T) == (80, 4, 120):
            SPLITS.extend([
                (f"fused_attention_full_bias {shape} training",
                 functools.partial(fa.attention_fb_fwd_kernel, q, k, v, bias4,
                                   sc, p, seed, with_stats=True)),
                (f"SDPA {shape}", functools.partial(sdpa, q, k, v, bias4, sc,
                                                    p))])
        for stats_on in (False, True):
            out, st = fa.attention_fb_fwd_kernel(q, k, v, bias4, sc, p, seed,
                                                 with_stats=stats_on)
            record("fused_attention_full_bias",
                   shape + (" training" if stats_on else ""),
                   _max_err(out, want),
                   lambda: fa.attention_fb_fwd_kernel(q, k, v, bias4, sc, p,
                                                      seed,
                                                      with_stats=stats_on),
                   lambda: fa.attention_full_bias_plain(q, k, v, bias4, sc, p,
                                                        seed),
                   4 * B * H * T * T * d,
                   (4 * B * H * T * d + B * H * T * T) * F32,
                   lambda: sdpa(q, k, v, bias4, sc, p))
        do = _randn(g, B, H, T, d)
        got = fa.attention_fb_bwd_kernel(q, k, v, bias4, out, st, do, sc, p,
                                         seed)
        want = fa.attention_full_bias_bwd_plain(q, k, v, bias4, do, sc, p,
                                                seed)
        bit_identical("fused_attention_full_bias_bwd", shape, got,
                      fa.attention_fb_bwd_kernel(q, k, v, bias4, out, st, do,
                                                 sc, p, seed))
        lib = [t.detach().requires_grad_(True) for t in (q, k, v, bias4)]
        o_lib = sdpa(*lib, sc, p)
        # five products; q, k, v, dout, bias4 read, dq, dk, dv, dS written
        record("fused_attention_full_bias_bwd", shape, _max_err(got, want),
               lambda: fa.attention_fb_bwd_kernel(q, k, v, bias4, out, st, do,
                                                  sc, p, seed),
               lambda: fa.attention_full_bias_bwd_plain(q, k, v, bias4, do,
                                                        sc, p, seed),
               10 * B * H * T * T * d,
               (7 * B * H * T * d + 2 * B * H * T * T) * F32,
               lambda: torch.autograd.grad(o_lib, lib, do, retain_graph=True))
        del q, k, v, bias4, out, st, got, want, lib, o_lib

    # #3 on #2's column bias broadcast over heads and queries, p = 0: the
    # same function, so the same results to the kernels' rounding. Both
    # backward passes run 3xTF32 on the tensor cores, but #3 takes dk and dv
    # from the stored dS and P∘Z where #2 recomputes Sᵀ: they do not sum in
    # the same order, and each is held to TOL_KERNEL, as against its plain
    # version
    B, H, T = 80, 4, 120
    q = _randn(g, B, H, T, d, scale=sc)
    k, v, do = (_randn(g, B, H, T, d) for _ in range(3))
    bias = _key_bias(B, T, g, all_padded_row=True)
    bias4 = bias[:, None, None, :].expand(B, H, T, T).contiguous()
    out, st = fa.attention_fb_fwd_kernel(q, k, v, bias4, 1.0,
                                         with_stats=True)
    out_h, st_h = fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0,
                                             with_stats=True)
    err = max(_max_err(out, out_h), _max_err(
        fa.attention_fb_bwd_kernel(q, k, v, bias4, out, st, do, 1.0)[:3],
        fa.attention_hm_bwd_kernel(q, k, v, bias, out_h, st_h, do, 1.0)))
    log(f"  fused_attention_full_bias vs fused_attention on a column bias "
        f"[{B},{H},{T},{d}] p=0: max abs diff {err:.3g} (<= {TOL_KERNEL}), "
        "forward and backward")
    if not err <= TOL_KERNEL:
        raise AssertionError(f"full-bias and head-major kernels differ by "
                             f"{err}")


def chunked_wrapper_calls(g):
    """A function that calls #5's and #3's inference forward, training
    forward and backward wrappers (1 + 1 + 2 kernels each)."""
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_relpos as fr

    B, T, H, p = 8, 120, 4, 0.1
    q, k, v, do = (_randn(g, B, T, H * 64, scale=0.5) for _ in range(4))
    a = _randn(g, B, T, H * fr.POS_DIM, scale=0.1)
    e = fr.relpos_basis(T, fr.POS_DIM, device="cuda")[2].contiguous()
    bias = _key_bias(B, T, g, all_padded_row=True)
    seeds = _seeds(g, B)
    qh, kh, vh, dh = (x.reshape(B, T, H, 64).transpose(1, 2).contiguous()
                      for x in (q, k, v, do))
    bias4 = full_bias4(g, B, H, T, T, masked_row=True)

    def run():
        fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, 0.125, p, seeds)
        out, st = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, 0.125, p,
                                       seeds, with_stats=True)
        fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, st, do, H, 0.125, p,
                             seeds)
        fa.attention_fb_fwd_kernel(qh, kh, vh, bias4, 0.125, p, seeds[:1])
        out, st = fa.attention_fb_fwd_kernel(qh, kh, vh, bias4, 0.125, p,
                                             seeds[:1], with_stats=True)
        fa.attention_fb_bwd_kernel(qh, kh, vh, bias4, out, st, dh, 0.125, p,
                                   seeds[:1])

    return run


def train_dp_inputs(g, B, T, L):
    """match [B, T, L] and log-softmax links [B, L, L] over the valid
    transitions of graphs of >= L/2 vertices, targets of >= T/2 tokens."""
    ol = torch.randint(L // 2, L + 1, (B,), generator=g)
    tl = torch.randint(T // 2, T + 1, (B,), generator=g)
    ol[0], tl[0] = L, T
    i = torch.arange(L)
    valid = ((i[None, None, :] > i[None, :, None])
             & (i[None, None, :] < ol[:, None, None])
             & (i[None, :, None] < ol[:, None, None]))
    x = torch.where(valid, torch.randn(B, L, L, generator=g), -math.inf)
    links = torch.where(valid, torch.log_softmax(x, dim=-1), -math.inf)
    match = torch.randn(B, T, L, generator=g) - 2.0
    match = torch.where(i[None, None, :] < ol[:, None, None], match,
                        -math.inf)
    return (match.cuda().contiguous(), links.cuda().contiguous(), ol.cuda(),
            tl.cuda())


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
    frames. ``model`` is the two-pass model or a FastSpeech 2."""
    fs2 = getattr(model, "tts", model)
    proj = fs2.var_adaptor.duration_predictor.proj
    with torch.no_grad():
        proj.weight.zero_()
        proj.bias.fill_(math.log(1.0 + frames))
    return model


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

    # --- the serving path's run: counters from 0, both batches served once
    reset_launches()
    set_durations_(model, d_a)
    hyp_a = gen_a.generate(batch_a)
    set_durations_(model, d_b)
    hyp_b = gen_b.generate(batch_b)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"  launches in the served run: {launches}")
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the serving "
                                 "path")

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
        device_busy(lambda: gen.generate(batch), f"generate batch{tag}")

    # the mels the vocoder was served, for the vocoder-mode phase
    mels = {}
    with torch.inference_mode():
        for tag, gen, batch, d in (("A", gen_a, batch_a, d_a),
                                   ("B", gen_b, batch_b, d_b)):
            set_durations_(model, d)
            _, z, zmask = gen.decode(*gen.to_device(batch))
            mels[tag] = gen.synthesize(z, zmask)[0]
    # the model, vocoder and batches, for the decode-strategy phase
    ctx = {"cfg": cfg, "model": model, "model_cpu": model_cpu, "voc": voc,
           "voc_cpu": voc_cpu, "batches": {"A": (batch_a, 416),
                                           "B": (batch_b, 1040)}}
    return launches, mels, ctx


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


def profile_dir():
    """``build/profile/`` at the root of the checkout (made if missing)."""
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "profile")
    os.makedirs(out_dir, exist_ok=True)
    return out_dir


def device_busy(fn, tag):
    """``fn()`` once under ``torch.profiler``: the device's busy time
    (union of kernel intervals) against the wall time, and the kernels that
    took the most device time. The trace goes to ``build/profile/``.
    Returns the names of the kernels it ran (None if the profiler saw
    none)."""
    events, wall = profiled_kernels(fn, tag)
    if not events:
        log(f"  {tag} profiled: wall {wall:.2f} ms; the profiler saw no "
            "kernels, device busy not measured")
        return None
    busy, end = 0.0, -1.0
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    busy /= 1e3
    log(f"  {tag} profiled: wall {wall:.2f} ms, {len(events)} kernels, "
        f"device busy {busy:.2f} ms ({busy / wall:.3f} of wall)")
    by_name = {}
    for e in events:
        n = by_name.setdefault(e["name"][:100], [0, 0.0])
        n[0] += 1
        n[1] += e["dur"] / 1e3
    for name, (count, ms) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:12]:
        log(f"    {ms:9.3f} ms {count:6d}x  {name}")
    # the FMA training forward; the link extraction's kernels (this tree's
    # or the parent's, all named links_*)
    for name in (FMA_FORWARD, "links_"):
        hits = [(c, ms) for n, (c, ms) in by_name.items() if name in n]
        log(f"    {name}: {sum(c for c, _ in hits)} launches, "
            f"{sum(ms for _, ms in hits):.3f} ms")
    return {e["name"] for e in events}


def device_busy_in_turns(fn, tag):
    """:func:`device_busy` of ``fn()``; with a parent tree (--parent) also
    with its kernels, in turns (this tree, parent, this tree). Returns the
    kernel names of this tree's first profile."""
    names = device_busy(fn, tag)
    if PARENT:
        with parent_library():
            device_busy(fn, f"{tag}, parent tree's kernels")
        device_busy(fn, f"{tag}, again")
    return names


def fma_forward_only(names, tag):
    """A training path's profiled update ran the FMA training forward, and
    every attention kernel it ran is the FMA forward's or attention_tc.cuh's:
    no other (SIMT) attention forward."""
    if names is None:
        log(f"  {tag}: no profile, training forward kernels not checked")
        return
    other = sorted(n for n in names if "attn_" in n and not any(
        t in n for t in (*TC_KERNELS, *FMA_KERNELS)))
    if other or not any(FMA_FORWARD in n for n in names):
        raise AssertionError(f"{tag}: attention kernels other than the FMA "
                             f"forward's and the tensor cores' {other}, FMA "
                             f"{any(FMA_FORWARD in n for n in names)}")


# ---------------------------------------------------------------------------
# training phase
# ---------------------------------------------------------------------------

DEVICE = "cuda"
TRAIN_B, TRAIN_S, TRAIN_T = 80, 480, 64   # bench.py config 5 (40k tokens)
PARITY_B = 8
TOL_LOSS = 1e-4          # relative, loss of one step
TOL_GRAD = 1e-3          # relative, per parameter (floor: see grad_error)
NEAR_TIE = 1e-3          # a glance that differs must be this close to a tie
NEAR_TIE_RELU = 1e-4     # a ReLU unit that changes side: |pre-activation|
LEARN_STEPS, LEARN_FRACTION = 30, 0.9


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def train_configs():
    from daspeech_torch.config import (ConformerConfig, DAGDecoderConfig,
                                       DAGModelConfig, VocabConfig)

    vocab = VocabConfig(size=128)
    no_drop = DAGModelConfig(
        vocab=vocab, encoder=ConformerConfig(dropout=0.0, attn_dropout=0.0),
        decoder=DAGDecoderConfig(dropout=0.0, attn_dropout=0.0,
                                 activation_dropout=0.0))
    return DAGModelConfig(vocab=vocab), no_drop


def make_train_batch(B, S, T, cfg, seed, device):
    """bench.py config 5's batch: B utterances of S fbank frames, graphs of
    S/2 vertices, targets of T random phonemes between <bos> and <eos>."""
    from daspeech_torch.models import graph_lengths, initialize_output_tokens

    rng = np.random.default_rng(seed)
    lens = torch.full((B,), S, dtype=torch.long)
    prev = initialize_output_tokens(
        graph_lengths(lens, cfg.decoder.src_upsample_scale,
                      cfg.decoder.max_target_positions), S // 2, cfg.vocab)
    tgt = rng.integers(4, cfg.vocab.size, size=(B, T))
    tgt[:, 0], tgt[:, -1] = cfg.vocab.bos, cfg.vocab.eos
    batch = {"fbank": torch.from_numpy(
                 rng.normal(size=(B, S, 80)).astype(np.float32)),
             "src_lengths": lens, "target": torch.from_numpy(tgt),
             "prev_output_tokens": prev}
    return {k: v.to(device) for k, v in batch.items()}


def loss_fn_for(cfg, glat_p):
    from daspeech_torch.losses import nat_dag_loss

    return lambda m, b, g: nat_dag_loss(m, b, g, glat_p, cfg.vocab)


def grad_errors(got, want):
    """Per parameter ||got - want|| / max(||want||, 1e-4 * global norm of
    ``want``), in float64: key biases shift every score of a softmax row
    alike, so their exact gradient is 0 and both sides hold rounding
    noise."""
    want = [w.detach().cpu().double() for w in want]
    floor = 1e-4 * math.sqrt(sum(float(w.norm()) ** 2 for w in want))
    return [float((a.detach().cpu().double() - b).norm())
            / max(float(b.norm()), floor) for a, b in zip(got, want)]


# parameters whose card-vs-CPU gradient difference is always logged: a
# training forward with a biased accumulation (the tensor cores') moved
# FastSpeech 2's positional-embedding scale, a sum over the whole batch,
# past the bar in the joint step
WATCHED_GRADS = ("tts.pos_emb_alpha",)


def grad_error(names, got, want, tag):
    """Worst of :func:`grad_errors`. Every parameter's value goes to
    ``build/profile/grads_<tag>.tsv``, the five worst and the watched ones
    to the log."""
    rel = list(zip(grad_errors(got, want), names))
    with open(os.path.join(profile_dir(), f"grads_{tag}.tsv"), "w") as f:
        f.writelines(f"{n}\t{r:.6g}\n" for r, n in rel)
    worst = sorted(rel, reverse=True)
    log(f"  {tag}: gradient difference relative to its norm, {len(rel)} "
        "parameters, worst five: "
        + ", ".join(f"{n} {r:.3g}" for r, n in worst[:5])
        + "".join(f"; {n} {r:.3g}" for r, n in rel if n in WATCHED_GRADS))
    return worst[0][0]


class plain_kernels:
    """Within the block the model's kernels are replaced by their plain
    PyTorch versions on the card (autograd differentiates them), for the
    kernel-path-against-plain-path comparison."""

    def __enter__(self):
        from daspeech_torch.models import dag_model
        from daspeech_torch.ops import dag_kernels as dk
        from daspeech_torch.ops import dag_ref as dr
        from daspeech_torch.ops import fused_attention as fa
        from daspeech_torch.ops import fused_links as fl
        from daspeech_torch.ops import fused_relpos as fr

        self.saved = [(fa, "fused_attention_packed", fa.attention_plain),
                      (fa, "fused_attention", fa.attention_hm_plain),
                      (fr, "fused_attention_relpos", fr.relpos_plain),
                      (dag_model, "fused_extract_links", fl.links_plain),
                      (dk, "dag_loss_forward_kernel",
                       dr.dag_loss_forward_plain),
                      (dk, "dag_best_alignment_kernel",
                       dr.dag_best_alignment_plain)]
        self.saved = [(m, n, getattr(m, n), f) for m, n, f in self.saved]
        for m, n, _, f in self.saved:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, orig, _ in self.saved:
            setattr(m, n, orig)


class glance_spy:
    """Records what ``glat_glance`` returns (and its inputs) in the block,
    for the S2TT and the joint criterion."""

    def __enter__(self):
        from daspeech_torch.losses import dag_loss as dl
        from daspeech_torch.losses import s2s_loss as sl

        self.modules, self.orig, self.calls = (dl, sl), dl.glat_glance, []

        def spy(logits, links, *a, **kw):
            info = self.orig(logits, links, *a, **kw)
            self.calls.append((logits, links, a, info))
            return info

        for m in self.modules:
            m.glat_glance = spy
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.glat_glance = self.orig


class relu_sides:
    """Within the block ``F.relu`` (FastSpeech 2's activation) records, call
    by call, which units are positive and which lie within NEAR_TIE_RELU of
    zero. Given ``follow``, another run's record, a unit on the other side
    of the kink from that run is a tie when its pre-activation lies that
    close to zero in both runs: it takes the other run's side, value and
    derivative (the derivative is undefined at the kink). ``ties`` and
    ``far`` count the units that changed side at a tie and farther out."""

    def __init__(self, follow=None):
        self.follow, self.sides = follow, []
        self.units = self.ties = self.far = 0
        self.worst = 0.0

    def __enter__(self):
        import torch.nn.functional as F

        self.module, self.orig = F, F.relu
        recorded = iter(self.follow or ())

        def relu(x, inplace=False):
            pos = x > 0
            self.units += pos.numel()
            if self.follow is None:
                self.sides.append((pos.cpu(),
                                   (x.abs() <= NEAR_TIE_RELU).cpu()))
                return self.orig(x, inplace)
            ref, near = (t.to(x.device) for t in next(recorded))
            differ = pos != ref
            if not bool(differ.any()):
                return self.orig(x, inplace)
            tie = differ & near & (x.abs() <= NEAR_TIE_RELU)
            self.ties += int(tie.sum())
            self.far += int((differ & ~tie).sum())
            self.worst = max(self.worst,
                             float(x.detach()[differ].abs().max()))
            return torch.where(tie, torch.where(ref, x, torch.zeros_like(x)),
                               self.orig(x))

        F.relu = relu
        return self

    def __exit__(self, *exc):
        self.module.relu = self.orig


class argmax_spy:
    """Records the inputs and the Viterbi path of the joint criterion's
    ``argmax`` strategy in the block (match [B, T, L], links, target
    lengths, path), on the host."""

    def __enter__(self):
        from daspeech_torch.losses import s2s_loss as sl

        self.module, self.orig, self.calls = sl, sl.dag_best_alignment, []

        def spy(match, links, ol, tl):
            path = self.orig(match, links, ol, tl)
            self.calls.append(tuple(x.detach().cpu() for x in
                                    (match, links, tl, path)))
            return path

        sl.dag_best_alignment = spy
        return self

    def __exit__(self, *exc):
        self.module.dag_best_alignment = self.orig


def viterbi_step_margin(match, links, tl):
    """The smallest top-2 gap of the first max over predecessors at every
    Viterbi step of one sample (match [T, L], links [L, L])."""
    f = torch.full_like(match[0], -math.inf)
    f[0] = match[0, 0]
    margin = math.inf
    for t in range(1, tl):
        top = (f[:, None] + links).topk(2, dim=0).values
        fin = torch.isfinite(top[0]) & torch.isfinite(top[1])
        if fin.any():
            margin = min(margin, float((top[0] - top[1])[fin].min()))
        f = top[0] + match[t]
    return margin


def viterbi_margin(logits, links, tgt, prev, pad, b):
    """The smallest top-2 gap of sample b's glance decisions: the first
    max over predecessors at every Viterbi step and the vertex argmax
    tokens (on the inputs of one path's glance)."""
    from daspeech_torch.ops.dag_ref import dag_logsoftmax_gather_tokens

    match = dag_logsoftmax_gather_tokens(logits[b:b + 1], tgt[b:b + 1])
    margin = viterbi_step_margin(match.transpose(1, 2)[0], links[b],
                                 int((tgt[b] != pad).sum()))
    tok = logits[b].float().topk(2, dim=-1).values
    n = int((prev[b] != pad).sum())
    return min(margin, float((tok[:n, 0] - tok[:n, 1]).min()))


def loss_and_grads(model, batch, seed, loss_fn):
    """One criterion pass + backward: (loss, grads, glance infos)."""
    for p in model.parameters():
        p.grad = None
    with glance_spy() as spy:
        loss, _ = loss_fn(model, batch, torch.Generator().manual_seed(seed))
        loss.backward()
    return (loss.detach(), [torch.zeros_like(p) if p.grad is None
                            else p.grad.detach().clone()
                            for p in model.parameters()], spy.calls)


def parity_step(model_cpu, no_drop_cfg):
    """One step, dropout 0 and GLAT p = 0, on the card and on the CPU (plain
    versions), same weights, sub-batch of PARITY_B."""
    from daspeech_torch.models import S2TConformerDAG
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    out = {}
    opt = GuardedAdam(lr=5e-4, warmup_updates=1)
    for dev in (DEVICE, "cpu"):
        model = S2TConformerDAG(no_drop_cfg)
        model.load_state_dict(model_cpu.state_dict())
        model.to(dev)
        state = TrainState.create(model, opt)
        before = [p.detach().clone() for p in state.params]
        step = make_train_step(loss_fn_for(no_drop_cfg, 0.0), opt)
        batch = make_train_batch(PARITY_B, TRAIN_S, TRAIN_T, no_drop_cfg,
                                 SEED + 2, dev)
        t0 = time.perf_counter()
        metrics = step(state, batch, torch.Generator().manual_seed(SEED))
        sync()
        out[dev] = (metrics, [p.grad.detach().cpu() for p in state.params],
                    [p.detach().cpu() for p in state.params],
                    [b.detach().cpu() for b in model.buffers()],
                    [b.cpu() for b in before])
        log(f"  parity step on {dev}: loss {metrics['loss'].item():.6f}, "
            f"gnorm {metrics['gnorm'].item():.4f} "
            f"({time.perf_counter() - t0:.1f} s)")
    (mg, gg, pg, bg, p0), (mc, gc, pc, bc, _) = out[DEVICE], out["cpu"]
    dloss = abs(mg["loss"].item() - mc["loss"].item()) / abs(
        mc["loss"].item())
    gerr = grad_error([n for n, _ in model_cpu.named_parameters()], gg, gc,
                      "gpu_vs_cpu")
    upd = [(a - b) for a, b in zip(pc, p0)]
    perr = max(float((a - b).abs().max()) for a, b in zip(pg, pc))
    n_far = sum(int(((a - b).abs() > 1e-3 * 5e-4).sum())
                for a, b in zip(pg, pc))
    n_all = sum(x.numel() for x in pc)
    berr = max(float((a - b).abs().max()) for a, b in zip(bg, bc))
    moved = max(float(u.abs().max()) for u in upd)
    log(f"  GPU vs CPU, one step on {PARITY_B} utterances: loss rel diff "
        f"{dloss:.3g} (<= {TOL_LOSS}); worst per-parameter gradient rel diff "
        f"{gerr:.3g} (<= {TOL_GRAD}); updated params max abs diff "
        f"{perr:.3g} with the step moving them by up to {moved:.3g}, "
        f"{n_far} of {n_all} entries differ by > 1e-3 of lr; BatchNorm "
        f"statistics max abs diff {berr:.3g}")
    if not (dloss <= TOL_LOSS and gerr <= TOL_GRAD and berr <= TOL_KERNEL
            and moved > 0):
        raise AssertionError("GPU and CPU training steps disagree")
    # Adam's first step moves each weight by lr * g / (|g| + 1e-8), +-lr
    # whatever |g|, so the two runs' weights can never differ by more than
    # ~2 lr and perr tells nothing. What separates a wrong update is the
    # share of entries that differ by more than 1e-3 lr (~130 ulp of a
    # weight of 0.05, far above rounding): only those whose gradient is
    # rounding noise (the key biases, exactly 0 in exact arithmetic) may
    # flip sign; a wrong moment, bias correction or sign moves nearly all
    if not n_far <= 1e-2 * n_all:
        raise AssertionError(f"updated parameters differ: {n_far} of "
                             f"{n_all} entries by > 1e-3 lr")
    return {"loss_rel": dloss, "grad_rel": gerr, "param_abs": perr}


class float64_ops:
    """Within the block (with :class:`plain_kernels`) a model and batch cast
    to float64 run in float64 end to end: ``Tensor.float()`` keeps float64
    and the rel-pos basis comes in float64. Only for the float64 reference
    of :func:`kernel_vs_plain`."""

    def __enter__(self):
        from daspeech_torch.ops import fused_relpos as fr

        self.fr, self.orig = fr, (torch.Tensor.float, fr.relpos_basis)
        to_float = self.orig[0]
        torch.Tensor.float = lambda t, *a, **k: (  # noqa: E731
            t.double() if t.is_floating_point() else to_float(t, *a, **k))
        fr.relpos_basis = lambda *a, **k: tuple(  # noqa: E731
            x.double() for x in self.orig[1](*a, **k))

    def __exit__(self, *exc):
        torch.Tensor.float, self.fr.relpos_basis = self.orig


def float64_loss_and_grads(model, batch, seed, loss_fn):
    """:func:`loss_and_grads` of the plain versions in float64."""
    m64 = copy.deepcopy(model).double()
    b64 = {k: v.double() if v.is_floating_point() else v
           for k, v in batch.items()}
    with plain_kernels(), float64_ops():
        out = loss_and_grads(m64, b64, seed, loss_fn)
    del m64
    return out


def kernel_vs_plain(model, batch, loss_fn, pad, what, against_float64=False):
    """The criterion's loss and gradients through the kernels and through
    their plain versions, on the card, same weights and seeds (same dropout
    bits): loss within TOL_LOSS relative and each gradient within TOL_GRAD
    of its norm. With ``against_float64`` both are held to the plain
    versions run in float64 instead: where fp32 rounding alone moves a
    gradient by more than TOL_GRAD (the joint step at J-long), the kernel
    path's error must stay within twice the fp32 plain path's own, or
    TOL_GRAD. A glance that differs must be a near tie; its sample is
    masked out of a second try."""
    B = batch["prev_output_tokens"].shape[0]
    for attempt in range(2):
        lk, gk, ck = loss_and_grads(model, batch, SEED, loss_fn)
        with plain_kernels():
            lp, gp, cp = loss_and_grads(model, batch, SEED, loss_fn)
        runs = [ck, cp]
        if against_float64:
            l64, g64, c64 = float64_loss_and_grads(model, batch, SEED,
                                                   loss_fn)
            runs.append(c64)
        prev_p = cp[0][3].prev_output_tokens
        differ = sorted({b for c in runs for b in (
            c[0][3].prev_output_tokens != prev_p).any(dim=1).nonzero()[:, 0]
            .tolist()})
        if not differ:
            break
        for b in differ:
            logits, links, (tgt, prev, *_), _ = cp[0]
            m = viterbi_margin(logits, links, tgt, prev, pad, b)
            log(f"  sample {b}: the glance differs between kernel and plain "
                f"path; top-2 margin of its decisions {m:.3g}")
            if not m < NEAR_TIE:
                raise AssertionError(f"sample {b}: glance differs with "
                                     f"margin {m} >= {NEAR_TIE}")
        # compare on the other samples
        mask = torch.ones(B, device=DEVICE)
        mask[differ] = 0.0
        batch = dict(batch, sample_mask=mask)
    dloss = abs(lk.item() - lp.item()) / abs(lp.item())
    names = [n for n, _ in model.named_parameters()]
    tag = "kernel_vs_plain_" + what.split(",")[0].replace(" ", "_")
    gerr = grad_error(names, gk, gp, tag)
    log(f"  kernel vs plain path on the card ({what}): loss "
        f"{lk.item():.6f} vs {lp.item():.6f}, rel diff {dloss:.3g} (<= "
        f"{TOL_LOSS}); worst per-parameter gradient rel diff {gerr:.3g}")
    if not against_float64:
        if not (dloss <= TOL_LOSS and gerr <= TOL_GRAD):
            raise AssertionError(f"kernel and plain paths disagree ({what})")
        return {"loss_rel": dloss, "grad_rel": gerr}
    e_k = grad_errors(gk, g64)
    e_p = grad_errors(gp, g64)
    excess = max(k / max(2.0 * p, TOL_GRAD) for k, p in zip(e_k, e_p))
    worst = max(range(len(names)), key=lambda i: e_k[i])
    log(f"  against the plain versions in float64 (loss "
        f"{l64.item():.9f}): kernel path worst per-parameter gradient rel "
        f"diff {max(e_k):.3g} ({names[worst]}), fp32 plain path "
        f"{max(e_p):.3g}; worst kernel error over max(2 x plain's, "
        f"{TOL_GRAD}) {excess:.3g} (<= 1)")
    with open(os.path.join(profile_dir(), f"grads_{tag}_float64.tsv"),
              "w") as f:
        f.writelines(f"{n}\t{k:.6g}\t{p:.6g}\n"
                     for n, k, p in zip(names, e_k, e_p))
    if not (dloss <= TOL_LOSS and excess <= 1.0):
        raise AssertionError(f"kernel path off float64 beyond fp32 rounding "
                             f"({what})")
    return {"loss_rel": dloss, "grad_rel": gerr, "excess": excess}


def train_sub_stages(state, batch, opt, cfg, reps=5):
    """Median host-clock ms of each stage of one update, each closed by a
    synchronize (the steps of ``nat_dag_loss`` and ``make_train_step``
    spelled out); the first of ``reps + 1`` rounds is a warm-up."""
    from daspeech_torch.losses.dag_loss import (compute_dag_loss,
                                                device_generator,
                                                glat_glance)
    from daspeech_torch.train import global_norm

    model = state.model
    names = ("encode", "glance pass + Viterbi", "second decode",
             "logsoftmax + DP", "backward", "optimizer")
    times = {k: [] for k in names}
    gen = torch.Generator().manual_seed(SEED + 7)
    for rep in range(reps + 1):
        for p in state.params:
            p.grad = None
        sync()
        ts = [time.perf_counter()]

        def mark():
            sync()
            ts.append(time.perf_counter())

        e_seed, d_seed, g_seed = (int(x) for x in torch.randint(
            0, 2 ** 62, (3,), generator=gen))
        prev = batch["prev_output_tokens"]
        enc, enc_pad, _ = model.encode(batch["fbank"], batch["src_lengths"],
                                       rng=device_generator(DEVICE, e_seed))
        mark()
        with torch.no_grad():
            logits1, links1, _ = model.decode(
                prev, enc, enc_pad, rng=device_generator(DEVICE, d_seed))
            info = glat_glance(logits1, links1, batch["target"], prev, 0.5,
                               cfg.vocab.pad,
                               rng=device_generator(DEVICE, g_seed))
        mark()
        logits, links, _ = model.decode(
            info.prev_output_tokens, enc, enc_pad,
            rng=device_generator(DEVICE, d_seed))
        mark()
        loss, _ = compute_dag_loss(logits, links, batch["target"],
                                   info.prev_output_tokens, cfg.vocab.pad,
                                   info.matchmask, info.keep_word_mask)
        mark()
        loss.backward()
        mark()
        grads = [p.grad for p in state.params]
        gnorm = global_norm(grads)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        state.opt_state = opt.update_(state.params, grads, state.opt_state,
                                      gnorm, ok)
        mark()
        if rep:
            for k, a, b in zip(names, ts[:-1], ts[1:]):
                times[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def train_phase():
    """The S2TT DAG training step (``make_train_step`` over
    ``nat_dag_loss``) at the recipe's widths, random weights from a seed:
    GPU-vs-CPU parity, kernel-vs-plain on the card, the timed main-path run
    (launch counts), sub-stages, busy share, peak memory, learning."""
    from daspeech_torch.models import S2TConformerDAG
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    cfg, no_drop_cfg = train_configs()
    model_cpu = init_random_(S2TConformerDAG(cfg), SEED)
    results = {"parity": parity_step(model_cpu, no_drop_cfg)}

    model = copy.deepcopy(model_cpu).to(DEVICE)
    results["kernel_vs_plain"] = kernel_vs_plain(
        model, make_train_batch(TRAIN_B, TRAIN_S, TRAIN_T, cfg, SEED + 3,
                                DEVICE),
        loss_fn_for(cfg, 0.5), cfg.vocab.pad,
        f"S2TT B={TRAIN_B}, dropout 0.1, GLAT 0.5")

    # --- the training path's run: counters from 0, 3 warm-up and 10 timed
    # updates of bench config 5 (recipe optimizer: lr 5e-4, 10k warm-up)
    opt = GuardedAdam()
    state = TrainState.create(model, opt)
    step = make_train_step(loss_fn_for(cfg, 0.5), opt)
    batch = make_train_batch(TRAIN_B, TRAIN_S, TRAIN_T, cfg, SEED + 4,
                             DEVICE)
    gen = torch.Generator().manual_seed(SEED + 5)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(13):
        sync()
        t0 = time.perf_counter()
        metrics = step(state, batch, gen)
        sync()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  launches in the training run (13 updates): {launches}")
    dp_clusters("S2TT")
    training_forwards_per_update(launches, 13, "S2TT")
    for name in TRAIN_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the training "
                                 "path")
    if not (torch.isfinite(metrics["loss"]) and metrics["skipped"] == 0):
        raise AssertionError(f"training step failed: {metrics}")
    q25, med, q75 = np.percentile(times, [25, 50, 75])
    log(f"  update at B={TRAIN_B} (S={TRAIN_S}, L={TRAIN_S // 2}, "
        f"T={TRAIN_T}): median {med:.3f} ms over 10 (IQR {q25:.3f}-"
        f"{q75:.3f}, min {min(times):.3f}, max {max(times):.3f}); loss "
        f"{metrics['loss'].item():.4f}, gnorm {metrics['gnorm'].item():.4f};"
        f" peak memory {peak:.2f} GiB")
    results.update(step_ms=med, step_iqr=(q25, q75), peak_gib=peak)

    med_st = train_sub_stages(state, batch, opt, cfg)
    log("  training sub-stages (median of 5, ms): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med_st.items())
        + f"; sum {sum(med_st.values()):.3f}")
    fma_forward_only(device_busy(lambda: step(state, batch, gen),
                                 "train step"), "train step")

    # --- learning: LEARN_STEPS updates on one fixed batch, warm-up 10
    learn_model = copy.deepcopy(model_cpu).to(DEVICE)
    opt = GuardedAdam(warmup_updates=10)
    state = TrainState.create(learn_model, opt)
    step = make_train_step(loss_fn_for(cfg, 0.5), opt)
    losses = [step(state, batch, gen)["loss"] for _ in range(LEARN_STEPS)]
    losses = [x.item() for x in losses]
    log(f"  learning, {LEARN_STEPS} updates on one batch: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (must fall below "
        f"{LEARN_FRACTION} of the first); every fifth: "
        + " ".join(f"{x:.3f}" for x in losses[::5]))
    if not losses[-1] < LEARN_FRACTION * losses[0]:
        raise AssertionError("the training step does not learn")
    return launches


# ---------------------------------------------------------------------------
# joint S2ST phase and FastSpeech 2 pretraining phase
# ---------------------------------------------------------------------------

# (B, S fbank frames, T target tokens, M mel frames, frames per token). J:
# bench.py's joint step (max-tokens 20k: L = 240, T' = 120). J-long: the
# same 20k tokens as 14 utterances of 14 s (T' = 350, L = 700), where the
# FastSpeech 2 decoder (1040 frames) and the DAG decoder's self-attention
# (700 vertices) take the head-major kernel
JOINT_SHAPES = {"J": (40, 480, 64, 512, 8), "J-long": (14, 1400, 128, 1040, 8)}
# head-major forward / backward launches per update: FastSpeech 2's 4
# decoder layers, the DAG decoder's 4 layers in 2 passes (the glance pass
# without gradient)
HM_PER_UPDATE = {"J": (0, 0), "J-long": (12, 8)}
JOINT_PARITY_B = 4
P_SHAPE = (14, 128, 1040, 8)    # B, T phonemes, M mel frames, frames/token
P_PARITY_B = 4


def joint_configs():
    from daspeech_torch.config import (ConformerConfig, DAGDecoderConfig,
                                       DAGModelConfig, FastSpeech2Config,
                                       S2SModelConfig, VocabConfig)

    vocab = VocabConfig(size=128)
    no_drop = S2SModelConfig(
        dag=DAGModelConfig(
            vocab=vocab,
            encoder=ConformerConfig(dropout=0.0, attn_dropout=0.0),
            decoder=DAGDecoderConfig(dropout=0.0, attn_dropout=0.0,
                                     activation_dropout=0.0)),
        tts=FastSpeech2Config(dropout=0.0, var_pred_dropout=0.0),
        adaptor_dropout=0.0)
    return S2SModelConfig(dag=DAGModelConfig(vocab=vocab)), no_drop


def _gold(rng, B, n, dur):
    """Gold durations (``dur`` frames each), pitches and energies U(0, 2)
    (a normalized feature's scale) of n tokens."""
    f = lambda: torch.from_numpy(  # noqa: E731
        rng.uniform(0, 2, size=(B, n)).astype(np.float32))
    return {"durations": torch.full((B, n), dur), "pitches": f(),
            "energies": f()}


def make_joint_batch(B, S, T, M, dur, cfg, seed, device):
    """B utterances of S fbank frames (graphs of S/2 vertices), targets of
    T random phonemes between <bos> and <eos>, a mel target of M frames
    N(0, 1) of which the T - 1 tokens fill (T - 1) * dur."""
    from daspeech_torch.models import graph_lengths, initialize_output_tokens

    rng = np.random.default_rng(seed)
    vocab = cfg.dag.vocab
    lens = torch.full((B,), S, dtype=torch.long)
    prev = initialize_output_tokens(
        graph_lengths(lens, cfg.dag.decoder.src_upsample_scale,
                      cfg.dag.decoder.max_target_positions), S // 2, vocab)
    tgt = rng.integers(4, vocab.size, size=(B, T))
    tgt[:, 0], tgt[:, -1] = vocab.bos, vocab.eos
    batch = {"fbank": torch.from_numpy(
                 rng.normal(size=(B, S, 80)).astype(np.float32)),
             "src_lengths": lens, "target_text": torch.from_numpy(tgt),
             "prev_output_tokens": prev,
             "target_audio": torch.from_numpy(
                 rng.normal(size=(B, M, 80)).astype(np.float32)),
             "target_audio_lengths": torch.full((B,), min((T - 1) * dur, M)),
             **_gold(rng, B, T - 1, dur)}
    return {k: v.to(device) for k, v in batch.items()}


def make_fs2_batch(B, T, M, dur, vocab, seed, device):
    """B phoneme sequences of T tokens (no padding), a mel target of M
    frames N(0, 1), gold durations, pitches and energies."""
    rng = np.random.default_rng(seed)
    batch = {"src_tokens": torch.from_numpy(
                 rng.integers(4, vocab.size, size=(B, T))),
             "target_audio": torch.from_numpy(
                 rng.normal(size=(B, M, 80)).astype(np.float32)),
             "target_audio_lengths": torch.full((B,), min(T * dur, M)),
             **_gold(rng, B, T, dur)}
    return {k: v.to(device) for k, v in batch.items()}


def joint_loss_fn(cfg, glat_p, strategy="expect", freeze_dag=False):
    from daspeech_torch.losses import s2s_dag_fastspeech2_loss

    return lambda m, b, g: s2s_dag_fastspeech2_loss(
        m, b, g, glat_p, cfg.dag.vocab, training_strategy=strategy,
        freeze_dag=freeze_dag)


def fs2_loss_fn(vocab):
    from daspeech_torch.losses import fastspeech2_criterion

    return lambda m, b, g: fastspeech2_criterion(m, b, g, vocab)


# the card-vs-CPU steps of step_parity that failed their bars
DISAGREEMENTS = []


def step_parity(tag, model_cpu, loss_fn, batch):
    """One ``make_train_step`` on the card and one on the CPU (plain
    versions), same weights and batch: loss within TOL_LOSS relative, each
    gradient within TOL_GRAD of its norm, BatchNorm statistics within
    TOL_KERNEL. The ``argmax`` strategy's Viterbi paths must agree; a
    sample whose path differs must be a near tie, and is masked out of a
    second try. A ReLU unit on the other side of the kink on the CPU than
    on the card must be a tie (:class:`relu_sides`), and the CPU's step
    takes the card's side there. A step past these bars goes to
    DISAGREEMENTS: the phases
    after it still run and report, and :func:`main` fails before it
    prints any result."""
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    opt = GuardedAdam(lr=5e-4, warmup_updates=1)
    B = next(iter(batch.values())).shape[0]
    for attempt in range(2):
        out, card = {}, None
        for dev in (DEVICE, "cpu"):
            model = copy.deepcopy(model_cpu).to(dev)
            state = TrainState.create(model, opt)
            b = {k: v.to(dev) for k, v in batch.items()}
            t0 = time.perf_counter()
            with argmax_spy() as spy, relu_sides(card) as relus:
                metrics = make_train_step(loss_fn, opt)(
                    state, b, torch.Generator().manual_seed(SEED))
            sync()
            card = relus.sides
            out[dev] = (metrics["loss"].item(),
                        [torch.zeros(p.shape) if p.grad is None
                         else p.grad.detach().cpu() for p in state.params],
                        [x.detach().cpu() for x in model.buffers()],
                        spy.calls)
            log(f"  {tag} step on {dev}: loss {out[dev][0]:.6f}, gnorm "
                f"{metrics['gnorm'].item():.4f} "
                f"({time.perf_counter() - t0:.1f} s)")
        (lg, gg, bg, cg), (lc, gc, bc, cc) = out[DEVICE], out["cpu"]
        differ = sorted({b for (_, _, _, pg), (_, _, _, pc) in zip(cg, cc)
                         for b in (pg != pc).any(dim=1).nonzero()[:, 0]
                         .tolist()})
        if not differ:
            break
        for b in differ:
            match, links, tl, _ = cc[0]
            m = viterbi_step_margin(match[b], links[b], int(tl[b]))
            log(f"  {tag} sample {b}: the argmax path differs between card "
                f"and CPU; top-2 margin of its decisions {m:.3g}")
            if not m < NEAR_TIE:
                raise AssertionError(f"{tag} sample {b}: path differs with "
                                     f"margin {m} >= {NEAR_TIE}")
        mask = torch.ones(B)
        mask[differ] = 0.0
        batch = dict(batch, sample_mask=mask)
    dloss = abs(lg - lc) / abs(lc)
    gerr = grad_error([n for n, p in model_cpu.named_parameters()
                       if p.requires_grad], gg, gc, tag.replace(" ", "_"))
    berr = max((float((a - b).abs().max()) for a, b in zip(bg, bc)
                if a.is_floating_point()), default=0.0)
    log(f"  {tag}: ReLU units on the CPU's side of the kink other than the "
        f"card's: {relus.ties} at a tie (|pre-activation| <= {NEAR_TIE_RELU} "
        f"in both, the card's side taken), {relus.far} farther out, of "
        f"{relus.units}; largest |pre-activation| among them "
        f"{relus.worst:.3g}")
    log(f"  {tag}, card vs CPU: loss rel diff {dloss:.3g} (<= {TOL_LOSS}); "
        f"worst per-parameter gradient rel diff {gerr:.3g} (<= {TOL_GRAD});"
        f" buffers max abs diff {berr:.3g}")
    if not (dloss <= TOL_LOSS and gerr <= TOL_GRAD and berr <= TOL_KERNEL
            and relus.far == 0):
        log(f"  FAILED: {tag}: card and CPU steps disagree")
        DISAGREEMENTS.append(tag)
    return {"loss_rel": dloss, "grad_rel": gerr}


def joint_sub_stages(state, batch, opt, cfg, reps=5):
    """Median host-clock ms of each stage of one joint update, each closed
    by a synchronize (the steps of ``s2s_dag_fastspeech2_loss`` and
    ``make_train_step`` spelled out, ``expect`` strategy); the first of
    ``reps + 1`` rounds is a warm-up."""
    from daspeech_torch.losses import (compute_dag_loss, expected_features,
                                       fastspeech2_losses, glat_glance)
    from daspeech_torch.losses.dag_loss import device_generator
    from daspeech_torch.models.layers import lengths_to_padding_mask
    from daspeech_torch.train import global_norm

    model, pad = state.model, cfg.dag.vocab.pad
    names = ("encode", "glance pass + Viterbi", "second decode",
             "DP with alpha/beta", "expected features", "FastSpeech 2",
             "backward", "optimizer")
    times = {k: [] for k in names}
    gen = torch.Generator().manual_seed(SEED + 8)
    tgt, prev = batch["target_text"], batch["prev_output_tokens"]
    M = batch["target_audio"].shape[1]
    for rep in range(reps + 1):
        for p in state.params:
            p.grad = None
        sync()
        ts = [time.perf_counter()]

        def mark():
            sync()
            ts.append(time.perf_counter())

        e, d, gl, tt = (int(x) for x in torch.randint(0, 2 ** 62, (4,),
                                                      generator=gen))
        enc, enc_pad, _ = model.encode(batch["fbank"], batch["src_lengths"],
                                       rng=device_generator(DEVICE, e))
        mark()
        with torch.no_grad():
            logits1, links1, _ = model.decode(
                prev, enc, enc_pad, rng=device_generator(DEVICE, d))
            info = glat_glance(logits1, links1, tgt, prev, 0.5, pad,
                               rng=device_generator(DEVICE, gl))
        mark()
        logits, links, feats = model.decode(
            info.prev_output_tokens, enc, enc_pad,
            rng=device_generator(DEVICE, d))
        mark()
        dagloss, _, alpha, beta = compute_dag_loss(
            logits, links, tgt, info.prev_output_tokens, pad,
            info.matchmask, info.keep_word_mask, with_alpha_beta=True)
        mark()
        z = expected_features(alpha, beta, feats)
        mark()
        n = z.shape[1]
        zpad = lengths_to_padding_mask((tgt != pad).sum(1) - 1, n)
        gold = [batch[k][:, :n] for k in ("durations", "pitches",
                                          "energies")]
        mel, _, log_dur, pitch, energy = model.synthesize(
            z, zpad, M, gold[0], pitches=gold[1], energies=gold[2],
            rng=device_generator(DEVICE, tt))
        tts, _ = fastspeech2_losses(
            mel, log_dur, pitch, energy, batch["target_audio"], *gold, ~zpad,
            ~lengths_to_padding_mask(batch["target_audio_lengths"], M))
        loss = dagloss + 5.0 * tts
        mark()
        loss.backward()
        mark()
        grads = [p.grad for p in state.params]
        gnorm = global_norm(grads)
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)
        state.opt_state = opt.update_(state.params, grads, state.opt_state,
                                      gnorm, ok)
        mark()
        if rep:
            for k, a, b in zip(names, ts[:-1], ts[1:]):
                times[k].append((b - a) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}


def timed_updates(step, state, batch, n_warm, n_timed, tag):
    """``n_warm`` + ``n_timed`` updates with the counters from 0: (median
    ms, IQR, launches, peak GiB, last metrics)."""
    gen = torch.Generator().manual_seed(SEED + 5)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(n_warm + n_timed):
        sync()
        t0 = time.perf_counter()
        metrics = step(state, batch, gen)
        sync()
        if i >= n_warm:
            times.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (torch.isfinite(metrics["loss"]) and metrics["skipped"] == 0):
        raise AssertionError(f"{tag}: update failed: {metrics}")
    q25, med, q75 = np.percentile(times, [25, 50, 75])
    log(f"  {tag}: median {med:.3f} ms per update over {n_timed} (IQR "
        f"{q25:.3f}-{q75:.3f}, min {min(times):.3f}, max {max(times):.3f});"
        f" loss {metrics['loss'].item():.4f}; peak memory {peak:.2f} GiB")
    return med, (q25, q75), launches, peak, metrics


def dp_clusters(tag):
    """Log the cluster sizes the DP kernels' launches of the last timed
    run took; at J-long every launch of both must split its samples over
    more than one block."""
    from daspeech_torch.ops import dag_kernels as dk

    by_cs = {n: dict(w.cluster_launches) for n, w in
             (("dag_loss_forward", dk.dag_loss_forward_kernel),
              ("dag_best_alignment", dk.dag_best_alignment_kernel))}
    log(f"  {tag} DP launches by cluster size: {by_cs}")
    if tag == "J-long" and any(not c or min(c) <= 1 for c in by_cs.values()):
        raise AssertionError(f"J-long DP launches not split over clusters: "
                             f"{by_cs}")


def joint_phase():
    """The joint S2ST step (``make_train_step`` over
    ``s2s_dag_fastspeech2_loss``) at the recipe's widths, random weights
    from a seed: card-vs-CPU steps (``expect`` and ``argmax``), kernel vs
    plain path at J-long with dropout on, timed updates with sub-stages at
    J and J-long (the head-major kernel's launches per update checked), a
    frozen-DAG step, and 30 updates that must lower the loss. Returns the
    launches of the J and J-long runs."""
    from daspeech_torch.models import S2SConformerDAGFastSpeech2
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    cfg, no_drop = joint_configs()
    model_cpu = init_random_(S2SConformerDAGFastSpeech2(cfg), SEED)
    B, S, T, M, dur = JOINT_SHAPES["J"]
    parity_batch = make_joint_batch(JOINT_PARITY_B, S, T, M, dur, cfg,
                                    SEED + 10, "cpu")
    ref = S2SConformerDAGFastSpeech2(no_drop)
    ref.load_state_dict(model_cpu.state_dict())
    for strategy in ("expect", "argmax"):
        step_parity(f"joint {strategy} B={JOINT_PARITY_B}", ref,
                    joint_loss_fn(no_drop, 0.0, strategy), parity_batch)

    model = copy.deepcopy(model_cpu).to(DEVICE)
    kernel_vs_plain(model, make_joint_batch(*JOINT_SHAPES["J-long"], cfg,
                                            SEED + 11, DEVICE),
                    joint_loss_fn(cfg, 0.5), cfg.dag.vocab.pad,
                    "joint J-long, dropout on, GLAT 0.5",
                    against_float64=True)

    runs = {}
    for tag, shape in JOINT_SHAPES.items():
        opt = GuardedAdam()
        state = TrainState.create(model, opt)
        step = make_train_step(joint_loss_fn(cfg, 0.5), opt)
        batch = make_joint_batch(*shape, cfg, SEED + 12, DEVICE)
        what = (f"joint {tag} (B={shape[0]}, S={shape[1]}, L={shape[1] // 2},"
                f" T={shape[2]}, M={shape[3]})")
        _, _, launches, _, _ = timed_updates(step, state, batch, 3, 10, what)
        per = {n: launches[n] / 13 for n in JOINT_KERNELS}
        log(f"  {tag} launches per update: "
            + ", ".join(f"{n} {v:g}" for n, v in per.items()))
        training_forwards_per_update(launches, 13, f"joint {tag}")
        for name in (JOINT_KERNELS if HM_PER_UPDATE[tag][0]
                     else TRAIN_KERNELS):
            if launches[name] <= 0:
                raise AssertionError(f"{name} was not launched by {what}")
        if (per["fused_attention"], per["fused_attention_bwd"]) != \
                HM_PER_UPDATE[tag]:
            raise AssertionError(f"{what}: head-major launches per update "
                                 f"{per['fused_attention']} / "
                                 f"{per['fused_attention_bwd']}, expected "
                                 f"{HM_PER_UPDATE[tag]}")
        runs[tag] = launches
        dp_clusters(tag)
        med = joint_sub_stages(state, batch, opt, cfg)
        log(f"  {tag} sub-stages (median of 5, ms): "
            + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
            + f"; sum {sum(med.values()):.3f}")
        fma_forward_only(device_busy(
            lambda: step(state, batch, torch.Generator()),
            f"joint step {tag}"), f"joint step {tag}")

    # --- a frozen-DAG step: no gradient reaches the encoder or the DAG
    # decoder; the adaptor and FastSpeech 2 train
    batch = make_joint_batch(*JOINT_SHAPES["J"], cfg, SEED + 13, DEVICE)
    loss, grads, _ = loss_and_grads(model, batch, SEED,
                                    joint_loss_fn(cfg, 0.5, freeze_dag=True))
    named = list(zip((n for n, _ in model.named_parameters()), grads))
    moved = [n for n, g in named if n.startswith("dag.") and g.any()]
    still = [n for n, g in named if not n.startswith("dag.")
             and not g.any()]
    log(f"  frozen-DAG step: loss {loss.item():.4f}; "
        f"{sum(n.startswith('dag.') for n, _ in named)} DAG parameters "
        f"with any nonzero gradient: {len(moved)}; adaptor and FastSpeech 2 "
        f"parameters with an all-zero gradient: {len(still)}")
    if moved or still:
        raise AssertionError(f"freeze_dag: {moved[:5]} {still[:5]}")

    # --- learning: LEARN_STEPS updates on one J batch, warm-up 10
    opt = GuardedAdam(warmup_updates=10)
    state = TrainState.create(copy.deepcopy(model_cpu).to(DEVICE), opt)
    step = make_train_step(joint_loss_fn(cfg, 0.5), opt)
    gen = torch.Generator().manual_seed(SEED + 14)
    losses = [step(state, batch, gen)["loss"] for _ in range(LEARN_STEPS)]
    losses = [x.item() for x in losses]
    log(f"  joint learning, {LEARN_STEPS} updates on one J batch: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} (must end at <= "
        f"{LEARN_FRACTION} of the first); every fifth: "
        + " ".join(f"{x:.3f}" for x in losses[::5]))
    if not losses[-1] <= LEARN_FRACTION * losses[0]:
        raise AssertionError("the joint step does not learn")
    return runs


def fs2_phase():
    """FastSpeech 2 pretraining (``make_train_step`` over
    ``fastspeech2_criterion``, token input) at the recipe's widths: one
    card-vs-CPU step at B = P_PARITY_B, then 5 timed updates at P."""
    from daspeech_torch.config import FastSpeech2Config, VocabConfig
    from daspeech_torch.models import FastSpeech2Encoder
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    vocab = VocabConfig(size=128)
    cfg = FastSpeech2Config()
    model_cpu = init_random_(FastSpeech2Encoder(cfg, vocab.size), SEED + 20)
    ref = FastSpeech2Encoder(FastSpeech2Config(dropout=0.0,
                                               var_pred_dropout=0.0),
                             vocab.size)
    ref.load_state_dict(model_cpu.state_dict())
    B, T, M, dur = P_SHAPE
    step_parity(f"FastSpeech 2 B={P_PARITY_B}", ref, fs2_loss_fn(vocab),
                make_fs2_batch(P_PARITY_B, T, M, dur, vocab, SEED + 21,
                               "cpu"))
    opt = GuardedAdam()
    state = TrainState.create(copy.deepcopy(model_cpu).to(DEVICE), opt)
    step = make_train_step(fs2_loss_fn(vocab), opt)
    batch = make_fs2_batch(B, T, M, dur, vocab, SEED + 22, DEVICE)
    _, _, launches, _, _ = timed_updates(
        step, state, batch, 2, 5,
        f"FastSpeech 2 pretraining P (B={B}, T={T}, M={M})")
    log(f"  P launches over 7 updates: "
        + ", ".join(f"{n} {launches[n]}" for n in JOINT_KERNELS))
    training_forwards_per_update(launches, 7, "P")
    for name in ("fused_attention_packed", "fused_attention",
                 "fused_attention_packed_bwd", "fused_attention_bwd"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by pretraining")
    fma_forward_only(device_busy_in_turns(
        lambda: step(state, batch, torch.Generator()), "pretraining step P"),
        "pretraining step P")
    return launches


# ---------------------------------------------------------------------------
# vocoder serving modes and the TTS generator
# ---------------------------------------------------------------------------

TOL_FUSED = 1e-4          # fused-MRF waveform against the default mode
TOL_CHUNKED = 1e-5        # chunked waveform against one-shot
TOL_WAV_CPU = 2.5e-4      # a waveform against its CPU run
TOL_TTS_MEL = 1e-3        # the TTS mel against its CPU run
SERVE_CHUNK = 64
V3 = dict(resblock="2", upsample_rates=(8, 8, 4),       # hifi-gan config_v3
          upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=256,
          resblock_kernel_sizes=(3, 5, 7),
          resblock_dilation_sizes=((1, 2), (2, 6), (3, 12)))


def first_chunk_ms(voc, mel, chunk, reps=10):
    """Median host-clock ms from a mel ready on the card to the first
    chunk's samples (``vocode_chunks``), over ``reps`` after a warm-up."""
    from daspeech_torch.models import vocode_chunks

    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next(vocode_chunks(voc, mel, chunk))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def init_vocoder_(voc: torch.nn.Module, seed: int):
    """Random vocoder weights from a seed that keep every level's
    activations of order 1 and the waveform out of tanh's saturation: each
    conv's weights N(0, 1 / fan_in) (a transposed conv's fan-in is
    in * k / stride), biases N(0, 0.1). (``init_random_``'s N(0, 0.05) grows
    config_v1's activations to ~1e3 and saturates 98% of the samples, where
    a waveform comparison says little.)"""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in voc.modules():
            if isinstance(m, torch.nn.ConvTranspose1d):
                fan = m.in_channels * m.kernel_size[0] / m.stride[0]
            elif isinstance(m, torch.nn.Conv1d):
                fan = m.in_channels * m.kernel_size[0]
            else:
                continue
            m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                           / math.sqrt(fan))
            m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return voc.eval().requires_grad_(False)


def vocoder_phase(mels):
    """The vocoder's serving modes at config_v1 on the serving phase's
    mels, and ResBlock type 2 at config_v3, with weights from
    ``init_vocoder_``. Returns the launches of the fused-mode run (each
    batch once) and the config_v1 vocoder (on the CPU)."""
    from daspeech_torch.config import HiFiGANConfig
    from daspeech_torch.decode import make_vocode_fn
    from daspeech_torch.models import HiFiGANGenerator
    from daspeech_torch.ops import fused_mrf as fm

    voc_cpu = init_vocoder_(HiFiGANGenerator(HiFiGANConfig()), SEED + 1)

    def with_weights(src, **serving):
        voc = HiFiGANGenerator(src.cfg, **serving)
        voc.load_state_dict(src.state_dict())
        return voc.eval().requires_grad_(False).cuda()

    voc = with_weights(voc_cpu)
    fused = with_weights(voc_cpu, fused_mrf=True)
    # every level at one tile
    fused_tiles = {t: with_weights(voc_cpu, fused_mrf=True, mrf_tile=t)
                   for t in fm.TILES}
    with torch.inference_mode():
        # --- the fused mode's run: counters from 0, each batch once
        reset_launches()
        wav_fused = {tag: fused(mel) for tag, mel in mels.items()}
        torch.cuda.synchronize()
        launches = read_launches()
        log(f"  launches in the fused-mode run: {launches}")
        if launches["mrf_level"] != 3 * len(mels):
            raise AssertionError(f"mrf_level launched {launches['mrf_level']}"
                                 f" times for {len(mels)} batches, not 3 "
                                 "per batch")
        for tag, mel in mels.items():
            want = voc(mel)
            err = _max_err(wav_fused[tag], want)
            if not (torch.isfinite(wav_fused[tag]).all() and err <= TOL_FUSED):
                raise AssertionError(f"fused vocoder, batch {tag}: max abs "
                                     f"diff {err} (<= {TOL_FUSED})")
            ms_default = cuda_ms(lambda: voc(mel), reps=5, warm=1)
            ms_fused = cuda_ms(lambda: fused(mel), reps=5, warm=1)
            ms_tiles = ", ".join(
                f"tile {t} {cuda_ms(lambda: v(mel), reps=5, warm=1):.3f} ms"
                for t, v in fused_tiles.items())
            audio_s = mel.shape[0] * mel.shape[1] * 256 / 22050.0
            log(f"  vocoder batch {tag} mel{list(mel.shape)}: default "
                f"{ms_default:.3f} ms, fused_mrf {ms_fused:.3f} ms "
                f"({audio_s / (ms_fused / 1e3):.1f} audio-s per s; every "
                f"level at {ms_tiles}); fused vs default max abs diff "
                f"{err:.3g} (<= {TOL_FUSED})")

        # --- exact chunked vocoding at B = 1 (one utterance of batch A):
        # each mode's chunks against its own one-shot run (<= 1e-5), the
        # fused mode's also against the default one-shot (<= 1e-4)
        mel1 = mels["A"][:1].contiguous()
        one = voc(mel1)
        one_fused = fused(mel1)
        for tag, chunked, own in (
                ("default", with_weights(voc_cpu, serve_chunk=SERVE_CHUNK),
                 one),
                ("fused_mrf", with_weights(voc_cpu, fused_mrf=True,
                                           serve_chunk=SERVE_CHUNK),
                 one_fused)):
            fn = make_vocode_fn(chunked)
            got = fn(mel1)
            err = _max_err(got, own)
            err_default = _max_err(got, one)
            if not (got.shape == one.shape and err <= TOL_CHUNKED
                    and err_default <= TOL_FUSED):
                raise AssertionError(f"chunked ({tag}) vs one-shot: "
                                     f"{tuple(got.shape)}, max abs diff "
                                     f"{err} (own mode), {err_default} "
                                     "(default mode)")
            log(f"  chunked {tag} (chunk {SERVE_CHUNK}, B=1, "
                f"{mel1.shape[1]} frames): first chunk "
                f"{first_chunk_ms(chunked, mel1, SERVE_CHUNK):.3f} ms after "
                f"the mel, whole {cuda_ms(lambda: fn(mel1), 5, 1):.3f} ms; "
                f"one-shot {cuda_ms(lambda: voc(mel1), 5, 1):.3f} ms; max abs "
                f"diff {err:.3g} against its mode's one-shot (<= "
                f"{TOL_CHUNKED}), {err_default:.3g} against the default's "
                f"(<= {TOL_FUSED})")

        # --- ResBlock type 2 at config_v3 widths
        v3_cpu = init_vocoder_(HiFiGANGenerator(HiFiGANConfig(**V3)),
                               SEED + 30)
        v3 = with_weights(v3_cpu)
        v3_chunked = with_weights(v3_cpu, serve_chunk=SERVE_CHUNK)
        one = v3(mel1)
        err_cpu = _max_err(one.cpu(), v3_cpu(mel1.cpu()))
        err_chunk = _max_err(make_vocode_fn(v3_chunked)(mel1), one)
        log(f"  ResBlock2 (config_v3): batch A {cuda_ms(lambda: v3(mels['A']), 5, 1):.3f}"
            f" ms, B=1 one-shot {cuda_ms(lambda: v3(mel1), 5, 1):.3f} ms; "
            f"card vs CPU {err_cpu:.3g} (<= {TOL_WAV_CPU}), chunked vs "
            f"one-shot {err_chunk:.3g} (<= {TOL_CHUNKED})")
        if not (err_cpu <= TOL_WAV_CPU and err_chunk <= TOL_CHUNKED):
            raise AssertionError("ResBlock2 vocoder disagrees")
    return launches, voc_cpu


def tts_phase(voc_cpu):
    """``NonAutoregressiveSpeechGenerator`` at the recipe's widths (random
    weights, every phoneme 8 frames) with the vocoder-mode phase's config_v1
    vocoder, on batches of 8 x 52 and 2 x 130 phonemes."""
    from daspeech_torch.config import FastSpeech2Config, VocabConfig
    from daspeech_torch.decode import NonAutoregressiveSpeechGenerator
    from daspeech_torch.models import FastSpeech2Encoder

    vocab = VocabConfig(size=128)
    model_cpu = set_durations_(init_random_(
        FastSpeech2Encoder(FastSpeech2Config(), vocab.size), SEED + 40), 8)
    model_cpu.eval().requires_grad_(False)
    model = copy.deepcopy(model_cpu).cuda()
    voc = copy.deepcopy(voc_cpu).cuda()
    rng = np.random.default_rng(SEED + 41)
    runs = {}
    for tag, B, n in (("A", 8, 52), ("B", 2, 130)):
        M = n * 8
        batch = {"src_tokens": rng.integers(4, vocab.size, size=(B, n))}
        gen = NonAutoregressiveSpeechGenerator(model, vocab, max_mel_len=M,
                                               vocoder=voc)
        reset_launches()
        hyps = gen.generate(batch)
        launches = read_launches()
        runs[tag] = launches
        for h in hyps:
            if not (h["feature"].shape == (M, 80)
                    and len(h["waveform"]) == M * 256
                    and np.isfinite(h["feature"]).all()
                    and np.isfinite(h["waveform"]).all()):
                raise AssertionError(f"TTS batch {tag}: mel "
                                     f"{h['feature'].shape}, "
                                     f"{len(h['waveform'])} samples")
        want = NonAutoregressiveSpeechGenerator(model_cpu, vocab,
                                                max_mel_len=M).generate(
            {"src_tokens": batch["src_tokens"][:2]})
        err = max(float(np.abs(g["feature"] - w["feature"]).max())
                  for g, w in zip(hyps, want))
        if not err <= TOL_TTS_MEL:
            raise AssertionError(f"TTS batch {tag}: mel differs from the CPU "
                                 f"run by {err}")
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            gen.generate(batch)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times[1:]))
        audio_s = B * M * 256 / 22050.0
        log(f"  TTS batch {tag} ({B} x {n} phonemes, {M} frames): "
            f"generate() {ms:.3f} ms (median of 5) for {audio_s:.2f} s of "
            f"audio = {audio_s / (ms / 1e3):.1f} audio-s per s; mel vs CPU "
            f"(first 2) {err:.3g} (<= {TOL_TTS_MEL}); launches "
            + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
        device_busy_in_turns(lambda: gen.generate(batch),
                             f"TTS generate batch {tag}")
    if runs["B"]["fused_attention"] <= 0:
        raise AssertionError("the 1040-frame TTS decoder did not take the "
                             "head-major attention")
    return runs


# ---------------------------------------------------------------------------
# alternates phase: the verified alternate backends #6 and #3
# ---------------------------------------------------------------------------

FFN_PER_UPDATE = 24      # 12 encoder layers x 2 FFNs, one encoder pass
ALIBI_SHAPE = (8, 8, 240)


def set_fused_ffn_(model, fused: bool):
    """Set every encoder layer's ``ffn1.fused`` / ``ffn2.fused``: measurement
    code, not a config field (no JAX config sets the field either)."""
    for layer in model.encoder.layers:
        layer.ffn1.fused = layer.ffn2.fused = fused
    return model


def alibi_bias(B, H, T):
    """[B, H, T, T] ALiBi-style bias -m_h |i - j| with the slopes
    m_h = 2^(-8 (h + 1) / H)."""
    m = 2.0 ** (-8.0 * torch.arange(1, H + 1) / H)
    i = torch.arange(T)
    dist = (i[None, :] - i[:, None]).abs().float()
    return (-m[:, None, None] * dist).expand(B, H, T, T).contiguous().cuda()


def alternates_phase():
    """``FeedForwardModule(fused=True)`` in the S2TT model of the training
    phase (Conformer 12L x 256d, F = 2048): fused vs unfused step at dropout 0
    and GLAT p = 0 (loss and every gradient), the fused run whose launches
    are read (24 forward and 24 backward FFN kernels per update), and the
    update ms both ways at cell T (dropout 0.1, GLAT 0.5); then
    ``fused_attention_full_bias`` on an ALiBi-style bias, forward and
    backward against the plain version. Returns each run's launches."""
    from daspeech_torch.models import S2TConformerDAG
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    cfg, no_drop = train_configs()
    model_cpu = init_random_(S2TConformerDAG(cfg), SEED)
    ref = S2TConformerDAG(no_drop)
    ref.load_state_dict(model_cpu.state_dict())
    ref.to(DEVICE)
    batch = make_train_batch(TRAIN_B, TRAIN_S, TRAIN_T, no_drop, SEED + 50,
                             DEVICE)
    loss_fn = loss_fn_for(no_drop, 0.0)
    lu, gu, _ = loss_and_grads(ref, batch, SEED, loss_fn)
    lf, gf, _ = loss_and_grads(set_fused_ffn_(ref, True), batch, SEED,
                               loss_fn)
    set_fused_ffn_(ref, False)
    dloss = abs(lf.item() - lu.item()) / abs(lu.item())
    gerr = grad_error([n for n, _ in ref.named_parameters()], gf, gu,
                      "fused_ffn_vs_unfused")
    log(f"  fused vs unfused FFN, S2TT B={TRAIN_B}, dropout 0, GLAT 0: loss "
        f"{lf.item():.6f} vs {lu.item():.6f}, rel diff {dloss:.3g} (<= "
        f"{TOL_LOSS}); worst per-parameter gradient rel diff {gerr:.3g} (<= "
        f"{TOL_GRAD})")
    if not (dloss <= TOL_LOSS and gerr <= TOL_GRAD):
        raise AssertionError("fused and unfused FFN steps disagree")
    del ref, gu, gf

    # --- cell T both ways, in turns (unfused, fused, fused, unfused), each
    # run 3 warm-up and 10 timed updates from the same weights; the first
    # fused run is the one whose launches are read
    runs, ms = {}, {"unfused": [], "fused": []}
    batch = make_train_batch(TRAIN_B, TRAIN_S, TRAIN_T, cfg, SEED + 4, DEVICE)
    for fused in (False, True, True, False):
        model = set_fused_ffn_(copy.deepcopy(model_cpu).to(DEVICE), fused)
        opt = GuardedAdam()
        state = TrainState.create(model, opt)
        step = make_train_step(loss_fn_for(cfg, 0.5), opt)
        tag = "fused" if fused else "unfused"
        med, iqr, launches, peak, _ = timed_updates(
            step, state, batch, 3, 10,
            f"S2TT T, encoder FFN {tag} (B={TRAIN_B}, dropout 0.1, GLAT 0.5)")
        ms[tag].append((med, iqr, peak))
        runs.setdefault(tag, launches)
        del model, state, step
    per = {n: runs["fused"][n] / 13 for n in ("fused_ffn", "fused_ffn_bwd")}
    log(f"  fused_ffn launches per update: forward {per['fused_ffn']:g}, "
        f"backward {per['fused_ffn_bwd']:g} (expected {FFN_PER_UPDATE} each);"
        " update ms (median, IQR, peak GiB) in turns: "
        + "; ".join(f"{tag} " + ", ".join(
            f"{m:.3f} ({q[0]:.3f}-{q[1]:.3f}, {pk:.2f})" for m, q, pk in v)
            for tag, v in ms.items()))
    if per != {"fused_ffn": FFN_PER_UPDATE, "fused_ffn_bwd": FFN_PER_UPDATE}:
        raise AssertionError(f"fused_ffn launches per update {per}")
    if any(runs["unfused"][n] for n in ALTERNATE_KERNELS):
        raise AssertionError("the unfused run launched an alternate kernel")

    # --- the full-bias attention on an ALiBi-style bias, through the op
    B, H, T = ALIBI_SHAPE
    g = torch.Generator().manual_seed(SEED + 51)
    q = _randn(g, B, H, T, 64)
    k, v, do = (_randn(g, B, H, T, 64) for _ in range(3))
    bias4 = alibi_bias(B, H, T)
    ins = [t.requires_grad_(True) for t in (q, k, v, bias4)]
    reset_launches()
    out = fa.fused_attention_full_bias(*ins, 1234, 0.125, 0.1, True)
    got = torch.autograd.grad(out, ins, do)
    torch.cuda.synchronize()
    runs["full_bias"] = read_launches()
    seed = torch.tensor([1234], dtype=torch.int32, device=DEVICE)
    plain = [t.detach() for t in ins]
    err = max(_max_err(out, fa.attention_full_bias_plain(*plain, 0.125, 0.1,
                                                          seed)),
              _max_err(got, fa.attention_full_bias_bwd_plain(
                  *plain, do, 0.125, 0.1, seed)))
    n_fb = (runs["full_bias"]["fused_attention_full_bias"],
            runs["full_bias"]["fused_attention_full_bias_bwd"])
    log(f"  fused_attention_full_bias, ALiBi bias [{B},{H},{T},64] p=0.1: "
        f"forward and backward against the plain version {err:.3g} (<= "
        f"{TOL_KERNEL}); launches forward {n_fb[0]}, backward {n_fb[1]}")
    if not (err <= TOL_KERNEL and n_fb == (1, 1)):
        raise AssertionError("full-bias attention through the op failed")
    # its training forward beside SDPA's on the same bias (timed only)
    fwd = functools.partial(fa.attention_fb_fwd_kernel, *plain, 0.125, 0.1,
                            seed, with_stats=True)
    lib = functools.partial(torch.nn.functional.scaled_dot_product_attention,
                            *plain[:3], attn_mask=plain[3], dropout_p=0.1,
                            scale=0.125)
    log(f"  fused_attention_full_bias, ALiBi bias [{B},{H},{T},64] p=0.1, "
        f"training forward: kernel {cuda_ms(fwd):.4f} ms"
        + ("" if not PARENT else f"  parent tree {parent_ms(fwd):.4f} ms")
        + f"  SDPA {cuda_ms(lib):.4f} ms")
    # its training forward is the FMA kernel's: no SIMT attention forward
    # on this path either (three steps in the profile: a session this short
    # and this late in the run can lose its only kernels)
    def steps():
        for _ in range(3):
            torch.autograd.grad(fa.fused_attention_full_bias(
                *ins, 1234, 0.125, 0.1, True), ins, do)

    steps()
    fma_forward_only(device_busy(steps, "three full-bias attention steps "
                                 "(ALiBi)"), "full-bias attention steps")
    return runs, ms


# ---------------------------------------------------------------------------
# decode-strategy phase: Viterbi, joint-Viterbi, beam search, the length
# beam and iterative refinement on the serving phase's model
# ---------------------------------------------------------------------------

# (tag, serving batch, generator, DecodeConfig fields). Beam search is S2T
# only, at the reference's defaults (beamsize 100, top_cand_n 5, top_p 0.9,
# alpha 1.1); at serving B (1040 mel frames) FastSpeech 2 takes #2
DECODE_RUNS = (
    ("viterbi A", "A", "s2s", {"strategy": "viterbi"}),
    ("jointviterbi A", "A", "s2s", {"strategy": "jointviterbi"}),
    ("viterbi B", "B", "s2s", {"strategy": "viterbi"}),
    ("jointviterbi B", "B", "s2s", {"strategy": "jointviterbi"}),
    ("beamsearch A", "A", "s2t", {"strategy": "beamsearch"}),
    ("length_beam=3 A", "A", "s2s", {"length_beam": 3}),
    ("iter_decode_max_iter=2 A", "A", "s2s", {"iter_decode_max_iter": 2}),
)
# the kernels every decode run launches (DAG decoder, links, encoder)
DECODE_KERNELS = ("fused_attention_packed", "fused_extract_links",
                  "fused_attention_relpos")


def decoder_outputs(model, fbank, lens, prev):
    """(logits, links) of the generators' encoder + decoder pass."""
    from daspeech_torch.decode.generator import decoder_pass

    return decoder_pass(model, fbank, lens, prev, None)[:2]


def length_beam_inputs(model, fbank, lens, prev, vocab, beam):
    """(logits, links, graph inputs) of the length beam's B * beam
    candidates, from the generators' own decoder pass."""
    from daspeech_torch.decode.generator import decoder_pass

    logits, links, _, prev_b = decoder_pass(model, fbank, lens, prev, vocab,
                                            beam)
    return logits, links, prev_b


def viterbi_path_score(logits, links, ol, path, pred_len, dc, joint):
    """The penalised Viterbi score of each row's given path (as
    ``viterbi_path`` returns it) under these logits and links."""
    tok = dc.beta * torch.log_softmax(logits.float(), -1).max(-1).values
    links = links.float().clamp_min(-1e9)
    out = []
    for b in range(logits.shape[0]):
        n = int(pred_len[b])
        vs = path[b, :n].flip(0).tolist()
        sc = float(links[b, 0, vs[0]] + tok[b, vs[0]])
        sc += float(tok[b, 0]) if joint else 0.0
        for u, v in zip(vs[:-1], vs[1:]):
            sc += float(links[b, u, v]) + (float(tok[b, v]) if joint else 0.0)
        sc += float(links[b, vs[-1], int(ol[b]) - 1])
        out.append(sc / n ** dc.viterbibeta)
    return out


def beam_hypothesis_score(logits, links, ol, toks, dc, pad):
    """The best penalised beam-search score, under these logits and links
    (one row), of a path that emits exactly the tokens ``toks``: a
    max-plus DP over (vertex, tokens emitted) through each vertex's
    candidates as ``beam_search`` prepares them (top_cand_n, top_p), in at
    most its number of steps; -inf where no such path exists."""
    from daspeech_torch.decode import beam_search as bs

    NEG, C = bs.NEG, int(dc.top_cand_n)
    L = logits.shape[1]
    logp = torch.log_softmax(logits[0].float(), -1)
    top_logits, top_tokens = bs.top_k(logp, C)
    cand = (links[0].float().clamp_min(NEG)[:, :, None]
            + dc.beta * top_logits[None, :, :])
    cs, cf = bs.top_k(cand.reshape(L, L * C), C)
    nxt, tok = cf // C, top_tokens.reshape(-1)[cf]               # [L, C]
    if dc.top_p < 1.0:
        p = torch.softmax(cs, -1)
        cs = torch.where(torch.cumsum(p, -1) - p < dc.top_p, cs, NEG)
    y, n = torch.as_tensor(toks, dtype=torch.int64), len(toks)
    if n == 0 or int(logp[0].argmax()) != int(y[0]):
        return -math.inf
    k = torch.arange(n + 1)
    # emits[i, c, k]: candidate c of vertex i emits after k tokens; it must
    # then emit y[k] (with dedup, a repeat of y[k - 1] emits nothing)
    emits = (tok != pad)[:, :, None].expand(L, C, n + 1)
    if dc.dedup:
        emits = emits & (tok[:, :, None] != y[(k - 1).clamp_min(0)])
    ok = ~emits | ((k < n) & (tok[:, :, None] == y[k.clamp_max(n - 1)]))
    k_new = (k + emits.long()).clamp_max(n)
    final = nxt[:, :, None] == int(ol[0]) - 1
    state = torch.full((L, n + 1), NEG)
    state[0, 1] = 0.0
    best = NEG
    for _ in range(dc.max_output_length or max(2, L // 2)):
        live = ok & (state[:, None, :] > NEG / 2) & (cs[:, :, None] > NEG / 2)
        new = torch.where(live, state[:, None, :] + cs[:, :, None], NEG)
        fin = new[final.expand_as(new) & (k_new == n)]
        if fin.numel():
            best = max(best, float(fin.max()) / n ** dc.alpha)
        new = torch.where(final, NEG, new)
        state = torch.full(((n + 1) * L,), NEG).scatter_reduce(
            0, (nxt[:, :, None] * (n + 1) + k_new).reshape(-1),
            new.reshape(-1), "amax").reshape(L, n + 1)
    return best if best > NEG / 2 else -math.inf


def lookahead_split_margin(model, model_cpu, fbank, lens, prev, vocab, b,
                           beta):
    """On one graph input: the top-2 margin, on the CPU, of the lookahead
    decision where row b's tokens first differ between card and CPU (inf
    where they agree)."""
    from daspeech_torch.decode.dag_decode import greedy_or_lookahead_decode

    outs = []
    for m, dev in ((model, DEVICE), (model_cpu, "cpu")):
        logits, links = decoder_outputs(m, fbank.to(dev), lens.to(dev),
                                        prev.to(dev))
        ol = (prev.to(dev) != vocab.pad).sum(1)
        outs.append((greedy_or_lookahead_decode(logits, links, ol, vocab.pad,
                                                beta), logits, links, ol))
    tg, tc = outs[0][0].tokens[b].cpu(), outs[1][0].tokens[b]
    if torch.equal(tg, tc):
        return math.inf
    s = int((tg != tc).nonzero()[0, 0])
    res, logits, links, ol = outs[1]
    v = int(res.feat_idx[b, s]) if s > 0 else 0
    return path_margin(logits, links, ol, b, v, beta)


def decode_margin(kind, dc, ctx, batch, b):
    """The CPU's own scores of the card's and the CPU's hypotheses of row
    b differ by this much: the penalised Viterbi score of the card's path
    against the CPU's best; the beam-search score of the card's tokens
    (:func:`beam_hypothesis_score`) against the CPU's best; the
    length beam's path score of the card's pick against the CPU's best, or
    (same pick) the lookahead margin there; refinement's lookahead margin
    at the first pass whose tokens differ."""
    from daspeech_torch.decode import beam_search as bs
    from daspeech_torch.decode import dag_decode as dd
    from daspeech_torch.decode.generator import (_strategy_decode,
                                                 length_beam_scores)

    model, model_cpu = ctx["model"], ctx["model_cpu"]
    vocab = ctx["cfg"].dag.vocab
    dev_in = {dev: [torch.as_tensor(batch[k], device=dev)
                    for k in ("fbank", "src_lengths", "prev_output_tokens")]
              for dev in (DEVICE, "cpu")}
    for dev in dev_in:
        dev_in[dev][1:] = [t.long() for t in dev_in[dev][1:]]
    ms = {DEVICE: model, "cpu": model_cpu}
    if dc.strategy in ("viterbi", "jointviterbi") and kind == "plain":
        joint = dc.strategy == "jointviterbi"
        got = {}
        for dev, m in ms.items():
            fbank, lens, prev = dev_in[dev]
            logits, links = decoder_outputs(m, fbank, lens, prev)
            ol = (prev != vocab.pad).sum(1)
            got[dev] = (logits, links, ol, dd.viterbi_path(
                logits, links, ol, dc.beta, dc.viterbibeta, joint,
                dc.max_output_length or max(2, prev.shape[1] // 4)))
        logits, links, ol, (_, _, _, best) = got["cpu"]
        path, pred_len = (t.cpu() for t in got[DEVICE][3][:2])
        card = viterbi_path_score(logits[b:b + 1], links[b:b + 1],
                                  ol[b:b + 1], path[b:b + 1],
                                  pred_len[b:b + 1], dc, joint)[0]
        return abs(float(best[b]) - card)
    if dc.strategy == "beamsearch":
        got = {}
        for dev, m in ms.items():
            fbank, lens, prev = dev_in[dev]
            logits, links = decoder_outputs(m, fbank, lens, prev)
            ol = (prev != vocab.pad).sum(1)
            got[dev] = (logits, links, ol, bs.beam_search(
                logits, links, ol, vocab.pad, vocab.bos,
                beam_size=int(dc.beamsize), top_cand_n=int(dc.top_cand_n),
                decode_beta=dc.beta, decode_alpha=dc.alpha, top_p=dc.top_p,
                dedup=dc.dedup, max_steps=dc.max_output_length or 0))
        logits, links, ol, (_, best) = got["cpu"]
        res = got[DEVICE][3][0]
        toks = res.tokens[b, :int(res.lengths[b])].cpu().tolist()
        card = beam_hypothesis_score(logits[b:b + 1], links[b:b + 1],
                                     ol[b:b + 1], toks, dc, vocab.pad)
        return abs(float(best[b]) - card)
    if kind == "length_beam":
        beam = int(dc.length_beam)
        sc, inputs = {}, None
        for dev, m in ms.items():
            fbank, lens, prev = dev_in[dev]
            logits, links, prev_b = length_beam_inputs(m, fbank, lens, prev,
                                                       vocab, beam)
            res = _strategy_decode(dc, vocab, logits, links, prev_b)
            sc[dev] = length_beam_scores(dc, logits, res, beam)[b].cpu()
            inputs = prev_b.cpu()
        pick, best = int(sc[DEVICE].argmax()), float(sc["cpu"].max())
        if pick != int(sc["cpu"].argmax()):
            return abs(best - float(sc["cpu"][pick]))
        fbank, lens, _ = dev_in["cpu"]
        row = b * beam + pick
        return lookahead_split_margin(
            model, model_cpu, fbank[b:b + 1], lens[b:b + 1],
            inputs[row:row + 1], vocab, 0, dc.beta)
    # refinement: walk the passes on the CPU's inputs
    fbank, lens, cur = dev_in["cpu"]
    for _ in range(1 + int(dc.iter_decode_max_iter)):
        m = lookahead_split_margin(model, model_cpu, fbank[b:b + 1],
                                   lens[b:b + 1], cur[b:b + 1], vocab, 0,
                                   dc.beta)
        if m < math.inf:
            return m
        logits, links = decoder_outputs(model_cpu, fbank, lens, cur)
        cur = dd.greedy_or_lookahead_decode(
            logits, links, (cur != vocab.pad).sum(1), vocab.pad,
            dc.beta).tokens
    return math.inf


def decode_stage(kind, gen, batch):
    """A function that runs the run's decode stage alone, on the
    decoder's outputs: the strategy (and, for the length beam, the
    candidates' scores and the pick); for refinement, the whole loop of
    passes (each re-runs the encoder and the decoder)."""
    from daspeech_torch.decode.generator import (_strategy_decode,
                                                 length_beam_scores)

    fbank, lens, prev = gen.to_device(batch)
    vocab, dc = gen.vocab, gen.cfg
    if kind == "refine":
        return lambda: gen.refine(fbank, lens, prev)
    if kind == "length_beam":
        beam = int(dc.length_beam)
        logits, links, prev_b = length_beam_inputs(gen.model, fbank, lens,
                                                   prev, vocab, beam)
        return lambda: length_beam_scores(dc, logits, _strategy_decode(
            dc, vocab, logits, links, prev_b), beam).argmax(1)
    logits, links = decoder_outputs(gen.model, fbank, lens, prev)
    return lambda: _strategy_decode(dc, vocab, logits, links, prev)


def host_ms(fn, reps=5):
    """Median host-clock ms of ``reps`` calls after a warm-up, each closed
    by a synchronize."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def decode_phase(ctx):
    """Every decode strategy but lookahead, the length beam and iterative
    refinement, through ``S2SNATGenerator`` (``S2TNATGenerator`` for beam
    search) on the serving phase's model and batches: each run's launches
    (#1, #4 and #5 in every run, #2 at B), tokens against a CPU run of the
    same weights (a row that differs must be a near tie of the CPU's own
    scores, within MARGIN), the mel within TOL_MEL, the decode stage's
    median host ms of 5 and its device kernels under ``torch.profiler``.
    Returns each run's launches."""
    from daspeech_torch.config import DecodeConfig
    from daspeech_torch.decode import S2SNATGenerator, S2TNATGenerator

    vocab = ctx["cfg"].dag.vocab
    model, model_cpu = ctx["model"], ctx["model_cpu"]
    runs = {}
    with torch.inference_mode():
        for tag, bt, which, fields in DECODE_RUNS:
            batch, M = ctx["batches"][bt]
            dc = DecodeConfig(**fields)
            kind = ("length_beam" if dc.length_beam > 1 else "refine"
                    if dc.iter_decode_max_iter > 0 else "plain")
            if which == "s2s":
                def make(m, v):
                    return S2SNATGenerator(m, vocab, dc, max_mel_len=M,
                                           vocoder=v)
                gen, gen_cpu = make(model, ctx["voc"]), make(model_cpu, None)
                _, d = durations_to_fill(gen, batch)
                set_durations_(model, d)
                set_durations_(model_cpu, d)
            else:
                gen = S2TNATGenerator(model, vocab, dc)
                gen_cpu = S2TNATGenerator(model_cpu, vocab, dc)
            reset_launches()
            hyps = gen.generate(batch)
            torch.cuda.synchronize()
            launches = runs[tag] = read_launches()
            want = DECODE_KERNELS + (("fused_attention",) if bt == "B"
                                     and which == "s2s" else ())
            missing = [n for n in want if launches[n] <= 0]
            if missing:
                raise AssertionError(f"decode {tag}: {missing} not launched")
            t0 = time.perf_counter()
            hyp_cpu = (gen_cpu.generate(batch, generate_waveform=False)
                       if which == "s2s" else gen_cpu.generate(batch))
            cpu_s = time.perf_counter() - t0
            margins, mel_err = [], 0.0
            for b, (hg, hc) in enumerate(zip(hyps, hyp_cpu)):
                if not np.array_equal(hg["tokens"], hc["tokens"]):
                    m = decode_margin(kind, dc, ctx, batch, b)
                    log(f"  decode {tag} sample {b}: tokens differ; the CPU's "
                        f"scores of the two hypotheses differ by {m:.3g}")
                    if not m <= MARGIN:
                        raise AssertionError(
                            f"decode {tag} sample {b}: tokens differ, score "
                            f"gap {m} > {MARGIN}")
                    margins.append(m)
                elif which == "s2s" and hg["feature"].size:
                    if hg["feature"].shape != hc["feature"].shape:
                        raise AssertionError(f"decode {tag}: mel lengths "
                                             "differ between card and CPU")
                    mel_err = max(mel_err, float(
                        np.abs(hg["feature"] - hc["feature"]).max()))
                for key in ("feature", "waveform"):
                    if key in hg and not np.isfinite(hg[key]).all():
                        raise AssertionError(f"decode {tag}[{b}]: non-finite "
                                             f"{key}")
            if not mel_err <= TOL_MEL:
                raise AssertionError(f"decode {tag}: mel differs from the "
                                     f"CPU run by {mel_err}")
            stage = decode_stage(kind, gen, batch)
            ms = host_ms(stage)
            events, _ = profiled_kernels(stage, f"decode {tag}")
            same = ("identical" if not margins
                    else f"{len(margins)} near ties")
            log(f"  decode {tag}: tokens/utt "
                f"{[len(h['tokens']) for h in hyps]}; card vs CPU tokens "
                f"{same}, mel max abs diff {mel_err:.3g} (<= {TOL_MEL}; CPU run "
                f"{cpu_s:.1f} s); decode stage {ms:.3f} ms (median of 5), "
                f"{len(events)} device kernels; launches "
                + ", ".join(f"{n} {launches[n]}" for n in
                            (*DECODE_KERNELS, "fused_attention")))
    base = runs["viterbi A"]["fused_attention_relpos"]
    beam = runs["length_beam=3 A"]
    if (beam["fused_attention_relpos"] != base
            or beam["fused_extract_links"] != 1):
        raise AssertionError("the length beam's encoder or decoder ran more "
                             f"than once: {beam}")
    log(f"  length beam: encoder once ({base} rel-pos launches), links once "
        "over the B * 3 candidates")
    return runs


# ---------------------------------------------------------------------------
# vocoder-training phase: HiFi-GAN config_v1 against MPD + MSD
# ---------------------------------------------------------------------------

VOC_B, VOC_SEGMENT = 16, 8192   # hifi-gan config_v1.json batch, segment
VOC_PARITY_B = 2
VOC_WARM, VOC_TIMED = 3, 10
VOC_LEARN_STEPS, VOC_LEARN_FRACTION = 30, 0.9


def vocoder_batch(B, seed, mel_fn):
    """(mel [B, 32, 80], wav [B, 8192]) on the CPU: each waveform three
    tones of random pitch, level and phase in noise, its log-mel by
    ``mel_fn`` (the mel loss's own)."""
    rng = np.random.default_rng(seed)
    t = np.arange(VOC_SEGMENT) / 22050.0
    wav = sum(rng.uniform(0.1, 0.3, (B, 1)) * np.sin(
        2 * np.pi * rng.uniform(80, 4000, (B, 1)) * t
        + rng.uniform(0, 2 * np.pi, (B, 1))) for _ in range(3))
    wav = torch.from_numpy((wav + 0.01 * rng.normal(size=wav.shape))
                           .astype(np.float32))
    return mel_fn(wav), wav


def vocoder_train_phase():
    """``daspeech_torch.train.vocoder_train.VocoderTrainer`` at config_v1
    with MPD + MSD, fp32, TF32 off: one D + G update on the card against
    one on the CPU at B = 2 (losses within TOL_LOSS, gradients within
    TOL_GRAD of their norm); 3 warm-up and 10 timed updates at B = 16 x
    8192 samples, the D and G halves apart, peak memory, the device busy
    share of one profiled update; 30 updates on one batch that must bring
    the mel loss to <= 0.9 of its first value. Returns the launches of the
    timed run (no hand kernel is on this path)."""
    from daspeech_torch.config import HiFiGANConfig
    from daspeech_torch.train.vocoder_train import (VocoderTrainer,
                                                    make_mel_fn)

    cfg = HiFiGANConfig()
    mel_cpu = make_mel_fn(device="cpu")
    trainers = {dev: VocoderTrainer(cfg, make_mel_fn(device=dev), device=dev)
                for dev in (DEVICE, "cpu")}
    tr = trainers[DEVICE]

    def fresh(dev, seed=SEED + 60):
        return trainers[dev].init_state(torch.Generator().manual_seed(seed))

    def grads(state):
        named = [(f"gen.{n}", p) for n, p in state.gen.named_parameters()]
        named += [(f"{k}.{n}", p) for k in ("mpd", "msd")
                  for n, p in state.disc[k].named_parameters()]
        return [n for n, _ in named], [p.grad.detach().cpu() for _, p in
                                       named]

    # --- one update on the card and one on the CPU, same weights and batch
    mel, wav = vocoder_batch(VOC_PARITY_B, SEED + 61, mel_cpu)
    out = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        state, m = trainers[dev].train_step(fresh(dev), mel.to(dev),
                                            wav.to(dev))
        sync()
        out[dev] = ({k: v.item() for k, v in m.items()}, *grads(state))
        log(f"  vocoder update on {dev} (B={VOC_PARITY_B}): "
            + ", ".join(f"{k} {v:.6f}" for k, v in out[dev][0].items())
            + f" ({time.perf_counter() - t0:.1f} s)")
    (mg, names, gg), (mc, _, gc) = out[DEVICE], out["cpu"]
    dloss = max(abs(mg[k] - mc[k]) / abs(mc[k]) for k in ("d_loss",
                                                          "g_loss"))
    gerr = grad_error(names, gg, gc, "vocoder_update")
    log(f"  vocoder update, card vs CPU: D and G loss rel diff {dloss:.3g} "
        f"(<= {TOL_LOSS}); worst per-parameter gradient rel diff "
        f"{gerr:.3g} (<= {TOL_GRAD})")
    if not (dloss <= TOL_LOSS and gerr <= TOL_GRAD):
        log("  FAILED: vocoder update: card and CPU disagree")
        DISAGREEMENTS.append("vocoder update")

    # --- 3 warm-up and 10 timed updates at B = 16, counters from 0
    mel, wav = (t.to(DEVICE) for t in vocoder_batch(VOC_B, SEED + 62,
                                                    mel_cpu))
    state = fresh(DEVICE)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    times = {"D": [], "G": [], "update": []}
    for i in range(VOC_WARM + VOC_TIMED):
        sync()
        t0 = time.perf_counter()
        state, d_loss = tr.d_update(state, mel, wav)
        sync()
        t1 = time.perf_counter()
        state, m = tr.g_update(state, mel, wav)
        sync()
        t2 = time.perf_counter()
        if i >= VOC_WARM:
            for k, v in (("D", t1 - t0), ("G", t2 - t1), ("update", t2 - t0)):
                times[k].append(v * 1e3)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not all(math.isfinite(v.item()) for v in (d_loss, *m.values())):
        raise AssertionError(f"vocoder updates: non-finite losses {m}")
    stats = {k: np.percentile(v, [25, 50, 75]) for k, v in times.items()}
    log(f"  vocoder updates (B={VOC_B} x {VOC_SEGMENT}, config_v1, MPD + MSD)"
        f", median ms over {VOC_TIMED} (IQR): " + "; ".join(
            f"{k} {q[1]:.3f} ({q[0]:.3f}-{q[2]:.3f})"
            for k, q in stats.items())
        + f"; peak memory {peak:.2f} GiB; launches "
        + ", ".join(f"{k} {v}" for k, v in launches.items() if v))
    if launches["mrf_level"]:
        raise AssertionError("vocoder training launched the inference MRF "
                             "kernel")
    device_busy(lambda: tr.train_step(state, mel, wav), "vocoder update")

    # --- learning: VOC_LEARN_STEPS updates on one batch
    state = fresh(DEVICE, SEED + 63)
    first = None
    for _ in range(VOC_LEARN_STEPS):
        state, m = tr.train_step(state, mel, wav)
        first = m["g_mel"].item() if first is None else first
    last = m["g_mel"].item()
    log(f"  vocoder learning: mel loss {first:.4f} -> {last:.4f} over "
        f"{VOC_LEARN_STEPS} updates on one batch (<= {VOC_LEARN_FRACTION} "
        f"of the first); D loss {m['d_loss'].item():.4f}, G adversarial "
        f"{m['g_adv'].item():.4f}")
    if not last <= VOC_LEARN_FRACTION * first:
        raise AssertionError(f"vocoder mel loss {first} -> {last}")
    return launches, {k: (float(q[1]), float(q[0]), float(q[2]))
                      for k, q in stats.items()}, peak


# ---------------------------------------------------------------------------
# runtime phase
# ---------------------------------------------------------------------------

RT_A = (80, 440, 520)     # utterances, least and most fbank frames (serving A)
RT_B = (4, 1200)          # utterances, fbank frames (serving B)
RT_VOCAB = 128            # the recipe's phoneme vocabulary, rounded up
RT_FRAMES_PER_PHONE = 10  # fbank frames (10 ms) per target phoneme
RT_UPDATES = 8
RT_EVERY = 2              # log and save every RT_EVERY updates
RT_RESTART = 4            # the update whose checkpoint is resumed
RT_MAX_TOKENS = 12288     # 24 utterances of 512 frames: 5 batches an
#                           epoch, so that update 4's checkpoint sits
#                           mid-epoch
RT_DUR = 8                # mel frames per token of the served model
RT_MEL = 1040             # --max-mel-len: B's mels reach #2 (>= 798)
RT_CPU_UTTS = 2           # utterances of the CLI's CPU run
TOL_CLI_FEATURE = 1e-5    # CLI features against the in-process generator


def pack_npy_zip(path: Path, arrays):
    """Store ``arrays`` as .npy members of an uncompressed zip and return
    their ``zip:offset:length`` paths (the reference's packed layout,
    ``tests/test_data.py``)."""
    import io
    import zipfile

    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        for i, a in enumerate(arrays):
            buf = io.BytesIO()
            np.save(buf, a)
            zf.writestr(f"{i}.npy", buf.getvalue())
    with zipfile.ZipFile(path) as zf:
        return [f"{path}:{info.header_offset + len(info.FileHeader())}:"
                f"{info.file_size}" for info in zf.infolist()]


def write_runtime_data(root: Path, seed: int):
    """A CVSS-style S2ST data directory: ``vocab.txt`` (RT_VOCAB symbols),
    fbank [S, 80] N(0, 1) in a stored zip, target mels [M, 80] in another,
    phoneme targets of S / 10 random phonemes whose durations (4-12
    frames, a trailing 0 for EOS) sum to the mel length M, pitch and energy
    U(0, 2). Splits: ``train`` (the RT_A utterances), ``test`` (those and
    the RT_B ones) and ``test_cpu`` (the first RT_CPU_UTTS of ``test``).
    No config.yaml. Returns the number of test utterances."""
    import csv

    from daspeech_torch.data import Dictionary

    rng = np.random.default_rng(seed)
    d = Dictionary()
    for i in range(RT_VOCAB - d.nspecial):
        d.add_symbol(f"P{i}")
    d.save(root / "vocab.txt")
    n_a, lo, hi = RT_A
    lengths = [int(x) for x in rng.integers(lo, hi + 1, size=n_a)]
    lengths += [RT_B[1]] * RT_B[0]
    fbanks = [rng.normal(size=(s, 80)).astype(np.float32) for s in lengths]
    rows, mels = [], []
    for i, s in enumerate(lengths):
        n = s // RT_FRAMES_PER_PHONE
        dur = rng.integers(4, 13, size=n)
        mels.append(rng.normal(size=(int(dur.sum()), 80)).astype(np.float32))
        rows.append({
            "id": f"utt{i:03d}", "src_n_frames": str(s),
            "tgt_text": " ".join(d.symbols[int(t)] for t in rng.integers(
                d.nspecial, RT_VOCAB, size=n)),
            "tgt_n_frames": str(int(dur.sum())),
            "duration": " ".join(map(str, [*dur.tolist(), 0])),
            "pitch": " ".join(f"{x:.4f}" for x in rng.uniform(0, 2, n + 1)),
            "energy": " ".join(f"{x:.4f}" for x in rng.uniform(0, 2, n + 1)),
        })
    for r, src, tgt in zip(rows, pack_npy_zip(root / "fbank.zip", fbanks),
                           pack_npy_zip(root / "mel.zip", mels)):
        r["src_audio"], r["tgt_audio"] = src, tgt
    for split, part in (("train", rows[:n_a]), ("test", rows),
                        ("test_cpu", rows[:RT_CPU_UTTS])):
        with open(root / f"{split}.tsv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
            w.writeheader()
            w.writerows(part)
    return len(rows)


class collate_spy:
    """Wrap ``batcher.collate``: record each collated batch's indices and
    the ms it took (on the producer thread)."""

    def __init__(self, batcher):
        self.batcher, self.orig = batcher, batcher.collate
        self.indices, self.ms = [], []

    def __enter__(self):
        def collate(spec, idxs, **kw):
            t0 = time.perf_counter()
            out = self.orig(spec, idxs, **kw)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.indices.append(list(idxs))
            return out

        self.batcher.collate = collate
        return self

    def __exit__(self, *exc):
        self.batcher.collate = self.orig


class deterministic:
    """torch's deterministic algorithms (cuDNN's included) for the runtime
    phase's two training runs; an op without a deterministic version warns
    (collected, logged once each) instead of raising."""

    def __enter__(self):
        import warnings

        self.prev = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled(),
                     torch.backends.cudnn.deterministic,
                     torch.backends.cudnn.benchmark)
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        log("  torch's deterministic algorithms on")
        self._catch = warnings.catch_warnings(record=True)
        self.caught = self._catch.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        self._catch.__exit__(*exc)
        torch.use_deterministic_algorithms(self.prev[0],
                                           warn_only=self.prev[1])
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.prev[2:]
        msgs = sorted({str(w.message).split("\n")[0] for w in self.caught})
        for m in msgs:
            log(f"  deterministic-mode warning: {m}")


def rt_train(state, step, batcher, manager, epoch, start, losses, rec,
             on_save=None):
    """The training loop of the runtime phase, to RT_UPDATES updates: the
    train CLI's loop (``daspeech_torch.cli.train.train_loop``) from
    ``(epoch, start)``: batches through ``prefetch_epoch`` (collated and
    copied to the card from pinned memory on the producer thread), one
    update each, its dropout drawn from a generator seeded by the step;
    every RT_EVERY updates the metrics go through ``MetricsAggregator`` +
    ``JsonProgressLogger`` (stderr) and a checkpoint (with its metric and
    the next batch's position) through ``manager``, then ``on_save(step)``.
    Each update's loss goes to ``losses``; ``rec`` collects the data wait,
    the CUDA-event update times and the save times."""
    from daspeech_torch.cli.train import LoopConfig, train_loop
    from daspeech_torch.train.metrics import JsonProgressLogger

    stats = train_loop(
        state, step, batcher, DEVICE,
        LoopConfig(max_update=RT_UPDATES, seed=SEED + 100,
                   log_interval=RT_EVERY, save_interval_updates=RT_EVERY),
        manager=manager,
        logger=JsonProgressLogger(stream=sys.stderr, log_interval=RT_EVERY),
        start=(epoch, start), on_save=on_save)
    manager.wait_until_finished()
    losses.extend(stats.losses)
    for key, got in (("wait_ms", stats.wait_ms),
                     ("update_ms", stats.update_ms),
                     ("save_s", stats.save_s)):
        rec[key].extend(got)


def rt_state(cfg, seed):
    from daspeech_torch.models import S2SConformerDAGFastSpeech2
    from daspeech_torch.train import GuardedAdam, TrainState

    model = init_random_(S2SConformerDAGFastSpeech2(cfg), seed).to(DEVICE)
    opt = GuardedAdam(warmup_updates=10)
    return TrainState.create(model.train(), opt), opt


def hypos_of(out_dir: Path, d):
    """{utt id: token ids with <bos> in front (the generator's slot 0)}
    read back from ``hypos.txt``."""
    out = {}
    for line in (out_dir / "hypos.txt").read_text().splitlines():
        utt, _, text = line.partition("\t")
        out[utt] = np.concatenate([[d.bos()], d.encode_line(
            text, append_eos=False)]).astype(np.int64)
    return out


def runtime_phase(ctx, smi, algorithms=deterministic):
    """The runtime (data -> tasks -> train loop -> checkpoints -> CLI) on
    the card: a data directory written to disk, 8 updates of the joint
    model at config J through the task's batch iterator and the
    prefetcher, checkpoints every 2 updates, a resume from update 4's
    checkpoint that must reproduce updates 5-8 bit for bit and collate no
    skipped batch, averaging, and the generate CLI over the data directory
    from the serving model's checkpoint and a vocoder checkpoint, against
    the in-process generator and a CPU run of the CLI. ``algorithms`` is
    the context manager both training runs are made under (torch's
    deterministic algorithms unless the caller passes another). Returns
    the launches of the training run and of the CLI run."""
    import contextlib
    import io
    import shutil
    import tempfile

    from daspeech_torch.cli import generate
    from daspeech_torch.config import DecodeConfig, HiFiGANConfig
    from daspeech_torch.decode import S2SNATGenerator
    from daspeech_torch.tasks import NATSpeechToSpeechTask, TaskConfig
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step
    from daspeech_torch.train.checkpoint import (CheckpointManager,
                                                 average_checkpoints,
                                                 resume_position)
    from daspeech_torch.train.vocoder_train import VocoderTrainer

    def say(msg):          # every reading beside the card's name and limit
        log(f"  [{smi}] {msg}")

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="runtime_smoke_", dir=build))
    try:
        t0 = time.perf_counter()
        n_test = write_runtime_data(root, SEED)
        say(f"data directory written in {time.perf_counter() - t0:.2f} s:"
            f" {n_test} utterances ({RT_A[0]} of {RT_A[1]}-{RT_A[2]} fbank "
            f"frames, {RT_B[0]} of {RT_B[1]}), vocab {RT_VOCAB}, "
            f"{sum(p.stat().st_size for p in root.iterdir()) / 2**20:.1f} "
            "MiB")

        # --- training at config J through the task and the prefetcher
        cfg, _ = joint_configs()
        task = NATSpeechToSpeechTask.setup_task(TaskConfig(
            data_dir=str(root), max_tokens=RT_MAX_TOKENS))
        task.load_dataset("train")
        batcher = task.get_batch_iterator("train", seed=SEED + 1)
        plan = [len(batcher.batches_for_epoch(e)) for e in (1, 2, 3)]
        say(f"buckets: {[vars(s) for s in batcher.specs]}; batches per "
            f"epoch {plan}")
        state, opt = rt_state(cfg, SEED)
        step = make_train_step(joint_loss_fn(cfg, 0.5), opt)
        manager = CheckpointManager(root / "ckpt", keep_last=2)
        # keep_last=2 prunes update 4's checkpoint by update 8: the resume
        # reads a copy taken when it was committed
        resume_dir = root / f"ckpt_update{RT_RESTART}"
        resume_dir.mkdir()

        def keep_restart(s):
            if s == RT_RESTART:
                for suffix in (".pt", ".json"):
                    shutil.copy(manager.dir / f"checkpoint_{s}{suffix}",
                                resume_dir)

        rec = {"wait_ms": [], "update_ms": [], "save_s": []}
        losses = []
        with algorithms(), collate_spy(batcher) as spy:
            reset_launches()
            sync()
            t0 = time.perf_counter()
            rt_train(state, step, batcher, manager, 1, 0, losses, rec,
                     keep_restart)
            sync()
            train_s = time.perf_counter() - t0
            train_launches = read_launches()
        say(f"runtime training, config J, {RT_UPDATES} updates in "
            f"{train_s:.3f} s (saves included), update ms (CUDA events) "
            f"{np.round(rec['update_ms'], 3)}; losses {losses}")
        say(f"data wait per update: median "
            f"{np.median(rec['wait_ms']):.3f} ms (first "
            f"{rec['wait_ms'][0]:.3f}, all {np.round(rec['wait_ms'], 3)}); "
            f"collate per batch: median {np.median(spy.ms):.3f} ms over "
            f"{len(spy.ms)} batches")
        for name in TRAIN_KERNELS:
            if train_launches[name] <= 0:
                raise AssertionError(f"{name} was not launched by the "
                                     "runtime training run")
        kept = manager.all_steps()
        best = manager._best_step()
        say(f"checkpoints kept {kept} (keep_last=2, best {best})")
        if kept != sorted({best, RT_UPDATES - RT_EVERY, RT_UPDATES}):
            raise AssertionError(f"keep-last-2 pruning kept {kept}")
        ck_bytes = (manager.dir / f"checkpoint_{RT_UPDATES}.pt").stat().st_size
        say(f"checkpoint {ck_bytes} bytes ({ck_bytes / 2**30:.3f} "
            f"GiB: model, Adam moments and counts); save s (to the return "
            f"of a non-blocking save: the host copy) "
            f"{[round(s, 3) for s in rec['save_s']]}")
        want_params = {k: v.detach().cpu().clone()
                       for k, v in state.model.state_dict().items()}
        want_moments = [m.cpu() for m in
                        state.opt_state.mu + state.opt_state.nu]
        names = [n for n, _ in state.model.named_parameters()]
        del state

        # --- resume at update 4's position in a fresh model and optimizer
        resumed, opt2 = rt_state(cfg, SEED + 7)
        step2 = make_train_step(joint_loss_fn(cfg, 0.5), opt2)
        sync()
        t0 = time.perf_counter()
        CheckpointManager(resume_dir).restore(resumed, step=RT_RESTART)
        sync()
        restore_s = time.perf_counter() - t0
        epoch, start = resume_position(CheckpointManager(resume_dir))
        say(f"restore s {restore_s:.3f}; resuming at epoch "
            f"{epoch}, batch {start}, update {resumed.step}")
        again = losses[:RT_RESTART]
        with algorithms(), collate_spy(batcher) as spy2:
            rt_train(resumed, step2, batcher,
                     CheckpointManager(root / "ckpt_resumed"), epoch, start,
                     again, {"wait_ms": [], "update_ms": [], "save_s": []})
        order = [ix for e in range(1, epoch + 1)
                 for _, ix in batcher.batches_for_epoch(e)]
        skipped = order[:sum(plan[:epoch - 1]) + start]
        n_skipped_collated = sum(ix in skipped for ix in spy2.indices)
        first = spy2.indices[0] == order[len(skipped)]
        diffs = [float((a.float() - b.float()).abs().max()) for a, b in
                 zip(want_params.values(),
                     (v.detach().cpu() for v in
                      resumed.model.state_dict().values()))]
        mdiffs = [float((a - b.cpu()).abs().max()) for a, b in zip(
            want_moments, resumed.opt_state.mu + resumed.opt_state.nu)]
        same = (again == losses and not any(diffs) and not any(mdiffs))
        say(f"resumed updates {RT_RESTART + 1}-{RT_UPDATES}: losses "
            f"{again[RT_RESTART:]} against {losses[RT_RESTART:]}; parameters"
            f" max abs diff {max(diffs):.3g}, moments {max(mdiffs):.3g}: "
            f"{'bit-identical' if same else 'DIFFERENT'}; batches collated "
            f"while skipping {n_skipped_collated} (skipped "
            f"{len(skipped)}), first collated is the saved position: "
            f"{first}")
        if not same:
            raise AssertionError("the resumed run differs from the "
                                 "uninterrupted one")
        if n_skipped_collated or not first:
            raise AssertionError("the resume collated a skipped batch")
        del resumed

        # --- averaging the last 2 checkpoints
        t0 = time.perf_counter()
        avg = average_checkpoints(manager, last_n=2, keys=names)
        avg_s = time.perf_counter() - t0
        a, b = (manager.restore(step=s)["model"] for s in kept[-2:])
        bad = [n for n in names if not torch.equal(
            avg[n], ((a[n].double() + b[n].double()) / 2).float())]
        say(f"average of checkpoints {kept[-2:]}: {avg_s:.3f} s, "
            f"{len(avg)} tensors, {len(bad)} off the float64 mean")
        if bad or not all(torch.isfinite(v).all() for v in avg.values()):
            raise AssertionError(f"averaged checkpoints: {bad[:5]}")
        del avg, a, b

        # --- the generate CLI on the e2e phase's serving model
        serve_cpu = set_durations_(ctx["model_cpu"], RT_DUR)
        serve = copy.deepcopy(serve_cpu).requires_grad_(True)
        CheckpointManager(root / "serve").save(
            TrainState.create(serve, GuardedAdam()), 1)
        del serve
        voc_state = VocoderTrainer(HiFiGANConfig(), device="cpu").init_state(
            torch.Generator().manual_seed(SEED))
        voc_state.gen.load_state_dict(ctx["voc_cpu"].state_dict())
        CheckpointManager(root / "vocoder").save(voc_state, 1)
        del voc_state
        cli = [str(root), "--task", "nat_speech_to_speech",
               "--checkpoint-dir", str(root / "serve"),
               "--max-mel-len", str(RT_MEL)]
        out_gpu, out_cpu = root / "out_gpu", root / "out_cpu"
        buf = io.StringIO()
        reset_launches()
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = generate.main(cli + [
                "--vocoder-checkpoint", str(root / "vocoder"),
                "--results-path", str(out_gpu)])
        sync()
        cli_s = time.perf_counter() - t0
        cli_launches = read_launches()
        rec_out = json.loads(buf.getvalue().strip().splitlines()[-1])
        feats = {p.stem: np.load(p) for p in (out_gpu / "feat").glob("*.npy")}
        audio_s = sum(f.shape[1] for f in feats.values()) * 256 / 22050.0
        say(f"generate CLI: rc {rc}, {rec_out['generated']} "
            f"utterances in {cli_s:.3f} s wall (restores included), "
            f"{audio_s:.2f} s of audio = {audio_s / cli_s:.2f} audio-s per "
            f"wall-s; launches {cli_launches}")
        if rc != 0 or rec_out["generated"] != n_test or len(feats) != n_test:
            raise AssertionError(f"generate CLI: rc {rc}, {rec_out}")
        for name in SERVING_KERNELS + ("fused_attention",):
            if cli_launches[name] <= 0:
                raise AssertionError(f"{name} was not launched by the "
                                     "generate CLI")
        for utt, f in feats.items():
            wav, _ = generate.read_wav(out_gpu / "wav" / f"{utt}_pred.wav")
            if not (f.shape[0] == 80 and f.shape[1] <= RT_MEL
                    and np.isfinite(f).all()
                    and len(wav) == f.shape[1] * 256):
                raise AssertionError(f"CLI output of {utt}: feature "
                                     f"{f.shape}, {len(wav)} samples")
        long_mels = sorted(f.shape[1] for f in feats.values())[-RT_B[0]:]
        say(f"CLI mel frames: median "
            f"{np.median([f.shape[1] for f in feats.values()]):.0f}, the "
            f"{RT_B[0]} longest {long_mels}")

        # the in-process generator on the CLI's own batches
        d = task.tgt_dict
        cli_tokens = hypos_of(out_gpu, d)
        model = copy.deepcopy(serve_cpu).to(DEVICE).eval()
        gen = S2SNATGenerator(model, task.vocab, DecodeConfig(),
                              max_mel_len=RT_MEL)
        # the CLI's task: its default --max-tokens
        task = NATSpeechToSpeechTask.setup_task(TaskConfig(
            data_dir=str(root), max_tokens=generate.parse_args(
                [str(root)]).max_tokens))
        task.load_dataset("test")
        it = task.get_batch_iterator("test")
        worst, n_tok = 0.0, 0
        for spec, idxs in it.batches_for_epoch(0):
            hyps = gen.generate(it.collate(spec, idxs, pad_last=False),
                                generate_waveform=False)
            for local, h in zip(idxs, hyps):
                utt = it.dataset.rows[local]["id"]
                toks = h["tokens"][(h["tokens"] != d.bos())
                                   & (h["tokens"] != d.eos())
                                   & (h["tokens"] != d.pad())]
                if not np.array_equal(cli_tokens[utt][1:], toks):
                    raise AssertionError(f"{utt}: CLI tokens differ from "
                                         "the in-process generator's")
                n_tok += len(toks)
                worst = max(worst, float(np.abs(feats[utt]
                                                - h["feature"].T).max())
                            if h["feature"].size else 0.0)
        say(f"CLI against the in-process S2SNATGenerator on the CLI's own "
            f"batches (same buckets, batch axis unpadded): tokens identical "
            f"({n_tok} tokens), features max abs diff {worst:.3g} "
            f"({'bit-identical' if worst == 0 else 'not bit-identical'})")
        if not worst <= TOL_CLI_FEATURE:
            raise AssertionError(f"CLI features off by {worst}")
        del model, gen

        # the CLI on the CPU for RT_CPU_UTTS utterances
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = generate.main(cli + ["--gen-subset", "test_cpu",
                                      "--device", "cpu",
                                      "--results-path", str(out_cpu)])
        cpu_s = time.perf_counter() - t0
        cpu_tokens = hypos_of(out_cpu, d)
        ids = sorted(cpu_tokens)
        task.load_dataset("test_cpu")
        it = task.get_batch_iterator("test_cpu")
        spec = max(it.specs, key=lambda s: s.src)
        batch = it.collate(spec, list(range(len(ids))), pad_last=False)
        gen_cpu = S2SNATGenerator(serve_cpu, task.vocab, DecodeConfig(),
                                  max_mel_len=RT_MEL)
        margin = compare_tokens(
            gen_cpu, batch, [{"tokens": cli_tokens[u]} for u in ids],
            [{"tokens": cpu_tokens[u]} for u in ids])
        mel_err = max((float(np.abs(
            np.load(out_cpu / "feat" / f"{u}.npy") - feats[u]).max())
            for u in ids if np.array_equal(cpu_tokens[u], cli_tokens[u])
            and feats[u].size), default=0.0)
        say(f"CLI on the CPU ({len(ids)} utterances, rc {rc}, "
            f"{cpu_s:.1f} s): tokens "
            f"{'identical' if margin is None else 'near-tie differences'}"
            f", features max abs diff {mel_err:.3g}")
        if rc != 0 or not mel_err <= TOL_MEL:
            raise AssertionError(f"CPU CLI: rc {rc}, features off by "
                                 f"{mel_err}")
        return train_launches, cli_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# CLI phase
# ---------------------------------------------------------------------------

CLI_UPDATES = {"s1": 6, "s2": 4, "s3": 6}
CLI_RESTORE_TO = 9        # stage 3 resumed from its update-6 checkpoint
CLI_EVERY = 3             # stages 1 and 3 save (and 3 validates) this often
CLI_FREEZE = 2            # --encoder-freezing-updates of stage 1
CLI_DEV = 8               # utterances of the valid split
CLI_TTS_SENTENCES = 16    # --max-sentences of stage 2
CLI_VOC = (16, 3 * 8192 + 2048)   # vocoder TSV: waveforms, samples each
CLI_VOC_UPDATES = 20
TOL_CLI_LOSS = 1e-5       # stage 3's first update against make_train_step
LOG_ROUNDING = 5e-5       # the progress log's 4 decimals


def write_cli_data(root: Path, seed: int) -> int:
    """``write_runtime_data``'s directory plus the views the CLI phase
    reads, written with the port's ``prep_data``: ``train_long`` (the 80
    short utterances and the 4 of RT_B[1] fbank frames), ``dev`` (the first
    CLI_DEV) and ``vocoder.tsv`` over a stored zip of CLI_VOC[0] synthetic
    voiced waveforms (22.05 kHz). The S2TT and TTS tasks read the S2ST
    rows as they are. Returns the number of utterances."""
    from daspeech_torch.data.datasets import load_tsv
    from daspeech_torch.preprocess.prep_data import (pack_features_to_zip,
                                                     write_tsv)

    n = write_runtime_data(root, seed)
    rows = load_tsv(root / "test.tsv")
    write_tsv(rows, root / "train_long.tsv")
    write_tsv(rows[:CLI_DEV], root / "dev.tsv")
    rng = np.random.default_rng(seed + 5)
    t = np.arange(CLI_VOC[1]) / 22050.0
    wavs = []
    for _ in range(CLI_VOC[0]):
        phase = 2 * np.pi * np.cumsum(rng.uniform(90, 260) * (1 + 0.1 * t))
        wav = sum((0.4 / k) * np.sin(k * phase / 22050.0) for k in (1, 2, 3))
        wavs.append((wav + 0.01 * rng.normal(size=t.shape)).astype(
            np.float32))
    names = [f"voc{i:02d}" for i in range(len(wavs))]
    paths = pack_features_to_zip(wavs, names, root / "vocoder_wavs.zip")
    write_tsv([{"id": k, "audio": p} for k, p in zip(names, paths)],
              root / "vocoder.tsv")
    return n


def run_train_cli(argv, on_update=None):
    """``daspeech_torch.cli.train.main`` in-process: (rc, its JSON records,
    its stderr, the loop's statistics, wall s, peak GiB). Its stderr is
    copied to this script's log."""
    import contextlib
    import io

    from daspeech_torch.cli import train

    out, err, got = io.StringIO(), io.StringIO(), {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = train.main(argv, on_update=on_update,
                        on_stats=lambda s: got.update(stats=s))
    sync()
    wall = time.perf_counter() - t0
    for line in err.getvalue().splitlines():
        if "FutureWarning" not in line and "return all_reduce" not in line:
            log(f"    | {line}")
    records = [json.loads(x) for x in out.getvalue().splitlines()
               if x.startswith("{")]
    return (rc, records, err.getvalue(), got["stats"], wall,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def next_position(batcher, updates: int):
    """(epoch, batch) of the batch after ``updates`` batches from epoch 1."""
    epoch = 1
    while updates >= len(batcher.batches_for_epoch(epoch)):
        updates -= len(batcher.batches_for_epoch(epoch))
        epoch += 1
    return epoch, updates


def cli_phase(smi):
    """The command line on the card (module docstring, 14th item): the
    three recipe stages through ``daspeech_torch.cli.train.main``, stage 3
    resumed, stage 3 under torchrun (world 1, NCCL), the vocoder CLI, the
    evaluation pipeline, the parity CLI and the pinned copy. Returns stage
    3's launches (the ``cli_train`` path)."""
    import contextlib
    import io
    import shutil
    import socket
    import tempfile

    from daspeech_torch.cli import eval_pipeline, generate, parity, train
    from daspeech_torch.cli import train_vocoder
    from daspeech_torch.data import prefetch
    from daspeech_torch.tasks import NATSpeechToSpeechTask, TaskConfig

    def say(msg):          # every reading beside the card's name and limit
        log(f"  [{smi}] {msg}")

    def stage_line(tag, stats, wall, peak):
        ms = stats.update_ms[1:] or stats.update_ms
        tot = stats.run_totals()
        wait = stats.wait_ms[1:] or stats.wait_ms
        say(f"{tag}: {len(stats.update_ms)} updates, update ms (CUDA events,"
            f" first left out) median {np.median(ms):.3f} (first "
            f"{stats.update_ms[0]:.3f}); data_wait_ms per update "
            f"{np.mean(stats.wait_ms):.3f} (after the first "
            f"{np.mean(wait):.3f}), h2d_ms per batch "
            f"{np.mean(stats.h2d_ms):.3f}, input_wait_frac "
            f"{tot['input_wait_frac']}, h2d MB per update "
            f"{tot['h2d_mb_per_step']}; save s "
            f"{[round(x, 3) for x in stats.save_s]}; wall {wall:.2f} s; "
            f"peak memory {peak:.2f} GiB")

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="cli_smoke_", dir=build))
    try:
        t0 = time.perf_counter()
        n_utts = write_cli_data(root, SEED)
        say(f"CLI data written in {time.perf_counter() - t0:.2f} s: "
            f"{n_utts} utterances, splits train / train_long / dev, "
            f"vocoder TSV of {CLI_VOC[0]} x {CLI_VOC[1]} samples")
        base = [str(root), "--seed", str(SEED), "--max-tokens",
                str(RT_MAX_TOKENS), "--keep-last-checkpoints", "2"]

        # --- stage 1: S2TT DAG, the encoder frozen for 2 updates
        enc = {}

        def s1_hook(state, update, spec, metrics):
            if update > CLI_FREEZE + 1:
                return
            named = list(state.model.named_parameters())
            enc[update] = (
                {n: p.detach().cpu().clone() for n, p in named
                 if n.startswith("encoder.")},
                all(not m.any() for (n, _), m in zip(named,
                                                     state.opt_state.mu)
                    if n.startswith("encoder.")))

        rc, _, _, st1, wall, peak = run_train_cli(base + [
            "--task", "nat_speech_to_text", "--criterion", "nat_dag_loss",
            "--save-dir", str(root / "s1"), "--max-update",
            str(CLI_UPDATES["s1"]), "--save-interval-updates",
            str(CLI_EVERY), "--log-interval", str(CLI_EVERY),
            "--encoder-freezing-updates", str(CLI_FREEZE),
            "--weight-decay", "0", "--valid-subset", "none"], s1_hook)
        stage_line("stage 1 (S2TT, nat_dag_loss)", st1, wall, peak)
        frozen = all(torch.equal(a, enc[CLI_FREEZE][0][n])
                     for n, a in enc[1][0].items())
        moved = sum(not torch.equal(a, enc[CLI_FREEZE + 1][0][n])
                    for n, a in enc[CLI_FREEZE][0].items())
        say(f"stage 1 encoder: unchanged through update {CLI_FREEZE}: "
            f"{frozen}, Adam moments still 0: {enc[CLI_FREEZE][1]}; tensors "
            f"moved by update {CLI_FREEZE + 1}: {moved} of "
            f"{len(enc[1][0])}; checkpoints "
            f"{train.CheckpointManager(root / 's1').all_steps()}")
        if (rc != 0 or not frozen or not enc[CLI_FREEZE][1]
                or enc[CLI_FREEZE + 1][1] or moved < len(enc[1][0]) // 2):
            raise AssertionError("stage 1's encoder freezing")
        if train.CheckpointManager(root / "s1").all_steps() != [3, 6]:
            raise AssertionError("stage 1's checkpoints")

        # --- stage 2: FastSpeech 2 pretraining
        rc, _, _, st2, wall, peak = run_train_cli(base + [
            "--task", "text_to_speech", "--criterion", "fastspeech2",
            "--max-sentences", str(CLI_TTS_SENTENCES),
            "--save-dir", str(root / "s2"), "--max-update",
            str(CLI_UPDATES["s2"]), "--save-interval-updates", "1000",
            "--log-interval", str(CLI_UPDATES["s2"]),
            "--valid-subset", "none"])
        stage_line("stage 2 (FastSpeech 2)", st2, wall, peak)
        if rc != 0:
            raise AssertionError("stage 2")

        # --- stage 3: joint, from stages 1 and 2, validating every 3
        s3 = base + [
            "--task", "nat_speech_to_speech",
            "--criterion", "s2s_dag_fastspeech2_loss",
            "--training-strategy", "expect", "--train-subset", "train_long",
            "--valid-subset", "dev", "--load-pretrained-dag-from",
            str(root / "s1"), "--load-pretrained-fastspeech-from",
            str(root / "s2"), "--save-interval-updates", str(CLI_EVERY),
            "--validate-interval-updates", str(CLI_EVERY),
            "--log-interval", str(CLI_EVERY), "--save-dir", str(root / "s3")]
        per_update, first = [], {}
        before = [None]

        def s3_hook(state, update, spec, metrics):
            now = read_launches()
            per_update.append((update, spec.src, {
                k: now[k] - before[0][k] for k in now}))
            before[0] = now
            if update == 1:
                first["loss"] = metrics["loss"].item()

        copies = prefetch.COPIES["pinned"]
        reset_launches()
        before[0] = read_launches()
        rc, recs, _, st3, wall, peak = run_train_cli(
            s3 + ["--max-update", str(CLI_UPDATES["s3"])], s3_hook)
        launches = read_launches()
        stage_line("stage 3 (joint, expect)", st3, wall, peak)
        valid = [r["valid_loss"] for r in recs if r["tag"] == "valid"]
        n_copies = prefetch.COPIES["pinned"] - copies
        say(f"stage 3: valid_loss {valid}; batches copied through the pinned"
            f" path {n_copies}; launches {launches}")
        if rc != 0 or len(valid) != 2 or n_copies < CLI_UPDATES["s3"]:
            raise AssertionError(f"stage 3: rc {rc}, valid {valid}, "
                                 f"pinned copies {n_copies}")
        for update, src, d in per_update:
            missing = [k for k in TRAIN_KERNELS if d[k] <= 0]
            hm = (d["fused_attention"], d["fused_attention_bwd"])
            long = src >= RT_B[1]
            say(f"  update {update} (bucket {src} fbank frames): head-major "
                f"#2 forward / backward {hm[0]} / {hm[1]}")
            if missing or (long and min(hm) <= 0) or (not long and max(hm)):
                raise AssertionError(f"stage 3 update {update}: {missing} "
                                     f"not launched, #2 {hm}")
        if not any(src >= RT_B[1] for _, src, _ in per_update):
            raise AssertionError("stage 3 ran no long-bucket update")

        # its first update against make_train_step in-process
        run = train.build(train.parse_args(
            s3 + ["--max-update", str(CLI_UPDATES["s3"])]), DEVICE)
        spec, idxs = run.batcher.batches_for_epoch(1)[0]
        m = run.step(run.state, prefetch.consume(prefetch.to_device(
            run.batcher.collate(spec, idxs), DEVICE)),
            train.update_generator(SEED, 0, 0))
        ref = m["loss"].item()
        rel = abs(first["loss"] - ref) / abs(ref)
        say(f"stage 3 update 1 loss: CLI {first['loss']!r}, in-process "
            f"make_train_step {ref!r}: relative {rel:.3g} (<= "
            f"{TOL_CLI_LOSS})")
        if not rel <= TOL_CLI_LOSS:
            raise AssertionError("stage 3's first update")
        restart = next_position(run.batcher, CLI_UPDATES["s3"])
        del run, m
        torch.cuda.empty_cache()

        # --restore to CLI_RESTORE_TO
        rc, recs, err, st9, wall, peak = run_train_cli(
            s3 + ["--max-update", str(CLI_RESTORE_TO), "--restore"])
        msg = (f"restored checkpoint at step {CLI_UPDATES['s3']} (epoch "
               f"{restart[0]}, batch {restart[1]})")
        stage_line(f"stage 3 resumed to {CLI_RESTORE_TO}", st9, wall, peak)
        say(f"stage 3 --restore: {msg!r} in its stderr: {msg in err}; "
            f"done at update {recs[-1]['update']}")
        if rc != 0 or msg not in err or recs[-1]["update"] != CLI_RESTORE_TO:
            raise AssertionError("stage 3's restore")

        # --- stage 3 under torchrun, world 1 (NCCL)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        ddp = list(s3) + ["--max-update", "1"]
        for flag, value in (("--valid-subset", "none"),
                            ("--save-dir", str(root / "ddp")),
                            ("--log-interval", "1")):
            ddp[ddp.index(flag) + 1] = value
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "1", "--master_addr", "127.0.0.1",
               "--master_port", str(port), "-m", "daspeech_torch.cli.train",
               *ddp]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                              capture_output=True, text=True, timeout=900)
        ddp_s = time.perf_counter() - t0
        recs = [json.loads(x) for x in proc.stdout.splitlines()
                if x.startswith("{")]
        if proc.returncode != 0 or not recs:
            log(proc.stderr[-4000:])
            raise AssertionError(f"torchrun stage 3: rc {proc.returncode}")
        done = recs[-1]
        got = next(r["loss"] for r in recs if r.get("update") == 1
                   and not r.get("done"))
        diff = abs(got - first["loss"])
        say(f"stage 3 under torchrun (world 1, NCCL; {ddp_s:.1f} s with the "
            f"process start): update 1 loss {got} (logged to 4 decimals) "
            f"against {first['loss']!r}; world {done.get('world_size')}, "
            f"gradient all-reduces {done.get('grad_all_reduces')}, "
            f"BatchNorm syncs {done.get('bn_syncs')}")
        if (diff > TOL_CLI_LOSS * abs(first["loss"]) + LOG_ROUNDING
                or done.get("world_size") != 1
                or not done.get("grad_all_reduces")
                or done.get("bn_syncs", 0) < 2 * 12):
            raise AssertionError(f"torchrun stage 3: {done}")

        # --- the vocoder CLI
        voc_ms, last = [], [None]

        def voc_hook(state, update, metrics):
            sync()
            now = time.perf_counter()
            if last[0] is not None:
                voc_ms.append((now - last[0]) * 1e3)
            last[0] = now

        out = io.StringIO()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_vocoder.main([
                str(root / "vocoder.tsv"), "--save-dir", str(root / "voc"),
                "--max-update", str(CLI_VOC_UPDATES), "--batch-size", "16",
                "--segment-size", "8192", "--log-interval",
                str(CLI_VOC_UPDATES), "--save-interval-updates",
                str(CLI_VOC_UPDATES), "--seed", str(SEED)],
                on_update=voc_hook)
        voc_s = time.perf_counter() - t0
        vrec = json.loads(out.getvalue().splitlines()[-1])
        say(f"vocoder CLI: {CLI_VOC_UPDATES} updates at B=16 x 8192 in "
            f"{voc_s:.2f} s (set-up and saves included); update ms (host "
            f"clock, synchronized, segments, copy and mel included) median "
            f"{np.median(voc_ms[2:]):.3f} over {len(voc_ms[2:])}; peak "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"last record {vrec}")
        if rc != 0 or not vrec.get("done"):
            raise AssertionError("vocoder CLI")

        # --- the evaluation pipeline, generate and parity, on stage 3's
        # last 2 checkpoints shaped as the serving phase shapes its random
        # model (after 9 updates the graph decodes to no token, and the
        # predicted durations round to 0 frames: no mel to hold)
        from daspeech_torch.models import S2SConformerDAGFastSpeech2

        task = NATSpeechToSpeechTask.setup_task(TaskConfig(
            data_dir=str(root)))
        model = S2SConformerDAGFastSpeech2(generate.build_model_cfg(
            "s2s_dag_fastspeech2_loss", None, task.vocab))
        served = train.CheckpointManager(root / "served")
        for step in train.CheckpointManager(root / "s3").all_steps()[-2:]:
            model.load_state_dict(train.CheckpointManager(
                root / "s3").restore(step=step)["model"])
            shape_random_decoder_(model, SEED)
            set_durations_(model, RT_DUR)
            served.save({"model": model.state_dict()}, step)
        del model
        common = ["--max-tokens", str(RT_MAX_TOKENS), "--max-mel-len",
                  str(RT_MEL), "--average-last-n", "2",
                  "--vocoder-checkpoint", str(root / "voc")]
        pipe = [str(root), "--checkpoint-dir", str(root / "served"),
                "--gen-subset", "dev", *common]
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = eval_pipeline.main(pipe + ["--skip-asr", "--results-path",
                                            str(root / "pipe")])
        pipe_s = time.perf_counter() - t0
        prec = json.loads(out.getvalue().splitlines()[-1])
        wavs = sorted((root / "pipe" / "wav").glob("*_pred.wav"))
        frames = [np.load(f).shape[1] for f in
                  sorted((root / "pipe" / "feat").glob("*.npy"))]
        say(f"eval pipeline (--skip-asr, average of the last 2 of stage 3, "
            f"{RT_DUR} frames a token; the vocoder CLI's checkpoint): rc "
            f"{rc}, {len(wavs)} waveforms, mel frames {frames}, wall "
            f"{pipe_s:.2f} s; {prec}")
        if rc != 0 or len(wavs) != CLI_DEV or min(frames) <= 0:
            raise AssertionError("eval pipeline")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = generate.main([
                str(root), "--task", "nat_speech_to_speech",
                "--checkpoint-dir", str(root / "served"), "--gen-subset",
                "dev", "--results-path", str(root / "gen"), *common])
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc2 = parity.main([str(root), "--skip-generate", "--skip-asr",
                               "--results-path", str(root / "pipe"),
                               "--reference-results", str(root / "gen")])
        par = json.loads(out.getvalue().splitlines()[-1])
        say(f"parity CLI (pipeline against generate with the same "
            f"arguments): {par}")
        if (rc or rc2 or par.get("token_exact_match") != 1.0
                or par.get("mel_mse") != 0.0):
            raise AssertionError(f"parity: {par}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = eval_pipeline.main(pipe + ["--results-path",
                                            str(root / "pipe_asr")])
        arec = json.loads(out.getvalue().splitlines()[-1])
        say(f"eval pipeline with the ASR stage: {arec}")
        if rc != 0 or arec.get("asr_bleu", "") is not None or not arec.get(
                "note"):
            raise AssertionError(f"eval pipeline ASR stage: {arec}")

        # --- the pinned copy: every batch of one epoch, bit for bit
        task = NATSpeechToSpeechTask.setup_task(TaskConfig(
            data_dir=str(root), max_tokens=RT_MAX_TOKENS))
        task.load_dataset("train_long")
        batcher = task.get_batch_iterator("train_long", seed=SEED)
        hosts = [batcher.collate(spec, idxs)
                 for spec, idxs in batcher.batches_for_epoch(1)]
        nbytes = [sum(v.nbytes for v in h.values()) for h in hosts]
        pinned, plain = ([], []), []
        for turn in (0, 1):      # the staging ring grows in the first pass
            for host in hosts:
                sync()
                t0 = time.perf_counter()
                dev = prefetch.consume(prefetch.to_device(host, DEVICE))
                sync()
                pinned[turn].append((time.perf_counter() - t0) * 1e3)
                if turn:
                    t0 = time.perf_counter()
                    ref = {k: torch.from_numpy(v).to(DEVICE)
                           for k, v in host.items()}
                    sync()
                    plain.append((time.perf_counter() - t0) * 1e3)
                    del ref
                for k, v in host.items():
                    if not torch.equal(dev[k].cpu(),
                                       torch.from_numpy(v).to(dev[k].dtype)):
                        raise AssertionError(f"pinned copy of {k} differs")
                del dev
        mb = np.median(nbytes) / 2 ** 20
        say(f"pinned copy: the {len(hosts)} batches of one epoch, twice, "
            f"equal their numpy collate bit for bit; ms per batch (host "
            f"clock, synchronized, medians) pinned {np.median(pinned[1]):.3f}"
            f" (first pass, the ring growing: {np.median(pinned[0]):.3f}), "
            f"plain .to(device) {np.median(plain):.3f}; MB per batch "
            f"{mb:.2f} (largest {max(nbytes) / 2**20:.2f}): "
            f"{np.median(nbytes) / np.median(pinned[1]) / 1e6:.2f} GB/s "
            f"pinned, {np.median(nbytes) / np.median(plain) / 1e6:.2f} "
            f"plain")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


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

    parent = None
    if "--parent" in sys.argv:
        # another checkout (the parent commit), whose kernels are built
        # beside this tree's and timed beside the redesigned rows
        root = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
        parent = threading.Thread(target=lambda: PARENT.update(
            build=_build.build(root / "daspeech_torch" / "csrc",
                               root / "build" / "daspeech_torch")))
        parent.start()
    built = _build.build()
    log(f"kernels built in {built.seconds:.1f} s -> {built.path}")
    if built.ptxas:
        log(built.ptxas.strip())
        for name, n in SPILL_CHECKED.items():
            no_spills(built.ptxas, name, n)
    _build.library()
    if parent is not None:
        parent.join()
        PARENT["lib"] = _build.load(PARENT["build"].path)
        log(f"parent tree's kernels built in {PARENT['build'].seconds:.1f} s "
            f"-> {PARENT['build'].path}")
    if b"15attn_fwd_kernel" in built.path.read_bytes():
        raise AssertionError("a SIMT attention forward (attn_fwd_kernel) is "
                             "in the kernel library")
    sass = sass_counts(built.path)
    log(f"HMMA and FFMA instructions in the SASS of attention_tc.cuh's "
        "kernels, of the FMA forward, of the link extraction and of #6's "
        "and #7's kernels: "
        + ("cuobjdump not found, not checked" if sass is None else str(sass)))
    if sass is not None:
        fma_names = {f"{FMA_FORWARD}{i}" for i in FMA_INSTANCES} | set(
            LINKS_FMA)
        tc = {n: c for n, c in sass.items() if n not in fma_names}
        fma = {n: c for n, c in sass.items() if n in fma_names}
        if ({n.split("<")[0] for n in tc} != {*TC_KERNELS, *LINKS_TC,
                                               *GEMM_TC}
                or not all(c["HMMA"] for c in tc.values())):
            raise AssertionError(f"tensor-core kernels without HMMA: {tc}")
        if (set(fma) != fma_names
                or any(c["HMMA"] or not c["FFMA"] for c in fma.values())):
            raise AssertionError(f"FMA kernels not on the FMA pipes: {fma}")

    log("kernel phase:")
    cases = kernel_phase()
    log("end-to-end phase (serving):")
    serving, mels, ctx = e2e_phase()
    log("training phase (S2TT):")
    training = train_phase()
    log("joint S2ST training phase:")
    joint = joint_phase()
    log("FastSpeech 2 pretraining phase:")
    pretrain = fs2_phase()
    log("vocoder-mode phase:")
    vocoder, voc_cpu = vocoder_phase(mels)
    log("TTS phase:")
    tts = tts_phase(voc_cpu)
    log("alternates phase (#6 fused FFN, #3 full-bias attention):")
    alternates, _ = alternates_phase()
    log("decode-strategy phase:")
    decoding = decode_phase(ctx)
    log("vocoder-training phase:")
    voc_train, _, _ = vocoder_train_phase()
    log("runtime phase (data, tasks, train loop, checkpoints, generate CLI):")
    rt_train_launches, cli_launches = runtime_phase(ctx, smi)
    del ctx
    log("CLI phase (the three recipe stages, resume, torchrun, vocoder, "
        "pipeline, parity, pinned copy):")
    cli_train = cli_phase(smi)

    # launches: each kernel's count is that of the run of the path it was
    # ported for (the forward kernels of the first slice: serving; the
    # second slice's: the S2TT training run; the head-major attention: the
    # joint step at J-long; the MRF level: the fused-mode vocoder run; the
    # fused FFN: the fused S2TT updates; the full-bias attention: the ALiBi
    # run); every path's count is kept
    by_path = {"serving": serving, "training": training,
               "joint_J": joint["J"], "joint_J-long": joint["J-long"],
               "fs2_pretraining": pretrain, "vocoder_fused": vocoder,
               "tts_A": tts["A"], "tts_B": tts["B"],
               **{f"decode {tag}": v for tag, v in decoding.items()},
               "vocoder_training": voc_train,
               "runtime_train": rt_train_launches,
               "cli_generate": cli_launches, "cli_train": cli_train}
    # the alternate backends launch on no other path
    stray = {(p, n): v[n] for p, v in by_path.items()
             for n in ALTERNATE_KERNELS if v[n]}
    if stray:
        raise AssertionError(f"alternate kernels launched elsewhere: {stray}")
    log(f"  {', '.join(ALTERNATE_KERNELS)}: 0 launches on every other path")
    # serving runs inference forwards only: no launch writes statistics
    serving_paths = ("serving", "vocoder_fused", "tts_A", "tts_B",
                     "cli_generate", *(f"decode {tag}" for tag in decoding))
    trained = {(p, n): by_path[p][f"{n} training"] for n in TRAIN_FORWARDS
               for p in serving_paths if by_path[p][f"{n} training"]}
    if trained:
        raise AssertionError(f"training forwards on serving paths: {trained}")
    log("  training forwards on the serving, vocoder, TTS, decode-strategy "
        "and CLI paths: 0")
    by_path.update({"alternates_ffn": alternates["fused"],
                    "alternates_full_bias": alternates["full_bias"]})
    kernels = []
    for name, shapes in cases.items():
        src, replaces = KERNELS[name]
        first = shapes[0]
        main_path = ("joint_J-long" if name in ("fused_attention",
                                                "fused_attention_bwd")
                     else "vocoder_fused" if name == "mrf_level"
                     else "alternates_ffn" if name.startswith("fused_ffn")
                     else "alternates_full_bias" if "full_bias" in name
                     else "serving" if name in SERVING_KERNELS
                     else "training")
        train = ({"training_launches": by_path[main_path][f"{name} training"],
                  "training_launches_by_path": {
                      k: v[f"{name} training"] for k, v in by_path.items()}}
                 if name in TRAIN_FORWARDS else {})
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": by_path[main_path][name],
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            **train,
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "shapes": shapes})
    if DISAGREEMENTS:
        raise AssertionError(f"card and CPU steps disagree: {DISAGREEMENTS}")
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
