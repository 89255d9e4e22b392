"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--parent DIR]

(``--parent DIR``: another checkout of the repository, typically the parent
commit unpacked with ``git archive``; its kernels are built too, and the
kernel phase times the rows of the kernels redesigned since (the training
forward of #1, #2, #3 and #5, the link extraction #4 forward and backward,
the DP #8 and the Viterbi #9, the fused FFN #6 forward and backward and
the MRF level #7, and the bf16 rows of #1 to #7) with its library
as well, on the same inputs in the same process (#6's and #7's with its
own wrappers too, whose scratch differs), and the bf16 phase's bf16
updates, the alternates phase's bf16 fused-FFN updates and the vocoder
rungs' bf16 fused-MRF runs with its kernels too, in turns.)

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
   and no spills in their ptxas report; bf16 HMMA
   (``HMMA.16816.F32.BF16``, and no other) in the SASS of the bf16
   attention kernels (attention_bf16.cuh), of the bf16 modes of #5 and #4
   (relpos_bf16.cuh, links_bf16.cuh) and of #6 and #7 (ffn_bf16.cuh,
   mrf_bf16.cuh), none in the fp32 modes' kernels of #6 and #7, and no
   spills in their ptxas report; with ``--parent``, the SASS of the fp32
   kernels of #5 and #4 the same as the parent tree's; the
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
   all-reduce and 24 BatchNorm reductions run), stage 3 under ``--fsdp``
   (a world of one: FSDP2 units, gathered checkpoints) in-process against
   the unsharded run over the same 4 updates (losses within 1e-4
   relative, update ms and peak memory of both) and under torchrun
   (update 1's loss), ``cli.train_vocoder`` (20
   updates at B=16 x 8192), ``cli.eval_pipeline --skip-asr
   --average-last-n 2`` over stage 3's last two checkpoints (shaped as the
   serving phase's decoder) with the vocoder CLI's checkpoint,
   ``cli.parity --skip-generate`` against ``cli.generate`` with the same
   arguments (tokens and mels equal), the pipeline's ASR stage
   (``"asr_bleu": null`` and its note without the model), and every batch
   of one epoch through the pinned copy against its numpy collate, bit
   for bit, timed against a plain ``.to(device)``; it prints the update
   ms, data wait, h2d, ``input_wait_frac``, save s and peak memory of
   each stage, each beside the card's name and power limit; and stages 1
   and 2 again under ``--dtype bfloat16``, 4 updates each, stage 2 then
   validating (stage 1's eval-BLEU needs sacrebleu), all finite;
15. bf16 phase (``--dtype bfloat16``; it runs after the pretraining
   phase): the bf16 entry points of #1, #2, #4 and #5 against their plain
   bf16 versions at cell T's, J-long's and a serving shape (inference and
   training forward and backward, within 2^-7 of the output's largest
   magnitude; #4's links within 1e-4 with the plain version's -inf
   pattern, its dgates fp32), #1's and #2's the three bf16 tensor-core
   kernels of attention_bf16.cuh, each once, and none of attention_tc.cuh's
   or attention_fma.cuh's, while their fp32 call still launches the FMA
   forward and attention_tc.cuh's backward; #5's and #4's the bf16 kernels
   of relpos_bf16.cuh and links_bf16.cuh, each once, and none of the fp32
   mode's, which their fp32 call launches as before (names and counts
   under the profiler; these rows are taken in a
   process of their own, the script run with ``--bf16-kernel-rows``;
   the bf16 rows of #7, #6 and #3 likewise, ``--bf16-alternate-rows``,
   #3's call the three kernels of attention_bf16.cuh's full-bias mode,
   each once, and none of the fp32 mode's, which its fp32 call launches),
   and one row each in the kernels' JSON (forward + backward: kernel,
   plain and SDPA ms in bf16, the bound at 989 TFLOP/s on the bf16
   bytes); the card's bf16 step against the CPU's at T (B=2) and J-long
   (B=1), dropout and GLAT off: ||card_bf16 - cpu_fp32|| <= 2
   ||cpu_bf16 - cpu_fp32|| over the gradients (each scaled by its fp32
   norm), each gradient within 8 times its own bar, the loss within it
   (floored at 2^-8 of the loss); 13 updates at T, J-long and P in fp32
   and then in bf16 (median of the last 10, device busy share of one
   profiled update, peak memory; every bf16 launch of #1, #2, #4 and #5
   on bf16 operands); 30 updates of S2TT at full width on one batch of
   16 at a constant lr in each dtype, the bf16 run ending within 5% of
   the fp32 one and below its first loss. No bf16 launch on any fp32 path
   (asserted);
16. AR and TTS-options phase (after the decode-strategy phase), at the
   recipe widths with random weights from a seed, fp32: ``at_tts``
   (``AutoRegressiveSpeechGenerator``, Transformer-TTS 4+4L x 256d) on
   TTS A's 8 x 52 phonemes for 1024 steps and ``at_s2s``
   (``MultiDecoderSpeechGenerator``, Conformer 12L x 256d, text decoder
   4L, synthesizer 2L, mel decoder 4L) on serving A's batch for 200 text
   and 1024 mel steps (the stop biases and the <eos> row placed by short
   probes on the card so that about half of the rows stop, and end,
   within 64 frames and 32 tokens), each checked against the CPU
   teacher-forced once on the card's buffer (every frame within 1e-3,
   every token the CPU's argmax or within 1e-4 of it, each stop step the
   CPU's or a near tie of the threshold within 1e-4), with ms per batch
   (at_tts: median of 5; at_s2s: the checked run), launches (#5 on
   at_s2s) and a profiled shorter run; the length beam of 3 at
   serving A reranked by the multi-decoder (scores within 1e-4 of the
   CPU's, decode-pass ms with and without the reranker, #5's launches);
   Griffin-Lim on serving A's mel (relative L2 within 1e-3 of the CPU's,
   each row alone equal to the batch bit for bit, ms); FastSpeech 2 with
   the Postnet, 4 speakers, ctc_weight 0.1 and the unfused attention at
   P's shape (a card-vs-CPU step at B=4, as the pretraining phase's;
   update ms unfused and on the kernels);
   and one card-vs-CPU step plus 5 timed updates each of
   ``tts_transformer_criterion`` (TTS A) and ``multidecoder_criterion``
   (serving A, #5 forward and backward);
17. banded phase (after the AR phase): ``nat_dag_loss`` with
   ``banded_dp`` (banded link extraction, the block-banded DP and Viterbi,
   ``max_transition_length`` 128) against the full-matrix masked path
   (#4 with the band, #8, #9) on the S2TT model at the recipe's widths,
   J-long's graph (B=14, L=700, T=128), dropout off, GLAT p 0.5: loss
   within 1e-4 relative, gradients within 1e-3 of their norm, glances
   equal or a near tie of the full path's decisions within 1e-4; a
   card-vs-CPU banded step at B=2; 3 + 10 timed updates each way with
   peak memory and launches (the banded run launches none of #4, #8, #9);
18. fused-vocab phase: ``fused_vocab_chunk=2048`` against the dense
   [B, L, V] logits at cell T's shape with a 10 000-entry vocabulary, on
   the same bars, with a card-vs-CPU step at B=2 and timed updates each
   way (every training kernel runs in both).

Traces go to ``build/profile/``. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the kernels'
JSON summary, and the nvidia-smi line comes before that. Any failed check
raises, a card-vs-CPU step's after the last phase (the phases after it
still run and report), and the script then exits non-zero and prints no
result, as it does without a CUDA device.
"""

from __future__ import annotations

import contextlib
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
# the bf16 modes of #7, #6 and #3 (the vocoder-rung and alternates phases)
BF16_ALTERNATES = ("mrf_level", *ALTERNATE_KERNELS)
# the sources of the bf16 modes that have kernels of their own (PR 20)
BF16_SOURCES = {"mrf_level": "daspeech_torch/csrc/mrf_bf16.cuh",
                "fused_ffn": "daspeech_torch/csrc/ffn_bf16.cuh",
                "fused_attention_packed":
                    "daspeech_torch/csrc/attention_bf16.cuh",
                "fused_attention": "daspeech_torch/csrc/attention_bf16.cuh",
                "fused_attention_relpos":
                    "daspeech_torch/csrc/relpos_bf16.cuh",
                "fused_extract_links": "daspeech_torch/csrc/links_bf16.cuh",
                "fused_attention_full_bias":
                    "daspeech_torch/csrc/attention_bf16.cuh"}


def launch_counters():
    """name -> the wrapper whose ``launches`` counts that kernel."""
    from daspeech_torch.telemetry import launch_counters as counters

    return counters()


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
        if hasattr(w, "bf16_launches"):
            w.bf16_launches = 0
        if hasattr(w, "cluster_launches"):
            w.cluster_launches.clear()


def read_launches():
    counters = launch_counters()
    launches = {n: w.launches for n, w in counters.items()}
    launches.update({f"{n} training": counters[n].train_launches
                     for n in TRAIN_FORWARDS})
    # of each count, the launches on bf16 operands (the bf16 entry points)
    launches.update({f"{n} bf16": counters[n].bf16_launches
                     for n in (*BF16_KERNELS, *BF16_KERNELS.values(),
                               *BF16_ALTERNATES)})
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
# the bf16 mode of #1 and #2 (attention_bf16.cuh): the forward (training
# and inference) and the two backward kernels, on the bf16 tensor cores
BF16_ATTN_KERNELS = ("attn_bf16_fwd_kernel", "attn_bf16_dq_kernel",
                     "attn_bf16_dkdv_kernel")
# the bf16 mode of #3: the same three kernels' full-bias mode
# (attention_bf16.cuh), each launched once by a training forward and
# backward
BF16_FB_KERNELS = ("attn_bf16_fb_fwd_kernel", "attn_bf16_fb_dq_kernel",
                   "attn_bf16_fb_dkdv_kernel")
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
# the bf16 modes of #5 and #4 on the bf16 tensor cores (relpos_bf16.cuh,
# links_bf16.cuh): the kernels of one training forward and backward, each
# launched once, and those of the fp32 mode's call
BF16_RELPOS_KERNELS = ("relpos_bf16_fwd_kernel", "relpos_bf16_ds_kernel",
                       "relpos_bf16_grad_kernel")
BF16_LINKS_KERNELS = ("links_bf16_lse_kernel", "links_bf16_fold_kernel",
                      "links_bf16_dq_kernel", "links_bf16_dk_kernel")
FP32_RELPOS_LAUNCH = {FMA_FORWARD: 1, "attn_tc_chunk_ds_kernel": 1,
                      "attn_tc_grad_kernel": 1}
FP32_LINKS_LAUNCH = {n: 1 for n in (*LINKS_FMA, *LINKS_TC)}
# the kernels of gemm_tc.cuh's tiles (tensor cores): the MRF level's conv
# (#7) and the fused FFN's forward, backward rows and weight gradients (#6)
GEMM_TC = ("mrf_conv_kernel", "ffn_fwd_kernel", "ffn_bwd_rows_kernel",
           "ffn_wgrad_kernel")
# the bf16 modes' kernels of #6 and #7 on the bf16 tensor cores
# (ffn_bf16.cuh, mrf_bf16.cuh), and the kernels their bf16 calls launch
BF16_GEMM_KERNELS = ("ffn_bf16_fwd_kernel", "ffn_bf16_rows_kernel",
                     "ffn_bf16_wgrad_kernel", "mrf_bf16_conv_kernel")
BF16_FFN_LAUNCH = {"ffn_bf16_fwd_kernel": 1, "ffn_bf16_rows_kernel": 1,
                   "ffn_bf16_wgrad_kernel": 1, "ffn_reduce_kernel": 1}
FP32_FFN_LAUNCH = {"ffn_fwd_kernel": 1, "ffn_bwd_rows_kernel": 1,
                   "ffn_wgrad_kernel": 1, "ffn_reduce_kernel": 1}
# a config_v1 level: the first pass and 18 convs
BF16_MRF_LAUNCH = {"mrf_bf16_act_kernel": 1, "mrf_bf16_conv_kernel": 18}
FP32_MRF_LAUNCH = {"mrf_conv_kernel": 18}
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


def parent_module(name):
    """The parent tree's ``daspeech_torch/ops/<name>.py``, loaded beside
    this tree's: it imports this tree's ``_build``, whose library
    :class:`parent_library` swaps for the parent's."""
    import importlib.util

    mods = PARENT.setdefault("modules", {})
    if name not in mods:
        path = PARENT["root"] / "daspeech_torch" / "ops" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    return mods[name]


# the wrappers whose scratch the parent tree sizes otherwise (the bf16 FFN's
# and MRF level's): within parent_library the parent tree's own
PARENT_WRAPPERS = (("fused_ffn", ("ffn_fwd_kernel", "ffn_bwd_kernel")),
                   ("fused_mrf", ("mrf_level_kernel",)))


class parent_library:
    """Within the block the wrappers launch the parent tree's kernels: the
    same wrappers call the same C entry points in its library, and the FFN's
    and the MRF level's kernel wrappers are the parent tree's (the ops call
    them by their module's name)."""

    def __enter__(self):
        import importlib

        from daspeech_torch.ops import _build

        self.build, self.own = _build, _build.library
        _build.library = lambda: PARENT["lib"]
        self.swapped = []
        for name, fns in PARENT_WRAPPERS:
            ours = importlib.import_module(f"daspeech_torch.ops.{name}")
            for fn in fns:
                self.swapped.append((ours, fn, getattr(ours, fn)))
                setattr(ours, fn, getattr(parent_module(name), fn))

    def __exit__(self, *exc):
        self.build.library = self.own
        for mod, fn, own in self.swapped:
            setattr(mod, fn, own)


def in_turns(fn, timer=None):
    """(this tree's ms, the parent tree's ms) of ``fn``, timed by
    ``timer`` (``cuda_ms``) in turns: this, parent, parent, this; each the
    mean of its two."""
    timer = timer or cuda_ms
    a = timer(fn)
    with parent_library():
        b = timer(fn)
        c = timer(fn)
    d = timer(fn)
    return (a + d) / 2, (b + c) / 2


def parent_ms(fn):
    """``cuda_ms(fn)`` with the parent tree's kernel library."""
    with parent_library():
        return cuda_ms(fn)


def parent_mrf_level(x, W, bias, kernel_sizes, dilations):
    """The parent tree's MRF level at its own tile choice (its wrapper and
    its entry point)."""
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
    includes), logged; returns their sum (None if the profiler saw no
    kernels)."""
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
    return sum(by.values()) if by else None


def sass_counts(lib_path):
    """HMMA (tensor-core) and FFMA (fp32 FMA) instructions per kernel of
    attention_tc.cuh, of attention_bf16.cuh (both modes), relpos_bf16.cuh
    and links_bf16.cuh (and, of the HMMA, those of the bf16 form,
    ``HMMA.16816.F32.BF16``: HMMA_BF16), of the FMA forward, of the link
    extraction and of #6's and #7's kernels (gemm_tc.cuh's tiles: the fp32
    modes' and the bf16 modes') in the built library's SASS
    (``kernel_sass``), a template kernel's instances apart
    (``attn_tc_chunk_fwd_kernel<5,0>``: #5's, ``<1,1>``: #3's;
    ``attn_fma_fwd_kernel<1,0>``: #1's and #2's, ``<5,0>``: #5's,
    ``<1,1>``: #3's); None without cuobjdump."""
    import re

    sass = kernel_sass(lib_path, (
        *TC_KERNELS, *BF16_ATTN_KERNELS, *BF16_FB_KERNELS,
        *BF16_RELPOS_KERNELS, *BF16_LINKS_KERNELS, FMA_FORWARD, *LINKS_FMA,
        *LINKS_TC, *GEMM_TC, *BF16_GEMM_KERNELS))
    if sass is None:
        return None
    counts = {}
    for (_, name), lines in sass.items():
        text = "\n".join(lines)
        counts[name] = {
            "HMMA": len(re.findall(r"\bHMMA\b", text)),
            "FFMA": len(re.findall(r"\bFFMA\b", text)),
            "HMMA_BF16": len(re.findall(r"\bHMMA\.16816\.F32\.BF16\b",
                                        text))}
    return counts


def kernel_sass(lib_path, names):
    """The SASS (``cuobjdump -sass``) of each kernel whose name holds one of
    ``names``, by (source, kernel<template instance>): its instructions
    without their addresses and encodings; None without cuobjdump."""
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
    out, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            name = next((t for t in names if t in fn), None)
            src = re.search(r"(fused_\w+?)_cu_", fn)
            inst = re.search(r"kernelI((?:L[a-z]\d+E)+)E", fn)
            if name and inst:
                name += "<" + ",".join(re.findall(r"L[a-z](\d+)E",
                                                  inst.group(1))) + ">"
            key = None if name is None else (src.group(1) if src else "",
                                             name)
            if key is not None:
                out[key] = []
        elif key is not None:
            ins = re.sub(r"/\*[0-9a-fx]+\*/", "", line).split(";")[0].strip()
            if ins and not ins.startswith("/*"):
                out[key].append(ins)
    return out


# the fp32 kernels of #5, #4 and #3, whose SASS this tree keeps as the
# parent tree built it (checked with --parent): every instance in the
# rel-pos and link libraries, and #3's in the fused_attention one (the FMA
# forward's full-bias mode, the chunked-score kernels and the gradient
# kernel of its backward)
FP32_KEPT = (FMA_FORWARD, "attn_tc_chunk_fwd_kernel",
             "attn_tc_chunk_ds_kernel", "attn_tc_grad_kernel", *LINKS_FMA,
             *LINKS_TC)
FP32_KEPT_FB = {("fused_attention", n) for n in (
    f"{FMA_FORWARD}<1,1>", "attn_tc_chunk_fwd_kernel<1,1>",
    "attn_tc_chunk_ds_kernel<1,1>", "attn_tc_grad_kernel")}


# the fp32 instances of #5 that draw dropout (their counter's head word is
# h + AttnArgs::h0, the model axis's head offset): their SASS may differ from
# the parent tree's, and their times are held to the parent's spread in
# the same call instead (head0_retime)
HEAD0_CHANGED = (FMA_FORWARD, "attn_tc_chunk_fwd_kernel",
                 "attn_tc_chunk_ds_kernel")


def head0_changed(key) -> bool:
    """Whether the SASS key (source, kernel<instance>) is one of #5's fp32
    instances of HEAD0_CHANGED."""
    return key[0] == "fused_relpos" and key[1].split("<")[0] in HEAD0_CHANGED


def fp32_sass_kept(lib, parent_lib):
    """The fp32 kernels of #5, #4 and #3 (FP32_KEPT, FP32_KEPT_FB) in this
    tree's library have the SASS of the parent tree's, instruction for
    instruction (the rel-pos instances of the attention kernels, every link
    kernel and #3's fp32 instances), but for the instances of HEAD0_CHANGED,
    which may differ; returns the keys compared and those of HEAD0_CHANGED
    that differ, or None without cuobjdump."""
    ours, theirs = kernel_sass(lib, FP32_KEPT), kernel_sass(parent_lib,
                                                            FP32_KEPT)
    if ours is None:
        return None

    def kept(sass):
        return {k for k in sass if k[0] in ("fused_relpos", "fused_links")
                or k in FP32_KEPT_FB}

    keys = sorted(kept(ours))
    if (not keys or set(keys) != kept(theirs)
            or not FP32_KEPT_FB <= set(keys)):
        raise AssertionError(f"fp32 kernels of #5, #4 and #3: {keys} here, "
                             f"{sorted(theirs)} in the parent tree")
    changed = [k for k in keys if ours[k] != theirs[k]]
    if not all(head0_changed(k) for k in changed):
        raise AssertionError(f"fp32 kernels whose SASS changed: {changed}")
    same = [k for k in keys if k not in changed]
    log(f"  SASS of the fp32 kernels of #5, #4 and #3 as the parent tree's: "
        f"{len(same)} kernels ({', '.join('/'.join(k) for k in same)}); "
        f"changed (the head offset; timed against the parent instead): "
        f"{', '.join('/'.join(k) for k in changed) or 'none'}")
    return keys, changed


HEAD0_ROUNDS = 5


def head0_retime():
    """The rows of #1, #2 and #5 (PERF.md section 6's shapes: fp32
    inference, training forward and backward, bf16 forward + backward)
    timed in turns with the parent tree's kernels (``in_turns``,
    HEAD0_ROUNDS times): each row's mean and range, this tree's and the
    parent's. The fp32 rows of #5, whose SASS changed (HEAD0_CHANGED), must
    keep a median within the parent's range (at most its slowest). Returns
    {row: {"ms": [...], "parent_ms": [...]}}."""
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_relpos as fr

    g = torch.Generator().manual_seed(SEED + 50)
    bf = torch.bfloat16

    def attn(B, Tq, Tk, C, H, p, dt=torch.float32):
        q = _randn(g, B, Tq, C, scale=(C // H) ** -0.5).to(dt)
        k, v = _randn(g, B, Tk, C).to(dt), _randn(g, B, Tk, C).to(dt)
        return (q, k, v, _key_bias(B, Tk, g), H, 1.0, p,
                _seeds(g, B) if p else None), _randn(g, B, Tq, C).to(dt)

    def hm(B, H, T, p, dt=torch.float32):
        q = _randn(g, B, H, T, 64, scale=0.125).to(dt)
        k, v = _randn(g, B, H, T, 64).to(dt), _randn(g, B, H, T, 64).to(dt)
        return (q, k, v, _key_bias(B, T, g), 1.0, p,
                _seeds(g, B) if p else None), _randn(g, B, H, T, 64).to(dt)

    def rel(B, T, H, p, dt=torch.float32):
        q = _randn(g, B, T, H * 64, scale=0.125).to(dt)
        k, v = _randn(g, B, T, H * 64).to(dt), _randn(g, B, T, H * 64).to(dt)
        a = _randn(g, B, T, H * 256, scale=0.05).to(dt)
        e = fr.relpos_basis(T, 256, device=DEVICE)[2].to(dt).contiguous()
        return ((q, k, v, a, e, _key_bias(B, T, g), H, 0.125, p,
                 _seeds(g, B) if p else None), _randn(g, B, T, H * 64).to(dt))

    def rows_of(name, fwd, bwd, args, do, n_in, train_only=False):
        out, st = fwd(*args, with_stats=True)
        rows = {} if train_only else {
            f"{name} inference": lambda: fwd(*args)}
        rows[f"{name} training"] = lambda: fwd(*args, with_stats=True)
        rows[f"{name} bwd"] = lambda: bwd(*args[:n_in], out, st, do,
                                          *args[n_in:])
        return rows

    rows = {}
    a, do = attn(80, 240, 240, 512, 8, 0.1)
    rows.update(rows_of("#1 T q[80,240,512] p=0.1", fa.attention_fwd_kernel,
                        fa.attention_bwd_kernel, a, do, 4, train_only=True))
    a8, _ = attn(8, 240, 240, 512, 8, 0.0)
    rows["#1 A q[8,240,512] inference"] = lambda: fa.attention_fwd_kernel(*a8)
    a, do = hm(14, 4, 1040, 0.0)
    rows.update(rows_of("#2 J-long FS2 [14,4,1040,64]",
                        fa.attention_hm_fwd_kernel,
                        fa.attention_hm_bwd_kernel, a, do, 4))
    r, do = rel(80, 120, 4, 0.1)
    rows.update(rows_of("#5 T [80,120,256] p=0.1", fr.relpos_fwd_kernel,
                        fr.relpos_bwd_kernel, r, do, 6, train_only=True))
    r8, _ = rel(8, 120, 4, 0.0)
    rows["#5 A [8,120,256] inference"] = lambda: fr.relpos_fwd_kernel(*r8)
    for name, mk, fwd, bwd, n_in in (
            ("#1 bf16 T q[80,240,512] p=0.1", lambda: attn(
                80, 240, 240, 512, 8, 0.1, bf), fa.attention_fwd_kernel,
             fa.attention_bwd_kernel, 4),
            ("#2 bf16 J-long FS2 [14,4,1040,64]", lambda: hm(
                14, 4, 1040, 0.0, bf), fa.attention_hm_fwd_kernel,
             fa.attention_hm_bwd_kernel, 4),
            ("#5 bf16 T [80,120,256] p=0.1", lambda: rel(80, 120, 4, 0.1, bf),
             fr.relpos_fwd_kernel, fr.relpos_bwd_kernel, 6)):
        args, do = mk()

        def both(fwd=fwd, bwd=bwd, args=args, do=do, n_in=n_in):
            out, st = fwd(*args, with_stats=True)
            return bwd(*args[:n_in], out, st, do, *args[n_in:])

        rows[f"{name} fwd + bwd"] = both
    out = {}
    for name, fn in rows.items():
        ours, theirs = zip(*(in_turns(fn) for _ in range(HEAD0_ROUNDS)))
        out[name] = {"ms": list(ours), "parent_ms": list(theirs)}
        med = sorted(ours)[len(ours) // 2]
        log(f"  {name}: {med:.4f} ms (range {min(ours):.4f}-"
            f"{max(ours):.4f}), the parent tree's "
            f"{sorted(theirs)[len(theirs) // 2]:.4f} ({min(theirs):.4f}-"
            f"{max(theirs):.4f}), in turns x {HEAD0_ROUNDS}")
        if name.startswith("#5 ") and "bf16" not in name \
                and not med <= max(theirs):
            raise AssertionError(f"{name}: {med} ms, beyond the parent "
                                 f"tree's range {min(theirs)}-{max(theirs)}")
    return out


HEAD0_GRID_ROUNDS = 3


def head0_grid_cost():
    """The bf16 rows of #1 and #2 (PERF.md section 6's shapes) at head
    offsets 0, H/2 and 7H (the last rank of a model axis of 8): with an
    offset their dq kernel launches h0 more heads' blocks per batch row,
    which return at once. The backward and the forward + backward, timed
    in turns (0, H/2, 7H, 7H, H/2, 0; HEAD0_GRID_ROUNDS times), each
    offset's median; returns {row: {offset: [ms, ...]}}."""
    from daspeech_torch.ops import fused_attention as fa

    g = torch.Generator().manual_seed(SEED + 51)
    bf = torch.bfloat16
    B, T, C, H = 80, 240, 512, 8
    q = _randn(g, B, T, C, scale=(C // H) ** -0.5).to(bf)
    k, v, do = (_randn(g, B, T, C).to(bf) for _ in range(3))
    packed = ((q, k, v, _key_bias(B, T, g), H, 1.0, 0.1, _seeds(g, B)), do,
              fa.attention_fwd_kernel, fa.attention_bwd_kernel, H)
    Bh, Hh, Th = 14, 4, 1040
    qh = _randn(g, Bh, Hh, Th, 64, scale=0.125).to(bf)
    kh, vh, doh = (_randn(g, Bh, Hh, Th, 64).to(bf) for _ in range(3))
    hm = ((qh, kh, vh, _key_bias(Bh, Th, g), 1.0, 0.0, None), doh,
          fa.attention_hm_fwd_kernel, fa.attention_hm_bwd_kernel, Hh)
    out = {}
    for name, (args, do, fwd, bwd, heads) in (
            ("#1 bf16 T q[80,240,512] p=0.1", packed),
            ("#2 bf16 J-long FS2 [14,4,1040,64]", hm)):
        offsets = (0, heads // 2, 7 * heads)

        def back(h0, o, st, args=args, do=do, bwd=bwd):
            return bwd(*args[:4], o, st, do, *args[4:], head0=h0)

        def both(h0, args=args, fwd=fwd):
            return back(h0, *fwd(*args, with_stats=True, head0=h0))

        rows = {f"{name} bwd": {}, f"{name} fwd + bwd": {}}
        for h0 in offsets:
            o, st = fwd(*args, with_stats=True, head0=h0)
            rows[f"{name} bwd"][h0] = lambda h0=h0, o=o, st=st: back(h0, o,
                                                                     st)
            rows[f"{name} fwd + bwd"][h0] = lambda h0=h0: both(h0)
        for row, by in rows.items():
            times = {h0: [] for h0 in offsets}
            for _ in range(HEAD0_GRID_ROUNDS):
                for h0 in offsets + offsets[::-1]:
                    times[h0].append(cuda_ms(by[h0]))
            out[row] = times
            med = {h0: float(np.median(t)) for h0, t in times.items()}
            log(f"  {row} at head0 " + ", ".join(
                f"{h0}: {m:.4f} ms" for h0, m in med.items())
                + f" (x{med[offsets[-1]] / med[0]:.3f} at 7H), in turns x "
                f"{HEAD0_GRID_ROUNDS}")
    return out


def check_sass(lib_path):
    """The HMMA and FFMA counts of sass_counts: HMMA in every tensor-core
    kernel, only bf16 HMMA in the bf16 kernels and none in the fp32 ones,
    FFMA and no HMMA in the FMA kernels."""
    sass = sass_counts(lib_path)
    log(f"HMMA and FFMA instructions in the SASS of attention_tc.cuh's "
        "kernels, of the FMA forward, of the link extraction and of #6's "
        "and #7's kernels: "
        + ("cuobjdump not found, not checked" if sass is None else str(sass)))
    if sass is not None:
        fma_names = {f"{FMA_FORWARD}{i}" for i in FMA_INSTANCES} | set(
            LINKS_FMA)
        tc = {n: c for n, c in sass.items() if n not in fma_names}
        fma = {n: c for n, c in sass.items() if n in fma_names}
        bf16_names = (*BF16_ATTN_KERNELS, *BF16_FB_KERNELS,
                      *BF16_RELPOS_KERNELS, *BF16_LINKS_KERNELS,
                      *BF16_GEMM_KERNELS)
        if ({n.split("<")[0] for n in tc} != {*TC_KERNELS, *LINKS_TC,
                                               *GEMM_TC, *bf16_names}
                or not all(c["HMMA"] for c in tc.values())):
            raise AssertionError(f"tensor-core kernels without HMMA: {tc}")
        # the bf16 attention kernels (both modes) and the bf16 modes of #5,
        # #4, #6 and #7 multiply on the bf16 tensor cores, and every HMMA
        # they hold is of that form; the fp32 tensor-core kernels hold none
        # (3xTF32 only)
        bf16_tc = {n: c for n, c in tc.items()
                   if n.split("<")[0] in bf16_names}
        if (len(bf16_tc) != len(bf16_names) - 1 + 8
                or not all(0 < c["HMMA_BF16"] == c["HMMA"]
                           for c in bf16_tc.values())):
            raise AssertionError(f"bf16 kernels without bf16 HMMA: {bf16_tc}")
        if any(c["HMMA_BF16"] for n, c in tc.items()
               if n.split("<")[0] in (*TC_KERNELS, *LINKS_TC, *GEMM_TC)):
            raise AssertionError(f"bf16 HMMA in the fp32 tensor-core "
                                 f"kernels: {tc}")
        if (set(fma) != fma_names
                or any(c["HMMA"] or not c["FFMA"] for c in fma.values())):
            raise AssertionError(f"FMA kernels not on the FMA pipes: {fma}")


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
# the fp32 MRF conv's six (32, 64 and 128 channels x 64 and 128 frames),
# the bf16 MRF conv's eight (16, 32, 64 and 128 channels x 64 and 128
# frames)
SPILL_CHECKED = {FMA_FORWARD: len(FMA_INSTANCES), "mrf_conv_kernel": 6,
                 "ffn_fwd_kernel": 1, "ffn_bwd_rows_kernel": 1,
                 "ffn_wgrad_kernel": 1, "mrf_bf16_conv_kernel": 8,
                 "mrf_bf16_act_kernel": 1,
                 **{n: 1 for n in (*BF16_ATTN_KERNELS, *BF16_FB_KERNELS,
                                   *BF16_RELPOS_KERNELS,
                                   *BF16_LINKS_KERNELS)},
                 **{n: 1 for n in BF16_GEMM_KERNELS[:3]}}


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


def busy_ms(events):
    """The union of the kernel events' intervals, in ms."""
    busy, end = 0.0, -1.0
    for s, e in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy / 1e3


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
    busy = busy_ms(events)
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

        self.module, self.orig, self.calls = sl, sl._best_alignment, []

        def spy(match, links, ol, tl, *a):
            path = self.orig(match, links, ol, tl, *a)
            self.calls.append(tuple(x.detach().cpu() for x in
                                    (match, links, tl, path)))
            return path

        sl._best_alignment = spy
        return self

    def __exit__(self, *exc):
        self.module._best_alignment = self.orig


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
        mel, _, _, log_dur, pitch, energy = model.synthesize(
            z, zpad, M, gold[0], pitches=gold[1], energies=gold[2],
            rng=device_generator(DEVICE, tt))
        tts, _ = fastspeech2_losses(
            mel, None, log_dur, pitch, energy, batch["target_audio"], *gold,
            ~zpad,
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
# bf16 phase
# ---------------------------------------------------------------------------

PEAK_FLOPS_BF16 = 989e12  # bf16 tensor cores, dense
BF16_BYTES = 2
TOL_BF16 = 2.0 ** -7      # a bf16 kernel against its plain bf16 version, of
#                           the output's largest magnitude (one bf16 ulp at 1)
BF16_FLOOR = 1e-5         # absolute, for an output that is 0 exactly
# each bf16 entry point (a row of the kernels line) -> its backward's counter
BF16_KERNELS = {"fused_attention_packed": "fused_attention_packed_bwd",
                "fused_attention": "fused_attention_bwd",
                "fused_attention_relpos": "fused_attention_relpos_bwd",
                "fused_extract_links": "fused_extract_links_bwd"}
# card vs CPU in bf16, against the CPU in fp32: ||card_bf16 - cpu_fp32||
# <= 2 ||cpu_bf16 - cpu_fp32|| over all gradients (each scaled by its fp32
# norm), each gradient alone within BF16_PER_TENSOR times that bar, the
# loss within it floored at one bf16 rounding of the loss
# (tests/test_torch_bf16_train.py sets out why)
BF16_PER_TENSOR = 8.0
# profiles of one same-kernels window: a window whose device events the
# profiler lost is taken again
PROFILE_ATTEMPTS = 3
BF16_LOSS_FLOOR = 2.0 ** -8
# the convergence run: S2TT at full width on one batch of 16, constant lr
CONVERGE_B, CONVERGE_LR, CONVERGE_TOL = 16, 3e-4, 0.05


def bf16_close(what, got, want):
    """A bf16 kernel output against its plain bf16 version: the same dtype,
    finite, within TOL_BF16 of the output's largest magnitude (or
    BF16_FLOOR where that is smaller). Returns the max abs error."""
    err = _max_err(got.float(), want.float())
    tol = max(TOL_BF16 * want.float().abs().max().item(), BF16_FLOOR)
    if (got.dtype != want.dtype or not torch.isfinite(got.float()).all()
            or not err <= tol):
        raise AssertionError(f"{what}: {got.dtype} vs {want.dtype}, max abs "
                             f"err {err} > {tol}")
    return err


def profiled_own_kernels(name, tag, fn, own=("daspeech",)):
    """(the names of our kernels that one ``fn()`` launched, under
    ``torch.profiler``: those whose name holds one of ``own``; each
    wrapper's launch count it added). A window
    whose wrappers launched and where the profiler saw none of their
    kernels lost its device events (CUPTI): it is profiled again, up to
    PROFILE_ATTEMPTS times; a window that saw other kernels is taken as it
    is."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        before = read_launches()
        # a first kernel in the profiled window (a fill) that the comparison
        # leaves out: the profiler has been seen to miss the window's first
        # kernel
        events, _ = profiled_kernels(
            lambda: (torch.ones(1, device="cuda"), fn()),
            f"bf16_kernels_{name}_{tag}")
        after = read_launches()
        ours = sorted(e["name"] for e in events
                      if any(o in e["name"] for o in own))
        moved = {k: after[k] - before[k] for k in after
                 if not k.endswith(" bf16")}
        if ours or not any(moved.values()):
            return ours, moved
        log(f"  {name} {tag}: the profile saw {len(events)} kernels, none "
            f"of ours, while the wrappers counted "
            f"{ {k: v for k, v in moved.items() if v} }: the profiler lost "
            f"the window's device events (attempt {attempt} of "
            f"{PROFILE_ATTEMPTS})")
    return ours, moved


def bf16_attention_kernels(name, run32, run16):
    """#1's or #2's bf16 call (training forward and backward) launches the
    bf16 kernels of attention_bf16.cuh, each once, and none of
    attention_tc.cuh's or attention_fma.cuh's; the fp32 call launches the
    FMA training forward and attention_tc.cuh's backward as before, and
    none of the bf16 kernels (by name, under ``torch.profiler``); both add
    the same counts to the wrappers' ``launches``. Returns the bf16 call's
    kernel count."""
    (k32, m32), (k16, m16) = (profiled_own_kernels(name, tag, fn) for tag, fn
                              in (("fp32", run32), ("bf16", run16)))
    fp32_kernels = (FMA_FORWARD, *TC_KERNELS[1:3])

    def count(kernels, t):
        return sum(t in n for n in kernels)

    ok16 = (all(count(k16, t) == 1 for t in BF16_ATTN_KERNELS)
            and len(k16) == len(BF16_ATTN_KERNELS)
            and not any("attn_tc_" in n or "attn_fma_" in n for n in k16))
    ok32 = (all(count(k32, t) >= 1 for t in fp32_kernels)
            and all(any(t in n for t in (*fp32_kernels, *FMA_KERNELS))
                    for n in k32)
            and not any(count(k32, t) for t in BF16_ATTN_KERNELS))
    if not (ok16 and ok32 and m32 == m16):
        raise AssertionError(f"{name}: the bf16 call launches {k16} "
                             f"({m16}), the fp32 call {k32} ({m32})")
    log(f"  {name} bf16: {len(k16)} kernels, attention_bf16.cuh's "
        f"({', '.join(n[:48] for n in k16)}); fp32: {len(k32)} kernels, the "
        "FMA forward and attention_tc.cuh's backward")
    return len(k16)


def bf16_kernel_rows():
    """Each bf16 entry point (#1, #2, #4, #5) against its plain bf16
    version at cell T's, J-long's and a serving shape: the inference and
    the training forward and the backward, and (forward + backward) the
    kernels', the plain version's and SDPA's bf16 times beside the bound at
    989 TFLOP/s and on the bf16 bytes, the device ms by kernel beside
    SDPA's, and with --parent the parent tree's kernels ("was_ms"); each
    entry point's first row also the kernels its bf16 call launches, by
    name. Returns the rows."""
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_links as fl
    from daspeech_torch.ops import fused_relpos as fr

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(SEED + 40)
    rows = {f"{n} bf16": [] for n in BF16_KERNELS}

    def row(name, shape, err, run_kernel, run_plain, flops, nbytes,
            run_library, **extra):
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        lib_ms = cuda_ms(run_library) if run_library is not None else None
        # the kernels redesigned for the bf16 tensor cores (attention_bf16.cuh,
        # relpos_bf16.cuh, links_bf16.cuh) beside the parent tree's
        was = parent_ms(run_kernel) if PARENT else None
        # the kernels' and SDPA's device time alone: at these sizes the
        # host's launch overhead is a share of both CUDA-event times
        extra["device_ms"] = kernel_split(run_kernel, f"{name} {shape}")
        extra["library_device_ms"] = (
            kernel_split(run_library, f"{name} {shape} SDPA")
            if run_library is not None else None)
        b_ms, b_by = bound(flops, nbytes, PEAK_FLOPS_BF16)
        rows[f"{name} bf16"].append({
            "shape": shape, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "was_ms": was, **extra})
        tf = lambda t: f" ({flops / t / 1e9:.1f} TFLOP/s)"  # noqa: E731
        log(f"  {name} bf16 {shape}, forward (training) + backward: max abs "
            f"err {err:.3g}  kernel {ms:.4f} ms{tf(ms)}"
            + ("" if was is None else f"  parent tree {was:.4f} ms")
            + f"  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
            "library "
            + ("none" if lib_ms is None else f"{lib_ms:.4f} ms{tf(lib_ms)}")
            + "".join(f"  {k} {extra[k]:.4f}" for k in
                      ("device_ms", "library_device_ms")
                      if extra.get(k) is not None))

    def bf16(*shape, scale=1.0):
        return _randn(g, *shape, scale=scale).to(bf)

    # --- #1 packed: cell T's decoder self-attention (dropout 0.1), J-long's
    # cross-attention (700 x 350) and serving A's self-attention
    for i, (tag, B, Tq, Tk, H, p) in enumerate((
            ("T", 80, 240, 240, 8, 0.1), ("J-long", 14, 700, 350, 8, 0.1),
            ("serving A", 8, 240, 240, 8, 0.0))):
        C, d = H * 64, 64
        q = bf16(B, Tq, C, scale=d ** -0.5)
        k, v, do = bf16(B, Tk, C), bf16(B, Tk, C), bf16(B, Tq, C)
        bias = _key_bias(B, Tk, g)
        seeds = _seeds(g, B) if p else None
        shape = f"{tag} q[{B},{Tq},{C}] kv_T={Tk} H={H} p={p}"
        want = fa.attention_plain(q, k, v, bias, H, 1.0, p, seeds)
        err = bf16_close(f"#1 bf16 {shape} inference", fa.attention_fwd_kernel(
            q, k, v, bias, H, 1.0, p, seeds)[0], want)
        out, st = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds,
                                          with_stats=True)
        err = max(err, bf16_close(f"#1 bf16 {shape} training", out, want))
        for x, w in zip(fa.attention_bwd_kernel(q, k, v, bias, out, st, do, H,
                                                1.0, p, seeds),
                        fa.attention_bwd_plain(q, k, v, bias, do, H, 1.0, p,
                                               seeds)):
            err = max(err, bf16_close(f"#1 bf16 {shape} backward", x, w))

        def run(q=q, k=k, v=v, do=do, bias=bias, seeds=seeds):
            o, s = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds,
                                           with_stats=True)
            return fa.attention_bwd_kernel(q, k, v, bias, o, s, do, H, 1.0,
                                           p, seeds)

        extra = {}
        if i == 0:
            f32 = [x.float() for x in (q, k, v, do)]
            extra["bf16_kernels"] = bf16_attention_kernels(
                "fused_attention_packed", lambda: run(*f32), run)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        h4 = lambda x: x.reshape(B, x.shape[1], H, d).transpose(1, 2)  # noqa: E731,E501
        mask = bias.to(bf)[:, None, None, :]
        row("fused_attention_packed", shape, err, run,
            lambda: fa.attention_bwd_plain(q, k, v, bias, do, H, 1.0, p,
                                           seeds)
            + (fa.attention_plain(q, k, v, bias, H, 1.0, p, seeds),),
            14 * B * H * Tq * Tk * d,
            (4 * B * Tq * C + 4 * B * Tk * C) * BF16_BYTES + B * Tk * F32,
            lambda: torch.autograd.grad(
                torch.nn.functional.scaled_dot_product_attention(
                    *(h4(x) for x in leaves), attn_mask=mask, dropout_p=p,
                    scale=1.0), leaves, h4(do)), **extra)

    # --- #2 head-major: J-long's FastSpeech 2 decoder (1040 frames) and
    # DAG self-attention (700 vertices, dropout 0.1), serving B's decoder
    for i, (tag, B, H, T, p) in enumerate((
            ("J-long FS2", 14, 4, 1040, 0.0), ("J-long DAG", 14, 8, 700, 0.1),
            ("serving B FS2", 2, 4, 1040, 0.0))):
        d = 64
        q = bf16(B, H, T, d, scale=d ** -0.5)
        k, v, do = bf16(B, H, T, d), bf16(B, H, T, d), bf16(B, H, T, d)
        bias = _key_bias(B, T, g)
        seeds = _seeds(g, B) if p else None
        shape = f"{tag} [{B},{H},{T},{d}] p={p}"
        want = fa.attention_hm_plain(q, k, v, bias, 1.0, p, seeds)
        err = bf16_close(f"#2 bf16 {shape} inference",
                         fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0, p,
                                                    seeds)[0], want)
        out, st = fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0, p, seeds,
                                             with_stats=True)
        err = max(err, bf16_close(f"#2 bf16 {shape} training", out, want))
        for x, w in zip(fa.attention_hm_bwd_kernel(q, k, v, bias, out, st, do,
                                                   1.0, p, seeds),
                        fa.attention_hm_bwd_plain(q, k, v, bias, do, 1.0, p,
                                                  seeds)):
            err = max(err, bf16_close(f"#2 bf16 {shape} backward", x, w))

        def run(q=q, k=k, v=v, do=do, bias=bias, seeds=seeds):
            o, s = fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0, p, seeds,
                                              with_stats=True)
            return fa.attention_hm_bwd_kernel(q, k, v, bias, o, s, do, 1.0,
                                              p, seeds)

        extra = {}
        if i == 0:
            f32 = [x.float() for x in (q, k, v, do)]
            extra["bf16_kernels"] = bf16_attention_kernels(
                "fused_attention", lambda: run(*f32), run)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        mask = bias.to(bf)[:, None, None, :]
        row("fused_attention", shape, err, run,
            lambda: fa.attention_hm_bwd_plain(q, k, v, bias, do, 1.0, p,
                                              seeds)
            + (fa.attention_hm_plain(q, k, v, bias, 1.0, p, seeds),),
            14 * B * H * T * T * d,
            8 * B * H * T * d * BF16_BYTES + B * T * F32,
            lambda: torch.autograd.grad(
                torch.nn.functional.scaled_dot_product_attention(
                    *leaves, attn_mask=mask, dropout_p=p, scale=1.0),
                leaves, do), **extra)

    # --- #5 rel-pos: cell T's encoder (dropout 0.1), J-long's (350
    # frames) and serving A's (inference shape, here forward + backward)
    for i, (tag, B, T, p) in enumerate((("T", 80, 120, 0.1),
                                        ("J-long", 14, 350, 0.1),
                                        ("serving A", 8, 120, 0.0))):
        H, C, P = 4, 256, fr.POS_DIM
        d = C // H
        q, k, v, do = (bf16(B, T, C, scale=0.5) for _ in range(4))
        a = bf16(B, T, H * P, scale=0.1)
        e = fr.relpos_basis(T, P, device="cuda")[2].to(bf).contiguous()
        bias = _key_bias(B, T, g)
        seeds = _seeds(g, B) if p else None
        sc = 1.0 / math.sqrt(d)
        shape = f"{tag} [{B},{T},{C}] H={H} p={p}"
        want = fr.relpos_plain(q, k, v, a, e, bias, H, sc, p, seeds)
        err = bf16_close(f"#5 bf16 {shape} inference", fr.relpos_fwd_kernel(
            q, k, v, a, e, bias, H, sc, p, seeds)[0], want)
        out, st = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, sc, p, seeds,
                                       with_stats=True)
        err = max(err, bf16_close(f"#5 bf16 {shape} training", out, want))
        for x, w in zip(fr.relpos_bwd_kernel(q, k, v, a, e, bias, out, st,
                                             do, H, sc, p, seeds),
                        fr.relpos_bwd_plain(q, k, v, a, e, bias, do, H, sc,
                                            p, seeds)):
            err = max(err, bf16_close(f"#5 bf16 {shape} backward", x, w))

        def run(q=q, k=k, v=v, a=a, e=e, do=do, bias=bias, seeds=seeds):
            o, s = fr.relpos_fwd_kernel(q, k, v, a, e, bias, H, sc, p, seeds,
                                        with_stats=True)
            return fr.relpos_bwd_kernel(q, k, v, a, e, bias, o, s, do, H, sc,
                                        p, seeds)

        extra = {}
        if i == 0:
            f32 = [x.float() for x in (q, k, v, a, e, do)]
            extra["bf16_kernels"] = bf16_mode_kernels(
                "fused_attention_relpos", lambda: run(*f32), run,
                FP32_RELPOS_LAUNCH, {n: 1 for n in BF16_RELPOS_KERNELS},
                own=("daspeech",))
        ops = relpos_sdpa_operands(q, k, v, a, e, bias.to(bf), H)
        leaves = [x.detach().requires_grad_(True) for x in ops[:3]]
        do4 = do.reshape(B, T, H, d).transpose(1, 2)
        row("fused_attention_relpos", shape, err, run,
            lambda: fr.relpos_bwd_plain(q, k, v, a, e, bias, do, H, sc, p,
                                        seeds)
            + (fr.relpos_plain(q, k, v, a, e, bias, H, sc, p, seeds),),
            2 * B * H * T * T * (7 * d + 3 * P),
            (9 * B * T * C + 2 * B * T * H * P + T * P) * BF16_BYTES
            + B * T * F32,
            lambda: torch.autograd.grad(
                relpos_sdpa(*leaves, ops[3], sc, p), leaves, do4),
            library_prep_ms=cuda_ms(lambda: relpos_sdpa_operands(
                q, k, v, a, e, bias.to(bf), H)), **extra)
        del ops, leaves

    # --- #4 links: cell T's [80, 240], J-long's [14, 700], serving A's
    for i, (tag, B, L) in enumerate((("T", 80, 240), ("J-long", 14, 700),
                                     ("serving A", 8, 240))):
        C, H = 512, 8
        dkh = C // H
        q, k = bf16(B, L, C, scale=0.5), bf16(B, L, C)
        gates = torch.log_softmax(_randn(g, B, L, H), dim=-1)
        ol = torch.randint(L // 2, L + 1, (B,), generator=g)
        ol[0] = L
        n_valid = int(sum(int(n) * (int(n) - 1) // 2 for n in ol))
        ol = ol.cuda()
        sc = 1.0 / math.sqrt(dkh)
        dlinks = _randn(g, B, L, L)
        shape = f"{tag} [{B},{L}] C={C} H={H}"
        links, lse = fl.links_fwd_kernel(q, k, gates, ol, H, sc, None,
                                         with_lse=True)
        want = fl.links_plain(q, k, gates, ol, H, sc, None)
        if links.dtype != torch.float32 or lse.dtype != torch.float32:
            raise AssertionError(f"#4 bf16 {shape}: links {links.dtype}, "
                                 f"lse {lse.dtype}")
        err = _finite_err(links, want, f"#4 bf16 links {shape}")
        if not err <= TOL_KERNEL:
            raise AssertionError(f"#4 bf16 links {shape}: max abs err {err}")
        got = fl.links_bwd_kernel(q, k, gates, ol, links, lse, dlinks, H, sc,
                                  None)
        wq, wk, wg = fl.links_bwd_plain(q, k, gates, ol, dlinks, H, sc, None)
        err = max(err, bf16_close(f"#4 bf16 {shape} dq", got[0], wq),
                  bf16_close(f"#4 bf16 {shape} dk", got[1], wk))
        dg_err = _max_err(got[2], wg)
        if got[2].dtype != torch.float32 or not dg_err <= TOL_KERNEL:
            raise AssertionError(f"#4 bf16 {shape} dgates: {got[2].dtype}, "
                                 f"{dg_err}")
        err = max(err, dg_err)

        def run(q=q, k=k, gates=gates, ol=ol, dlinks=dlinks):
            lk, ls = fl.links_fwd_kernel(q, k, gates, ol, H, sc, None,
                                         with_lse=True)
            return fl.links_bwd_kernel(q, k, gates, ol, lk, ls, dlinks, H,
                                       sc, None)

        extra = {}
        if i == 0:
            f32 = [q.float(), k.float()]
            extra["bf16_kernels"] = bf16_mode_kernels(
                "fused_extract_links", lambda: run(*f32), run,
                FP32_LINKS_LAUNCH, {n: 1 for n in BF16_LINKS_KERNELS},
                own=("daspeech",))
        row("fused_extract_links", shape, err, run,
            lambda: fl.links_bwd_plain(q, k, gates, ol, dlinks, H, sc, None)
            + (fl.links_plain(q, k, gates, ol, H, sc, None),),
            8 * n_valid * H * dkh,
            4 * B * L * C * BF16_BYTES
            + (2 * B * L * H + 2 * B * L * L) * F32, None, **extra)
    return rows


# the rows taken in a process of their own: flag -> the function whose
# JSON that process prints
ROWS_APART = {"--bf16-kernel-rows": "bf16_kernel_rows",
              "--bf16-alternate-rows": "bf16_alternate_rows"}


def rows_apart(flag):
    """The rows of ``ROWS_APART[flag]`` in a fresh process (this script
    with ``flag``, the library already built): late in a long process the
    profiler has been seen to lose every kernel of a short window, or most
    of them, which the kernel-identity checks profile."""
    here = os.path.dirname(os.path.abspath(__file__))
    parent = (sys.argv[sys.argv.index("--parent"):][:2]
              if "--parent" in sys.argv else [])
    out = subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                          *parent],
                         capture_output=True, text=True, cwd=here,
                         timeout=900)
    for line in out.stderr.splitlines():
        if "UserWarning" not in line and "_warn_once" not in line:
            log(line)
    if out.returncode != 0 or not out.stdout.strip():
        raise AssertionError(f"{ROWS_APART[flag]} failed: rc "
                             f"{out.returncode}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def busy_share(fn, tag):
    """(device busy ms, wall ms) of one ``fn()`` under ``torch.profiler``
    (the union of its kernel intervals), or (None, wall)."""
    events, wall = profiled_kernels(fn, tag)
    return (busy_ms(events) if events else None), wall


def bf16_vs_cpu(tag, model_cpu, loss_fn, batch):
    """The card's bf16 step against the CPU's fp32 one, each gradient and
    the loss, held to the CPU's own bf16 step (the bars above BF16_KERNELS'
    definition). Dropout 0 and GLAT 0 in ``loss_fn``."""
    from daspeech_torch.models.layers import set_dtype

    runs = []
    for dev, dt in ((DEVICE, torch.bfloat16), ("cpu", torch.bfloat16),
                    ("cpu", torch.float32)):
        model = set_dtype(copy.deepcopy(model_cpu), dt).to(dev).train()
        t0 = time.perf_counter()
        loss, grads, _ = loss_and_grads(
            model, {k: v.to(dev) for k, v in batch.items()}, SEED, loss_fn)
        sync()
        runs.append((loss.item(), [x.cpu().double() for x in grads]))
        log(f"  {tag} {dev} {str(dt)[6:]}: loss {loss.item():.6f} "
            f"({time.perf_counter() - t0:.1f} s)")
    (lk, gk), (lb, gb), (lf, gf) = runs
    names = [n for n, _ in model_cpu.named_parameters()]
    return bf16_step_check(tag, names, {"loss": (lk, lb, lf)}, gk, gb, gf)


def bf16_step_check(tag, names, losses, gk, gb, gf, separate=False,
                    noise=None):
    """A bf16 step on the card against the CPU's (``gk``, ``gb``: gradients
    in the order of ``names``) and the CPU's fp32 step (``gf``): each loss
    of ``losses`` ({name: (card, CPU bf16, CPU fp32)}) within 2x the CPU's
    own bf16 error (floored at BF16_LOSS_FLOOR of the value), the
    gradients, each scaled by its fp32 norm, within 2x the CPU's bf16 error
    on the aggregate and each within BF16_PER_TENSOR times its own, or,
    given ``noise`` (each tensor's ||card fp32 - CPU fp32|| in the same
    order), times that where it is larger: a tensor that bf16 barely moves
    is held to the card's fp32 disagreement with the CPU. With
    ``separate``, the card's gradients must also lie closer to the CPU's
    bf16 step than to its fp32 one (a card that rounded nothing fails)."""
    for what, (lk, lb, lf) in losses.items():
        loss_bar = max(2 * abs(lb - lf), BF16_LOSS_FLOOR * abs(lf))
        log(f"  {tag}: {what} card bf16 {lk:.6f}, CPU bf16 {lb:.6f}, CPU "
            f"fp32 {lf:.6f} (|card - fp32| {abs(lk - lf):.3g} <= "
            f"{loss_bar:.3g})")
        if not abs(lk - lf) <= loss_bar:
            raise AssertionError(f"{tag}: the card's bf16 {what} is not a "
                                 "bf16 step's of the CPU's")
    card = cpu = apart = 0.0
    worst = (0.0, "", 0.0, 0.0, 0.0)
    # a key projection's bias has an exact gradient of 0: each tensor's
    # scale is floored at 1e-4 of the global norm (as grad_errors')
    floor = 1e-4 * math.sqrt(sum(float(f.norm()) ** 2 for f in gf))
    per = []
    for i, (n, a, b, f) in enumerate(zip(names, gk, gb, gf)):
        scale = max(float(f.norm()), floor)
        da, db = float((a - f).norm()), float((b - f).norm())
        card += (da / scale) ** 2
        cpu += (db / scale) ** 2
        apart += (float((a - b).norm()) / scale) ** 2
        own = max(2 * db, 1e-6 * scale,
                  0.0 if noise is None else noise[i])
        worst = max(worst, (da / own, n, da / scale, db / scale,
                            0.0 if noise is None else noise[i] / scale))
        per.append((da / scale, db / scale, n))
    card, cpu, apart = card ** 0.5, cpu ** 0.5, apart ** 0.5
    for da, db, n in sorted(per, reverse=True)[:5]:
        log(f"    {n}: ||card - fp32|| {da:.3g}, ||CPU bf16 - fp32|| {db:.3g}"
            " of its fp32 norm")
    log(f"  {tag}: gradients, each scaled by its fp32 norm: ||card - fp32|| "
        f"{card:.4g} <= 2 ||CPU bf16 - fp32|| = {2 * cpu:.4g}; ||card - CPU "
        f"bf16|| {apart:.4g}{f' < {card:.4g}' if separate else ''}; worst "
        f"tensor {worst[1]} at {worst[0]:.3g} of its own bar (<= "
        f"{BF16_PER_TENSOR}; ||card - fp32|| {worst[2]:.3g}, ||CPU bf16 - "
        f"fp32|| {worst[3]:.3g}"
        + ("" if noise is None else f", card fp32 vs CPU {worst[4]:.3g}")
        + " of its fp32 norm)")
    if not (card <= 2 * cpu and worst[0] <= BF16_PER_TENSOR
            and (not separate or apart < card)):
        raise AssertionError(f"{tag}: the card's bf16 step is not a bf16 "
                             "step of the CPU's")
    return {"card_vs_fp32": card, "cpu_bf16_vs_fp32": cpu,
            "card_vs_cpu_bf16": apart, "worst_ratio": worst[0]}


def bf16_phase():
    """bf16 compute on the card (``--dtype bfloat16``): the bf16 entry
    points of #1, #2, #4 and #5; the bf16 updates of ``make_train_step`` at
    T, J-long and P beside fp32's in the same call (median of 10 after 3
    warm-ups, device busy share, peak memory); the card's bf16 step against
    the CPU's at T (B=2) and J-long (B=1); 30 updates of S2TT in bf16 and in fp32.
    Returns (rows, launches by path)."""
    from daspeech_torch.config import FastSpeech2Config, VocabConfig
    from daspeech_torch.models import (FastSpeech2Encoder,
                                       S2SConformerDAGFastSpeech2,
                                       S2TConformerDAG)
    from daspeech_torch.models.layers import set_dtype
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    bf = torch.bfloat16
    rows = rows_apart("--bf16-kernel-rows")

    # --- card vs CPU, dropout 0 and GLAT 0 (T at B=2, J-long at B=1: the
    # CPU's bf16 step is several times slower than its fp32 one)
    cfg, no_drop = train_configs()
    model_s2t = init_random_(S2TConformerDAG(cfg), SEED)
    ref = S2TConformerDAG(no_drop)
    ref.load_state_dict(model_s2t.state_dict())
    parity = {"T": bf16_vs_cpu(
        "S2TT T bf16 step B=2", ref, loss_fn_for(no_drop, 0.0),
        make_train_batch(2, TRAIN_S, TRAIN_T, no_drop, SEED + 41, "cpu"))}
    jcfg, jno_drop = joint_configs()
    model_joint = init_random_(S2SConformerDAGFastSpeech2(jcfg), SEED)
    jref = S2SConformerDAGFastSpeech2(jno_drop)
    jref.load_state_dict(model_joint.state_dict())
    _, S, T, M, dur = JOINT_SHAPES["J-long"]
    parity["J-long"] = bf16_vs_cpu(
        "joint J-long bf16 step B=1", jref, joint_loss_fn(jno_drop, 0.0),
        make_joint_batch(1, S, T, M, dur, jno_drop, SEED + 42, "cpu"))

    # --- updates at T, J-long and P: fp32, then bf16, in turns
    vocab = VocabConfig(size=128)
    model_fs2 = init_random_(FastSpeech2Encoder(FastSpeech2Config(),
                                                vocab.size), SEED + 20)
    B, Tp, Mp, durp = P_SHAPE
    configs = {
        "T": (model_s2t, loss_fn_for(cfg, 0.5), lambda: make_train_batch(
            TRAIN_B, TRAIN_S, TRAIN_T, cfg, SEED + 4, DEVICE)),
        "J-long": (model_joint, joint_loss_fn(jcfg, 0.5),
                   lambda: make_joint_batch(*JOINT_SHAPES["J-long"], jcfg,
                                            SEED + 12, DEVICE)),
        "P": (model_fs2, fs2_loss_fn(vocab), lambda: make_fs2_batch(
            B, Tp, Mp, durp, vocab, SEED + 22, DEVICE))}
    updates, by_path = {}, {}
    for tag, (model_cpu, loss_fn, make_batch) in configs.items():
        batch = make_batch()
        for dt in (torch.float32, bf):
            name = "bf16" if dt == bf else "fp32"
            model = set_dtype(copy.deepcopy(model_cpu), dt).to(DEVICE)
            opt = GuardedAdam()
            state = TrainState.create(model, opt)
            step = make_train_step(loss_fn, opt)
            med, iqr, launches, peak, _ = timed_updates(
                step, state, batch, 3, 10, f"{tag} {name} update")
            busy, wall = busy_share(lambda: step(state, batch,
                                                 torch.Generator()),
                                    f"bf16 phase {tag} {name} step")
            share = None if busy is None else busy / wall
            log(f"  {tag} {name}: device busy "
                + ("not measured" if busy is None else
                   f"{busy:.2f} of {wall:.2f} ms ({share:.3f})"))
            updates[(tag, name)] = {"ms": med, "iqr": iqr, "peak_gib": peak,
                                    "busy_ms": busy, "busy_share": share}
            if dt == bf and PARENT:
                # the same bf16 updates with the parent tree's kernels, then
                # with this tree's again (host-clock times drift within a
                # process)
                with parent_library():
                    pmed, _, _, _, _ = timed_updates(
                        step, state, batch, 3, 10,
                        f"{tag} {name} update, parent tree's kernels")
                    pbusy, pwall = busy_share(
                        lambda: step(state, batch, torch.Generator()),
                        f"bf16 phase {tag} {name} step, parent tree")
                log(f"  {tag} {name}, parent tree's kernels: device busy "
                    + ("not measured" if pbusy is None else
                       f"{pbusy:.2f} of {pwall:.2f} ms "
                       f"({pbusy / pwall:.3f})"))
                again, _, _, _, _ = timed_updates(
                    step, state, batch, 3, 10, f"{tag} {name} update, again")
                updates[(tag, name)].update(
                    parent_ms=pmed, parent_busy_ms=pbusy,
                    parent_busy_share=(None if pbusy is None
                                       else pbusy / pwall),
                    again_ms=again)
            if dt == bf:
                by_path[f"bf16_{tag}"] = launches
                own = {n: launches[f"{n} bf16"] for n in BF16_KERNELS} | {
                    b: launches[f"{b} bf16"] for b in BF16_KERNELS.values()}
                wanted = (("fused_attention_packed", "fused_attention")
                          if tag == "P" else
                          tuple(BF16_KERNELS) if tag == "J-long" else
                          ("fused_attention_packed", "fused_attention_relpos",
                           "fused_extract_links"))
                if any(own[n] <= 0 or own[n] != launches[n] for n in wanted) \
                        or any(own[n] != launches[n] for n in own):
                    raise AssertionError(f"{tag} bf16 updates: bf16 launches "
                                         f"{own}, all {launches}")
                log(f"  {tag} bf16 launches over 13 updates: {own}")
            del model, opt, state, step
            torch.cuda.empty_cache()
        f32, b16 = updates[(tag, "fp32")], updates[(tag, "bf16")]
        log(f"  {tag}: bf16 {b16['ms']:.3f} ms an update against fp32 "
            f"{f32['ms']:.3f} ({b16['ms'] / f32['ms']:.3f}); peak "
            f"{b16['peak_gib']:.2f} against {f32['peak_gib']:.2f} GiB")

    # --- convergence: 30 updates of S2TT at full width on one batch of
    # CONVERGE_B, constant lr, dropout 0 and GLAT 0, in bf16 and in fp32
    batch = make_train_batch(CONVERGE_B, TRAIN_S, TRAIN_T, no_drop, SEED + 43,
                             DEVICE)
    curves = {}
    for dt in (torch.float32, bf):
        model = set_dtype(copy.deepcopy(ref), dt).to(DEVICE)
        opt = GuardedAdam(lr=CONVERGE_LR, warmup_updates=10 ** 6,
                          warmup_init_lr=CONVERGE_LR)
        state = TrainState.create(model, opt)
        step = make_train_step(loss_fn_for(no_drop, 0.0), opt)
        gen = torch.Generator().manual_seed(SEED + 44)
        losses = [step(state, batch, gen)["loss"] for _ in range(LEARN_STEPS)]
        curves[dt] = [x.item() for x in losses]
        log(f"  {LEARN_STEPS} updates, B={CONVERGE_B}, lr {CONVERGE_LR} "
            f"constant, {str(dt)[6:]}: loss {curves[dt][0]:.4f} -> "
            f"{curves[dt][-1]:.4f}; every fifth: "
            + " ".join(f"{x:.3f}" for x in curves[dt][::5]))
    f_end, b_first, b_end = curves[torch.float32][-1], curves[bf][0], \
        curves[bf][-1]
    if not (abs(b_end - f_end) <= CONVERGE_TOL * abs(f_end)
            and b_end < b_first):
        raise AssertionError(f"bf16 convergence: {b_first} -> {b_end}, fp32 "
                             f"ends at {f_end}")
    return rows, by_path, {"updates": updates, "parity": parity,
                           "curves": curves}


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


# ---------------------------------------------------------------------------
# vocoder-rung phase: the serving ladder (--vocoder-quant) at config_v1,
# and the bf16 modes of #7, #6 and #3 against their plain bf16 versions
# ---------------------------------------------------------------------------

# (tag, --vocoder-quant, fused_mrf): the ladder, and the bf16 rung with the
# fused MRF (#7 with bf16 weights)
RUNGS = (("fp32", "none", False), ("bf16", "bf16", False),
         ("bf16 fused_mrf", "bf16", True), ("int8", "int8", False),
         ("int8-skip1", "int8-skip1", False))
RUNG_CALIB = 2              # the int8 rungs calibrate over A and B
RUNG_CPU_FRAMES = 96        # mel frames of the card-vs-CPU comparison
# a reduced-precision rung's waveform against its CPU run and its chunked
# run against its one-shot run: the norm of the difference within this
# share of the rung's own error (||rung - fp32||) on the same device.
# bf16: twice, the bar for another implementation's independent bf16
# roundings (PERF.md §2). The conv library computes some sites' output
# elements with other bits in a 94-frame window than in the 1040-frame
# batch of serving B (``window_witness``); a bf16 rounding that flips
# there moves every later site, and B's chunked run read 0.69 of the
# rung's error against a bar of 0.5 set before the first run. int8: one
# int8 error, as the card's fp32 conv_pre moves activations across int8
# rounding boundaries and every later site's inputs with them (the CPU
# tests read 0.35 against JAX, ``tests/test_torch_vocoder_rungs.py``).
# Against the CPU, each reduced rung must also lie nearer the CPU's rung
# than the CPU's fp32 waveform: a card that did not round or quantize
# fails that
RUNG_RATIO = {"bf16": 2.0, "int8": 1.0}


def _norm(t):
    return float(t.double().norm())


def window_witness(voc, mels):
    """Whether each conv site of the vocoder ``voc`` (on the card) gives an
    output element the same bits when it computes a whole batch and when it
    computes the window of SERVE_CHUNK + 2 halo mel frames that
    ``vocode_chunks`` takes from the batch's middle: ``conv_pre``, each
    upsample and each ResBlock conv in the form the generator computes it at
    its level (``HiFiGANGenerator.forward``, ``res_conv``) and ``conv_post``,
    on N(0, 1) inputs of the batch's shape at the site's rate, compared over
    the window's interior (each edge's reach of the conv dropped). Returns
    {batch: {"sites", "sites_differing", "elements_differing",
    "elements"}}."""
    from daspeech_torch.models.hifigan import level_fold, receptive_halo_mel
    from daspeech_torch.models.layers import FP32

    cfg = voc.cfg
    W = SERVE_CHUNK + 2 * receptive_halo_mel(cfg)

    def form(conv, ch):
        return (conv if conv.dtype == FP32 or level_fold(ch) == 1
                else conv.product)

    # (module's call, input channels, frames per mel frame in, out, reach)
    sites, f, ch = [(voc.conv_pre, cfg.num_mels, 1, 1, 3)], 1, \
        cfg.upsample_initial_channel
    for i, (u, k) in enumerate(zip(cfg.upsample_rates,
                                   cfg.upsample_kernel_sizes)):
        up = voc.ups[i]
        sites.append((up if up.dtype == FP32 else up.product, ch, f, f * u,
                      k))
        f, ch = f * u, ch // 2
        for block in voc.resblocks[i * voc.num_kernels:
                                   (i + 1) * voc.num_kernels]:
            for conv in block.modules():
                if isinstance(conv, torch.nn.Conv1d):
                    sites.append((form(conv, ch), ch, f, f,
                                  (conv.kernel_size[0] - 1) // 2
                                  * conv.dilation[0]))
    sites.append((form(voc.conv_post, ch), ch, f, f, 3))
    dev = next(voc.parameters()).device
    g = torch.Generator(device=dev).manual_seed(SEED + 90)
    out = {}
    with torch.inference_mode():
        for tag, mel in mels.items():
            B, M = mel.shape[:2]
            s0 = (M - W) // 2
            n_sites = n_diff = n_el = n_all = 0
            for fn, cin, fi, fo, reach in sites:
                x = torch.randn(B, cin, M * fi, generator=g, device=dev)
                whole = fn(x)
                win = fn(x[..., s0 * fi:(s0 + W) * fi])
                a, b = s0 * fo + reach, (s0 + W) * fo - reach
                d = int((whole[..., a:b] != win[..., reach:W * fo - reach])
                        .sum())
                n_sites += 1
                n_diff += d > 0
                n_el += d
                n_all += whole[..., a:b].numel()
                del x, whole, win
            out[tag] = {"sites": n_sites, "sites_differing": n_diff,
                        "elements_differing": n_el, "elements": n_all}
    return out


def vocoder_rung_phase(mels, voc_cpu):
    """Each rung of ``RUNGS`` through ``make_vocode_fn`` at config_v1 (the
    vocoder-mode phase's weights) on serving A [8, 416] and B [2, 1040],
    one-shot and with ``serve_chunk=64``: the launches of its first served
    pass over A and B (the int8 rungs' calibration), ms per batch (median
    of 5) after calibration, device busy on A, the chunked run against the
    one-shot run, ``window_witness`` of the fp32 and bf16 rungs, and the
    card against the CPU's same rung on one utterance (int8 with the
    card's frozen scales), nearer it than the CPU's fp32 waveform.
    Returns ({tag: launches}, rows)."""
    from daspeech_torch.decode import make_vocode_fn
    from daspeech_torch.decode.speech_generator import quant_fields
    from daspeech_torch.models import HiFiGANGenerator

    def build(device, **serving):
        voc = HiFiGANGenerator(voc_cpu.cfg, **serving)
        voc.load_state_dict(voc_cpu.state_dict())
        return voc.eval().requires_grad_(False).to(device)

    sub = mels["A"][:1, :RUNG_CPU_FRAMES].contiguous()
    launches, rows, fp32 = {}, {}, {}
    with torch.inference_mode():
        cpu_fp32 = voc_cpu(sub.cpu())
        for tag, quant, fused in RUNGS:
            fields = dict(quant_fields(quant), fused_mrf=fused)
            kind = "bf16" if quant == "bf16" else "int8"
            voc = build("cuda", **fields)
            fn = make_vocode_fn(voc, calib_batches=RUNG_CALIB)
            reset_launches()
            for mel in mels.values():
                fn(mel)
            torch.cuda.synchronize()
            launches[tag] = read_launches()
            n_mrf = (launches[tag]["mrf_level"],
                     launches[tag]["mrf_level bf16"])
            want_mrf = ((3 * len(mels), 3 * len(mels)) if fused else (0, 0))
            if n_mrf != want_mrf:
                raise AssertionError(f"vocoder {tag}: mrf_level launches "
                                     f"(all, bf16) {n_mrf}, not {want_mrf}")
            one = {b: fn(mel) for b, mel in mels.items()}
            if quant == "none":
                fp32 = one
            chunked = build("cuda", serve_chunk=SERVE_CHUNK, **fields)
            fn_c = make_vocode_fn(chunked, calib_batches=RUNG_CALIB)
            for mel in mels.values():
                fn_c(mel)                          # the same calibration
            row = {}
            for b, mel in mels.items():
                got = fn_c(mel)
                own = _norm(one[b] - fp32[b])
                if quant == "none":
                    err, bar = _max_err(got, one[b]), TOL_CHUNKED
                else:
                    err, bar = (_norm(got - one[b]),
                                RUNG_RATIO[kind] * own)
                if not (got.shape == one[b].shape
                        and torch.isfinite(got).all() and err <= bar):
                    raise AssertionError(f"vocoder {tag} batch {b}: chunked "
                                         f"vs one-shot {err} > {bar}")
                audio_s = mel.shape[0] * mel.shape[1] * 256 / 22050.0
                ms = cuda_ms(lambda: fn(mel), reps=5, warm=1)
                ms_c = cuda_ms(lambda: fn_c(mel), reps=5, warm=1)
                row[b] = {"ms": ms, "chunked_ms": ms_c,
                          "audio_s_per_s": audio_s / (ms / 1e3),
                          "vs_fp32_norm": own,
                          "wav_norm": _norm(fp32[b]),
                          "chunked_vs_one_shot": err, "chunk_bar": bar}
                log(f"  vocoder {tag} batch {b} mel{list(mel.shape)}: "
                    f"one-shot {ms:.3f} ms ({audio_s / (ms / 1e3):.1f} "
                    f"audio-s per s), chunked ({SERVE_CHUNK}) {ms_c:.3f} ms;"
                    f" ||rung - fp32|| {own:.4g} of ||fp32|| "
                    f"{_norm(fp32[b]):.4g}; chunked vs one-shot {err:.3g} "
                    f"(<= {bar:.3g})")
            names = device_busy(lambda: fn(mels["A"]), f"vocoder {tag} A")
            if fused and names is not None and not any(
                    "mrf_bf16_conv_kernel" in n for n in names):
                raise AssertionError(f"vocoder {tag}: the profile holds no "
                                     "mrf_bf16_conv_kernel")
            if fused and PARENT:
                # the fused rung with the parent tree's MRF kernels, in
                # turns, one-shot and chunked; and the device busy ms of
                # one call with each tree's kernels
                for b, mel in mels.items():
                    for key, f_ in (("ms", fn), ("chunked_ms", fn_c)):
                        now, was = in_turns(
                            lambda: f_(mel),
                            lambda g: cuda_ms(g, reps=5, warm=1))
                        busy = busy_share(lambda: f_(mel),
                                          f"vocoder {tag} {b} {key}")[0]
                        with parent_library():
                            busy_was = busy_share(
                                lambda: f_(mel),
                                f"vocoder {tag} {b} {key} parent")[0]
                        row[b].update({f"{key}_in_turns": now,
                                       f"was_{key}": was,
                                       f"{key}_busy": busy,
                                       f"was_{key}_busy": busy_was})
                    log(f"  vocoder {tag} batch {b}, in turns with the "
                        f"parent tree's kernels: one-shot "
                        f"{row[b]['ms_in_turns']:.3f} ms (parent tree "
                        f"{row[b]['was_ms']:.3f}), chunked "
                        f"{row[b]['chunked_ms_in_turns']:.3f} ms (parent "
                        f"tree {row[b]['was_chunked_ms']:.3f}); device busy "
                        f"of one call, this tree / parent: one-shot "
                        f"{row[b]['ms_busy']} / {row[b]['was_ms_busy']}, "
                        f"chunked {row[b]['chunked_ms_busy']} / "
                        f"{row[b]['was_chunked_ms_busy']}")
            if not fused and quant in ("none", "bf16"):
                # witness of the chunked run's differences: the conv sites'
                # bits in a window against the whole batch's
                row["window_witness"] = window_witness(voc, mels)
                for b, w in row["window_witness"].items():
                    log(f"  vocoder {tag} batch {b}: {w['sites_differing']}"
                        f" of {w['sites']} conv sites give another bit in "
                        f"the window than in the whole batch "
                        f"({w['elements_differing']} of {w['elements']} "
                        "elements)")
            # the card against the CPU's same rung, one utterance
            cpu = build("cpu", **fields)
            for (name, buf), (_, b_card) in zip(cpu.named_buffers(),
                                                voc.named_buffers()):
                buf.copy_(b_card.cpu())
            want = cpu(sub.cpu())
            got = voc(sub).cpu()
            if quant == "none":
                err, bar = _max_err(got, want), TOL_WAV_CPU
                off = apart = None
            else:
                err = _norm(got - want)
                bar = RUNG_RATIO[kind] * _norm(want - cpu_fp32)
                # a card that did not round or quantize lies nearer the
                # CPU's fp32 waveform than the CPU's rung
                off, apart = _norm(got - cpu_fp32), _norm(want - cpu_fp32)
            row["card_vs_cpu"], row["card_vs_cpu_bar"] = err, bar
            row["card_vs_cpu_fp32"] = off
            log(f"  vocoder {tag}, card vs CPU (utterance 0 of A, "
                f"{RUNG_CPU_FRAMES} frames): {err:.4g} (<= {bar:.4g})"
                + ("" if off is None else
                   f", card vs the CPU's fp32 {off:.4g} (> {err:.4g}); "
                   f"CPU rung vs CPU fp32 {apart:.4g}"))
            if not err <= bar:
                raise AssertionError(f"vocoder {tag}: card vs CPU {err} > "
                                     f"{bar}")
            if off is not None and not err < off:
                raise AssertionError(f"vocoder {tag}: the card lies nearer "
                                     f"the CPU's fp32 waveform ({off}) than "
                                     f"its rung ({err})")
            rows[tag] = row
            del voc, chunked, cpu
    return launches, rows


def mrf_chain_bf16(x, W, biases, kernel_sizes, dilations):
    """#7's library time: the level as a chain of ``F.conv1d`` in bf16
    (activations, weights and biases bf16). Timed only."""
    F_ = torch.nn.functional
    x, W, biases = x.to(torch.bfloat16), W.to(torch.bfloat16), \
        biases.to(torch.bfloat16)
    tap, conv, out = 0, 0, None
    for k, ds in zip(kernel_sizes, dilations):
        cur = x
        for d in ds:
            w1 = W[tap:tap + k].permute(2, 1, 0)
            w2 = W[tap + k:tap + 2 * k].permute(2, 1, 0)
            xt = F_.conv1d(F_.leaky_relu(cur, 0.1), w1, biases[conv],
                           padding=(k - 1) // 2 * d, dilation=d)
            cur = cur + F_.conv1d(F_.leaky_relu(xt, 0.1), w2,
                                  biases[conv + 1], padding=(k - 1) // 2)
            tap, conv = tap + 2 * k, conv + 2
        out = cur if out is None else out + cur
    return out / len(kernel_sizes)


def bf16_mode_kernels(name, run32, run16, want32, want16,
                      own=("ffn_", "mrf_", "widen_kernel", "narrow_kernel")):
    """#6's, #7's, #5's, #4's or #3's bf16 call launches its bf16 kernels
    (ffn_bf16.cuh's, mrf_bf16.cuh's, relpos_bf16.cuh's, links_bf16.cuh's,
    attention_bf16.cuh's full-bias mode; ``want16``: name -> count) and
    none of the fp32 mode's kernels or the
    casts the bf16 entry points once ran; the fp32 call launches the fp32
    mode's (``want32``) as before and no bf16 kernel (by name, under
    ``torch.profiler``; ``own``: what the names of our kernels hold, #6's
    and #7's living outside namespace daspeech). Returns the bf16 call's
    kernel count."""
    (k32, _), (k16, _) = (profiled_own_kernels(name, tag, fn, own)
                          for tag, fn in (("fp32", run32), ("bf16", run16)))

    def counts(kernels, want):
        return {t: sum(t in n for n in kernels) for t in want}

    ok16 = (counts(k16, want16) == want16
            and len(k16) == sum(want16.values())
            and not any(t in n for n in k16 for t in (
                *GEMM_TC, "widen_kernel", "narrow_kernel")))
    ok32 = (counts(k32, want32) == want32
            and len(k32) == sum(want32.values())
            and not any("_bf16_" in n for n in k32))
    if not (ok16 and ok32):
        raise AssertionError(f"{name}: the bf16 call launches {k16}, the "
                             f"fp32 call {k32}")
    log(f"  {name} bf16: {len(k16)} kernels, the bf16 mode's "
        f"({', '.join(sorted(set(n[:48] for n in k16)))}); fp32: "
        f"{len(k32)} kernels, the 3xTF32 mode's")
    return len(k16)


def bf16_alternate_rows():
    """#7, #6 and #3 with bf16 operands against their plain bf16 versions
    (within 2^-7 of the output's largest magnitude): #7 at serving A's
    level 1, serving B's level 1 and a chunk window, #6 at cell T's FFN
    [80, 120] (forward and backward, dropout 0.1), #3 at the ALiBi shape
    (training forward and backward, dropout 0.1); each row's kernel, plain
    and library times beside the bound at 989 TFLOP/s and on the bf16
    bytes, its TFLOP/s, the device ms by kernel beside the library's, the
    kernels each bf16 call launches (by name), and with --parent the
    parent tree's time timed in turns (``was_ms``). Returns {name: rows}."""
    from daspeech_torch.models import conformer
    from daspeech_torch.models.layers import set_dtype
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_ffn as ff
    from daspeech_torch.ops import fused_mrf as fm

    bf = torch.bfloat16
    g = torch.Generator().manual_seed(SEED + 60)
    rows = {n: [] for n in ("mrf_level bf16", "fused_ffn bf16",
                            "fused_attention_full_bias bf16")}

    def row(name, shape, err, run_kernel, run_plain, flops, nbytes,
            run_library, **extra):
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        lib_ms = cuda_ms(run_library)
        b_ms, b_by = bound(flops, nbytes, PEAK_FLOPS_BF16)
        # every bf16 mode here has kernels of its own: the parent tree's
        # time, in turns, and the device time by kernel beside the library's
        was = None
        if PARENT:
            ms, was = in_turns(run_kernel)
        extra["device_ms"] = kernel_split(run_kernel, f"{name} {shape}")
        extra["library_device_ms"] = kernel_split(
            run_library, f"{name} {shape} library")
        extra["tflops"] = flops / ms / 1e9
        extra["library_tflops"] = flops / lib_ms / 1e9
        rows[name].append({
            "shape": shape, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "was_ms": was, **extra})
        tf = lambda t: f" ({flops / t / 1e9:.1f} TFLOP/s)"  # noqa: E731
        log(f"  {name} {shape}: max abs err {err:.3g}  kernel {ms:.4f} ms"
            f"{tf(ms)}" + ("" if was is None else
                           f"  parent tree {was:.4f} ms{tf(was)}")
            + f"  plain {plain_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})  "
            f"library {lib_ms:.4f} ms{tf(lib_ms)}"
            + "".join(f"  {k} {extra[k]:.4f}" for k in
                      ("device_ms", "library_device_ms")
                      if extra.get(k) is not None))

    # --- #7: bf16 weights, fp32 activations and output
    n_taps = 2 * len(MRF_DILATIONS[0]) * sum(MRF_KERNELS)
    for i, (B, C, T) in enumerate((MRF_SHAPES[0], MRF_SHAPES[3],
                                   MRF_SHAPES[4])):
        x, W, biases = mrf_inputs(g, B, C, T)
        Wb = W.to(bf)
        shape = f"x[{B},{C},{T}] bf16 W"
        extra = {}
        with torch.inference_mode():
            got = fm.mrf_level(x, Wb, biases, MRF_KERNELS, MRF_DILATIONS)
            err = bf16_close(f"#7 bf16 {shape}", got, fm.mrf_level_ref(
                x, Wb, biases, MRF_KERNELS, MRF_DILATIONS))
            if i == 0:
                extra["bf16_kernels"] = bf16_mode_kernels(
                    "mrf_level", lambda: fm.mrf_level(
                        x, W, biases, MRF_KERNELS, MRF_DILATIONS),
                    lambda: fm.mrf_level(x, Wb, biases, MRF_KERNELS,
                                         MRF_DILATIONS),
                    FP32_MRF_LAUNCH, BF16_MRF_LAUNCH)
            row("mrf_level bf16", shape, err,
                lambda: fm.mrf_level(x, Wb, biases, MRF_KERNELS,
                                     MRF_DILATIONS),
                lambda: fm.mrf_level_ref(x, Wb, biases, MRF_KERNELS,
                                         MRF_DILATIONS),
                2 * B * T * C * C * n_taps,
                2 * B * C * T * F32 + n_taps * C * C * BF16_BYTES,
                lambda: mrf_chain_bf16(x, W, biases, MRF_KERNELS,
                                       MRF_DILATIONS), **extra)
        del x, W, Wb, biases, got

    # --- #6: bf16 x, weights and biases; forward + backward
    C, Fd = ff.WIDTH, FFN_DIM
    B, T, p = FFN_SHAPES[0]
    N = B * T
    x = _randn(g, B, T, C).to(bf)
    gm, bt, w1, b1, w2, b2 = ffn_params(g, C, Fd)
    params = (gm, bt, *(t.to(bf) for t in (w1, b1, w2, b2)))
    seeds = _seeds(g, B)
    do = _randn(g, B, T, C, scale=N ** -0.5).to(bf)
    shape = f"x[{B},{T},{C}] F={Fd} p={p} bf16"
    err = bf16_close(f"#6 bf16 {shape}", ff.ffn_fwd_kernel(
        x, *params, seeds, p, p), ff.ffn_plain(x, *params, seeds, p, p))
    for u, w in zip(ff.ffn_bwd_kernel(x, *params, do, seeds, p, p),
                    ff.ffn_bwd_plain(x, *params, do, seeds, p, p)):
        err = max(err, bf16_close(f"#6 bf16 {shape} backward", u, w))
    lib = set_dtype(conformer.FeedForwardModule(C, Fd, dropout=p),
                    bf).cuda().train()
    lib_ins = [x.detach().requires_grad_(True)]

    def run_lib():
        out = lib(lib_ins[0], torch.Generator(device="cuda"))
        return torch.autograd.grad(out, [lib_ins[0], *lib.parameters()], do)

    def run(x=x, params=params, do=do):
        return (ff.ffn_fwd_kernel(x, *params, seeds, p, p),
                ff.ffn_bwd_kernel(x, *params, do, seeds, p, p))

    f32 = [x.float(), gm, bt, w1, b1, w2, b2, do.float()]
    bf16_kernels = bf16_mode_kernels(
        "fused_ffn", lambda: run(f32[0], f32[1:7], f32[7]), run,
        FP32_FFN_LAUNCH, BF16_FFN_LAUNCH)
    row("fused_ffn bf16", shape, err, run,
        lambda: (ff.ffn_plain(x, *params, seeds, p, p),
                 ff.ffn_bwd_plain(x, *params, do, seeds, p, p)),
        14 * N * C * Fd,
        (4 * N * C + 2 * C * Fd + Fd + C) * BF16_BYTES
        + (2 * C * Fd + Fd + 5 * C) * F32, run_lib,
        bf16_kernels=bf16_kernels,
        fp32_ms=cuda_ms(lambda: run(f32[0], f32[1:7], f32[7])))
    del x, params, do, lib, lib_ins, f32

    # --- #3: bf16 q, k, v, fp32 bias4; training forward + backward
    B, H, T = ALIBI_SHAPE
    q = _randn(g, B, H, T, 64, scale=0.125).to(bf)
    k, v, do = (_randn(g, B, H, T, 64).to(bf) for _ in range(3))
    bias4 = alibi_bias(B, H, T)
    seed = torch.tensor([99], dtype=torch.int32, device="cuda")
    shape = f"ALiBi [{B},{H},{T},64] p=0.1 bf16"
    want = fa.attention_full_bias_plain(q, k, v, bias4, 1.0, 0.1, seed)
    err = bf16_close(f"#3 bf16 {shape} inference", fa.attention_fb_fwd_kernel(
        q, k, v, bias4, 1.0, 0.1, seed)[0], want)
    out, st = fa.attention_fb_fwd_kernel(q, k, v, bias4, 1.0, 0.1, seed,
                                         with_stats=True)
    err = max(err, bf16_close(f"#3 bf16 {shape} training", out, want))
    for u, w in zip(fa.attention_fb_bwd_kernel(q, k, v, bias4, out, st, do,
                                               1.0, 0.1, seed),
                    fa.attention_full_bias_bwd_plain(q, k, v, bias4, do, 1.0,
                                                     0.1, seed)):
        err = max(err, bf16_close(f"#3 bf16 {shape} backward", u, w))

    def run(q=q, k=k, v=v, do=do):
        o, s = fa.attention_fb_fwd_kernel(q, k, v, bias4, 1.0, 0.1, seed,
                                          with_stats=True)
        return fa.attention_fb_bwd_kernel(q, k, v, bias4, o, s, do, 1.0, 0.1,
                                          seed)

    f32 = [x.float() for x in (q, k, v, do)]
    # the fp32 call launches #5's fp32 kernels in their full-bias instances
    bf16_kernels = bf16_mode_kernels(
        "fused_attention_full_bias", lambda: run(*f32), run,
        FP32_RELPOS_LAUNCH, {n: 1 for n in BF16_FB_KERNELS},
        own=("daspeech",))
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    mask = bias4.to(bf).requires_grad_(True)
    row("fused_attention_full_bias bf16", shape, err, run,
        lambda: (fa.attention_full_bias_plain(q, k, v, bias4, 1.0, 0.1, seed),
                 fa.attention_full_bias_bwd_plain(q, k, v, bias4, do, 1.0,
                                                  0.1, seed)),
        14 * B * H * T * T * 64,
        8 * B * H * T * 64 * BF16_BYTES + 2 * B * H * T * T * F32,
        lambda: torch.autograd.grad(
            torch.nn.functional.scaled_dot_product_attention(
                *leaves, attn_mask=mask, dropout_p=0.1, scale=1.0),
            [*leaves, mask], do),
        bf16_kernels=bf16_kernels, fp32_ms=cuda_ms(lambda: run(*f32)))
    return rows


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
    from daspeech_torch.models.layers import set_dtype
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

    # --- cell T in bf16 (--dtype bfloat16) with every encoder FFN fused:
    # 3 warm-up and 10 timed updates whose launches are read, each FFN on
    # the bf16 entry points
    model = set_dtype(set_fused_ffn_(copy.deepcopy(model_cpu).to(DEVICE),
                                     True), torch.bfloat16)
    opt = GuardedAdam()
    step = make_train_step(loss_fn_for(cfg, 0.5), opt)
    med, iqr, launches, peak, _ = timed_updates(
        step, TrainState.create(model, opt), batch, 3, 10,
        f"S2TT T bf16, encoder FFN fused (B={TRAIN_B}, dropout 0.1, GLAT "
        "0.5)")
    runs["fused bf16"] = launches
    per = {n: launches[f"{n} bf16"] / 13 for n in ("fused_ffn",
                                                    "fused_ffn_bwd")}
    log(f"  bf16 fused_ffn launches per update: forward "
        f"{per['fused_ffn']:g}, backward {per['fused_ffn_bwd']:g} (expected "
        f"{FFN_PER_UPDATE} each); update {med:.3f} ms (IQR {iqr[0]:.3f}-"
        f"{iqr[1]:.3f}), peak {peak:.2f} GiB")
    if per != {"fused_ffn": FFN_PER_UPDATE, "fused_ffn_bwd": FFN_PER_UPDATE}:
        raise AssertionError(f"bf16 fused_ffn launches per update {per}")
    del model, step
    if PARENT:
        # the same bf16 updates with the parent tree's FFN kernels, in
        # turns: this tree, parent, parent, this
        turns = {"this tree": [], "parent tree": []}
        for mine in (True, False, False, True):
            model = set_dtype(set_fused_ffn_(
                copy.deepcopy(model_cpu).to(DEVICE), True), torch.bfloat16)
            opt = GuardedAdam()
            step = make_train_step(loss_fn_for(cfg, 0.5), opt)
            tag = "this tree" if mine else "parent tree"
            state = TrainState.create(model, opt)
            with (contextlib.nullcontext() if mine else parent_library()):
                med, _, _, _, _ = timed_updates(
                    step, state, batch, 3, 10,
                    f"S2TT T bf16, encoder FFN fused, {tag}'s kernels")
                busy, _ = busy_share(
                    lambda: step(state, batch,
                                 torch.Generator().manual_seed(SEED)),
                    f"bf16 fused FFN update {tag}")
            turns[tag].append((med, busy))
            del model, state, step
        ms["fused bf16 in turns"] = turns
        log("  bf16 fused-FFN updates in turns (median ms, device busy ms "
            "of one update): " + "; ".join(
                f"{tag} " + ", ".join(
                    f"{m:.3f} ({'-' if b is None else f'{b:.2f}'})"
                    for m, b in v) for tag, v in turns.items()))

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
    # --- the same in bf16: bf16 q, k, v, fp32 ALiBi bias
    bf = torch.bfloat16
    b_ins = [*(t.detach().to(bf).requires_grad_(True) for t in ins[:3]),
             ins[3].detach().requires_grad_(True)]
    reset_launches()
    out_b = fa.fused_attention_full_bias(*b_ins, 1234, 0.125, 0.1, True)
    got_b = torch.autograd.grad(out_b, b_ins, do.to(bf))
    torch.cuda.synchronize()
    runs["full_bias bf16"] = read_launches()
    b_plain = [t.detach() for t in b_ins]
    err = bf16_close("#3 bf16 through the op", out_b,
                     fa.attention_full_bias_plain(*b_plain, 0.125, 0.1,
                                                  seed))
    for u, w in zip(got_b, fa.attention_full_bias_bwd_plain(
            *b_plain, do.to(bf), 0.125, 0.1, seed)):
        err = max(err, bf16_close("#3 bf16 through the op, backward", u, w))
    n_fb = tuple(runs["full_bias bf16"][f"{n} bf16"] for n in (
        "fused_attention_full_bias", "fused_attention_full_bias_bwd"))
    log(f"  fused_attention_full_bias bf16, ALiBi bias [{B},{H},{T},64] "
        f"p=0.1: forward and backward against the plain bf16 version "
        f"{err:.3g}; bf16 launches forward {n_fb[0]}, backward {n_fb[1]}")
    if n_fb != (1, 1):
        raise AssertionError("bf16 full-bias attention through the op did "
                             f"not launch its kernels: {n_fb}")
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
# AR and TTS-options phase: Transformer-TTS (at_tts), the two-pass
# multi-decoder S2ST (at_s2s) with the length beam's reranker, Griffin-Lim,
# FastSpeech 2's Postnet, speakers, CTC head and unfused attention, and the
# two AR criteria's training steps
# ---------------------------------------------------------------------------

AR_TTS_SHAPE = (8, 52)       # TTS A: utterances, phonemes
AR_MAX_MEL = 1024            # --max-mel-len, the generate CLI's default
AR_MAX_TEXT = 200            # --max-text-len, the generate CLI's default
AR_PROFILE = (32, 128)       # text steps, mel frames of the profiled runs
AR_PROBE = (32, 64)          # text steps, mel frames of the shaping probes
AR_THRESHOLD = 0.5           # --stop-threshold, the CLI's default
TOL_AR_MEL = 1e-3            # a generated frame against the CPU's
TOL_RERANK = 1e-4            # a reranker score against the CPU's
TOL_GL = 1e-3                # Griffin-Lim waveform, relative L2, vs CPU
AR_TRAIN_TTS = (8, 52, 416)  # B, phonemes, mel frames
AR_TRAIN_MDEC = (8, 480, 64, 416)   # B, fbank frames, text tokens, mel
FS2_SPEAKERS = 4


class no_prenet_dropout:
    """Within the block the AR mel decoders' prenet dropout (a fixed 0.5)
    is 0: the card's and the CPU's generators draw other masks, so a
    card-vs-CPU step runs with every dropout off."""

    def __enter__(self):
        from daspeech_torch.models import tts_transformer as tt

        self.module, self.orig = tt, tt.PRENET_DROPOUT
        tt.PRENET_DROPOUT = 0.0
        return self

    def __exit__(self, *exc):
        self.module.PRENET_DROPOUT = self.orig


def place_stops_(model, decode, B):
    """Random weights stop every row at its first frame or never. Zero the
    stop head's bias, run AR_PROBE[1] steps on the card, then set the bias
    halfway between the 4th and 5th highest row peaks of the probe's stop
    logits: the first AR_PROBE[1] frames of the real run are the probe's
    (no frame depends on the stop head), so half of the rows stop within
    them. Returns the bias."""
    from daspeech_torch.models.tts_transformer import ar_mel_loop

    with torch.inference_mode():
        model.stop_out.bias.zero_()
        mel, _ = ar_mel_loop(decode, B, AR_PROBE[1], model.out_dim,
                             model.dtype, DEVICE)
        _, stop = decode(torch.cat([torch.zeros_like(mel[:, :1]),
                                    mel[:, :-1]], dim=1))
        peaks = stop.float().max(dim=1).values.sort(descending=True).values
        bias = -float(peaks[B // 2 - 1] + peaks[B // 2]) / 2
        model.stop_out.bias.fill_(bias)
    return bias


def place_eos_(md, enc, enc_pad, vocab):
    """Random weights emit <s> or <eos> at every step, or one word. The
    tied table's <s>, <pad> and <unk> rows become 0, and <eos>'s row e is
    scaled by s; the learned position row of slot 0 (where every prefix
    holds <eos>) takes the change of that row's input, so the decoder's
    states do not move. With the row zeroed, a probe of AR_PROBE[0] steps
    gives each row the least s at which <eos> would first win (the tokens
    before are the probe's), and s is set halfway between the 4th and 5th
    smallest: half of the rows end within the probe's steps. Returns s."""
    dec = md.mt_decoder
    emb, pos = dec.embed_tokens.weight, dec.embed_positions.weight
    row, root = vocab.pad + 1, math.sqrt(dec.embed_dim)

    def set_eos(value):
        pos[row] += (emb[vocab.eos] - value) * root
        emb[vocab.eos] = value

    with torch.inference_mode():
        e = emb[vocab.eos].clone()
        emb[[vocab.bos, vocab.pad, vocab.unk]] = 0.0
        set_eos(torch.zeros_like(e))
        B = enc.shape[0]
        buf = torch.full((B, AR_PROBE[0] + 1), vocab.pad, dtype=torch.long,
                         device=DEVICE)
        buf[:, 0] = vocab.eos
        for t in range(AR_PROBE[0]):   # the probe, no row ending
            logits, _ = md.mt_decode(buf[:, : t + 1], enc, enc_pad)
            buf[:, t + 1] = logits[:, t].argmax(dim=-1)
        logits, feats = md.mt_decode(buf[:, :-1], enc, enc_pad)
        a = feats.float() @ e.float()                       # [B, K]
        logits[..., vocab.eos] = -math.inf
        m = logits.float().max(dim=-1).values
        ratio = torch.where(a > 0, m / a, torch.full_like(a, math.inf))
        first = ratio.clamp(min=0.0).min(dim=1).values.sort().values
        k = B // 2
        s = (float(first[k - 1] + first[k]) / 2
             if bool(torch.isfinite(first[k])) else 0.0)
        set_eos(s * e)
    return s


def check_ar_mels(tag, mel, lens, decode_cpu):
    """The card's generated frames against the CPU teacher-forced once on
    the card's buffer (no drift compounds): every frame within TOL_AR_MEL,
    and each row's stop step the CPU's first crossing, or else the CPU's
    stop logit at the step where the two part within MARGIN of the
    threshold's logit. Returns (max abs diff, stop steps, near ties)."""
    mel = mel.float().cpu()
    prev = torch.cat([torch.zeros_like(mel[:, :1]), mel[:, :-1]], dim=1)
    with torch.inference_mode():
        mel_c, stop_c = decode_cpu(prev)
    err = float((mel_c.float() - mel).abs().max())
    if not (torch.isfinite(mel).all() and err <= TOL_AR_MEL):
        raise AssertionError(f"{tag}: frames differ from the CPU's by {err}")
    thr = math.log(AR_THRESHOLD / (1 - AR_THRESHOLD))
    M, ties = mel.shape[1], []
    steps = [int(x) for x in lens.cpu()]
    for b, got in enumerate(steps):
        hits = (stop_c[b].float() > thr).nonzero()
        want = int(hits[0]) + 1 if len(hits) else M
        if got != want:
            t = min(got, want) - 1
            gap = abs(float(stop_c[b, t]) - thr)
            log(f"  {tag} row {b}: the card stops at {got}, the CPU at "
                f"{want}; the CPU's stop logit at step {t} is {gap:.3g} "
                "from the threshold's")
            if not gap <= MARGIN:
                raise AssertionError(f"{tag} row {b}: stop steps differ, "
                                     f"gap {gap} > {MARGIN}")
            ties.append(gap)
    return err, steps, ties


def ar_tts_run(vocab, rng):
    """``at_tts``: Transformer-TTS (TTSTransformerConfig's defaults, 4+4L x
    256d) on TTS A's batch, AR_MAX_MEL steps. Returns its launches."""
    from daspeech_torch.config import TTSTransformerConfig, to_dict
    from daspeech_torch.decode import AutoRegressiveSpeechGenerator
    from daspeech_torch.models import TTSTransformer

    model_cpu = init_random_(TTSTransformer(
        vocab.size, vocab.pad, **to_dict(TTSTransformerConfig())),
        SEED + 60).eval().requires_grad_(False)
    model = copy.deepcopy(model_cpu).to(DEVICE)
    B, n = AR_TTS_SHAPE
    batch = {"src_tokens": rng.integers(4, vocab.size, size=(B, n))}
    tokens = torch.as_tensor(batch["src_tokens"])
    with torch.inference_mode():
        enc_d = model.encode(tokens.to(DEVICE))
    bias = place_stops_(model, lambda p: model.decode_mel(p, *enc_d), B)
    model_cpu.load_state_dict(model.state_dict())
    gen = AutoRegressiveSpeechGenerator(model, vocab, max_mel_len=AR_MAX_MEL)
    reset_launches()
    with torch.inference_mode():
        mel, lens = gen.synthesize(tokens.to(DEVICE))
    sync()
    launches = read_launches()
    with torch.inference_mode():
        enc = model_cpu.encode(tokens)
    err, steps, ties = check_ar_mels(
        "at_tts", mel, lens, lambda prev: model_cpu.decode_mel(prev, *enc))
    ms = host_ms(lambda: gen.generate(batch, generate_waveform=False))
    short = AutoRegressiveSpeechGenerator(model, vocab,
                                          max_mel_len=AR_PROFILE[1])
    with torch.inference_mode():
        device_busy(lambda: short.synthesize(tokens.to(DEVICE)),
                    f"at_tts {AR_PROFILE[1]} frames")
    log(f"  at_tts ({B} x {n} phonemes, {AR_MAX_MEL} steps): generate() "
        f"{ms:.3f} ms (median of 5), {ms / AR_MAX_MEL:.3f} ms a step; stop "
        f"bias {bias:.4g}, stop steps {steps}; frames vs the CPU "
        f"teacher-forced on the card's buffer {err:.3g} (<= {TOL_AR_MEL}), "
        f"{len(ties)} stop near ties; "
        "launches " + (", ".join(f"{k} {v}" for k, v in launches.items()
                                 if v) or "none (every attention plain)"))
    return launches


def ar_s2s_run(ctx, vocab):
    """``at_s2s`` with MultiDecoderConfig's defaults (Conformer 12L x 256d,
    text decoder 4L, synthesizer 2L, mel decoder 4L) on serving A's batch,
    then the same model as the length beam's reranker of serving A's DAG
    model. Returns (at_s2s launches, reranker launches)."""
    from daspeech_torch.config import DecodeConfig, MultiDecoderConfig, to_dict
    from daspeech_torch.decode import (MultiDecoderSpeechGenerator,
                                       S2TNATGenerator)
    from daspeech_torch.decode.generator import (_strategy_decode,
                                                 decoder_pass,
                                                 length_beam_scores,
                                                 rerank_scores)
    from daspeech_torch.models import S2SMultiDecoderModel

    md_cpu = init_random_(S2SMultiDecoderModel(
        vocab.size, vocab.pad, vocab.bos, vocab.eos,
        **to_dict(MultiDecoderConfig())), SEED + 61).eval().requires_grad_(
            False)
    md = copy.deepcopy(md_cpu).to(DEVICE)
    batch = ctx["batches"]["A"][0]
    TL = AR_MAX_TEXT
    gen = MultiDecoderSpeechGenerator(md, vocab, max_text_len=TL,
                                      max_mel_len=AR_MAX_MEL)
    with torch.inference_mode():
        fbank, lens = gen.to_device(batch)
        enc, enc_pad = md.forward_encoder(fbank, lens)
    eos_scale = place_eos_(md, enc, enc_pad, vocab)
    reset_launches()
    sync()
    t0 = time.perf_counter()
    with torch.inference_mode():
        buf, tl, enc, enc_pad = gen.translate(fbank, lens)
        sync()
        t_text = time.perf_counter() - t0
        synth, mt_pad_d = gen.synth_states(buf, tl, enc, enc_pad)
    bias = place_stops_(md, lambda p: md.tts_decode(p, synth, mt_pad_d),
                        fbank.shape[0])
    sync()
    t1 = time.perf_counter()
    with torch.inference_mode():
        mel, mel_lens = gen.synthesize(buf, tl, enc, enc_pad)
    sync()
    ms = (t_text + time.perf_counter() - t1) * 1e3
    launches = read_launches()
    md_cpu.load_state_dict(md.state_dict())
    if launches["fused_attention_relpos"] <= 0:
        raise AssertionError("at_s2s did not launch the rel-pos attention")
    # the CPU teacher-forced on the card's tokens: each token the CPU's
    # argmax, or within MARGIN of it
    gen_c = MultiDecoderSpeechGenerator(md_cpu, vocab, max_text_len=TL,
                                        max_mel_len=AR_MAX_MEL)
    buf_c, tl_c = buf.cpu(), tl.cpu()
    with torch.inference_mode():
        fb_c, lens_c = gen_c.to_device(batch)
        enc_c, pad_c = md_cpu.forward_encoder(fb_c, lens_c)
        logits, _ = md_cpu.mt_decode(buf_c[:, :TL], enc_c, pad_c)
        logp = torch.log_softmax(logits.float(), dim=-1)
    tok_ties = []
    for b in range(buf_c.shape[0]):
        for t in range(int(tl_c[b])):
            card = int(buf_c[b, t + 1])
            gap = float(logp[b, t].max() - logp[b, t, card])
            if gap > 0:
                log(f"  at_s2s row {b} step {t}: the CPU's top token is not "
                    f"the card's; log-prob gap {gap:.3g}")
                if not gap <= MARGIN:
                    raise AssertionError(f"at_s2s row {b} step {t}: token "
                                         f"differs, gap {gap} > {MARGIN}")
                tok_ties.append(gap)
    with torch.inference_mode():
        idx = torch.arange(TL)[None, :]
        prev_mt = torch.where(idx < tl_c[:, None], buf_c[:, :TL], vocab.pad)
        _, feats = md_cpu.mt_decode(prev_mt, enc_c, pad_c)
        mt_pad = prev_mt == vocab.pad
        synth = md_cpu.synthesize_encode(feats, mt_pad)
    err, steps, ties = check_ar_mels(
        "at_s2s", mel, mel_lens,
        lambda prev: md_cpu.tts_decode(prev, synth, mt_pad))
    short = MultiDecoderSpeechGenerator(md, vocab, max_text_len=AR_PROFILE[0],
                                        max_mel_len=AR_PROFILE[1])
    device_busy(lambda: short.generate(batch, generate_waveform=False),
                f"at_s2s {AR_PROFILE[0]} tokens {AR_PROFILE[1]} frames")
    log(f"  at_s2s (serving A, 8 x 480 fbank frames, {TL} text and "
        f"{AR_MAX_MEL} mel steps): translate + synthesize {ms:.3f} ms (one "
        "run, the stop probe left out); "
        f"<eos> scale {eos_scale:.4g}, stop bias {bias:.4g}; "
        f"text lengths {tl_c.tolist()}, card vs CPU tokens "
        f"{'identical' if not tok_ties else f'{len(tok_ties)} near ties'}; "
        f"stop steps {steps}; frames vs the CPU {err:.3g} (<= "
        f"{TOL_AR_MEL}), {len(ties)} stop near ties; fused_attention_relpos "
        f"launches {launches['fused_attention_relpos']} (the Conformer's "
        "12 layers, one encoder pass)")

    # the length beam of 3 over serving A's DAG model, reranked by md
    dc = DecodeConfig(length_beam=3)
    dag = ctx["model"]
    gen_r = S2TNATGenerator(dag, vocab, dc, reranker=md)
    gen_p = S2TNATGenerator(dag, vocab, dc)
    reset_launches()
    gen_r.generate(batch)
    sync()
    launches_r = read_launches()
    if launches_r["fused_attention_relpos"] <= 0:
        raise AssertionError("the reranked length beam did not launch the "
                             "rel-pos attention")
    with torch.inference_mode():
        fbank, lens, prev = gen_r.to_device(batch)
        lg, lk, _, prev3 = decoder_pass(dag, fbank, lens, prev, vocab, 3)
        res = _strategy_decode(dc, vocab, lg, lk, prev3)
        sc = rerank_scores(md, fbank, lens, res.tokens, vocab.pad,
                           vocab.eos, 3)
        sc_c = rerank_scores(md_cpu, fb_c, lens_c, res.tokens.cpu(),
                             vocab.pad, vocab.eos, 3)
        by_path = length_beam_scores(dc, lg, res, 3).argmax(1).cpu()
    rerr = float((sc.cpu() - sc_c).abs().max())
    if not rerr <= TOL_RERANK:
        raise AssertionError(f"reranker scores differ from the CPU's by "
                             f"{rerr}")
    moved = int((sc_c.reshape(-1, 3).argmax(1) != by_path).sum())
    with torch.inference_mode():
        ms_r = host_ms(lambda: gen_r.run(fbank, lens, prev))
        ms_p = host_ms(lambda: gen_p.run(fbank, lens, prev))
    log(f"  length beam 3 at serving A reranked by the multi-decoder: "
        f"scores vs the CPU's {rerr:.3g} (<= {TOL_RERANK}); the reranker "
        f"picks another candidate than the path score in {moved} of "
        f"{len(by_path)} rows; decode pass {ms_r:.3f} ms with the reranker, "
        f"{ms_p:.3f} ms without (median of 5); fused_attention_relpos "
        f"launches {launches_r['fused_attention_relpos']} (the DAG's and the "
        "reranker's encoders, one pass each)")
    return launches, launches_r


def griffin_lim_run(mel):
    """Griffin-Lim (32 iterations) on serving A's mel against the CPU
    (relative L2 within TOL_GL), each row alone against the batch bit for
    bit, and its CUDA-event ms."""
    from daspeech_torch.models import GriffinLimVocoder

    voc = GriffinLimVocoder()
    with torch.inference_mode():
        mel = mel.float()
        wav = voc(mel)
        sync()
        wav_c = voc(mel.cpu())
        rel = float((wav.cpu() - wav_c).norm() / wav_c.norm())
        if not (torch.isfinite(wav).all() and rel <= TOL_GL):
            raise AssertionError(f"Griffin-Lim: waveform off the CPU's by "
                                 f"{rel}")
        for i in range(mel.shape[0]):
            if not torch.equal(voc(mel[i:i + 1])[0], wav[i]):
                raise AssertionError(f"Griffin-Lim: row {i} alone differs "
                                     "from the batch")
        ms = cuda_ms(lambda: voc(mel), reps=5, warm=1)
    log(f"  Griffin-Lim, serving A's mel {tuple(mel.shape)}, 32 iterations: "
        f"{ms:.3f} ms (median of 5); vs the CPU relative L2 {rel:.3g} (<= "
        f"{TOL_GL}); each row alone equal to the batch, bit for bit")


def fs2_options_run(vocab):
    """FastSpeech 2 with the Postnet, FS2_SPEAKERS speakers, ctc_weight 0.1
    and the unfused attention at P's shape: one card-vs-CPU step (dropout
    off) on P_PARITY_B of P's utterances, as the pretraining phase's (at
    B = 14 the Postnet's conv weights, which feed a BatchNorm that cancels
    most of their gradient, read 1.8e-3: the CPU's own fp32 sat 9.4e-4 of
    their norm off float64 there, the card's 2.0e-3); then 5 timed
    updates at P on the unfused route and on the kernel route
    (the same options and weights, fused_attention=True), in turns.
    Returns the unfused updates' launches."""
    import dataclasses

    from daspeech_torch.config import FastSpeech2Config
    from daspeech_torch.models import FastSpeech2Encoder
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    cfg = FastSpeech2Config(add_postnet=True, num_speakers=FS2_SPEAKERS,
                            ctc_weight=0.1, fused_attention=False)
    model_cpu = init_random_(FastSpeech2Encoder(cfg, vocab.size), SEED + 62)
    ref = FastSpeech2Encoder(dataclasses.replace(
        cfg, dropout=0.0, var_pred_dropout=0.0, postnet_dropout=0.0),
        vocab.size)
    ref.load_state_dict(model_cpu.state_dict())
    B, T, M, dur = P_SHAPE
    batch = make_fs2_batch(B, T, M, dur, vocab, SEED + 63, "cpu")
    batch["speaker"] = torch.arange(B) % FS2_SPEAKERS
    step_parity(f"FastSpeech 2 options P (B={P_PARITY_B}, M={M})", ref,
                fs2_loss_fn(vocab),
                {k: v[:P_PARITY_B] for k, v in batch.items()})
    batch = {k: v.to(DEVICE) for k, v in batch.items()}
    opt = GuardedAdam()
    runs = {}
    for fused in (False, True, False):
        m = FastSpeech2Encoder(dataclasses.replace(cfg, fused_attention=fused),
                               vocab.size)
        m.load_state_dict(model_cpu.state_dict())
        state = TrainState.create(m.to(DEVICE), opt)
        route = "kernel route" if fused else "unfused route"
        med, _, launches, _, _ = timed_updates(
            make_train_step(fs2_loss_fn(vocab), opt), state, batch, 2, 5,
            f"FastSpeech 2 options P, {route}")
        runs.setdefault(route, (med, launches))
    if runs["unfused route"][1]["fused_attention"] or (
            runs["unfused route"][1]["fused_attention_packed"]):
        raise AssertionError("the unfused route launched an attention kernel")
    if runs["kernel route"][1]["fused_attention"] <= 0:
        raise AssertionError("the kernel route's 1040-frame decoder did not "
                             "take the head-major attention")
    log(f"  FastSpeech 2 options P: update {runs['unfused route'][0]:.3f} ms "
        f"unfused, {runs['kernel route'][0]:.3f} ms on the kernels (median "
        "of 5 each)")
    return runs["unfused route"][1]


def ar_train_run(vocab):
    """One card-vs-CPU step (every dropout off) and 5 timed updates (the
    models' own dropout) of ``tts_transformer_criterion`` at TTS A's shape
    and ``multidecoder_criterion`` at serving A's. Returns the
    multi-decoder updates' launches."""
    from daspeech_torch.config import (MultiDecoderConfig,
                                       TTSTransformerConfig, to_dict)
    from daspeech_torch.losses import (multidecoder_criterion,
                                       tts_transformer_criterion)
    from daspeech_torch.models import S2SMultiDecoderModel, TTSTransformer
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    rng = np.random.default_rng(SEED + 64)
    B, n, M = AR_TRAIN_TTS
    tts_batch = {
        "src_tokens": torch.from_numpy(rng.integers(4, vocab.size,
                                                    size=(B, n))),
        "target_audio": torch.from_numpy(
            rng.normal(size=(B, M, 80)).astype(np.float32)),
        "target_audio_lengths": torch.from_numpy(
            rng.integers(M // 2, M + 1, size=B))}
    B, S, T, M = AR_TRAIN_MDEC
    tgt = rng.integers(4, vocab.size, size=(B, T))
    tgt[:, 0], tgt[:, -1] = vocab.bos, vocab.eos
    md_batch = {
        "fbank": torch.from_numpy(
            rng.normal(size=(B, S, 80)).astype(np.float32)),
        "src_lengths": torch.full((B,), S), "target_text":
            torch.from_numpy(tgt),
        "target_audio": torch.from_numpy(
            rng.normal(size=(B, M, 80)).astype(np.float32)),
        "target_audio_lengths": torch.from_numpy(
            rng.integers(M // 2, M + 1, size=B))}
    runs = {}
    for tag, build, crit, batch, seed in (
            ("Transformer-TTS A", lambda **kw: TTSTransformer(
                vocab.size, vocab.pad, **{**to_dict(TTSTransformerConfig()),
                                          **kw}),
             tts_transformer_criterion, tts_batch, SEED + 65),
            ("multi-decoder S2ST A", lambda **kw: S2SMultiDecoderModel(
                vocab.size, vocab.pad, vocab.bos, vocab.eos,
                **{**to_dict(MultiDecoderConfig()), **kw}),
             multidecoder_criterion, md_batch, SEED + 66)):
        loss_fn = functools.partial(
            lambda c, m, b, g: c(m, b, g, vocab), crit)
        model_cpu = init_random_(build(), seed)
        ref = build(dropout=0.0)
        ref.load_state_dict(model_cpu.state_dict())
        with no_prenet_dropout():
            step_parity(tag, ref, loss_fn, batch)
        opt = GuardedAdam()
        state = TrainState.create(copy.deepcopy(model_cpu).to(DEVICE), opt)
        dev_batch = {k: v.to(DEVICE) for k, v in batch.items()}
        step = make_train_step(loss_fn, opt)
        med, _, launches, peak, _ = timed_updates(step, state, dev_batch, 2,
                                                  5, f"{tag} updates")
        runs[tag] = launches
    md = runs["multi-decoder S2ST A"]
    for name in ("fused_attention_relpos", "fused_attention_relpos_bwd"):
        if md[name] <= 0:
            raise AssertionError(f"multidecoder training did not launch "
                                 f"{name}")
    log("  multi-decoder updates: fused_attention_relpos "
        f"{md['fused_attention_relpos']}, backward "
        f"{md['fused_attention_relpos_bwd']} over 7 updates")
    return md


def ar_phase(ctx, mel_a):
    """The AR and TTS-options phase. Returns {path: launches}."""
    vocab = ctx["cfg"].dag.vocab
    rng = np.random.default_rng(SEED + 59)
    paths = {"at_tts": ar_tts_run(vocab, rng)}
    paths["at_s2s"], paths["reranker"] = ar_s2s_run(ctx, vocab)
    griffin_lim_run(mel_a)
    paths["fs2_options"] = fs2_options_run(vocab)
    paths["ar_train_mdec"] = ar_train_run(vocab)
    return paths


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
    TOL_GRAD of their norm); the same update with ``disc_dtype=bf16`` on
    the card and the CPU, held to the CPU's fp32 one (``bf16_step_check``,
    with the card closer to the CPU's bf16 update than to its fp32 one);
    3 warm-up and 10 timed updates at B = 16 x 8192 samples with bf16 D
    and then with fp32 D, the D and G halves apart, peak memory, the
    device busy share of one profiled update; 30 updates on one batch that
    must bring the mel loss to <= 0.9 of its first value. Returns the
    launches of the fp32 timed run (no hand kernel is on this path)."""
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

    # --- the same update with bf16 discriminators (disc_dtype=bf16) on the
    # card and on the CPU, held to the CPU's fp32 update above
    tr16 = {dev: VocoderTrainer(cfg, make_mel_fn(device=dev), device=dev,
                                disc_dtype=torch.bfloat16)
            for dev in (DEVICE, "cpu")}
    out16 = {}
    for dev in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        state, m = tr16[dev].train_step(
            tr16[dev].init_state(torch.Generator().manual_seed(SEED + 60)),
            mel.to(dev), wav.to(dev))
        sync()
        out16[dev] = ({k: v.item() for k, v in m.items()},
                      [g.double() for g in grads(state)[1]])
        log(f"  vocoder bf16-D update on {dev} (B={VOC_PARITY_B}): "
            + ", ".join(f"{k} {v:.6f}" for k, v in out16[dev][0].items())
            + f" ({time.perf_counter() - t0:.1f} s)")
    (mk, gk), (mb, gb) = out16[DEVICE], out16["cpu"]
    bf16_step_check("vocoder bf16-D update", names,
                    {k: (mk[k], mb[k], mc[k]) for k in ("d_loss", "g_loss")},
                    gk, gb, [g.double() for g in gc], separate=True,
                    noise=[float((a.double() - b.double()).norm())
                           for a, b in zip(gg, gc)])

    # --- 3 warm-up and 10 timed updates at B = 16, counters from 0, fp32
    # D (the launches and peak memory are this run's) and bf16 D
    mel, wav = (t.to(DEVICE) for t in vocoder_batch(VOC_B, SEED + 62,
                                                    mel_cpu))
    for tag, trainer in (("bf16-D", tr16[DEVICE]), ("fp32", tr)):
        # the state carries the discriminators' compute dtype
        state = trainer.init_state(torch.Generator().manual_seed(SEED + 60))
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        times = {"D": [], "G": [], "update": []}
        for i in range(VOC_WARM + VOC_TIMED):
            sync()
            t0 = time.perf_counter()
            state, d_loss = trainer.d_update(state, mel, wav)
            sync()
            t1 = time.perf_counter()
            state, m = trainer.g_update(state, mel, wav)
            sync()
            t2 = time.perf_counter()
            if i >= VOC_WARM:
                for k, v in (("D", t1 - t0), ("G", t2 - t1),
                             ("update", t2 - t0)):
                    times[k].append(v * 1e3)
        if tag == "bf16-D":
            q = {k: np.percentile(v, [25, 50, 75]) for k, v in times.items()}
            log(f"  vocoder updates with bf16 D (B={VOC_B} x {VOC_SEGMENT})"
                f", median ms over {VOC_TIMED} (IQR): " + "; ".join(
                    f"{k} {v[1]:.3f} ({v[0]:.3f}-{v[2]:.3f})"
                    for k, v in q.items())
                + f"; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
            if not all(math.isfinite(v.item()) for v in (d_loss,
                                                          *m.values())):
                raise AssertionError(f"bf16-D updates: non-finite {m}")
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
# the DAG loss's memory variants: the banded DP and the streamed vocabulary
# ---------------------------------------------------------------------------

BAND_W = 128                      # max_transition_length of the banded phase
BAND_SHAPE = (14, 1400, 128)      # J-long's graph: B, fbank frames (L 700), T
FV_SHAPE = (TRAIN_B, TRAIN_S, TRAIN_T)   # cell T: L = 240
FV_VOCAB = 10000                  # a multilingual subword vocabulary
FV_CHUNK = 2048                   # --fused-vocab-chunk
VARIANT_CPU_B = 2                 # utterances of the card-vs-CPU steps
VARIANT_GLAT = 0.5


def variant_config(vocab: int, mtl: int = 99999):
    """The S2TT model at the recipe's widths, dropout off, with ``vocab``
    entries and a transition band of ``mtl``."""
    from daspeech_torch.config import (ConformerConfig, DAGDecoderConfig,
                                       DAGModelConfig, VocabConfig)

    return DAGModelConfig(
        vocab=VocabConfig(size=vocab),
        encoder=ConformerConfig(dropout=0.0, attn_dropout=0.0),
        decoder=DAGDecoderConfig(dropout=0.0, attn_dropout=0.0,
                                 activation_dropout=0.0,
                                 max_transition_length=mtl))


def variant_loss_fn(cfg, glat_p, **kw):
    from daspeech_torch.losses import nat_dag_loss

    return lambda m, b, g: nat_dag_loss(m, b, g, glat_p, cfg.vocab, **kw)


def variant_vs_reference(model, batch, loss_var, loss_ref, pad, what):
    """The variant's loss and gradients against the reference path's on the
    card, same weights, batch and seeds: loss within TOL_LOSS relative,
    each gradient within TOL_GRAD of its norm. A glance that differs (the
    variant's Viterbi against the reference's) must be a near tie of the
    reference's decisions, within MARGIN; its sample is masked out of a
    second try."""
    B = batch["prev_output_tokens"].shape[0]
    for attempt in range(2):
        lv, gv, cv = loss_and_grads(model, batch, SEED, loss_var)
        lr, gr, cr = loss_and_grads(model, batch, SEED, loss_ref)
        prev_r = cr[0][3].prev_output_tokens
        differ = (cv[0][3].prev_output_tokens != prev_r).any(dim=1)
        differ = differ.nonzero()[:, 0].tolist()
        log(f"  {what}: glanced tokens equal in {B - len(differ)} of {B} "
            "samples")
        if not differ:
            break
        for b in differ:
            logits, links, (tgt, prev, *_), _ = cr[0]
            m = viterbi_margin(logits, links, tgt, prev, pad, b)
            log(f"  sample {b}: the glance differs; top-2 margin of the "
                f"reference's decisions {m:.3g} (< {MARGIN})")
            if not m < MARGIN:
                raise AssertionError(f"{what}: sample {b}'s glance differs "
                                     f"with margin {m}")
        mask = torch.ones(B, device=DEVICE)
        mask[differ] = 0.0
        batch = dict(batch, sample_mask=mask)
    dloss = abs(lv.item() - lr.item()) / abs(lr.item())
    gerr = grad_error([n for n, _ in model.named_parameters()], gv, gr,
                      what.split(" ")[0] + "_vs_reference")
    log(f"  {what}: loss {lv.item():.6f} vs {lr.item():.6f}, rel diff "
        f"{dloss:.3g} (<= {TOL_LOSS}); worst per-parameter gradient rel "
        f"diff {gerr:.3g} (<= {TOL_GRAD})")
    if not (dloss <= TOL_LOSS and gerr <= TOL_GRAD):
        raise AssertionError(f"{what}: the variant and the reference "
                             "disagree")
    return {"loss_rel": dloss, "grad_rel": gerr,
            "glance_differs": len(differ)}


def variant_phase(tag, cfg, shape, var_kw, ref_kw, ref_name, smi):
    """One memory variant of the S2TT step (``var_kw`` of ``nat_dag_loss``)
    against its reference path (``ref_kw``) at ``shape`` (B, fbank frames,
    target tokens), random weights from a seed, dropout off: the
    comparison on the card (GLAT p 0.5), a card-vs-CPU step of the variant
    at B = 2 (GLAT p 0), and 3 + 10 timed updates each way with launches
    and peak memory. Returns ({"variant": launches, "reference":
    launches}, numbers)."""
    from daspeech_torch.models import S2TConformerDAG
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    B, S, T = shape
    model_cpu = init_random_(S2TConformerDAG(cfg), SEED + 71)
    model = copy.deepcopy(model_cpu).to(DEVICE)
    batch = make_train_batch(B, S, T, cfg, SEED + 72, DEVICE)
    out = {"vs_reference": variant_vs_reference(
        model, batch, variant_loss_fn(cfg, VARIANT_GLAT, **var_kw),
        variant_loss_fn(cfg, VARIANT_GLAT, **ref_kw), cfg.vocab.pad,
        f"{tag} against {ref_name} (B={B}, L={S // 2}, T={T})")}
    del model
    out["vs_cpu"] = step_parity(
        f"{tag} card vs CPU (B={VARIANT_CPU_B})", model_cpu,
        variant_loss_fn(cfg, 0.0, **var_kw),
        {k: v[:VARIANT_CPU_B].cpu() for k, v in batch.items()})
    paths = {}
    for name, kw in (("variant", var_kw), ("reference", ref_kw)):
        torch.cuda.empty_cache()
        opt = GuardedAdam()
        state = TrainState.create(copy.deepcopy(model_cpu).to(DEVICE), opt)
        step = make_train_step(variant_loss_fn(cfg, VARIANT_GLAT, **kw), opt)
        label = tag if name == "variant" else ref_name
        med, iqr, launches, peak, _ = timed_updates(
            step, state, batch, 3, 10, f"{label} updates at B={B}")
        paths[name] = launches
        out[name] = {"ms": med, "iqr": iqr, "peak_gib": peak}
        say = {k: launches[k] for k in JOINT_KERNELS}
        log(f"  [{smi}] {label}: update {med:.3f} ms (median of 10 after 3, "
            f"IQR {iqr[0]:.3f}-{iqr[1]:.3f}), peak memory {peak:.2f} GiB; "
            f"launches in 13 updates {say}")
        del state, step
    return paths, out


def banded_phase(smi):
    """``--banded-dp`` (banded link extraction, the block-banded DP and
    Viterbi, W = 128) against the full-matrix masked path (#4 with the
    band, #8, #9) at J-long's graph (B = 14, L = 700, T = 128). The banded
    run launches the attention kernels (#1, #5) and none of #4, #8, #9;
    the full run all of them."""
    cfg = variant_config(128, BAND_W)
    paths, out = variant_phase(
        "banded", cfg, BAND_SHAPE,
        dict(max_transition_length=BAND_W, banded_dp=True),
        dict(max_transition_length=BAND_W), "full-matrix", smi)
    full = ("fused_extract_links", "fused_extract_links_bwd",
            "dag_loss_forward", "dag_best_alignment")
    for name in TRAIN_KERNELS:
        if (paths["variant"][name] > 0) == (name in full):
            raise AssertionError(f"banded run: {name} launched "
                                 f"{paths['variant'][name]} times")
        if paths["reference"][name] <= 0:
            raise AssertionError(f"full-matrix run: {name} not launched")
    log(f"  [{smi}] banded vs full-matrix at B={BAND_SHAPE[0]}, L="
        f"{BAND_SHAPE[1] // 2}, W={BAND_W}: update "
        f"{out['variant']['ms']:.3f} vs {out['reference']['ms']:.3f} ms, "
        f"peak memory {out['variant']['peak_gib']:.2f} vs "
        f"{out['reference']['peak_gib']:.2f} GiB")
    for L in BAND_MEMORY_L:
        band_loss_memory(cfg, BAND_SHAPE[0], L, BAND_SHAPE[2], smi)
    return paths


# graph sizes of the loss path's memory: J-long's, and the longest the DAG
# decoder's 1024 learned positions allow
BAND_MEMORY_L = (700, 1024)


def band_loss_memory(cfg, B, L, T, smi):
    """The memory of the DAG loss path alone, banded and full-matrix, at
    (B, L, T): from the decoder's features [B, L, 512] and a match [B, T, L]
    (both needing gradient) through the links, the Viterbi, the DP and the
    backward to both. Logs the peak above what was allocated before, beside
    the sizes of the tensors of each path's layout, and returns {path: peak
    MiB}."""
    from daspeech_torch.models import S2TConformerDAG
    from daspeech_torch.ops.dag_banded import (dag_best_alignment_banded,
                                               dag_loss_banded)
    from daspeech_torch.ops.dag_ref import dag_best_alignment, dag_loss

    dec = S2TConformerDAG(cfg).decoder.to(DEVICE)
    g = torch.Generator().manual_seed(SEED + 73)
    feats = torch.randn(B, L, cfg.decoder.embed_dim, generator=g).to(DEVICE)
    match = torch.log_softmax(torch.randn(B, T, L, generator=g), dim=-1
                              ).to(DEVICE)
    prev = torch.full((B, L), 4, dtype=torch.long, device=DEVICE)
    out_len = torch.full((B,), L, dtype=torch.long, device=DEVICE)
    tgt_len = torch.full((B,), T, dtype=torch.long, device=DEVICE)
    runs = {
        "banded": (dec.extract_links_banded, dag_best_alignment_banded,
                   dag_loss_banded),
        "full": (dec.extract_links, dag_best_alignment, dag_loss)}
    peaks = {}
    for name, (links_fn, viterbi, loss_fn) in runs.items():
        f = feats.clone().requires_grad_()
        m = match.clone().requires_grad_()
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        links = links_fn(f, prev)
        viterbi(m.detach(), links.detach(), out_len, tgt_len)
        loss = -loss_fn(m, links, out_len, tgt_len).sum()
        loss.backward()
        sync()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        if not (torch.isfinite(loss) and torch.isfinite(f.grad).all()):
            raise AssertionError(f"band loss memory {name} L={L}: {loss}")
        del f, m, links, loss
    H, W, D = cfg.decoder.num_heads, BAND_W, cfg.decoder.embed_dim
    mib = 4 / 2 ** 20
    log(f"  [{smi}] DAG loss path alone at B={B}, L={L}, T={T}, W={W}: "
        f"peak above its inputs {peaks['banded']:.1f} MiB banded vs "
        f"{peaks['full']:.1f} MiB full-matrix; one [B, L, L] f32 is "
        f"{B * L * L * mib:.1f} MiB, one [B, L, W, H] "
        f"{B * L * W * H * mib:.1f}, the block-pair scores [B, L/W, W, 2W, "
        f"H] {B * -(-L // W) * W * 2 * W * H * mib:.1f}, q/k [B, L, D] "
        f"{B * L * D * mib:.1f}")
    return peaks


def fused_vocab_phase(smi):
    """``--fused-vocab-chunk 2048`` (the streamed vocabulary projection)
    against the dense [B, L, V] logits at cell T's shape (B = 80, L = 240,
    T = 64) with a 10 000-entry vocabulary (768 MB of fp32 logits). Both
    runs launch every training kernel."""
    cfg = variant_config(FV_VOCAB)
    paths, out = variant_phase(
        "fused-vocab", cfg, FV_SHAPE, dict(fused_vocab_chunk=FV_CHUNK), {},
        "dense", smi)
    for name in TRAIN_KERNELS:
        for p in ("variant", "reference"):
            if paths[p][name] <= 0:
                raise AssertionError(f"fused-vocab {p} run: {name} not "
                                     "launched")
    log(f"  [{smi}] fused-vocab vs dense at B={FV_SHAPE[0]}, L="
        f"{FV_SHAPE[1] // 2}, |V|={FV_VOCAB}, chunk {FV_CHUNK}: update "
        f"{out['variant']['ms']:.3f} vs {out['reference']['ms']:.3f} ms, "
        f"peak memory {out['variant']['peak_gib']:.2f} vs "
        f"{out['reference']['peak_gib']:.2f} GiB")
    return paths


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
RT_RUNG_A = 12            # utterances of A in the CLI's rung runs (with B's)
RT_RUNG_TOKENS = 4000     # their --max-tokens: batches of 8 and 4 of A,
#                           3 and 1 of B
RT_RUNG_CALIB = 1         # their --vocoder-calib-batches
RT_RUNG_OFF = 0.25        # a rung's waveforms off fp32's by at most this
#                           share of their norm (and by more than 0)
WAV_STEP = 1 / 32767      # the int16 WAV's step
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
    the RT_B ones), ``test_cpu`` (the first RT_CPU_UTTS of ``test``) and
    ``test_rung`` (the last RT_RUNG_A of A and the RT_B ones).
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
                        ("test_cpu", rows[:RT_CPU_UTTS]),
                        ("test_rung", rows[n_a - RT_RUNG_A:])):
        with open(root / f"{split}.tsv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
            w.writeheader()
            w.writerows(part)
    return len(rows)


def cli_rung_runs(generate, cli, root, say):
    """``generate.main(cli + ...)`` for each ``--vocoder-quant`` (none,
    bf16, int8, int8-skip1), one-shot and with ``--vocoder-chunk``
    SERVE_CHUNK. Each run's vocoder (caught as ``load_vocoder_and_gcmvn``
    returns it) must carry the rung's fields, the chunk and
    RT_RUNG_CALIB; its forwards are recorded: an int8 run calibrates its
    first RT_RUNG_CALIB batches one-shot, then serves frozen scales (the
    chunked run in windows), and leaves every site of a quantized level
    with an amax and every skipped level's at 0. The features must equal
    the fp32 run's; a rung's waveforms differ from fp32's by more than 0
    and at most RT_RUNG_OFF of their norm; the chunked run's within the
    vocoder-rung phase's bar of the one-shot run's (fp32: one WAV step,
    each sample). Returns {(quant, chunk): seconds}."""
    import contextlib
    import io

    from daspeech_torch.decode.speech_generator import quant_fields
    from daspeech_torch.models.hifigan import receptive_halo_mel

    caught = []
    orig = generate.load_vocoder_and_gcmvn

    def load(*a, **kw):
        voc, gcmvn = orig(*a, **kw)
        calls = []
        fwd = voc.forward

        def forward(mel):
            calls.append((mel.shape[1], bool(voc.calibrate)))
            return fwd(mel)

        voc.forward = forward
        caught.append((voc, calls))
        return voc, gcmvn

    def read(out):
        feats = {p.stem: np.load(p) for p in (out / "feat").glob("*.npy")}
        wavs = {u: generate.read_wav(out / "wav" / f"{u}_pred.wav")[0]
                for u in feats}
        return feats, wavs

    def diff(a, b):
        return float(np.sqrt(sum(np.sum((a[u].astype(np.float64) - b[u])
                                        ** 2) for u in a)))

    secs, wavs, fp32_feats = {}, {}, None
    generate.load_vocoder_and_gcmvn = load
    try:
        for quant in ("none", "bf16", "int8", "int8-skip1"):
            for chunk in (0, SERVE_CHUNK):
                out = root / f"out_{quant}_{chunk}"
                sync()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    rc = generate.main(cli + [
                        "--vocoder-quant", quant,
                        "--vocoder-chunk", str(chunk),
                        "--results-path", str(out)])
                sync()
                secs[quant, chunk] = time.perf_counter() - t0
                voc, calls = caught[-1]
                want = dict(quant_fields(quant), serve_chunk=chunk,
                            serve_calib_batches=RT_RUNG_CALIB)
                got = {k: getattr(voc, k) for k in want}
                if rc != 0 or got != want:
                    raise AssertionError(f"CLI --vocoder-quant {quant} "
                                         f"--vocoder-chunk {chunk}: rc {rc},"
                                         f" vocoder fields {got} != {want}")
                feats, wavs[quant, chunk] = read(out)
                fp32_feats = fp32_feats or feats
                if any(not np.array_equal(f, fp32_feats[u])
                       for u, f in feats.items()):
                    raise AssertionError(f"CLI {quant}: features differ "
                                         "from the fp32 run's")
                W = SERVE_CHUNK + 2 * receptive_halo_mel(voc.cfg)
                if voc.quant_int8:
                    n = RT_RUNG_CALIB
                    if (len(calls) <= n or not all(c for _, c in calls[:n])
                            or any(c for _, c in calls[n:])
                            or (chunk and any(m > W for m, _ in calls[n:]))):
                        raise AssertionError(f"CLI {quant} chunk {chunk}: "
                                             f"forwards {calls}")
                    for name, buf in voc.named_buffers():
                        if not name.endswith("_amax"):
                            continue
                        level = (int(name.split(".")[1]) // voc.num_kernels
                                 if name.startswith("resblocks.")
                                 else int(name.split("_")[1]))
                        if (float(buf) > 0) != (level
                                                >= voc.quant_skip_levels):
                            raise AssertionError(f"CLI {quant}: {name} = "
                                                 f"{float(buf)}")
                n_win = sum(m == W for m, _ in calls)
                fp32 = wavs["none", 0]
                off, ref = diff(wavs[quant, chunk], fp32), diff(fp32, {
                    u: np.zeros_like(w) for u, w in fp32.items()})
                say(f"generate CLI --vocoder-quant {quant} --vocoder-chunk "
                    f"{chunk}: {len(feats)} utterances in "
                    f"{secs[quant, chunk]:.3f} s wall, {len(calls)} vocoder "
                    f"forwards ({n_win} windows); ||wav - fp32 wav|| "
                    f"{off:.4g} of {ref:.4g}")
                if quant != "none" and not 0 < off <= RT_RUNG_OFF * ref:
                    raise AssertionError(f"CLI {quant}: waveforms off fp32 "
                                         f"by {off} of {ref}")
                if chunk:
                    one = wavs[quant, 0]
                    if quant == "none":
                        err = max(float(np.abs(wavs[quant, chunk][u]
                                               - one[u]).max()) for u in one)
                        bar = 1.01 * WAV_STEP      # one step, read in fp32
                    else:
                        err = diff(wavs[quant, chunk], one)
                        kind = "bf16" if quant == "bf16" else "int8"
                        bar = RUNG_RATIO[kind] * diff(one, fp32)
                    say(f"  chunked vs one-shot: {err:.4g} (<= {bar:.4g})")
                    if not err <= bar:
                        raise AssertionError(f"CLI {quant}: chunked vs "
                                             f"one-shot {err} > {bar}")
    finally:
        generate.load_vocoder_and_gcmvn = orig
    return secs


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
    the in-process generator and a CPU run of the CLI, and the CLI's
    vocoder rungs (``cli_rung_runs``). ``algorithms`` is
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
    from daspeech_torch.models import HiFiGANGenerator
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
        # the rung runs' vocoder: the vocoder-mode phase's weights, whose
        # waveform stays out of tanh's saturation
        voc_state.gen.load_state_dict(init_vocoder_(
            HiFiGANGenerator(HiFiGANConfig()), SEED + 1).state_dict())
        CheckpointManager(root / "vocoder_rung").save(voc_state, 1)
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

        # the serving ladder through the CLI: --vocoder-quant, one-shot and
        # chunked, --vocoder-calib-batches
        cli_rung_runs(generate, cli + [
            "--gen-subset", "test_rung", "--max-tokens", str(RT_RUNG_TOKENS),
            "--vocoder-checkpoint", str(root / "vocoder_rung"),
            "--vocoder-calib-batches", str(RT_RUNG_CALIB)], root, say)

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
CLI_FSDP_UPDATES = 4      # stage 3 updates under --fsdp and unsharded
TOL_FSDP = 1e-4           # relative, their losses update by update
CLI_BF16_UPDATES = 4      # stages 1 and 2 under --dtype bfloat16
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

        # --- stages 1 and 2 in bf16 (--dtype bfloat16), 4 updates each;
        # stage 2 then validates (the valid loss). Stage 1's validation is
        # eval-BLEU, and sacrebleu is not installed on the card's machine
        for tag, argv, key in (
                ("stage 1", ["--task", "nat_speech_to_text", "--criterion",
                             "nat_dag_loss", "--valid-subset", "none"], None),
                ("stage 2", ["--task", "text_to_speech", "--criterion",
                             "fastspeech2", "--max-sentences",
                             str(CLI_TTS_SENTENCES), "--valid-subset", "dev",
                             "--validate-interval-updates",
                             str(CLI_BF16_UPDATES)], "valid_loss")):
            rc, recs, _, stb, wall, peak = run_train_cli(base + argv + [
                "--dtype", "bfloat16", "--save-dir",
                str(root / f"{tag.replace(' ', '')}_bf16"), "--max-update",
                str(CLI_BF16_UPDATES), "--save-interval-updates", "1000",
                "--log-interval", "1"])
            stage_line(f"{tag} in bf16 (--dtype bfloat16)", stb, wall, peak)
            losses = [r["loss"] for r in recs
                      if r["tag"] == "train" and not r.get("done")]
            valid = [r for r in recs if r["tag"] == "valid"]
            say(f"{tag} in bf16: losses {losses}; validation {valid}")
            if (rc != 0 or len(losses) != CLI_BF16_UPDATES
                    or not np.isfinite(losses).all()
                    or (key is not None and (
                        len(valid) != 1 or not np.isfinite(valid[0][key])))):
                raise AssertionError(f"{tag} in bf16: rc {rc}, losses "
                                     f"{losses}, validation {valid}")

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

        # --- stage 3 under --fsdp (a world of one) against the unsharded
        # run over the same updates, in-process, each validating the dev
        # split after its last update; then under torchrun
        fsdp_runs, fsdp_valid, fsdp_launches = {}, {}, None
        for name, extra in (("unsharded", []), ("fsdp", ["--fsdp"])):
            argv = list(ddp)
            for flag, value in (
                    ("--max-update", str(CLI_FSDP_UPDATES)),
                    ("--save-dir", str(root / name)),
                    ("--valid-subset", "dev"),
                    ("--validate-interval-updates", str(CLI_FSDP_UPDATES))):
                argv[argv.index(flag) + 1] = value
            torch.cuda.empty_cache()
            reset_launches()
            rc, recs, _, st, wall, peak = run_train_cli(argv + extra)
            if name == "fsdp":
                fsdp_launches = read_launches()
            stage_line(f"stage 3 {name} ({CLI_FSDP_UPDATES} updates)", st,
                       wall, peak)
            fsdp_valid[name] = [r["valid_loss"] for r in recs
                                if r.get("tag") == "valid"]
            if (rc != 0 or len(st.losses) != CLI_FSDP_UPDATES
                    or len(fsdp_valid[name]) != 1):
                raise AssertionError(f"stage 3 {name}: rc {rc}, valid "
                                     f"{fsdp_valid[name]}")
            fsdp_runs[name] = st.losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(
            fsdp_runs["fsdp"] + fsdp_valid["fsdp"],
            fsdp_runs["unsharded"] + fsdp_valid["unsharded"]))
        missing = [k for k in TRAIN_KERNELS if fsdp_launches[k] <= 0]
        say(f"stage 3 --fsdp: losses {fsdp_runs['fsdp']}, valid_loss "
            f"{fsdp_valid['fsdp']} against the unsharded run's "
            f"{fsdp_runs['unsharded']}, {fsdp_valid['unsharded']}: worst "
            f"relative {rel:.3g} (<= {TOL_FSDP}); launches "
            f"{ {k: fsdp_launches[k] for k in JOINT_KERNELS} }")
        if not (rel <= TOL_FSDP and np.isfinite(fsdp_runs["fsdp"]).all()
                and not missing):
            raise AssertionError(f"stage 3 --fsdp: {rel}, {missing} not "
                                 "launched")
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            cmd[cmd.index("--master_port") + 1] = str(sk.getsockname()[1])
        cmd[cmd.index("--save-dir") + 1] = str(root / "fsdp_torchrun")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ["--fsdp"],
                              cwd=Path(__file__).resolve().parent,
                              capture_output=True, text=True, timeout=900)
        fsdp_s = time.perf_counter() - t0
        recs = [json.loads(x) for x in proc.stdout.splitlines()
                if x.startswith("{")]
        if proc.returncode != 0 or not recs:
            log(proc.stderr[-4000:])
            raise AssertionError(f"torchrun --fsdp: rc {proc.returncode}")
        got = next(r["loss"] for r in recs if r.get("update") == 1
                   and not r.get("done"))
        say(f"stage 3 under torchrun --fsdp (world 1, NCCL; {fsdp_s:.1f} s "
            f"with the process start): update 1 loss {got} against "
            f"{first['loss']!r}; last record {recs[-1]}")
        if (abs(got - first["loss"]) > TOL_FSDP * abs(first["loss"])
                + LOG_ROUNDING or recs[-1].get("world_size") != 1):
            raise AssertionError(f"torchrun --fsdp: {recs[-1]}")

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
        return launches, fsdp_launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------- the model and seq axes

TP_LAYERS = {   # the recipe's layers: (kind, width, heads, B, T)
    "conformer": (256, 4, 8, 120), "decoder": (512, 8, 8, 240),
    "fft": (256, 4, 8, 416)}
TP_KERNELS = ("fused_attention_packed", "fused_extract_links",
              "fused_attention_relpos", "dag_loss_forward",
              "dag_best_alignment")


def head0_kernels(g):
    """#1, #2 and #5 on a tensor-parallel rank's heads (the second half of
    a layer's: ``head0`` = H/2), dropout 0.1, in fp32 and bf16, training
    forward, inference forward and backward, each against its plain version
    at the same ``head0`` (fp32 within TOL_KERNEL, bf16 within TOL_BF16 of
    the output's largest magnitude); and the masks at ``head0`` are not
    those at 0. Returns {kernel: max abs err} (fp32)."""
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_relpos as fr

    errs = {}
    p = 0.1
    for dt in (torch.float32, torch.bfloat16):
        tag = "fp32" if dt == torch.float32 else "bf16"

        def close(what, got, want):
            if dt == torch.bfloat16:
                return bf16_close(what, got, want)
            err = _max_err(got, want)
            if not err <= TOL_KERNEL:
                raise AssertionError(f"{what}: max abs err {err}")
            return err

        # #1: decoder self-attention's 4 of 8 heads at T's shape
        B, T, H, h0 = 80, 240, 4, 4
        q = _randn(g, B, T, H * 64, scale=0.125).to(dt)
        k, v = _randn(g, B, T, H * 64).to(dt), _randn(g, B, T, H * 64).to(dt)
        bias, seeds = _key_bias(B, T, g), _seeds(g, B)
        do = _randn(g, B, T, H * 64).to(dt)
        out, stats = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds,
                                             with_stats=True, head0=h0)
        inf, _ = fa.attention_fwd_kernel(q, k, v, bias, H, 1.0, p, seeds,
                                         head0=h0)
        want = fa.attention_plain(q, k, v, bias, H, 1.0, p, seeds, h0)
        at0 = fa.attention_plain(q, k, v, bias, H, 1.0, p, seeds)
        e = [close(f"#1 {tag} head0={h0} training", out, want),
             close(f"#1 {tag} head0={h0} inference", inf, want)]
        e += [close(f"#1 {tag} head0={h0} bwd", a, b_) for a, b_ in zip(
            fa.attention_bwd_kernel(q, k, v, bias, out, stats, do, H, 1.0, p,
                                    seeds, h0),
            fa.attention_bwd_plain(q, k, v, bias, do, H, 1.0, p, seeds, h0))]
        if torch.equal(want, at0):
            raise AssertionError("#1: head0 does not move the masks")
        errs[f"fused_attention_packed {tag}"] = max(e)

        # #2: the DAG decoder's 4 of 8 heads at J-long's 700 vertices
        B, H, T = 14, 4, 700
        q = _randn(g, B, H, T, 64, scale=0.125).to(dt)
        k, v = _randn(g, B, H, T, 64).to(dt), _randn(g, B, H, T, 64).to(dt)
        bias, seeds = _key_bias(B, T, g), _seeds(g, B)
        do = _randn(g, B, H, T, 64).to(dt)
        out, stats = fa.attention_hm_fwd_kernel(
            q, k, v, bias, 1.0, p, seeds, with_stats=True, head0=h0)
        inf, _ = fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0, p, seeds,
                                            head0=h0)
        want = fa.attention_hm_plain(q, k, v, bias, 1.0, p, seeds, h0)
        e = [close(f"#2 {tag} head0={h0} training", out, want),
             close(f"#2 {tag} head0={h0} inference", inf, want)]
        e += [close(f"#2 {tag} head0={h0} bwd", a, b_) for a, b_ in zip(
            fa.attention_hm_bwd_kernel(q, k, v, bias, out, stats, do, 1.0,
                                       p, seeds, h0),
            fa.attention_hm_bwd_plain(q, k, v, bias, do, 1.0, p, seeds, h0))]
        errs[f"fused_attention {tag}"] = max(e)

        # #5: the Conformer's 2 of 4 heads at T's 120 frames
        B, T, H, h0r = 80, 120, 2, 2
        q = _randn(g, B, T, H * 64, scale=0.125).to(dt)
        k, v = _randn(g, B, T, H * 64).to(dt), _randn(g, B, T, H * 64).to(dt)
        a = _randn(g, B, T, H * 256, scale=0.05).to(dt)
        e_ = _randn(g, T, 256).to(dt)
        bias, seeds = _key_bias(B, T, g), _seeds(g, B)
        do = _randn(g, B, T, H * 64).to(dt)
        out, stats = fr.relpos_fwd_kernel(q, k, v, a, e_, bias, H, 0.125, p,
                                          seeds, with_stats=True, head0=h0r)
        inf, _ = fr.relpos_fwd_kernel(q, k, v, a, e_, bias, H, 0.125, p,
                                      seeds, head0=h0r)
        want = fr.relpos_plain(q, k, v, a, e_, bias, H, 0.125, p, seeds, h0r)
        e = [close(f"#5 {tag} head0={h0r} training", out, want),
             close(f"#5 {tag} head0={h0r} inference", inf, want)]
        e += [close(f"#5 {tag} head0={h0r} bwd", x, y) for x, y in zip(
            fr.relpos_bwd_kernel(q, k, v, a, e_, bias, out, stats, do, H,
                                 0.125, p, seeds, h0r),
            fr.relpos_bwd_plain(q, k, v, a, e_, bias, do, H, 0.125, p, seeds,
                                h0r))]
        errs[f"fused_attention_relpos {tag}"] = max(e)
    log("  #1, #2, #5 at head0 = H/2, dropout 0.1, fwd (training and "
        "inference) and bwd against their plain versions: "
        + ", ".join(f"{n} {v:.3g}" for n, v in errs.items()))
    return errs


def tp_layer(kind):
    """A recipe-width layer with dropout 0.1 and its forward's inputs."""
    from daspeech_torch.models.conformer import ConformerEncoderLayer
    from daspeech_torch.models.fastspeech2 import FFTLayer
    from daspeech_torch.models.layers import TransformerDecoderLayer

    C, H, B, T = TP_LAYERS[kind]
    g = torch.Generator().manual_seed(SEED + 40)
    x = _randn(g, B, T, C)
    pad = (torch.arange(T, device=DEVICE)[None, :]
           >= torch.randint(T // 2, T + 1, (B, 1), generator=g).to(DEVICE))
    if kind == "conformer":
        layer = ConformerEncoderLayer(C, 2048, H, 31, 0.1, 0.1)
        args = (x, pad)
    elif kind == "decoder":
        layer = TransformerDecoderLayer(C, 2048, H, dropout=0.1,
                                        attention_dropout=0.1,
                                        activation_dropout=0.1)
        S = T // 2
        args = (x, pad, _randn(g, B, S, C),
                torch.zeros(B, S, dtype=torch.bool, device=DEVICE))
    else:
        layer = FFTLayer(C, H, 1024, 9, 0.1, 0.1)
        args = (x, pad)
    return init_random_(layer, SEED + 41).to(DEVICE).train(), args


def emulated_two_shards():
    """Shard 0 and shard 1 of a model-2 split of a Conformer layer (256d,
    H = 4), a DAG decoder layer (512d, H = 8) and an FFT layer (256d,
    H = 4) run on two threads of this process
    (``partition.emulated_shards``), their row-parallel outputs summed in
    rank order, dropout 0.1 from one seed: each layer's output within
    TOL_KERNEL of the unsharded layer's. Shard 1 runs the attention
    kernels on heads H/2 .. H - 1 with ``head0`` = H/2 (the FFT layer is
    FastSpeech 2's: two heads a shard at the kernels' depth of 64)."""
    from daspeech_torch.parallel import partition, shard

    errs = {}
    for kind in TP_LAYERS:
        layer, args = tp_layer(kind)

        def fwd(m):
            with torch.no_grad():       # per thread
                return m(*args, rng=torch.Generator(
                    device=DEVICE).manual_seed(5))

        want = fwd(layer)
        group, shards = partition.emulated_shards(layer, 2)
        outs = shard.run_ranks(group, [lambda m=m: fwd(m) for m in shards])
        sync()
        errs[kind] = _max_err(outs[0], want)
        if not (errs[kind] <= TOL_KERNEL and torch.equal(outs[0], outs[1])):
            raise AssertionError(f"two emulated shards of the {kind} layer: "
                                 f"max abs err {errs[kind]}")
        if shards[1].self_attn.tp.rank != 1:
            raise AssertionError("the second shard is not rank 1")
    log("  two emulated model shards against the unsharded layer (max abs "
        "err, dropout 0.1): " + ", ".join(f"{k} {v:.3g}"
                                          for k, v in errs.items()))
    return errs


# the relative size of the forward noise of tp_seq_phase's floor: fp32's
# rounding of a Conformer layer's output
FLOOR_NOISE = 2.0 ** -23


@contextlib.contextmanager
def layer_noise(eps, seed):
    """Within the block each Conformer layer's output is multiplied by
    1 + eps or 1 - eps, the signs drawn on the card from ``seed``."""
    from daspeech_torch.models import conformer

    real = conformer.ConformerEncoderLayer.forward
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def noisy(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        sign = 2 * torch.randint(0, 2, out.shape, generator=gen,
                                 device=out.device) - 1
        return out * (1 + eps * sign.to(out.dtype))

    conformer.ConformerEncoderLayer.forward = noisy
    try:
        yield
    finally:
        conformer.ConformerEncoderLayer.forward = real


def tp_seq_phase():
    """The data x seq x model code on the one card (``parallel.partition``,
    ``parallel.shard``): #1, #2 and #5 on a rank's heads (``head0``) and
    the bf16 rows' cost of an offset (:func:`head0_grid_cost`); the joint
    step at J's widths (B = 40 x 480 frames, M = 512, GLAT 0: its argmax is
    a discrete choice that rounding may flip) through
    ``partition.MeshParallel`` on a data 1 x seq 1 x model 1 mesh over NCCL
    against the unsharded step from the same weights, the glance pass
    running the Viterbi: with dropout off the loss within TOL_LOSS and each
    gradient within TOL_GRAD of its norm; with dropout 0.1 the loss within
    TOL_LOSS and the worst gradient within twice the floor or within
    TOL_GRAD. The floor is the unsharded step against itself with each
    Conformer layer's output moved by fp32's rounding (:func:`layer_noise`,
    FLOOR_NOISE): the mesh's forward rounds in another order (its
    collectives and split products), and at dropout 0.1 this step's
    gradients move by that much under such a change, while the same step
    run again, the other floor logged, moves them far less; two model
    shards of three layers emulated in this
    process; ``dryrun_multichip(1)`` on the card, and a request for two
    cards refused. Returns the dropout-0.1 mesh step's launches (#1, #4,
    #5, #8, #9 each at least once)."""
    from daspeech_torch.models import S2SConformerDAGFastSpeech2
    from daspeech_torch.parallel import partition
    from daspeech_torch.parallel.dryrun import dryrun_multichip
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    head0_kernels(torch.Generator().manual_seed(SEED + 42))
    log("  the bf16 rows of #1 and #2 at a head offset (the dq kernel's "
        "grid):")
    head0_grid_cost()

    partition.init_single_process_group(DEVICE)
    mesh = partition.make_mesh(1, (("data", -1), ("seq", 1), ("model", 1)),
                               device=DEVICE)

    def steps(cfg, tags):
        """{tag: (loss, gnorm, gradients, launches)} of one step from the
        same weights and batch."""
        base = init_random_(S2SConformerDAGFastSpeech2(cfg), SEED)
        batch = make_joint_batch(*JOINT_SHAPES["J"], cfg, SEED + 30, DEVICE)
        loss_fn = joint_loss_fn(cfg, 0.0)
        got = {}
        for tag in tags:
            model = copy.deepcopy(base).to(DEVICE)
            opt = GuardedAdam()
            plan = (partition.MeshParallel(model, mesh) if tag == "mesh"
                    else None)
            state = TrainState.create(model, opt, plan)
            step = make_train_step(loss_fn, opt, group=None if plan is None
                                   else plan.group, sharding=plan)
            b = batch if plan is None else plan.shard_batch(batch)
            reset_launches()
            with (layer_noise(FLOOR_NOISE, SEED + 32) if tag == "noise"
                  else contextlib.nullcontext()):
                m = step(state, b, torch.Generator().manual_seed(SEED + 31))
            sync()
            launches = read_launches()
            got[tag] = (float(m["loss"]), float(m["gnorm"]),
                        [p.grad.detach().clone()
                         for _, p in model.named_parameters()], launches)
        return [n for n, _ in base.named_parameters()], got

    drop_cfg, no_drop_cfg = joint_configs()
    for rate, cfg, tags in ((0.0, no_drop_cfg, ("unsharded", "mesh")),
                            (0.1, drop_cfg, ("unsharded", "again", "noise",
                                             "mesh"))):
        names, got = steps(cfg, tags)
        (lu, gu, grads_u, _), (lm, gm, grads_m, launches) = (
            got["unsharded"], got["mesh"])
        rel_loss = abs(lm - lu) / abs(lu)
        worst = grad_error(names, grads_m, grads_u, f"tp_seq_mesh1_p{rate}")
        bar = TOL_GRAD
        if rate:
            again = grad_error(names, got["again"][2], grads_u,
                               "tp_seq_again")
            floor = grad_error(names, got["noise"][2], grads_u,
                               "tp_seq_floor")
            bar = max(TOL_GRAD, 2 * floor)
            log(f"  at dropout 0.1 the unsharded step run again: worst "
                f"gradient {again:.3g}; with each Conformer layer's output "
                f"moved by 2^-23 (the floor): {floor:.3g}")
        log(f"  J step (dropout {rate}, GLAT 0) on a data 1 x seq 1 x model "
            f"1 mesh (NCCL) against the unsharded step: loss {lm:.6f} / "
            f"{lu:.6f} (rel {rel_loss:.3g}, <= {TOL_LOSS}), gnorm {gm:.4f} "
            f"/ {gu:.4f}, worst gradient {worst:.3g} (<= {bar:.3g})")
        if not (rel_loss <= TOL_LOSS and worst <= bar):
            raise AssertionError(f"the mesh-of-one J step at dropout {rate}"
                                 " is not the unsharded step")
        del got

    missing = [n for n in TP_KERNELS if launches[n] <= 0]
    log("  mesh step launches: " + ", ".join(f"{n} {launches[n]}"
                                             for n in TP_KERNELS))
    if missing:
        raise AssertionError(f"not launched by the mesh step: {missing}")

    emulated_two_shards()

    t = time.perf_counter()
    res = dryrun_multichip(1)
    log(f"  dryrun_multichip(1) on the card: {res} "
        f"({time.perf_counter() - t:.1f} s)")
    try:
        dryrun_multichip(torch.cuda.device_count() + 1)
    except RuntimeError as e:
        log(f"  dryrun_multichip(2) refused: {e}")
    else:
        raise AssertionError("dryrun_multichip ran on more cards than exist")
    return launches


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
        PARENT["root"] = root
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
        PARENT["lib"] = _build.load(PARENT["build"].path, strict=False)
        log(f"parent tree's kernels built in {PARENT['build'].seconds:.1f} s "
            f"-> {PARENT['build'].path}")
    for flag, fn in ROWS_APART.items():
        if flag in sys.argv:
            # kernel rows in a process of their own (rows_apart)
            print(json.dumps(globals()[fn]()))
            return 0
    if b"15attn_fwd_kernel" in built.path.read_bytes():
        raise AssertionError("a SIMT attention forward (attn_fwd_kernel) is "
                             "in the kernel library")
    check_sass(built.path)
    if parent is not None:
        fp32_sass_kept(built.path, PARENT["build"].path)
    log("kernel phase:")
    cases = kernel_phase()
    if parent is not None:
        log("#1, #2 and #5 in turns with the parent tree's kernels (the head "
            "offset of the model axis):")
        head0_retime()
    log("end-to-end phase (serving):")
    serving, mels, ctx = e2e_phase()
    log("training phase (S2TT):")
    training = train_phase()
    log("joint S2ST training phase:")
    joint = joint_phase()
    log("FastSpeech 2 pretraining phase:")
    pretrain = fs2_phase()
    # before the later phases: late in a long process the profiler has
    # been seen to lose kernel events, which the bf16 phase's profiles read
    log("bf16 phase (--dtype bfloat16: #1, #2, #4, #5 in bf16, the updates "
        "at T, J-long and P, card vs CPU, convergence):")
    bf16_rows, bf16_paths, _ = bf16_phase()
    log("vocoder-mode phase:")
    vocoder, voc_cpu = vocoder_phase(mels)
    log("vocoder-rung phase (--vocoder-quant: fp32, bf16, bf16 + fused MRF, "
        "int8, int8-skip1; one-shot and chunked):")
    rungs, _ = vocoder_rung_phase(mels, voc_cpu)
    log("bf16 rows of #7, #6 and #3:")
    bf16_alt_rows = rows_apart("--bf16-alternate-rows")
    log("TTS phase:")
    tts = tts_phase(voc_cpu)
    log("alternates phase (#6 fused FFN, #3 full-bias attention):")
    alternates, _ = alternates_phase()
    log("decode-strategy phase:")
    decoding = decode_phase(ctx)
    log("AR and TTS-options phase (at_tts, at_s2s, the reranker, "
        "Griffin-Lim, FastSpeech 2's options, the AR training steps):")
    ar_paths = ar_phase(ctx, mels["A"])
    log("banded phase (--banded-dp against the full-matrix path, J-long's "
        "graph):")
    variants = {f"banded{'' if k == 'variant' else '_reference'}": v
                for k, v in banded_phase(smi).items()}
    log("fused-vocab phase (--fused-vocab-chunk against the dense logits, "
        "cell T, 10 000 entries):")
    variants.update({f"fused_vocab{'' if k == 'variant' else '_reference'}":
                     v for k, v in fused_vocab_phase(smi).items()})
    log("vocoder-training phase:")
    voc_train, _, _ = vocoder_train_phase()
    log("runtime phase (data, tasks, train loop, checkpoints, generate CLI):")
    rt_train_launches, cli_launches = runtime_phase(ctx, smi)
    del ctx
    log("CLI phase (the three recipe stages, resume, torchrun, --fsdp, "
        "vocoder, pipeline, parity, pinned copy):")
    cli_train, cli_fsdp = cli_phase(smi)
    log("model and seq axes phase (head0 kernels, the J step on a mesh of "
        "one, two emulated model shards, dryrun_multichip):")
    tp_seq = tp_seq_phase()

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
               "cli_generate": cli_launches, "cli_train": cli_train,
               "cli_fsdp": cli_fsdp, "tp_seq": tp_seq, **variants,
               **ar_paths}
    # the alternate backends launch on no other path
    stray = {(p, n): v[n] for p, v in by_path.items()
             for n in ALTERNATE_KERNELS if v[n]}
    if stray:
        raise AssertionError(f"alternate kernels launched elsewhere: {stray}")
    log(f"  {', '.join(ALTERNATE_KERNELS)}: 0 launches on every other path")
    # serving runs inference forwards only: no launch writes statistics
    serving_paths = ("serving", "vocoder_fused", "tts_A", "tts_B",
                     "cli_generate", "at_tts", "at_s2s", "reranker",
                     *(f"decode {tag}" for tag in decoding))
    trained = {(p, n): by_path[p][f"{n} training"] for n in TRAIN_FORWARDS
               for p in serving_paths if by_path[p][f"{n} training"]}
    if trained:
        raise AssertionError(f"training forwards on serving paths: {trained}")
    log("  training forwards on the serving, vocoder, TTS, decode-strategy, "
        "AR serving and CLI paths: 0")
    # the bf16 entry points launch on the bf16 paths only
    stray = {(p, n): v[n] for p, v in by_path.items()
             for n in v if n.endswith(" bf16") and v[n]}
    if stray:
        raise AssertionError(f"bf16 launches on fp32 paths: {stray}")
    log("  bf16 launches on every fp32 path: 0")
    by_path.update(bf16_paths)
    by_path.update({"alternates_ffn": alternates["fused"],
                    "alternates_full_bias": alternates["full_bias"],
                    "alternates_ffn_bf16": alternates["fused bf16"],
                    "alternates_full_bias_bf16": alternates["full_bias bf16"],
                    **{f"vocoder {tag}": v for tag, v in rungs.items()}})
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
    # the bf16 entry points: launches from the bf16 updates at T (#1, #4,
    # #5) and J-long (#2); forward and backward timed as one row
    for name, shapes in bf16_rows.items():
        base = name[:-len(" bf16")]
        src, replaces = KERNELS[base]
        src = BF16_SOURCES.get(base, src)
        main_path = "bf16_J-long" if base == "fused_attention" else "bf16_T"
        first = shapes[0]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": by_path[main_path][name],
            "bwd_launches": by_path[main_path][f"{BF16_KERNELS[base]} bf16"],
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            # the bf16 kernels' count (attention_bf16.cuh, relpos_bf16.cuh,
            # links_bf16.cuh) and the device split beside SDPA's
            **{k: first[k] for k in ("bf16_kernels", "device_ms",
                                     "library_device_ms") if k in first},
            "was_ms": first["was_ms"],
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first["library_ms"], "shapes": shapes})
    # the bf16 modes of #7 (launches from the bf16 fused-MRF vocoder run),
    # #6 (the bf16 fused-FFN updates) and #3 (the bf16 ALiBi step)
    alt_paths = {"mrf_level": ("vocoder bf16 fused_mrf", None),
                 "fused_ffn": ("alternates_ffn_bf16", "fused_ffn_bwd"),
                 "fused_attention_full_bias": (
                     "alternates_full_bias_bf16",
                     "fused_attention_full_bias_bwd")}
    for name, shapes in bf16_alt_rows.items():
        base = name[:-len(" bf16")]
        src, replaces = KERNELS[base]
        src = BF16_SOURCES.get(base, src)
        main_path, bwd = alt_paths[base]
        first = shapes[0]
        launches = by_path[main_path][name]
        if not launches:
            raise AssertionError(f"{name}: no launch on {main_path}")
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches,
            **({} if bwd is None else {
                "bwd_launches": by_path[main_path][f"{bwd} bf16"]}),
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            # #6 and #7 (redesigned): the bf16 kernels' count, the parent
            # tree's time, TFLOP/s and the device split
            **{k: first[k] for k in ("bf16_kernels", "was_ms", "tflops",
                                     "device_ms", "library_device_ms")
               if k in first},
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
