"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py [--parent DIR]

(``--parent DIR``: another checkout of the repository, typically the parent
commit unpacked with ``git archive``; its kernels are built too, and the
kernel phase times the rows of the kernels redesigned since (the training
forward of #1, #2, #3 and #5, the link extraction #4 forward and backward,
the DP #8 and the Viterbi #9) with its library as well, on the same inputs
in the same process.)

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
   forward (the same masks) and its drop fraction within 1% of p; the
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
   (``serve_chunk=64``, B=1) against one-shot (<= 1e-5), its first-chunk
   latency and whole time, once with ``fused_mrf=True``; ResBlock type 2
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
   other path (asserted).

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
# rows also timed with the parent tree's library when one is given
# (--parent): every row of a name, or " training": its training-forward
# rows
REDESIGNED = ("fused_attention_packed training", "fused_attention training",
              "fused_attention_relpos training",
              "fused_attention_full_bias training", "fused_extract_links",
              "fused_extract_links_bwd", "dag_loss_forward",
              "dag_best_alignment")
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
    attention_tc.cuh, of the FMA forward and of the link extraction in the
    built library's SASS (``cuobjdump -sass``), a template kernel's
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
                                     *LINKS_TC)
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


def fma_spills(ptxas):
    """The FMA forward's instances in nvcc's -Xptxas -v report: each must
    use no more than 255 registers and spill nothing."""
    import re

    lines = ptxas.splitlines()
    found = 0
    for i, line in enumerate(lines):
        if "entry function" not in line or FMA_FORWARD not in line:
            continue
        found += 1
        info = " ".join(lines[i + 1:i + 4])
        regs = re.search(r"Used (\d+) registers", info)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", info)
        log(f"  {FMA_FORWARD} instance {found}: {regs.group(1)} registers, "
            f"spill stores/loads {spill.group(1)}/{spill.group(2)} bytes")
        if int(regs.group(1)) > 255 or spill.group(1) != "0" \
                or spill.group(2) != "0":
            raise AssertionError(f"{FMA_FORWARD} spills: {info}")
    if found != len(FMA_INSTANCES):
        raise AssertionError(f"{found} instances of {FMA_FORWARD} in the "
                             f"ptxas report, not {len(FMA_INSTANCES)}")


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
               **extra):
        ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
        lib_ms = cuda_ms(run_library) if run_library is not None else None
        training = shape.endswith(" training")
        fma_row = f"{name} training" in REDESIGNED and training
        redesigned = fma_row or name in REDESIGNED
        was = parent_ms(run_kernel) if PARENT and redesigned else None
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
    # the wrapper picks, then with the other; the work is the 126 taps of
    # C x C products at every frame
    dev = torch.device("cuda")
    picked = [fm.pick_tile(B, T, dev) for B, _, T in MRF_SHAPES]
    other = [next(u for u in fm.TILES if u != t) for t in picked]
    for (B, C, T), tile in zip(MRF_SHAPES * 2, picked + other):
        x, W, bias = mrf_inputs(g, B, C, T)
        args = (x, W, bias, MRF_KERNELS, MRF_DILATIONS)
        got = fm.mrf_level_kernel(*args, tile)
        want = fm.mrf_level_ref(*args)
        shape = (f"[{B},{C},{T}] tile {tile}"
                 + (" (picked)" if tile == fm.pick_tile(B, T, dev) else ""))
        log(f"  mrf_level {shape}: output std {want.std().item():.3f}")
        if B == 1:
            # the kernel and cuDNN's fp32 implicit GEMM can sum in the same
            # order; both against float64 show each one's own rounding
            exact = fm.mrf_level_ref(*(t.double() for t in args[:3]),
                                     MRF_KERNELS, MRF_DILATIONS)
            log(f"  mrf_level {shape} against float64: kernel "
                f"{_max_err(got.double(), exact):.3g}, plain "
                f"{_max_err(want.double(), exact):.3g}")
        record("mrf_level", shape, _max_err(got, want),
               lambda: fm.mrf_level_kernel(*args, tile),
               lambda: fm.mrf_level_ref(*args),
               2 * B * T * C * C * W.shape[0],
               (2 * B * C * T + W.numel() + bias.numel()) * F32)
        del x, args, got, want
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
               4 * N * C * Fd, (2 * N * C + 2 * C * Fd + Fd + 3 * C) * F32)
        # a mean loss's cotangent: the weight gradients, sums over the N
        # rows, stay of order 1
        do = _randn(g, B, T, C, scale=N ** -0.5)
        bargs = (x, *params, do, seeds, p, p)
        got = ff.ffn_bwd_kernel(*bargs)
        record("fused_ffn_bwd", shape,
               _max_err(got, ff.ffn_bwd_plain(*bargs)),
               lambda: ff.ffn_bwd_kernel(*bargs),
               lambda: ff.ffn_bwd_plain(*bargs),
               10 * N * C * Fd,
               (3 * N * C + 4 * C * Fd + 2 * Fd + 6 * C) * F32)
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
    return launches, mels


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

        # --- exact chunked vocoding at B = 1 (one utterance of batch A)
        mel1 = mels["A"][:1].contiguous()
        one = voc(mel1)
        for tag, chunked in (("default", with_weights(
                voc_cpu, serve_chunk=SERVE_CHUNK)), ("fused_mrf", with_weights(
                    voc_cpu, fused_mrf=True, serve_chunk=SERVE_CHUNK))):
            fn = make_vocode_fn(chunked)
            got = fn(mel1)
            err = _max_err(got, one)
            tol = TOL_CHUNKED if tag == "default" else TOL_FUSED
            if not (got.shape == one.shape and err <= tol):
                raise AssertionError(f"chunked ({tag}) vs one-shot: "
                                     f"{tuple(got.shape)}, max abs diff {err}")
            log(f"  chunked {tag} (chunk {SERVE_CHUNK}, B=1, "
                f"{mel1.shape[1]} frames): first chunk "
                f"{first_chunk_ms(chunked, mel1, SERVE_CHUNK):.3f} ms after "
                f"the mel, whole {cuda_ms(lambda: fn(mel1), 5, 1):.3f} ms; "
                f"one-shot {cuda_ms(lambda: voc(mel1), 5, 1):.3f} ms; max abs "
                f"diff {err:.3g} (<= {tol})")

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
        fma_spills(built.ptxas)
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
        "kernels, of the FMA forward and of the link extraction: "
        + ("cuobjdump not found, not checked" if sass is None else str(sass)))
    if sass is not None:
        fma_names = {f"{FMA_FORWARD}{i}" for i in FMA_INSTANCES} | set(
            LINKS_FMA)
        tc = {n: c for n, c in sass.items() if n not in fma_names}
        fma = {n: c for n, c in sass.items() if n in fma_names}
        if ({n.split("<")[0] for n in tc} != {*TC_KERNELS, *LINKS_TC}
                or not all(c["HMMA"] for c in tc.values())):
            raise AssertionError(f"tensor-core kernels without HMMA: {tc}")
        if (set(fma) != fma_names
                or any(c["HMMA"] or not c["FFMA"] for c in fma.values())):
            raise AssertionError(f"FMA kernels not on the FMA pipes: {fma}")

    log("kernel phase:")
    cases = kernel_phase()
    log("end-to-end phase (serving):")
    serving, mels = e2e_phase()
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

    # launches: each kernel's count is that of the run of the path it was
    # ported for (the forward kernels of the first slice: serving; the
    # second slice's: the S2TT training run; the head-major attention: the
    # joint step at J-long; the MRF level: the fused-mode vocoder run; the
    # fused FFN: the fused S2TT updates; the full-bias attention: the ALiBi
    # run); every path's count is kept
    by_path = {"serving": serving, "training": training,
               "joint_J": joint["J"], "joint_J-long": joint["J-long"],
               "fs2_pretraining": pretrain, "vocoder_fused": vocoder,
               "tts_A": tts["A"], "tts_B": tts["B"]}
    # the alternate backends launch on no other path
    stray = {(p, n): v[n] for p, v in by_path.items()
             for n in ALTERNATE_KERNELS if v[n]}
    if stray:
        raise AssertionError(f"alternate kernels launched elsewhere: {stray}")
    log(f"  {', '.join(ALTERNATE_KERNELS)}: 0 launches on every other path")
    # serving runs inference forwards only: no launch writes statistics
    trained = {(p, n): by_path[p][f"{n} training"] for n in TRAIN_FORWARDS
               for p in ("serving", "vocoder_fused", "tts_A", "tts_B")
               if by_path[p][f"{n} training"]}
    if trained:
        raise AssertionError(f"training forwards on serving paths: {trained}")
    log("  training forwards on the serving, vocoder and TTS paths: 0")
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
