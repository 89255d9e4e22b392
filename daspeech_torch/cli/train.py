"""Training CLI, on the card: the three recipe stages (S2TT DAG,
FastSpeech 2, joint S2ST), the two AR baselines (Transformer-TTS and the
two-pass multi-decoder S2ST), resume, validation and data parallelism.

Counterpart of ``daspeech_tpu/cli/train.py`` (a rebuild of
``fairseq_cli/train.py`` for the DASpeech recipes)::

  python -m daspeech_torch.cli.train DATA --task nat_speech_to_text \\
      --criterion nat_dag_loss --save-dir ckpt/s2tt --max-update 100000
  python -m daspeech_torch.cli.train DATA --task text_to_speech \\
      --criterion fastspeech2 --save-dir ckpt/fs2 ...
  python -m daspeech_torch.cli.train DATA --task nat_speech_to_speech \\
      --criterion s2s_dag_fastspeech2_loss --save-dir ckpt/joint \\
      --load-pretrained-dag-from ckpt/s2tt \\
      --load-pretrained-fastspeech-from ckpt/fs2 ...
  python -m daspeech_torch.cli.train DATA --task text_to_speech \\
      --criterion tts_transformer --save-dir ckpt/at_tts ...
  python -m daspeech_torch.cli.train DATA --task nat_speech_to_speech \\
      --criterion s2s_multidecoder --save-dir ckpt/at_s2s ...
  torchrun --nproc_per_node 4 -m daspeech_torch.cli.train DATA ...

It runs on ``--device`` (default ``cuda``) and exits non-zero when that
device is missing; under torchrun (or ``--coordinator``, or SLURM) each
process takes ``cuda:LOCAL_RANK`` and an NCCL group. The recipe's model
widths are the defaults; ``--model-yaml`` replaces them.

One update: the task's bucketed batch, collated and copied to the card
from pinned memory on the prefetch thread (``data/prefetch.py``), this
rank's rows of it, the criterion's loss and gradients with dropout drawn
from a generator seeded by (seed, update, rank), gradients summed over the
ranks, then the guarded Adam update (``train/step.py``). The step returns
device tensors; they are read in one transfer at each log, validation or
save boundary. ``--banded-dp`` and ``--fused-vocab-chunk`` select the DAG
loss's memory variants (``losses/dag_loss.py``); ``--fsdp`` shards
parameters, gradients and Adam's moments over the ranks
(``parallel/partition.py``; a single process is a world of one). The JAX
CLI's TPU options are not accepted (README).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from daspeech_torch.cli.generate import build_model_cfg, resolve_device
from daspeech_torch.config import DecodeConfig
from daspeech_torch.data.prefetch import consume, prefetch_epoch, to_device
from daspeech_torch.parallel import multihost as mh
from daspeech_torch.parallel import partition
from daspeech_torch.tasks import (
    NATSpeechToSpeechTask,
    NATSpeechToTextTask,
    TaskConfig,
    TextToSpeechTask,
)
from daspeech_torch.train.checkpoint import (
    CheckpointManager,
    host_state,
    resume_position,
    transfer_dag_params,
    transfer_tts_params,
)
from daspeech_torch.train.metrics import JsonProgressLogger, MetricsAggregator
from daspeech_torch.train.step import make_train_step
from daspeech_torch.train.train_state import (
    GuardedAdam,
    TrainState,
    anneal_value,
    parse_anneal,
)

def parse_args(argv=None):
    p = argparse.ArgumentParser("daspeech-torch-train")
    p.add_argument("data")
    p.add_argument("--task", default="nat_speech_to_text",
                   choices=["nat_speech_to_text", "nat_speech_to_speech",
                            "text_to_speech"])
    p.add_argument("--criterion", default="nat_dag_loss",
                   choices=["nat_dag_loss", "s2s_dag_fastspeech2_loss",
                            "fastspeech2", "tts_transformer",
                            "s2s_multidecoder"],
                   help="tts_transformer = the AR Transformer-TTS baseline "
                        "(at_tts generation); s2s_multidecoder = the "
                        "two-pass AR S2ST baseline (at_s2s generation, and "
                        "the length beam's reranker)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on; without a card, pass "
                        "--device cpu (the default never falls back)")
    p.add_argument("--max-sentences", type=int, default=64)
    p.add_argument("--update-freq", type=int, default=1,
                   help="gradient accumulation over N same-bucket batches")
    p.add_argument("--model-yaml", default=None,
                   help="YAML with the model config tree; default recipe dims")
    p.add_argument("--save-dir", default="checkpoints")
    p.add_argument("--max-update", type=int, default=1000)
    p.add_argument("--max-tokens", type=int, default=40000)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--warmup-updates", type=int, default=10000)
    p.add_argument("--warmup-init-lr", type=float, default=1e-7)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--clip-norm", type=float, default=1.0)
    p.add_argument("--noise", default="full_mask",
                   choices=["full_mask", "random_mask", "random_delete",
                            "no_noise"],
                   help="prev-target corruption for CMLM-style NAT models "
                        "(the DAG criterion builds its own graph input)")
    p.add_argument("--glat-p", default="0.5:0.1@100k")
    p.add_argument("--glance-strategy", default="number-random",
                   help="number-random (the recipe's), cmlm, or none (no "
                        "glancing pass)")
    p.add_argument("--no-force-emit", action="store_true")
    p.add_argument("--training-strategy", default="expect",
                   choices=["expect", "argmax"])
    p.add_argument("--tts-loss-weight", type=float, default=5.0)
    p.add_argument("--dag-freezing-steps", type=int, default=-1)
    p.add_argument("--encoder-freezing-updates", type=int, default=0,
                   help="freeze the Conformer encoder for the first N "
                        "updates (``s2t_conformer.py:140-154``)")
    p.add_argument("--src-upsample-scale", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--save-interval-updates", type=int, default=2000)
    p.add_argument("--validate-interval-updates", type=int, default=2000)
    p.add_argument("--eval-inference", action="store_true",
                   help="during TTS validation also synthesize with "
                        "predicted durations and report corpus MCD")
    p.add_argument("--keep-last-checkpoints", type=int, default=5)
    p.add_argument("--train-subset", default="train")
    p.add_argument("--valid-subset", default="dev")
    p.add_argument("--num-buckets", type=int, default=8)
    p.add_argument("--max-source-positions", type=int, default=6000)
    p.add_argument("--max-target-positions", type=int, default=1024)
    p.add_argument("--restore", action="store_true",
                   help="resume from the latest checkpoint in save-dir")
    p.add_argument("--load-pretrained-dag-from", default=None,
                   help="checkpoint dir of a pretrained DA-Transformer")
    p.add_argument("--load-pretrained-fastspeech-from", default=None,
                   help="checkpoint dir of a pretrained FastSpeech2")
    p.add_argument("--reset-decoder-vocab", action="store_true",
                   help="keep fresh decoder embeddings when loading the "
                        "pretrained DAG (multilingual vocabulary swap)")
    p.add_argument("--banded-dp", action="store_true",
                   help="block-banded DAG links, DP and Viterbi when the "
                        "model's max_transition_length W < L-1: no [L, L] "
                        "matrix, but at L <= 1024 more memory and time "
                        "than the full-matrix kernels, whose [L, L] "
                        "tensors are the smaller there (the recipe's "
                        "99999 is a no-op)")
    p.add_argument("--fused-vocab-chunk", type=int, default=None,
                   help="stream the vocabulary projection + log-softmax + "
                        "target gather over chunks of N entries: the "
                        "[B, L, V] logits never exist (large vocabularies)")
    p.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port of a multi-process "
                        "run (also DASPEECH_COORDINATOR); torchrun and "
                        "SLURM environments need none")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--fsdp", action="store_true",
                   help="shard parameters, gradients and Adam moments over "
                        "the data-parallel ranks (ZeRO-3; a single process "
                        "is a world of one)")
    p.add_argument("--min-fsdp-size", type=int,
                   default=partition.MIN_FSDP_SIZE,
                   help="with --fsdp, keep parameters of fewer elements "
                        "replicated (fairseq's --min-params-to-wrap)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of updates 5-15 to "
                        "DIR")
    p.add_argument("--tensorboard-logdir", default=None)
    p.add_argument("--wandb-project", default=None)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="model compute dtype (parameters, gradients and "
                        "Adam stay fp32; the DAG DP and every loss run "
                        "fp32); validation runs in it too")
    p.add_argument("--heartbeat-timeout", type=float, default=-1,
                   help="kill the process (stack dump + SIGINT) if no "
                        "update completes for N seconds; <= 0 disables; "
                        "arms after the first update")
    p.add_argument("--aim-repo", default=None)
    p.add_argument("--aim-run-hash", default=None)
    p.add_argument("--azureml-logging", action="store_true")
    return p.parse_args(argv)


def check_args(args) -> None:
    """Raise for an unknown glance strategy."""
    glance = args.glance_strategy
    if glance not in ("number-random", "cmlm", "none", "None"):
        raise ValueError(f"unknown --glance-strategy {glance!r}")


# ---------------------------------------------------------------- build

def init_weights_(model: nn.Module, g: torch.Generator) -> nn.Module:
    """The JAX modules' initialisation, drawn from ``g``: linear and conv
    weights from flax's ``lecun_normal`` (a normal of variance 1 / fan_in
    truncated at two standard deviations), embeddings N(0, dim^-1/2),
    the rel-pos biases from ``xavier_uniform``, norm scales and the
    positional alphas 1, biases 0. Buffers (BatchNorm's running
    statistics) keep their initial values."""
    from daspeech_torch.models.conformer import MaskedBatchNorm

    with torch.no_grad():
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                if name == "bias" or (name == "weight" and isinstance(
                        mod, (nn.LayerNorm, MaskedBatchNorm))):
                    p.fill_(0.0 if name == "bias" else 1.0)
                elif isinstance(mod, nn.Embedding):
                    p.copy_(torch.randn(p.shape, generator=g)
                            * p.shape[-1] ** -0.5)
                elif name.startswith("pos_bias"):
                    bound = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                    p.copy_((torch.rand(p.shape, generator=g) * 2 - 1)
                            * bound)
                elif "alpha" in name:
                    p.fill_(1.0)
                else:
                    # the std of a unit normal truncated to [-2, 2]
                    std = math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978
                    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                          generator=g)
    return model


def _saved_model(directory) -> Dict[str, torch.Tensor]:
    data = CheckpointManager(directory).restore()
    if data is None:
        raise SystemExit(f"no checkpoint found in {directory}")
    return data["model"]


def load_pretrained_(model: nn.Module, dag_from=None, fastspeech_from=None,
                     reset_vocab: bool = False) -> None:
    """The stage-3 transfers (``cli/train.py:346-366``): the encoder,
    ``enc_proj`` and decoder of a DA-Transformer checkpoint and the
    FastSpeech 2 of a stage-2 checkpoint replace the model's. Parameters
    only: BatchNorm statistics stay the model's, as in JAX."""
    names = {n for n, _ in model.named_parameters()}
    params = {n: p.detach() for n, p in model.named_parameters()}
    if dag_from:
        params = transfer_dag_params(params, _saved_model(dag_from),
                                     reset_vocab=reset_vocab)
        print(f"loaded pretrained DA-Transformer from {dag_from}",
              file=sys.stderr)
    if fastspeech_from:
        params = transfer_tts_params(params, _saved_model(fastspeech_from))
        print(f"loaded pretrained FastSpeech2 from {fastspeech_from}",
              file=sys.stderr)
    model.load_state_dict({k: v for k, v in params.items() if k in names},
                          strict=False)


def dag_options(args, cfg) -> Dict:
    """The DAG criteria's memory-variant arguments (``cli/train.py:
    396-436``): ``max_transition_length`` from the model config
    (``dag.decoder`` of the joint model, ``decoder`` of the S2TT one)."""
    if args.criterion not in ("nat_dag_loss", "s2s_dag_fastspeech2_loss"):
        return {}
    dec = (cfg.dag.decoder if args.criterion == "s2s_dag_fastspeech2_loss"
           else cfg.decoder)
    return dict(fused_vocab_chunk=args.fused_vocab_chunk,
                max_transition_length=dec.max_transition_length,
                banded_dp=args.banded_dp)


def update_generator(seed: int, step: int, rank: int = 0) -> torch.Generator:
    """The host generator of update ``step + 1`` on ``rank``: a pure
    function of the three, so a resumed run draws the same dropout without
    any saved generator state, and ranks draw different masks."""
    return torch.Generator().manual_seed(
        ((seed * 1000003 + step) * 4096 + rank) % 2 ** 63)


def step_generator(seed: int, step: int, rank: int,
                   sharding=None) -> torch.Generator:
    """:func:`update_generator` keyed by the data coordinate of ``rank``
    (``sharding.data_rank`` on a ``partition.MeshParallel`` mesh): ranks
    that differ only in their ``seq`` or ``model`` coordinate draw the same
    dropout, so that their replicated activations stay equal. Without a
    mesh the rank itself."""
    return update_generator(seed, step,
                            getattr(sharding, "data_rank", rank))


@dataclasses.dataclass
class Run:
    """What :func:`build` sets up from the arguments."""
    task: object
    model: nn.Module
    state: TrainState
    step: Callable
    batcher: object
    vocab: object
    has_valid: bool
    dag_kw: Dict = dataclasses.field(default_factory=dict)

    def call(self, fn, *args):
        """``fn(model, *args)`` for validation (without gradient), under
        ``--fsdp`` as the root's forward inside its ``gathered``
        (:func:`make_validator`)."""
        if self.state.sharding is None:
            return fn(self.model, *args)
        with torch.no_grad():
            return self.state.sharding.run(fn, *args)


def build(args, device, group=None, mesh=None) -> Run:
    """The task and its datasets (the valid split when present), the model
    initialised from ``--seed``, the stage-3 transfers, the optimizer, the
    training state on ``device``, the criterion and the step. ``mesh``: a
    ``partition.make_mesh`` mesh of data, seq and model axes, over which
    the model is split (``partition.MeshParallel``, ``--fsdp`` over its
    ``data`` axis, which is then the step's group); each rank's batch is
    then ``run.state.sharding.shard_batch`` of the global batch. ``--fsdp``
    without a mesh: a mesh of ``data`` alone over the default process
    group's ranks."""
    import torch.distributed as dist

    from daspeech_torch.config import to_dict
    from daspeech_torch.losses import (dag_frozen, fastspeech2_criterion,
                                       multidecoder_criterion, nat_dag_loss,
                                       s2s_dag_fastspeech2_loss,
                                       tts_transformer_criterion)
    from daspeech_torch.models import (FastSpeech2Encoder,
                                       S2SConformerDAGFastSpeech2,
                                       S2SMultiDecoderModel,
                                       S2TConformerDAG, TTSTransformer)

    task_cls = {"nat_speech_to_speech": NATSpeechToSpeechTask,
                "text_to_speech": TextToSpeechTask}.get(
                    args.task, NATSpeechToTextTask)
    task = task_cls.setup_task(TaskConfig(
        data_dir=args.data, max_tokens=args.max_tokens,
        num_buckets=args.num_buckets, noise=args.noise,
        max_source_positions=args.max_source_positions,
        max_target_positions=args.max_target_positions))
    task.load_dataset(args.train_subset,
                      upsample_scale=args.src_upsample_scale)
    try:
        task.load_dataset(args.valid_subset,
                          upsample_scale=args.src_upsample_scale)
        has_valid = True
    except FileNotFoundError:
        has_valid = False

    vocab = task.vocab
    cfg = build_model_cfg(args.criterion, args.model_yaml, vocab)
    is_s2s = args.criterion == "s2s_dag_fastspeech2_loss"
    is_tts = args.criterion == "fastspeech2"
    # bf16 compute on fp32 parameters, as JAX's --dtype bfloat16 (which
    # replaces the reference's fp16 AMP and loss scaler)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    if is_tts:
        model = FastSpeech2Encoder(cfg, vocab_size=vocab.size, pad=vocab.pad,
                                   dtype=dtype)
    elif args.criterion == "tts_transformer":
        model = TTSTransformer(vocab.size, vocab.pad, dtype=dtype,
                               **to_dict(cfg))
    elif args.criterion == "s2s_multidecoder":
        model = S2SMultiDecoderModel(vocab.size, vocab.pad, vocab.bos,
                                     vocab.eos, dtype=dtype, **to_dict(cfg))
    elif is_s2s:
        model = S2SConformerDAGFastSpeech2(cfg, dtype=dtype)
    else:
        model = S2TConformerDAG(cfg, dtype=dtype)
    init_weights_(model, torch.Generator().manual_seed(args.seed))
    if args.load_pretrained_dag_from or args.load_pretrained_fastspeech_from:
        load_pretrained_(model, args.load_pretrained_dag_from,
                         args.load_pretrained_fastspeech_from,
                         args.reset_decoder_vocab)
    opt = GuardedAdam(lr=args.lr, warmup_updates=args.warmup_updates,
                      warmup_init_lr=args.warmup_init_lr,
                      weight_decay=args.weight_decay,
                      clip_norm=args.clip_norm)
    model = model.to(device).train()
    if mesh is None and args.fsdp:
        mesh = partition.make_mesh(dist.get_world_size(), device=device)
    sharding = None
    if mesh is not None:
        sharding = partition.MeshParallel(model, mesh, args.fsdp,
                                          args.min_fsdp_size)
        group = sharding.group
    state = TrainState.create(model, opt, sharding)

    glat_sched = parse_anneal(args.glat_p)
    glance = (None if args.glance_strategy in ("none", "None")
              else args.glance_strategy)
    dag_kw = dag_options(args, cfg)

    def loss_fn(m, batch, rng):
        # the host's update count decides GLAT p and both freezes: the
        # loss reads nothing from the device
        step = state.step
        if is_tts:
            return fastspeech2_criterion(m, batch, rng, vocab)
        if args.criterion == "tts_transformer":
            return tts_transformer_criterion(m, batch, rng, vocab)
        if args.criterion == "s2s_multidecoder":
            return multidecoder_criterion(m, batch, rng, vocab)
        glat_p = anneal_value(glat_sched, step)
        enc_freeze = step < args.encoder_freezing_updates
        if is_s2s:
            return s2s_dag_fastspeech2_loss(
                m, batch, rng, glat_p, vocab,
                tts_loss_weight=args.tts_loss_weight,
                training_strategy=args.training_strategy,
                freeze_dag=dag_frozen(step, args.dag_freezing_steps),
                freeze_encoder=enc_freeze, glance_strategy=glance,
                no_force_emit=args.no_force_emit, **dag_kw)
        return nat_dag_loss(m, batch, rng, glat_p, vocab,
                            glance_strategy=glance,
                            no_force_emit=args.no_force_emit,
                            freeze_encoder=enc_freeze, **dag_kw)

    if is_tts or args.criterion == "tts_transformer":
        batcher = task.get_batch_iterator(args.train_subset,
                                          max_sentences=args.max_sentences,
                                          seed=args.seed)
    else:
        batcher = task.get_batch_iterator(
            args.train_subset, seed=args.seed,
            upsample_scale=args.src_upsample_scale)
    step = make_train_step(loss_fn, opt, accum_steps=args.update_freq,
                           group=group, sharding=sharding)
    return Run(task, model, state, step, batcher, vocab, has_valid, dag_kw)


# ----------------------------------------------------------- validation

def make_validator(args, run: Run, device):
    """``validate(state) -> (metric or None, [(record, tag)])``, or None
    when nothing is validated: eval-BLEU through the lookahead generator
    for ``nat_dag_loss`` (``cli/train.py:594-617``), the valid loss for the
    joint, FastSpeech 2 and AR criteria (``:620-645``, ``:693-720``) and,
    with
    ``--eval-inference``, FastSpeech 2's corpus MCD (``:663-691``). Each
    kind runs on this rank's round-robin share of the valid batches and is
    gathered over the ranks. Under ``--fsdp`` the parameters are gathered
    once for the whole validation: the shares may differ in number."""
    validate = _validator(args, run, device)
    sharding = run.state.sharding
    if validate is None or sharding is None:
        return validate

    def gathered(state):
        with sharding.gathered():
            return validate(state)

    return gathered


def _validator(args, run: Run, device):
    if not run.has_valid:
        return None
    task, model = run.task, run.model
    crit = args.criterion
    is_tts = crit == "fastspeech2"

    def batches():
        if is_tts or crit == "tts_transformer":
            vit = task.get_batch_iterator(args.valid_subset,
                                          max_sentences=args.max_sentences,
                                          seed=args.seed)
        else:
            vit = task.get_batch_iterator(
                args.valid_subset, seed=args.seed,
                upsample_scale=args.src_upsample_scale)
        for spec, idxs in mh.shard_batches(vit.batches_for_epoch(0)):
            yield vit, idxs, vit.collate(spec, idxs)

    if crit == "nat_dag_loss":
        from daspeech_torch.data.encoders import build_bpe, build_tokenizer

        generator = task.build_generator(model,
                                         DecodeConfig(strategy="lookahead"))
        dcfg = task.data_cfg
        bpe = build_bpe(dcfg.bpe_tokenizer if dcfg is not None else None)
        pretok = build_tokenizer(dcfg.pre_tokenizer if dcfg is not None
                                 else None)

        def detok(s: str) -> str:
            return pretok.decode(bpe.decode(s))

        def validate(state):
            from daspeech_torch.eval import corpus_bleu

            hyps, refs = [], []
            for vit, idxs, b in batches():
                out = run.call(lambda _m: generator.generate(b))
                for i, local in enumerate(idxs):
                    hyps.append(detok(task.tgt_dict.string(out[i]["tokens"])))
                    refs.append(detok(vit.dataset._tgt_text(int(local))))
            parts = mh.all_gather_host_objects((hyps, refs))
            hyps = [h for hs, _ in parts for h in hs]
            refs = [r for _, rs in parts for r in rs]
            bleu = corpus_bleu(hyps, refs)
            return bleu, [({"valid_bleu": round(bleu, 2)}, "valid")]

        return validate

    from daspeech_torch.losses import (fastspeech2_criterion,
                                       multidecoder_criterion,
                                       s2s_dag_fastspeech2_loss,
                                       tts_transformer_criterion)

    def eval_loss(batch):
        g = torch.Generator().manual_seed(args.seed)
        if is_tts:
            return fastspeech2_criterion(model, batch, g, run.vocab,
                                         train=False)
        if crit == "tts_transformer":
            return tts_transformer_criterion(model, batch, g, run.vocab,
                                             train=False)
        if crit == "s2s_multidecoder":
            return multidecoder_criterion(model, batch, g, run.vocab,
                                          train=False)
        return s2s_dag_fastspeech2_loss(
            model, batch, g, 0.0, run.vocab,
            tts_loss_weight=args.tts_loss_weight,
            training_strategy=args.training_strategy,
            no_force_emit=args.no_force_emit, train=False, **run.dag_kw)

    def validate_loss():
        total, n = 0.0, 0
        with torch.no_grad():
            for _, idxs, b in batches():
                _, m = run.call(lambda _m, bb: eval_loss(bb),
                                consume(to_device(b, device)))
                ns = int(m["nsentences"]) if "nsentences" in m else len(idxs)
                total += float(m["loss"]) * ns
                n += ns
        parts = mh.all_gather_host_objects((total, n))
        return (sum(t for t, _ in parts)
                / max(sum(c for _, c in parts), 1))

    def validate_mcd(max_utts: int = 64):
        from daspeech_torch.eval.mcd import mel_cepstral_distortion

        vals = []
        per_proc = -(-max_utts // mh.process_count())
        with torch.inference_mode():
            for _, idxs, b in batches():
                M = int(b["target_audio"].shape[1])
                tokens = torch.as_tensor(b["src_tokens"], device=device)
                mel, mel_post, out_lens = run.call(
                    lambda m: m(src_tokens=tokens.long(),
                                max_out_len=2 * M))[:3]
                if mel_post is not None:
                    mel = mel_post
                mel = mel.float().cpu().numpy()
                out_lens = out_lens.cpu().numpy()
                for i in range(len(idxs)):
                    if b["sample_mask"][i] == 0 or len(vals) >= per_proc:
                        break
                    hyp = mel[i, : max(int(out_lens[i]), 1)]
                    ref = b["target_audio"][
                        i, : int(b["target_audio_lengths"][i])]
                    vals.append(mel_cepstral_distortion(hyp, ref))
                if len(vals) >= per_proc:
                    break
        vals = [v for part in mh.all_gather_host_objects(vals)
                for v in part][:max_utts]
        return float(np.mean(vals)) if vals else None

    def validate(state):
        vloss = validate_loss()
        records = [({"valid_loss": round(vloss, 4)}, "valid")]
        if is_tts and args.eval_inference:
            mcd = validate_mcd()
            if mcd is not None:
                records.append(({"valid_mcd": round(mcd, 3)}, "valid"))
        return vloss, records

    return validate


# ----------------------------------------------------------------- loop

@dataclasses.dataclass
class LoopConfig:
    max_update: int
    seed: int = 1
    log_interval: int = 100
    save_interval_updates: int = 2000
    validate_interval_updates: int = 2000
    update_freq: int = 1
    profile_dir: Optional[str] = None


@dataclasses.dataclass
class LoopStats:
    """What the loop measured, per update (``losses``: each update's loss;
    ``update_ms``: CUDA-event time of each update on a card, host time
    otherwise; ``wait_ms``: the wait for its batch), per batch moved
    (``h2d_ms``, host time of the copy call on the producer thread) and
    per save (``save_s``: to the return of ``save``; ``blocking=False``
    writes the file in the background). ``last``: the last log window's
    statistics; ``next_position``: the iterator position of the batch after
    the last update, as a checkpoint's ``extra``."""
    losses: List[float] = dataclasses.field(default_factory=list)
    update_ms: List[float] = dataclasses.field(default_factory=list)
    wait_ms: List[float] = dataclasses.field(default_factory=list)
    h2d_ms: List[float] = dataclasses.field(default_factory=list)
    h2d_bytes: int = 0
    save_s: List[float] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    epoch: int = 1
    last: Dict[str, float] = dataclasses.field(default_factory=dict)
    next_position: Optional[Dict[str, int]] = None
    # the log window's input accounting (``cli/train.py:741-794``)
    window: Dict[str, float] = dataclasses.field(default_factory=lambda: {
        "wait_s": 0.0, "h2d_s": 0.0, "steps": 0})

    def run_totals(self) -> Dict[str, float]:
        """The run's input statistics, under the JAX CLI's names."""
        if not self.wait_ms:
            return {}
        wait_s, h2d_s = sum(self.wait_ms) / 1e3, sum(self.h2d_ms) / 1e3
        return {
            "run_data_wait_s": round(wait_s, 4),
            "run_h2d_s": round(h2d_s, 4),
            "input_wait_frac": round((wait_s + h2d_s)
                                     / max(self.wall_s, 1e-9), 4),
            "h2d_mb_per_step": round(self.h2d_bytes / len(self.wait_ms)
                                     / 2 ** 20, 2)}


class PendingMetrics:
    """Device metrics of the updates since the last boundary, read back in
    one transfer (``_fetch_pending``, ``cli/train.py:750-764``), with each
    update's start and end events."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.metrics: List[Dict[str, torch.Tensor]] = []
        self.marks: List = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def add(self, metrics, start, end):
        self.metrics.append(metrics)
        self.marks.append((start, end))

    def fetch(self):
        """([{key: float}], [update ms]) of the pending updates."""
        if not self.metrics:
            return [], []
        keys = sorted(self.metrics[0])
        rows = torch.stack([torch.stack([m[k].float().reshape(())
                                         for k in keys])
                            for m in self.metrics]).cpu().tolist()
        ms = [(a.elapsed_time(b) if self.cuda else (b - a) * 1e3)
              for a, b in self.marks]
        self.metrics, self.marks = [], []
        return [dict(zip(keys, r)) for r in rows], ms


class _NullStream:
    def write(self, _):
        pass

    def flush(self):
        pass


def train_loop(state: TrainState, step: Callable, batcher, device,
               cfg: LoopConfig, *, manager: Optional[CheckpointManager] = None,
               logger: Optional[JsonProgressLogger] = None,
               validate: Optional[Callable] = None, start=(1, 0),
               group=None, watchdog=None,
               on_update: Optional[Callable] = None,
               on_save: Optional[Callable] = None) -> LoopStats:
    """Train ``state`` to ``cfg.max_update`` updates (``cli/train.py:
    796-899``). Epochs count from 1; ``start`` = (epoch, batch) resumes
    there through ``prefetch_epoch(start=...)``, which neither collates nor
    moves a skipped batch. Each saved checkpoint records the position of
    the next batch. ``group``: the data-parallel process group (each rank
    keeps its rows of every batch). ``on_update(state, update, spec,
    metrics)`` runs after each update (``metrics``: the step's device
    tensors); ``on_save(update)`` after each checkpoint has been written.
    Only rank 0 writes checkpoints; when the loop raises, it first leaves
    a crash checkpoint. Every batch goes to the device on the producer
    thread; with ``cfg.update_freq`` > 1 the step gets the list of a
    bucket's microbatches."""
    device = torch.device(device)
    rank = mh.process_index() if group is not None else 0
    world = mh.process_count() if group is not None else 1
    stats = LoopStats()
    pending = PendingMetrics(device)
    agg = MetricsAggregator()

    def shard(batch):
        if group is None:
            return batch
        rows = next(v for v in batch.values()
                    if isinstance(v, np.ndarray)).shape[0]
        return mh.slice_batch(batch, mh.process_batch_slice(rows, rank,
                                                            world))

    def move(batch):
        t = time.perf_counter()
        out = to_device(batch, device)
        stats.h2d_ms.append((time.perf_counter() - t) * 1e3)
        stats.window["h2d_s"] += stats.h2d_ms[-1] / 1e3
        stats.h2d_bytes += sum(v.nbytes for v in batch.values()
                               if isinstance(v, np.ndarray))
        return out

    def flush():
        rows, ms = pending.fetch()
        for r in rows:
            stats.losses.append(r["loss"])
            for k, v in r.items():
                agg.log_scalar(k, v)
            agg.log_speed("ups")
        stats.update_ms += ms
        out = agg.get_smoothed_values()
        agg.reset()
        w = stats.window
        if w["steps"]:
            out["data_wait_ms"] = round(w["wait_s"] * 1e3 / w["steps"], 3)
            out["h2d_ms"] = round(w["h2d_s"] * 1e3 / w["steps"], 3)
            w.update(wait_s=0.0, h2d_s=0.0, steps=0)
        if device.type == "cuda":
            out["peak_hbm_gb"] = round(
                torch.cuda.max_memory_allocated(device) / 2 ** 30, 3)
        stats.last = out
        return out

    update = state.step
    epoch, first = max(start[0], 1), start[1]
    stats.next_position = {"epoch": epoch, "batch_idx": first}
    profiler = None
    t_start = time.perf_counter()
    accum: Dict = {}
    try:
        while update < cfg.max_update:
            n_batches = len(batcher.batches_for_epoch(epoch))
            pf = iter(prefetch_epoch(batcher, epoch, start=first,
                                     to_device=lambda b: move(shard(b))))
            try:
                for i in range(first, n_batches):
                    t = time.perf_counter()
                    spec, batch = next(pf)
                    waited = time.perf_counter() - t
                    stats.wait_ms.append(waited * 1e3)
                    stats.window["wait_s"] += waited
                    batch = consume(batch)
                    if cfg.update_freq > 1:
                        # microbatches of one bucket, each already on the
                        # device; the step accumulates over the list
                        buf = accum.setdefault(spec, [])
                        buf.append(batch)
                        if len(buf) < cfg.update_freq:
                            continue
                        batch = accum.pop(spec)
                    stats.window["steps"] += 1
                    if cfg.profile_dir and update == 5:
                        profiler = _start_profiler(device)
                    if profiler is not None and update == 15:
                        _stop_profiler(profiler, cfg.profile_dir)
                        profiler = None
                    t0 = pending.mark()
                    metrics = step(state, batch,
                                   step_generator(cfg.seed, state.step,
                                                  rank, state.sharding))
                    pending.add(metrics, t0, pending.mark())
                    update = state.step
                    nxt = ((epoch, i + 1) if i + 1 < n_batches
                           else (epoch + 1, 0))
                    stats.next_position = {"epoch": nxt[0],
                                           "batch_idx": nxt[1]}
                    if watchdog is not None:
                        watchdog.ping()
                    if on_update is not None:
                        on_update(state, update, spec, metrics)

                    need_log = (logger is not None
                                and update % cfg.log_interval == 0)
                    need_validate = (validate is not None and update
                                     % cfg.validate_interval_updates == 0)
                    need_save = (manager is not None and update
                                 % cfg.save_interval_updates == 0)
                    done = update >= cfg.max_update
                    if not (need_log or need_validate or need_save or done):
                        continue
                    out = flush()
                    if logger is not None:
                        logger.log(out, update, epoch)
                    metric = out.get("loss")
                    if need_validate:
                        vmetric, records = validate(state)
                        for rec, tag in records:
                            if logger is not None:
                                logger.print(rec, update, epoch, tag=tag)
                        if vmetric is not None:
                            metric = vmetric
                    if need_save:
                        t = time.perf_counter()
                        save_checkpoint(manager, state, update, rank,
                                        metric=metric,
                                        extra=stats.next_position,
                                        blocking=False)
                        stats.save_s.append(time.perf_counter() - t)
                        if on_save is not None and rank == 0:
                            manager.wait_until_finished()
                            on_save(update)
                    if done:
                        return stats
            finally:
                pf.close()
            epoch, first = epoch + 1, 0
        return stats
    except Exception:
        # a sharded state is gathered by every rank: one that failed alone
        # cannot, so a --fsdp run of several ranks leaves none
        if (manager is not None and rank == 0
                and (state.sharding is None or state.sharding.world == 1)):
            _save_crash_checkpoint(manager, state, stats.next_position)
        raise
    finally:
        if profiler is not None:
            _stop_profiler(profiler, cfg.profile_dir)
        stats.wall_s = time.perf_counter() - t_start
        stats.epoch = epoch


def save_checkpoint(manager: CheckpointManager, state: TrainState,
                    step: int, rank: int, **kw) -> None:
    """Rank 0 writes the checkpoint; under ``--fsdp`` every rank takes part
    in gathering the shards (``checkpoint.host_state``)."""
    if rank == 0:
        manager.save(state, step, **kw)
    elif state.sharding is not None:
        host_state(state)


def _save_crash_checkpoint(manager: CheckpointManager, state: TrainState,
                           position: Dict[str, int]):
    """The crash checkpoint (``trainer.py:869-874`` crash.pt equivalent):
    the state at its last finished update, with the position of the next
    batch, so that ``--restore`` goes on from there. A checkpoint already
    saved at that update holds the same state and is kept as it is."""
    try:
        manager.wait_until_finished()
    except Exception:
        pass
    if manager.latest_step() == state.step:
        print(f"crash: the checkpoint at step {state.step} is the last "
              "finished update", file=sys.stderr)
        return
    try:
        manager.save(state, state.step, extra={**position, "crash": True})
        print(f"saved crash checkpoint at step {state.step}",
              file=sys.stderr)
    except Exception:
        pass


def _start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profiler(prof, directory):
    prof.__exit__(None, None, None)
    Path(directory).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(Path(directory) / f"trace_rank{mh.process_index()}.json"))


def make_sinks(args):
    """The logger's mirrors (``train/metrics.py``), rank 0 only."""
    from daspeech_torch.train import metrics as tm

    sinks = []
    if args.tensorboard_logdir:
        sinks.append(tm.TensorboardSink(args.tensorboard_logdir))
    if args.wandb_project:
        sinks.append(tm.WandBSink(args.wandb_project,
                                  run_name=Path(args.save_dir).name))
    if args.aim_repo:
        sinks.append(tm.AimSink(args.aim_repo, run_hash=args.aim_run_hash))
    if args.azureml_logging:
        sinks.append(tm.AzureMLSink())
    return sinks


def main(argv=None, *, on_update: Optional[Callable] = None,
         on_stats: Optional[Callable] = None) -> int:
    """Run the CLI. For in-process callers that inspect the run:
    ``on_update`` is :func:`train_loop`'s hook, ``on_stats(stats)`` gets
    the loop's :class:`LoopStats` when it ends."""
    import torch.distributed as dist

    args = parse_args(argv)
    check_args(args)
    device = resolve_device(args.device, prog="train")
    multi = mh.initialize_distributed(
        args.coordinator, args.num_processes, args.process_id,
        device_type=device.type)
    group = None
    if args.fsdp and not multi:
        partition.init_single_process_group(device)   # a world of one
        group = dist.group.WORLD
    if multi:
        group = dist.group.WORLD
        if device.type == "cuda":
            device = torch.device("cuda", mh.local_rank())
        print(f"data-parallel run: process {mh.process_index()} of "
              f"{mh.process_count()} on {device}", file=sys.stderr)
    rank = mh.process_index()
    run = build(args, device, group)
    state = run.state
    ckpt = CheckpointManager(
        args.save_dir, keep_last=args.keep_last_checkpoints,
        maximize_best=run.has_valid and args.criterion == "nat_dag_loss")
    start = (1, 0)
    if args.restore and ckpt.latest_step() is not None:
        ckpt.restore(state)
        start = resume_position(ckpt)
        print(f"restored checkpoint at step {state.step} (epoch "
              f"{start[0]}, batch {start[1]})", file=sys.stderr)

    sinks = make_sinks(args) if rank == 0 else []
    logger = JsonProgressLogger(
        stream=None if rank == 0 else _NullStream(),
        log_interval=args.log_interval, sinks=sinks)
    watchdog = mh.HeartbeatWatchdog(args.heartbeat_timeout)
    cfg = LoopConfig(
        max_update=args.max_update, seed=args.seed,
        log_interval=args.log_interval,
        save_interval_updates=args.save_interval_updates,
        validate_interval_updates=args.validate_interval_updates,
        update_freq=args.update_freq, profile_dir=args.profile_dir)
    try:
        # a failure inside the loop leaves a crash checkpoint there
        stats = train_loop(
            state, run.step, run.batcher, device, cfg, manager=ckpt,
            logger=logger, validate=make_validator(args, run, device),
            start=start, group=group, watchdog=watchdog,
            on_update=on_update)
        t = time.perf_counter()
        save_checkpoint(ckpt, state, state.step, rank,
                        extra=stats.next_position)
        stats.save_s.append(time.perf_counter() - t)
        if on_stats is not None:
            on_stats(stats)
        done = {"done": True, "wall_s": round(stats.wall_s, 3),
                **stats.run_totals(), **stats.last}
        if group is not None:
            done.update(world_size=mh.process_count(),
                        grad_all_reduces=mh.COUNTS["grad_all_reduce"],
                        bn_syncs=mh.COUNTS["bn_sync"])
        logger.print(done, state.step, stats.epoch)
    finally:
        watchdog.stop()
        try:
            ckpt.wait_until_finished()
        except Exception:
            pass
        for s in sinks:
            try:
                s.close()
            except Exception:
                pass
        if group is not None:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
