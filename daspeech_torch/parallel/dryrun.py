"""One joint S2ST training step over an n-rank mesh: the port's counterpart
of ``__graft_entry__.py:90-217`` ``dryrun_multichip``.

``dryrun_multichip(n)`` starts n processes, one a card (NCCL), or with
``device="cpu"`` n CPU processes (gloo); it never falls back to the CPU
when it is asked for cards, and raises when there are fewer than n. Each
builds JAX's ``_tiny_cfg`` joint model from one seed (on cards at the
narrowest widths the kernels take, :func:`tiny_cfg`), the mesh
``(data -1, seq 2, model 2)`` when 8 divides n (else ``data`` alone), the
tensor-parallel and sequence split with FSDP over ``data``
(``partition.MeshParallel``, ``min_fsdp_size`` 64), and takes one step of
``s2s_dag_fastspeech2_loss`` on its part of JAX's dryrun batch (n rows of
32 frames). Rank 0 prints the loss and the gradient norm; every rank
checks ``step == 1`` and a finite loss.
"""

from __future__ import annotations

import math
import socket
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist


def tiny_cfg(kernel_widths: bool = False):
    """``__graft_entry__._tiny_cfg``: the joint model at widths 16/32. With
    ``kernel_widths`` the narrowest the card's kernels take (a head depth
    of 64, the rel-pos kernel's 256 channels): the encoder at 256 with 4
    heads, the decoder and FastSpeech 2 at 128 with 2."""
    from daspeech_torch.config import (ConformerConfig, DAGDecoderConfig,
                                       DAGModelConfig, FastSpeech2Config,
                                       S2SModelConfig, VocabConfig)

    enc, dec, heads = (256, 128, 2) if kernel_widths else (16, 16, 2)
    return S2SModelConfig(
        dag=DAGModelConfig(
            vocab=VocabConfig(size=32),
            encoder=ConformerConfig(
                embed_dim=enc, ffn_dim=2 * enc, num_layers=2,
                num_heads=2 * heads if kernel_widths else heads,
                conv_channels=32, depthwise_kernel_size=7),
            decoder=DAGDecoderConfig(
                embed_dim=dec, ffn_dim=2 * dec, num_layers=2,
                num_heads=heads, max_target_positions=64)),
        tts=FastSpeech2Config(
            encoder_layers=1, encoder_embed_dim=dec, encoder_heads=heads,
            decoder_layers=1, decoder_embed_dim=dec, decoder_heads=heads,
            fft_hidden_dim=2 * dec, var_pred_hidden_dim=16,
            var_pred_n_bins=8),
        adaptor_ffn_dim=2 * dec)


def dryrun_batch(cfg, B: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """JAX's dryrun batch (``__graft_entry__.py:166-186``): B rows of 32
    fbank frames, graphs of 16 vertices, 6 target tokens, 24 mel frames."""
    from daspeech_torch.models.dag_model import (graph_lengths,
                                                 initialize_output_tokens)

    S, L, T, M = 32, 16, 6, 24
    rng = np.random.default_rng(seed)
    v = cfg.dag.vocab
    src_lengths = torch.full((B,), S, dtype=torch.int32)
    prev = initialize_output_tokens(graph_lengths(src_lengths, 0.5, 64), L,
                                    v).numpy()
    tgt = rng.integers(4, v.size, size=(B, T)).astype(np.int64)
    tgt[:, 0], tgt[:, T - 1] = v.bos, v.eos
    return {
        "fbank": rng.normal(size=(B, S, 80)).astype(np.float32),
        "src_lengths": src_lengths.numpy().astype(np.int64),
        "target_text": tgt,
        "prev_output_tokens": prev,
        "target_audio": rng.normal(size=(B, M, 80)).astype(np.float32),
        "target_audio_lengths": np.full((B,), M, np.int64),
        "durations": np.full((B, T - 1), M // (T - 1), np.int64),
        "pitches": np.zeros((B, T - 1), np.float32),
        "energies": np.zeros((B, T - 1), np.float32),
    }


def mesh_axes(n: int):
    """The dryrun's mesh: data x seq 2 x model 2 when 8 divides n."""
    if n % 8 == 0:
        return (("data", -1), ("seq", 2), ("model", 2))
    return (("data", -1),)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, n: int, device: str, port: int, queue) -> None:
    from daspeech_torch.cli.train import init_weights_, step_generator
    from daspeech_torch.losses import s2s_dag_fastspeech2_loss
    from daspeech_torch.models import S2SConformerDAGFastSpeech2
    from daspeech_torch.parallel.partition import MeshParallel, make_mesh
    from daspeech_torch.train import (GuardedAdam, TrainState,
                                      make_train_step)

    cuda = device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dev = torch.device(f"cuda:{rank}" if cuda else "cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n)
    try:
        mesh = make_mesh(n, mesh_axes(n), device=device)
        cfg = tiny_cfg(kernel_widths=cuda)
        model = S2SConformerDAGFastSpeech2(cfg)
        init_weights_(model, torch.Generator().manual_seed(0))
        model = model.to(dev).train()
        plan = MeshParallel(model, mesh, fsdp=True, min_fsdp_size=64)
        opt = GuardedAdam(lr=1e-3, warmup_updates=10)
        state = TrainState.create(model, opt, plan)

        def loss_fn(m, batch, rng):
            return s2s_dag_fastspeech2_loss(m, batch, rng, 0.1, cfg.dag.vocab,
                                            tts_loss_weight=5.0,
                                            training_strategy="expect")

        step = make_train_step(loss_fn, opt, group=plan.group, sharding=plan)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in dryrun_batch(cfg, n).items()}
        metrics = step(state, plan.shard_batch(batch),
                       step_generator(0, 0, rank, plan))
        loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
        assert state.step == 1, state.step
        assert math.isfinite(loss), metrics
        if rank == 0:
            shape = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))
            print(f"dryrun_multichip({n}): mesh {shape} loss={loss:.4f} "
                  f"gnorm={gnorm:.4f}", flush=True)
            queue.put({"loss": loss, "gnorm": gnorm, "mesh": shape})
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device=None) -> Dict:
    """One joint step over n ranks (module docstring): n cards unless
    ``device`` is the CPU. Returns rank 0's ``{"loss", "gnorm", "mesh"}``.
    Raises RuntimeError when asked for more cards than there are, and when
    a rank fails."""
    import torch.multiprocessing as mp

    device = "cpu" if device is not None and torch.device(
        device).type == "cpu" else "cuda"
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, "
                               f"found {have}")
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    mp.start_processes(_rank, args=(n, device, _free_port(), queue),
                       nprocs=n, join=True, start_method="spawn")
    return queue.get()

