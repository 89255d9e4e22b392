"""The tensor-parallel (``model``) and sequence (``seq``) axes of the port
(``daspeech_torch.parallel.partition`` and ``shard``), on the CPU with
gloo.

* One spawn of four ranks (``torch.multiprocessing``, rendezvous through a
  file under ``tmp_path``) builds two meshes of them: data 1 x seq 2 x
  model 2, and data 2 x model 2 with ``--fsdp --min-fsdp-size 64``. On
  each, every rank makes one update of the tiny S2TT (``nat_dag_loss``)
  and joint model on its part of one global batch (its rows over
  ``data``, its 32 of the 64 fbank frames over ``seq``); one process makes
  the same update on the whole batch. Held at
  ``tests/test_torch_ddp.py``'s bars (``assert_update_matches``): the
  loss, ``skipped``, the gradient norm, every gradient and parameter
  (gathered over ``data`` and ``model``), BatchNorm's running statistics;
  with every dropout at 0 on both meshes and at 0.1 on data 1 x seq 2 x
  model 2, where the ranks draw the unsharded masks (the attention
  kernels' counted from the rank's first head, ``head0``). Data ranks draw
  their own masks, as in data parallelism, so a data-2 mesh with dropout
  is not one process's step. The same at dropout 0.1 on data 1 x seq 2 x
  model 2 with the batch cut to 36 fbank frames ("dsm36"), which divide
  over ``seq`` while their T' of 9 does not: the encoder then runs whole
  on both ``seq`` ranks and its gradients are counted once.
* After the update every tensor replicated over ``seq`` or ``model`` is
  the same on those ranks bit for bit (the local shards of the ranks that
  differ only in ``seq``; the replicated parameters of those that differ
  only in ``model``).
* A tensor-parallel checkpoint (gathered, written by rank 0) restores into
  one process bit for bit; a non-finite loss on one data rank's rows skips
  the step on all four ranks with every shard unchanged; decoding over
  data 2 x model 2 (``generate_sharded``) gives one process's tokens.
* ``tp_placement`` is JAX's ``param_partition_spec`` (called directly, on
  the flax trees of the three models, transposed to torch's layout) for
  every parameter, FastSpeech 2's ``out_proj`` and an indivisible
  vocabulary included; ``mesh_shape``'s wildcard and its error; the
  Philox masks at ``head0``; two shards of a layer emulated in one process
  (``shard.EmulatedGroup``) equal to the layer.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

from daspeech_torch.parallel import multihost as mh
from daspeech_torch.parallel import partition, shard
from test_torch_ddp import FLAGS, _global_batch, assert_update_matches
from torch_cli_corpus import YAMLS, cli_args, one_torch_thread  # noqa: F401

WORLD = 4
MESHES = {"dsm": (("data", 1), ("seq", 2), ("model", 2)),
          "dm": (("data", 2), ("model", 2))}
CRITS = ("nat_dag_loss", "s2s_dag_fastspeech2_loss")
# (criterion, mesh, dropout): every dropout rate of the model; "dsm36" is
# "dsm" on the batch cut to SHORT fbank frames
UPDATES = [(c, "dsm", 0.0) for c in CRITS] + [(c, "dsm", 0.1) for c in CRITS] \
    + [(c, "dm", 0.0) for c in CRITS] + [(c, "dsm36", 0.1) for c in CRITS]
MIN_SIZE = 64
# fbank frames of a batch whose frames divide over seq 2 and whose T' (9)
# does not: its encoder runs whole on every seq rank
SHORT = 36


def _cut(mesh):
    """What the batch of an update on ``mesh`` is cut to."""
    return _short if mesh == "dsm36" else lambda batch: batch


def _dropout_yaml(tree, rate):
    return {k: (_dropout_yaml(v, rate) if isinstance(v, dict)
                else rate if "dropout" in k else v) for k, v in tree.items()}


def _args(root, crit, rate, *flags):
    from daspeech_torch.cli import train as ttrain

    extra = ("--model-yaml", str(root / f"{crit}_drop.yaml")) if rate else ()
    return ttrain.parse_args(cli_args(root, crit, "unused", *FLAGS, *flags,
                                      *extra))


def _short(batch):
    """``batch`` cut to its first ``SHORT`` fbank frames."""
    return dict(batch, fbank=batch["fbank"][:, :SHORT],
                src_lengths=np.minimum(batch["src_lengths"], SHORT))


def _gathered_update(run, batch, rank):
    """One update on this rank's part of ``batch``; every tensor gathered
    to its unsharded value (collective), and the rank's local parameters
    and gradients."""
    from daspeech_torch.cli.train import step_generator
    from daspeech_torch.data.prefetch import to_device

    plan = run.state.sharding
    named = list(run.model.named_parameters())
    before = {n: plan.full(n, p.detach()).clone() for n, p in named}
    m = run.step(run.state, to_device(plan.shard_batch(batch), "cpu"),
                 step_generator(1, 0, rank, plan))
    return {
        "before": before,
        "loss": float(m["loss"]), "skipped": float(m["skipped"]),
        "gnorm": float(m["gnorm"]),
        "grads": {n: plan.full(n, p.grad).clone() for n, p in named
                  if p.grad is not None},
        "params": {n: plan.full(n, p.detach()).clone() for n, p in named},
        "stats": {n: b.clone() for n, b in run.model.named_buffers()
                  if "running_" in n},
        "local": {n: partition.local([p.detach()])[0].clone()
                  for n, p in named},
        "split": dict(plan.dims)}


def _rank_main(rank, init_file, root, out_dir):
    from daspeech_torch.cli import train as ttrain
    from daspeech_torch.config import DecodeConfig
    from daspeech_torch.data.prefetch import to_device
    from daspeech_torch.decode.generator import S2TNATGenerator
    from daspeech_torch.train.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    assert mh.initialize_distributed("unused:0", WORLD, rank,
                                     device_type="cpu",
                                     init_method=f"file://{init_file}")
    meshes = {k: partition.make_mesh(WORLD, axes, device="cpu")
              for k, axes in MESHES.items()}
    out = {"updates": {}, "coords": {
        k: tuple(int(c) for c in m.get_coordinate()) for k, m in
        meshes.items()}}
    for crit, mesh, rate in UPDATES:
        flags = ("--fsdp", "--min-fsdp-size", str(MIN_SIZE)) \
            if mesh == "dm" else ()
        run = ttrain.build(_args(root, crit, rate, *flags), "cpu",
                           mesh=meshes[mesh[:3]])
        out["updates"][crit, mesh, rate] = _gathered_update(
            run, _cut(mesh)(_global_batch(run, 4)), rank)
        if (crit, mesh, rate) == ("s2s_dag_fastspeech2_loss", "dsm", 0.0):
            ttrain.save_checkpoint(CheckpointManager(out_dir / "tp_ck"),
                                   run.state, 1, rank)
            plan, s = run.state.sharding, run.state.opt_state
            names = [n for n, p in run.model.named_parameters()]
            out["moments"] = ([plan.full(n, x) for n, x in zip(names, s.mu)],
                              [plan.full(n, x) for n, x in zip(names, s.nu)])

    # a non-finite loss on data rank 1's rows skips the step everywhere
    crit = "s2s_dag_fastspeech2_loss"
    skip = ttrain.build(_args(root, crit, 0.0, "--fsdp", "--min-fsdp-size",
                              str(MIN_SIZE)), "cpu", mesh=meshes["dm"])
    plan, s = skip.state.sharding, skip.state
    batch = _global_batch(skip, 4)
    batch["fbank"][2:, 0, 0] = np.inf
    before = [x.clone() for x in plan.local(
        s.params + s.opt_state.mu + s.opt_state.nu)]
    m = skip.step(s, to_device(plan.shard_batch(batch), "cpu"),
                  ttrain.step_generator(1, 0, rank, plan))
    after = plan.local(s.params + s.opt_state.mu + s.opt_state.nu)
    out["skip"] = {"skipped": float(m["skipped"]),
                   "same": all(torch.equal(a, b)
                               for a, b in zip(before, after)),
                   "count": int(s.opt_state.count)}

    # decoding: rows over data, the model split over model
    dec = ttrain.build(_args(root, "nat_dag_loss", 0.0), "cpu",
                       mesh=meshes["dm"])
    gen = S2TNATGenerator(dec.model.eval(), dec.vocab, DecodeConfig())
    batch = _global_batch(dec, 4)
    out["tokens"] = [h["tokens"] for h in partition.generate_sharded(
        gen, batch, meshes["dm"])]
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, out_dir / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from torch_cli_corpus import write_corpus

    root = tmp_path_factory.mktemp("tp")
    write_corpus(root)
    for crit in CRITS:
        (root / f"{crit}_drop.yaml").write_text(
            yaml.safe_dump(_dropout_yaml(YAMLS[crit], 0.1)))
    return root


@pytest.fixture(scope="module")
def four_ranks(corpus, tmp_path_factory):
    """What each of the four ranks saved."""
    import torch.multiprocessing as tmp

    out = tmp_path_factory.mktemp("tp_ranks")
    tmp.spawn(_rank_main, args=(out / "init", corpus, out), nprocs=WORLD,
              join=True)
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(WORLD)]


def _single(corpus, crit, rate, cut=lambda batch: batch):
    """One process's update on the whole batch, in float64 (its gradients,
    parameters and statistics rounded to float32), and its run. The exact
    arithmetic is the reference: two float32 runs that sum in other orders
    can sit further apart than either from it (at dropout 0.1 one float32
    process reads ``tts.pos_emb_alpha``'s gradient 8.9e-6 of its norm off
    float64, the data 1 x seq 2 x model 2 ranks 3.4e-6)."""
    from daspeech_torch.cli import train as ttrain
    from daspeech_torch.cli.train import update_generator
    from daspeech_torch.data.prefetch import to_device

    run = ttrain.build(_args(corpus, crit, rate), "cpu")
    run.model.double()
    s = run.state.opt_state
    run.state.opt_state = s._replace(mu=[x.double() for x in s.mu],
                                     nu=[x.double() for x in s.nu])
    named = list(run.model.named_parameters())
    before = {n: p.detach().float() for n, p in named}
    batch = {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
             else v
             for k, v in to_device(cut(_global_batch(run, 4)),
                                   "cpu").items()}
    m = run.step(run.state, batch, update_generator(1, 0, 0))
    return run, {
        "before": before,
        "loss": float(m["loss"]), "skipped": float(m["skipped"]),
        "gnorm": float(m["gnorm"]),
        "grads": {n: p.grad.float() for n, p in named
                  if p.grad is not None},
        "params": {n: p.detach().float() for n, p in named},
        "stats": {n: b.float() for n, b in run.model.named_buffers()
                  if "running_" in n}}


def _rank_of(ranks, mesh, coord):
    return next(r for r in ranks if r["coords"][mesh] == coord)


@pytest.mark.parametrize("crit,mesh,rate", UPDATES)
def test_mesh_update_equals_one_process(four_ranks, corpus, crit, mesh,
                                        rate):
    _, ranks = four_ranks
    got = [r["updates"][crit, mesh, rate] for r in ranks]
    _, want = _single(corpus, crit, rate, _cut(mesh))
    # rank 0 against one process; the last rank (other coordinates on
    # every axis) equal to rank 0 bit for bit
    assert_update_matches(got[0], got[-1], want)
    assert got[0]["split"], "nothing split over model"


@pytest.mark.parametrize("crit,rate", [(c, r) for c in CRITS
                                       for r in (0.0, 0.1)])
def test_replicated_tensors_equal_across_seq_and_model(four_ranks, crit,
                                                       rate):
    _, ranks = four_ranks
    keys = [(crit, "dsm", rate)] + ([(crit, "dsm36", rate)] if rate else [])
    for key, s, m in [(k, s, m) for k in keys for s in range(2)
                      for m in range(2)]:
        r = _rank_of(ranks, "dsm", (0, s, m))["updates"][key]
        over_seq = _rank_of(ranks, "dsm", (0, 1 - s, m))["updates"][key]
        over_model = _rank_of(ranks, "dsm", (0, s, 1 - m))["updates"][key]
        for n, x in r["local"].items():
            assert torch.equal(x, over_seq["local"][n]), n
            if n not in r["split"]:
                assert torch.equal(x, over_model["local"][n]), n
            else:
                assert not torch.equal(x, over_model["local"][n]), n
        for n, b in r["stats"].items():
            assert torch.equal(b, over_seq["stats"][n]), n
            assert torch.equal(b, over_model["stats"][n]), n


def test_tensor_parallel_checkpoint_restores_into_one_process(four_ranks,
                                                              corpus):
    from daspeech_torch.cli import train as ttrain
    from daspeech_torch.train.checkpoint import CheckpointManager

    out, ranks = four_ranks
    run = ttrain.build(_args(corpus, "s2s_dag_fastspeech2_loss", 0.0),
                       "cpu")
    CheckpointManager(out / "tp_ck").restore(run.state)
    saved = ranks[0]["updates"]["s2s_dag_fastspeech2_loss", "dsm", 0.0]
    for n, p in run.model.named_parameters():
        assert torch.equal(p.detach(), saved["params"][n]), n
    for n, b in run.model.named_buffers():
        if "running_" in n:
            assert torch.equal(b, saved["stats"][n]), n
    mu, nu = ranks[0]["moments"]
    for a, b in zip(run.state.opt_state.mu + run.state.opt_state.nu,
                    mu + nu):
        assert torch.equal(a, b)
    assert run.state.step == 1


def test_non_finite_loss_skips_on_every_rank(four_ranks):
    _, ranks = four_ranks
    for r in ranks:
        assert r["skip"] == {"skipped": 1.0, "same": True, "count": 0}


def test_sharded_decoding_gives_one_process_tokens(four_ranks, corpus):
    from daspeech_torch.cli import train as ttrain
    from daspeech_torch.config import DecodeConfig
    from daspeech_torch.decode.generator import S2TNATGenerator

    _, ranks = four_ranks
    run = ttrain.build(_args(corpus, "nat_dag_loss", 0.0), "cpu")
    gen = S2TNATGenerator(run.model.eval(), run.vocab, DecodeConfig())
    want = [h["tokens"] for h in gen.generate(_global_batch(run, 4))]
    assert len(want) == 4 and any(len(t) for t in want)
    for r in ranks:
        assert len(r["tokens"]) == 4
        for a, b in zip(r["tokens"], want):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------- placement and mesh

def _jax_and_port(crit, root, vocab_size=None):
    """(flax variables, the port's model) of ``crit`` at the corpus's tiny
    widths; ``vocab_size`` replaces the S2TT model's vocabulary size."""
    import dataclasses

    from daspeech_torch.cli.generate import build_model_cfg
    from daspeech_torch.models import S2TConformerDAG
    from daspeech_tpu.models import S2TConformerDAG as JaxS2TConformerDAG
    from test_torch_train_cli import _jax_side, _variables

    task, cfg, model, it = _jax_side(crit, root)
    spec, idxs = it.batches_for_epoch(1)[0]
    batch = it.collate(spec, idxs)
    if vocab_size is None:
        from daspeech_torch.cli import train as ttrain

        port = ttrain.build(_args(root, crit, 0.0), "cpu").model
    else:
        def resized(c):
            return dataclasses.replace(c, vocab=dataclasses.replace(
                c.vocab, size=vocab_size))

        model = JaxS2TConformerDAG(resized(cfg))
        port = S2TConformerDAG(resized(build_model_cfg(
            crit, str(root / f"{crit}.yaml"), task.vocab)))
    return _variables(crit, model, batch), port


def _port_names(model, variables):
    """{flax path: (port parameter name, whether the leaf is a Dense
    kernel, transposed in torch)} over the ``params`` collection."""
    from daspeech_torch import convert

    names = {id(m): n for n, m in model.named_modules()}
    out = {}
    for path, value in convert._leaves(variables["params"]):
        owner = model
        for key in path[:-1]:
            owner = convert._resolve(owner, key)
        attr, _ = convert._convert(owner, path[-1], np.asarray(value))
        prefix = names[id(owner)]
        out[path] = ((prefix + "." if prefix else "") + attr,
                     path[-1] == "kernel" and np.ndim(value) == 2)
    return out


@pytest.mark.parametrize("crit,vocab_size", [
    ("nat_dag_loss", None), ("s2s_dag_fastspeech2_loss", None),
    ("fastspeech2", None), ("nat_dag_loss", 33)])
def test_tp_placement_is_jax_param_partition_spec(corpus, crit, vocab_size):
    import jax
    from jax.sharding import Mesh

    from daspeech_torch import convert
    from daspeech_tpu.parallel.partition import param_partition_spec

    variables, port = _jax_and_port(crit, corpus, vocab_size)
    params = dict(port.named_parameters())
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    names = _port_names(port, variables)
    assert set(n for n, _ in names.values()) == set(params)
    leaves = dict(convert._leaves(variables["params"]))
    split = 0
    for path, (name, kernel) in names.items():
        spec = tuple(param_partition_spec("params/" + "/".join(path),
                                          np.asarray(leaves[path]), "model",
                                          mesh))
        want = None
        if "model" in spec:
            j = spec.index("model")
            want = 1 - j if kernel else j
        got = partition.tp_placement(name, tuple(params[name].shape), 2)
        assert got == want, (name, spec, got)
        split += got is not None
    assert split
    if crit == "s2s_dag_fastspeech2_loss":
        assert partition.tp_placement(
            "tts.out_proj.weight", tuple(params["tts.out_proj.weight"].shape),
            2) == 1
    if vocab_size == 33:        # an indivisible vocabulary stays whole
        assert partition.tp_placement(
            "decoder.embed_tokens.weight",
            tuple(params["decoder.embed_tokens.weight"].shape), 2) is None


@pytest.mark.parametrize("n,axes,want", [
    (8, (("data", -1), ("seq", 2), ("model", 2)), (2, 2, 2)),
    (4, (("data", -1), ("model", 2)), (2, 2)),
    (4, (("data", -1),), (4,)),
    (4, (("data", -1), ("seq", 2), ("model", 2)), (1, 2, 2)),
])
def test_mesh_shape_wildcard(n, axes, want):
    names, sizes = partition.mesh_shape(n, axes)
    assert names == tuple(a for a, _ in axes)
    assert sizes == want


@pytest.mark.parametrize("n,axes", [
    (2, (("data", -1), ("seq", 2), ("model", 2))),
    (6, (("data", 4), ("model", 2))),
])
def test_mesh_shape_raises_when_the_sizes_do_not_make_n(n, axes):
    with pytest.raises(ValueError, match="needs"):
        partition.mesh_shape(n, axes)


# ------------------------------------------------ head0 and emulated shards

def test_attention_keep_at_head0_is_the_layers_heads():
    from daspeech_torch.ops.philox import attention_keep

    seeds = torch.tensor([7, -3, 2 ** 30], dtype=torch.int32)
    whole = attention_keep(seeds, 8, 5, 9, 0.3)
    for h0 in (0, 2, 4, 6):
        assert torch.equal(attention_keep(seeds, 2, 5, 9, 0.3, h0),
                           whole[:, h0:h0 + 2])


@pytest.mark.parametrize("op", ["packed", "head_major", "relpos"])
def test_plain_attention_on_a_ranks_heads_is_the_layers(op):
    """Heads h0 .. h0 + 1 of a 4-head attention with dropout, run alone
    with ``head0`` = h0, are the whole call's (the CUDA kernels take the
    same counters; ``tests/test_torch_cuda_kernels.py`` holds them to
    these plain versions on the card)."""
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_relpos as fr

    g = torch.Generator().manual_seed(0)
    B, T, H, d, p = 2, 6, 4, 8, 0.3
    q, k, v = (torch.randn(B, T, H * d, generator=g) for _ in range(3))
    bias = torch.zeros(B, T)
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B,), generator=g,
                          dtype=torch.int32)
    for h0 in (0, 2):
        cols = slice(h0 * d, (h0 + 2) * d)
        if op == "packed":
            whole = fa.attention_plain(q, k, v, bias, H, 0.5, p, seeds)
            part = fa.attention_plain(q[..., cols], k[..., cols],
                                      v[..., cols], bias, 2, 0.5, p, seeds,
                                      h0)
        elif op == "head_major":
            def hm(x):
                return x.reshape(B, T, H, d).transpose(1, 2)

            whole = fa.attention_hm_plain(hm(q), hm(k), hm(v), bias, 0.5, p,
                                          seeds).transpose(1, 2).reshape(
                                              B, T, H * d)
            part = fa.attention_hm_plain(
                hm(q)[:, h0:h0 + 2], hm(k)[:, h0:h0 + 2],
                hm(v)[:, h0:h0 + 2], bias, 0.5, p, seeds, h0).transpose(
                    1, 2).reshape(B, T, 2 * d)
        else:
            C = 5
            a = torch.randn(B, T, H * C, generator=g)
            e = torch.randn(T, C, generator=g)
            whole = fr.relpos_plain(q, k, v, a, e, bias, H, 0.5, p, seeds)
            part = fr.relpos_plain(q[..., cols], k[..., cols], v[..., cols],
                                   a[..., h0 * C:(h0 + 2) * C], e, bias, 2,
                                   0.5, p, seeds, h0)
        torch.testing.assert_close(part, whole[..., cols], rtol=0,
                                   atol=1e-6)


def _layer(kind):
    """(a tiny layer with dropout 0.1 everywhere, its forward's
    arguments)."""
    from daspeech_torch.models.conformer import ConformerEncoderLayer
    from daspeech_torch.models.fastspeech2 import FFTLayer
    from daspeech_torch.models.layers import TransformerDecoderLayer

    torch.manual_seed(0)
    B, T, C = 2, 10, 16
    x = torch.randn(B, T, C)
    pad = torch.arange(T)[None, :] >= torch.tensor([[T], [7]])
    if kind == "conformer":
        return (ConformerEncoderLayer(C, 32, 2, 7, 0.1, 0.1), (x, pad))
    if kind == "decoder":
        enc = torch.randn(B, 12, C)
        enc_pad = torch.arange(12)[None, :] >= torch.tensor([[12], [9]])
        return (TransformerDecoderLayer(C, 32, 2, dropout=0.1,
                                        attention_dropout=0.1,
                                        activation_dropout=0.1),
                (x, pad, enc, enc_pad))
    return FFTLayer(C, 2, 32, 3, 0.1, 0.1), (x, pad)


@pytest.mark.parametrize("kind", ["conformer", "decoder", "fft"])
def test_two_emulated_shards_equal_the_layer(kind):
    """Shard 0 and 1 of a model-2 split, on two threads of one process
    whose row-parallel outputs are summed in rank order
    (``partition.emulated_shards``), give the unsharded layer's training
    forward (dropout 0.1, the same generator seed): the rank's heads with
    ``head0``, its slice of the FFN's inner width and of each mask."""
    layer, args = _layer(kind)
    layer.train()
    want = layer(*args, rng=torch.Generator().manual_seed(5))
    group, shards = partition.emulated_shards(layer, 2)
    outs = shard.run_ranks(group, [
        lambda m=m: m(*args, rng=torch.Generator().manual_seed(5))
        for m in shards])
    torch.testing.assert_close(outs[0], want, rtol=0, atol=1e-5)
    assert torch.equal(outs[0], outs[1])
    assert shards[1].self_attn.tp.rank == 1
