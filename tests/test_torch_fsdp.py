"""Fully sharded data parallelism in the port (``--fsdp``,
``daspeech_torch.parallel.partition``), on the CPU with gloo.

* Two ranks (``torch.multiprocessing``, rendezvous through a file under
  ``tmp_path``) each take their half of one global batch under ``--fsdp
  --min-fsdp-size 64`` and make one update of the tiny S2TT or joint
  model; one process makes the same update on the whole batch, unsharded.
  Held at ``tests/test_torch_ddp.py``'s bars (its
  ``assert_update_matches``): the loss, ``skipped``, the gradient norm,
  every gradient (gathered from its shards), BatchNorm's running
  statistics and every parameter after the update; both ranks gather the
  same tensors bit for bit.
* The placement: a parameter under ``--min-fsdp-size`` elements stays
  replicated (a plain tensor, its gradient all-reduced), the others are
  split along their largest dim, a conv kernel along its tap dim only;
  ``shard_dim``'s rules on their own.
* Checkpoints: the ranks' checkpoint (gathered, written by rank 0)
  restores into one process with the ranks' parameters and Adam moments
  bit for bit, in the unsharded run's format; one process's checkpoint
  restores under ``--fsdp`` with every rank holding its slice, the
  gathered state equal to the file bit for bit.
* Validation of three valid batches over two ranks (two on rank 0, one
  on rank 1) runs to its end and gives one process's metric on both.
* A non-finite loss on one rank's rows skips the step on both ranks:
  every shard of every parameter and moment unchanged bit for bit, the
  counts kept.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from daspeech_torch.parallel import multihost as mh
from daspeech_torch.parallel import partition
from test_torch_ddp import (CASES, FLAGS, WORLD, _global_batch, _single,
                            assert_update_matches)
from torch_cli_corpus import cli_args

MIN_SIZE = 64
FSDP_FLAGS = FLAGS + ("--fsdp", "--min-fsdp-size", str(MIN_SIZE))


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _one_update(run, batch):
    """``test_torch_ddp._one_update`` with every tensor gathered."""
    from daspeech_torch.cli.train import update_generator
    from daspeech_torch.data.prefetch import to_device

    before = {n: _full(p.detach()).clone()
              for n, p in run.model.named_parameters()}
    m = run.step(run.state, to_device(batch, "cpu"),
                 update_generator(1, 0, 0))
    return {
        "before": before,
        "loss": float(m["loss"]), "skipped": float(m["skipped"]),
        "gnorm": float(m["gnorm"]),
        "grads": {n: _full(p.grad).clone() for n, p in
                  run.model.named_parameters() if p.grad is not None},
        "params": {n: _full(p.detach()).clone()
                   for n, p in run.model.named_parameters()},
        "stats": {n: b.clone() for n, b in run.model.named_buffers()
                  if "running_" in n}}


def _gathered(state):
    """(model state dict, mu, nu) gathered to full tensors."""
    return ({k: partition.full(v) for k, v in state.model.state_dict().items()},
            [partition.full(m) for m in state.opt_state.mu],
            [partition.full(v) for v in state.opt_state.nu])


def _rank_main(rank, init_file, root, crit, out_dir, single_dir):
    from daspeech_torch.cli import train as ttrain
    from daspeech_torch.data.prefetch import to_device
    from daspeech_torch.train.checkpoint import CheckpointManager

    torch.set_num_threads(1)
    assert mh.initialize_distributed("unused:0", WORLD, rank,
                                     device_type="cpu",
                                     init_method=f"file://{init_file}")
    out = {"updates": {}}
    args = ttrain.parse_args(cli_args(root, crit, "unused", *FSDP_FLAGS))
    group = dist.group.WORLD
    for n_real in CASES:
        run = ttrain.build(args, "cpu", group=group)
        batch = _global_batch(run, n_real)
        local = mh.slice_batch(batch, mh.process_batch_slice(4))
        out["updates"][n_real] = _one_update(run, local)

    # the placement
    out["dims"] = dict(run.state.sharding.fsdp.dims)
    out["replicated"] = [n for n, p in run.model.named_parameters()
                         if not run.state.sharding.sharded([p])[0]]
    out["local_shapes"] = {n: tuple(p._local_tensor.shape)
                           for n, p in run.model.named_parameters()
                           if n in out["dims"]}
    # the sharded checkpoint, gathered (rank 0 writes it)
    ttrain.save_checkpoint(CheckpointManager(out_dir / "fsdp_ck"),
                           run.state, 1, rank)
    out["saved"] = _gathered(run.state)

    # validation before any update: the three valid batches go 2 / 1 to
    # the ranks
    fresh = ttrain.build(args, "cpu", group=group)
    out["valid"] = ttrain.make_validator(args, fresh, "cpu")(fresh.state)
    # one process's checkpoint restored under --fsdp
    CheckpointManager(single_dir).restore(fresh.state)
    out["restored"] = _gathered(fresh.state)
    out["restored_step"] = fresh.state.step
    out["restored_local"] = {
        n: p._local_tensor.clone() for n, p in fresh.model.named_parameters()
        if n in out["dims"]}

    # a non-finite loss on rank 1's rows skips the step everywhere
    skip = ttrain.build(args, "cpu", group=group)
    batch = mh.slice_batch(_global_batch(skip, 4),
                           mh.process_batch_slice(4))
    if rank == 1:
        batch["fbank"][0, 0, 0] = np.inf
    s = skip.state
    before = [x.clone() for x in partition.local(
        s.params + s.opt_state.mu + s.opt_state.nu)]
    m = skip.step(s, to_device(batch, "cpu"), ttrain.update_generator(1, 0,
                                                                      0))
    after = partition.local(s.params + s.opt_state.mu + s.opt_state.nu)
    out["skip"] = {"skipped": float(m["skipped"]),
                   "same": all(torch.equal(a, b)
                               for a, b in zip(before, after)),
                   "count": int(s.opt_state.count),
                   "sched_count": int(s.opt_state.sched_count)}
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, out_dir / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from torch_cli_corpus import write_corpus

    root = tmp_path_factory.mktemp("fsdp")
    write_corpus(root)
    return root


def _single_args(corpus, crit, *flags):
    from daspeech_torch.cli import train as ttrain

    return ttrain.parse_args(cli_args(corpus, crit, "unused", *FLAGS,
                                      *flags))


def _single_run(corpus, crit, *flags):
    from daspeech_torch.cli import train as ttrain

    return ttrain.build(_single_args(corpus, crit, *flags), "cpu")


@pytest.fixture(scope="module", params=["nat_dag_loss",
                                        "s2s_dag_fastspeech2_loss"])
def two_ranks(request, corpus, tmp_path_factory):
    """(criterion, the single process's checkpointed run, what each rank
    saved)."""
    import torch.multiprocessing as tmp

    from daspeech_torch.train.checkpoint import CheckpointManager

    crit = request.param
    out = tmp_path_factory.mktemp(f"fsdp_{crit}")
    # one process's checkpoint after an update, for the ranks to restore
    single = _single_run(corpus, crit)
    _one_update(single, _global_batch(single, 3))
    CheckpointManager(out / "single_ck").save(single.state,
                                              single.state.step)
    tmp.spawn(_rank_main, args=(out / "init", corpus, crit, out,
                                out / "single_ck"),
              nprocs=WORLD, join=True)
    return crit, single, out, [torch.load(out / f"rank{r}.pt",
                                          weights_only=False)
                               for r in range(WORLD)]


@pytest.mark.parametrize("n_real", CASES)
def test_fsdp_ranks_equal_one_process(two_ranks, corpus, n_real):
    crit, _, _, ranks = two_ranks
    assert_update_matches(ranks[0]["updates"][n_real],
                          ranks[1]["updates"][n_real],
                          _single(corpus, crit, n_real))


def test_small_parameters_stay_replicated(two_ranks):
    _, single, _, ranks = two_ranks
    shapes = {n: tuple(p.shape) for n, p in single.model.named_parameters()}
    r0 = ranks[0]
    assert r0["dims"] and r0["replicated"]
    assert set(r0["dims"]) | set(r0["replicated"]) == set(shapes)
    assert r0["dims"] == ranks[1]["dims"]
    for n in r0["replicated"]:
        assert partition.shard_dim(shapes[n], WORLD, MIN_SIZE) is None, n
    for n, d in r0["dims"].items():
        assert int(np.prod(shapes[n])) >= MIN_SIZE, n
        assert d == partition.shard_dim(shapes[n], WORLD, MIN_SIZE)
        want = list(shapes[n])
        want[d] //= WORLD
        assert r0["local_shapes"][n] == tuple(want), n
    # a 16-element bias is under the bar; the decoder's embedding is not
    assert "decoder.layers.0.self_attn.k_proj.bias" in r0["replicated"] or \
        "dag.decoder.layers.0.self_attn.k_proj.bias" in r0["replicated"]
    assert any(n.endswith("decoder.embed_tokens.weight") for n in r0["dims"])


def test_fsdp_checkpoint_restores_into_one_process(two_ranks, corpus):
    from daspeech_torch.train.checkpoint import CheckpointManager

    crit, _, out, ranks = two_ranks
    run = _single_run(corpus, crit)
    CheckpointManager(out / "fsdp_ck").restore(run.state)
    sd, mu, nu = ranks[0]["saved"]
    assert set(sd) == set(run.model.state_dict())        # the same format
    for k, v in run.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for a, b in zip(run.state.opt_state.mu + run.state.opt_state.nu,
                    mu + nu):
        assert torch.equal(a, b)
    assert run.state.step == 1
    for r in ranks[1:]:
        for k, v in r["saved"][0].items():
            assert torch.equal(v, sd[k]), k


def test_one_process_checkpoint_restores_under_fsdp(two_ranks):
    from daspeech_torch.train.checkpoint import CheckpointManager

    _, single, out, ranks = two_ranks
    data = CheckpointManager(out / "single_ck").restore()
    for rank, r in enumerate(ranks):
        assert r["restored_step"] == single.state.step
        sd, mu, nu = r["restored"]
        for k, v in data["model"].items():
            assert torch.equal(sd[k], v), k
        for a, b in zip(mu + nu, data["opt_state"]["mu"]
                        + data["opt_state"]["nu"]):
            assert torch.equal(a, b)
        for n, local in r["restored_local"].items():
            want = data["model"][n].chunk(WORLD, r["dims"][n])[rank]
            assert torch.equal(local, want), n


def test_fsdp_validates_uneven_shares(two_ranks, corpus):
    """Three valid batches over two ranks: rank 0 validates two, rank 1
    one. Under --fsdp every rank ends with one process's metric (BLEU for
    ``nat_dag_loss``, the valid loss for the joint criterion)."""
    from daspeech_torch.cli import train as ttrain

    crit, _, _, ranks = two_ranks
    args = _single_args(corpus, crit)
    run = ttrain.build(args, "cpu")
    vit = run.task.get_batch_iterator(args.valid_subset, seed=args.seed,
                                      upsample_scale=args.src_upsample_scale)
    assert len(list(vit.batches_for_epoch(0))) % WORLD == 1
    want, records = ttrain.make_validator(args, run, "cpu")(run.state)
    for r in ranks:
        got, got_records = r["valid"]
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9), (got, want)
        assert got_records[0][0].keys() == records[0][0].keys()


def test_non_finite_loss_skips_on_both_ranks(two_ranks):
    _, _, _, ranks = two_ranks
    for r in ranks:
        assert r["skip"] == {"skipped": 1.0, "same": True, "count": 0,
                             "sched_count": 0}


@pytest.mark.parametrize("shape,world,min_size,want", [
    ((512, 256), 2, 4096, 0),       # the largest dim
    ((256, 512), 4, 4096, 1),
    ((256, 256), 2, 4096, 0),       # the first of equals
    ((30, 512), 4, 4096, 1),        # the largest that divides
    ((6, 10), 4, 4, None),          # none divides
    ((16,), 2, 64, None),           # under the size bar
    ((512,), 2, 64, 0),
    ((512, 256, 31), 2, 64, None),  # a conv kernel: its tap dim only
    ((512, 256, 32), 2, 64, 2),
    ((512, 1, 5, 5), 5, 64, 2),
    ((4096, 4), 1, 4096, 0),        # a world of one splits into one piece
])
def test_shard_dim_rules(shape, world, min_size, want):
    assert partition.shard_dim(shape, world, min_size) == want
