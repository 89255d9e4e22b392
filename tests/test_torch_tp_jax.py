"""The port's data x seq x model step against JAX's ``jit_sharded`` (slow).

Eight gloo ranks (``torch.multiprocessing``) make one update of the tiny
S2TT model of ``tests/test_parallel.py`` (``tiny_dag_cfg``, B = 8 x 32
frames, no glance) on a (data 2, seq 2, model 2) mesh with FSDP over
``data`` (``partition.MeshParallel``), from the flax weights of JAX's own
test (``fast_init``); JAX makes the same update with ``jit_sharded(...,
seq_axis="seq", fsdp_axis="data")`` on the 8-device CPU mesh. Held at JAX's
bars (``tests/test_parallel.py:118-125``): the loss within 1e-4 relative,
every parameter after the update within rtol 5e-3, atol 5e-5. Dropout is
off on both sides (two generators cannot draw the same masks); the
sharded dropout is held to one process's in ``tests/test_torch_tp.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from daspeech_torch.parallel import multihost as mh
from daspeech_torch.parallel import partition

pytestmark = pytest.mark.slow
WORLD = 8
AXES = (("data", -1), ("seq", 2), ("model", 2))


def _no_dropout(cfg):
    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.0,
                                         attn_dropout=0.0),
        decoder=dataclasses.replace(cfg.decoder, dropout=0.0,
                                    attn_dropout=0.0,
                                    activation_dropout=0.0))


def _port_cfg(jcfg):
    from daspeech_torch.config import DAGModelConfig, from_dict, to_dict

    return from_dict(DAGModelConfig, to_dict(jcfg))


def _rank_main(rank, init_file, variables, batch, jcfg, out_dir):
    from daspeech_torch import convert
    from daspeech_torch.losses import nat_dag_loss
    from daspeech_torch.train import GuardedAdam, TrainState, make_train_step

    torch.set_num_threads(1)
    assert mh.initialize_distributed("unused:0", WORLD, rank,
                                     device_type="cpu",
                                     init_method=f"file://{init_file}")
    cfg = _port_cfg(jcfg)
    model = convert.dag_from_flax(variables, cfg, device="cpu").train()
    mesh = partition.make_mesh(WORLD, AXES, device="cpu")
    plan = partition.MeshParallel(model, mesh, fsdp=True, min_fsdp_size=64)
    opt = GuardedAdam(lr=1e-3, warmup_updates=10)
    state = TrainState.create(model, opt, plan)

    def loss_fn(m, b, rng):
        return nat_dag_loss(m, b, rng, 0.0, cfg.vocab, glance_strategy=None)

    step = make_train_step(loss_fn, opt, group=plan.group, sharding=plan)
    tb = {k: torch.as_tensor(np.asarray(v)).long()
          if np.asarray(v).dtype == np.int32 else torch.as_tensor(
              np.asarray(v)) for k, v in batch.items()}
    m = step(state, plan.shard_batch(tb), torch.Generator().manual_seed(2))
    params = {n: plan.full(n, p.detach()) for n, p in
              model.named_parameters()}
    if rank == 0:
        torch.save({"loss": float(m["loss"]), "params": params},
                   out_dir / "rank0.pt")
    dist.barrier()
    dist.destroy_process_group()


def test_mesh_step_matches_jax_jit_sharded(tmp_path):
    import torch.multiprocessing as tmp

    from daspeech_tpu.losses import nat_dag_loss
    from daspeech_tpu.models import S2TConformerDAG
    from daspeech_tpu.parallel import jit_sharded, make_mesh
    from daspeech_tpu.train import TrainState, make_optimizer, make_train_step
    from test_models import tiny_dag_cfg
    from test_train import make_batch
    from testutils import fast_init

    from daspeech_torch import convert

    cfg = _no_dropout(tiny_dag_cfg())
    model = S2TConformerDAG(cfg)
    batch = make_batch(np.random.default_rng(11), cfg, B=8, S=32)
    variables = fast_init(model, jax.random.key(0), batch["fbank"],
                          batch["src_lengths"], batch["prev_output_tokens"])
    tx = make_optimizer(lr=1e-3, warmup_updates=10)

    def loss_fn(pd, b, key, step):
        return nat_dag_loss(model, pd, b, key, jnp.asarray(0.0), cfg.vocab,
                            glance_strategy=None)

    step = make_train_step(loss_fn, tx)
    np_vars = jax.tree.map(np.asarray, variables)   # the step donates them
    state = TrainState.create(variables, tx)
    mesh = make_mesh(8, AXES)
    new, m = jit_sharded(step, mesh, state, seq_axis="seq", fsdp_axis="data",
                         min_fsdp_size=64)(state, batch, jax.random.key(2))
    tmp.spawn(_rank_main, args=(tmp_path / "init", np_vars,
                                jax.tree.map(np.asarray, batch), cfg,
                                tmp_path), nprocs=WORLD, join=True)
    got = torch.load(tmp_path / "rank0.pt", weights_only=False)
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-4)
    # JAX's updated parameters in the port's layout, by name
    want = convert.dag_from_flax(
        {**np_vars, "params": jax.tree.map(np.asarray, new.params)},
        _port_cfg(cfg), device="cpu")
    for name, p in want.named_parameters():
        np.testing.assert_allclose(got["params"][name].numpy(),
                                   p.detach().numpy(), rtol=5e-3, atol=5e-5,
                                   err_msg=name)
