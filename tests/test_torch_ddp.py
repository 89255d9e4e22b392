"""Data parallelism in the port (``daspeech_torch.parallel.multihost`` and
the process group of ``train.make_train_step``), on the CPU with gloo.

* Two ranks (``torch.multiprocessing``, rendezvous through a file under
  ``tmp_path``) each take their half of one global batch and make one
  update of the tiny S2TT or joint model; one process makes the same
  update on the whole batch. The batch's fill rows (``sample_mask`` 0) sit
  on the second rank: with 2 real rows of 4 that rank holds no real row,
  with 3 it holds one. Held: the loss within 1e-6 relative, the reduced
  gradients within 1e-5 of each tensor's norm, BatchNorm's running
  statistics within 1e-6, the same ``skipped`` and gradient norm (the
  clip's), and the parameters after the update within 1e-6. The update
  starts its warmup at the full lr (``--warmup-init-lr`` = ``--lr``), so
  every parameter with a gradient moves by about lr = 1e-3, a thousand
  times the bar. Held apart are the elements where Adam's first step,
  lr g / (|g| + eps), is sign-like: a gradient below 1e-5 of its tensor's
  largest, the key projections' biases (exact gradient 0), and the
  elements whose two gradients differ by more than 1e-3 of their value
  (the step's relative error is the gradient's): 2 lr there, and at most
  1% of the parameters that have a gradient. Both ranks end with the same
  parameters, bit for bit. The ranks change the order of the sums over
  rows: most gradients stay within 1e-6 of their norm, but fp32 rounds
  the tensors behind a softmax's shift invariance (the link gates, the
  query biases, whose elements are differences of much larger terms) and
  a few large sums of the joint model up to 6.2e-6 of theirs, so the bar
  is 1e-5, that of the CLI's parity test against JAX. A key projection's
  bias (exact gradient 0) is held to 1e-5 of its kernel's gradient's
  norm.
* The same ranks exchange host objects (``all_gather_host_objects``,
  ``broadcast_host``), split the evaluation batches (``shard_batches``)
  and sum gradients in several buckets (``all_reduce_grads_``).
* The counterparts of ``tests/test_multihost.py``: topology resolution
  (explicit, ``DASPEECH_*``, torchrun, SLURM; a partial spec raises),
  ``initialize_distributed`` with ``init_process_group`` replaced,
  ``process_batch_slice``, ``shard_batches``, single-process degradation
  and the heartbeat watchdog's four cases.
"""

import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from daspeech_torch.parallel import multihost as mh
from torch_cli_corpus import LR, cli_args

WORLD = 2
TOL = 1e-6
GRAD_TOL = 1e-5         # of each tensor's norm
SUB_FLOOR = 1e-5
KEY_BIASES = (".k_proj.bias", ".linear_k.bias", ".key_linear.bias")
ADAM_REL = 1e-3         # above: the first step's error exceeds 1e-3 lr
CASES = (2, 3)          # real rows of the global batch of 4
# the first update at the full lr (the default warmup starts it at 1e-7)
FLAGS = ("--warmup-init-lr", str(LR))


def _global_batch(run, n_real: int):
    """The first batch of epoch 1 cut to ``n_real`` items and collated:
    the batch axis is filled to 4 rows with ``sample_mask`` 0."""
    spec, idxs = run.batcher.batches_for_epoch(1)[0]
    assert spec.batch == 4 and len(idxs) == 4
    return run.batcher.collate(spec, idxs[:n_real])


def _one_update(run, batch):
    from daspeech_torch.cli.train import update_generator
    from daspeech_torch.data.prefetch import to_device

    before = {n: p.detach().clone() for n, p in run.model.named_parameters()}
    m = run.step(run.state, to_device(batch, "cpu"),
                 update_generator(1, 0, 0))
    return {
        "before": before,
        "loss": float(m["loss"]), "skipped": float(m["skipped"]),
        "gnorm": float(m["gnorm"]),
        "grads": {n: p.grad.clone() for n, p in
                  run.model.named_parameters() if p.grad is not None},
        "params": {n: p.detach().clone()
                   for n, p in run.model.named_parameters()},
        "stats": {n: b.clone() for n, b in run.model.named_buffers()
                  if "running_" in n}}


def _rank_main(rank, init_file, root, crit, out_dir):
    """One rank: join the group, make one update per case on its rows,
    exercise the host collectives, save what it saw."""
    from daspeech_torch.cli import train as ttrain

    torch.set_num_threads(1)
    assert mh.initialize_distributed("unused:0", WORLD, rank,
                                     device_type="cpu",
                                     init_method=f"file://{init_file}")
    out = {"updates": {}}
    args = ttrain.parse_args(cli_args(root, crit, "unused", *FLAGS))
    for n_real in CASES:
        run = ttrain.build(args, "cpu", group=dist.group.WORLD)
        batch = _global_batch(run, n_real)
        local = mh.slice_batch(batch, mh.process_batch_slice(4))
        out["updates"][n_real] = _one_update(run, local)
    out["counts"] = dict(mh.COUNTS)
    out["gathered"] = mh.all_gather_host_objects(
        {"rank": rank, "payload": "x" * (1000 * rank + 1)})
    out["broadcast"] = mh.broadcast_host(f"from rank {rank}")
    out["shard"] = list(mh.shard_batches(range(7)))
    grads = [torch.full((n,), float(rank + 1)) for n in (3, 5, 2, 4)]
    mh.all_reduce_grads_(grads, dist.group.WORLD, bucket_bytes=24)
    out["bucketed"] = grads
    dist.barrier()
    dist.destroy_process_group()
    torch.save(out, out_dir / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from torch_cli_corpus import write_corpus

    root = tmp_path_factory.mktemp("ddp")
    write_corpus(root)
    return root


@pytest.fixture(scope="module", params=["nat_dag_loss",
                                        "s2s_dag_fastspeech2_loss"])
def two_ranks(request, corpus, tmp_path_factory):
    """(criterion, what each rank saved)."""
    import torch.multiprocessing as tmp

    crit = request.param
    out = tmp_path_factory.mktemp(f"ranks_{crit}")
    tmp.spawn(_rank_main, args=(out / "init", corpus, crit, out),
              nprocs=WORLD, join=True)
    return crit, [torch.load(out / f"rank{r}.pt", weights_only=False)
                  for r in range(WORLD)]


def _single(corpus, crit, n_real):
    """One process's update on the whole batch."""
    from daspeech_torch.cli import train as ttrain

    run = ttrain.build(ttrain.parse_args(cli_args(corpus, crit, "unused",
                                                  *FLAGS)), "cpu")
    return _one_update(run, _global_batch(run, n_real))


@pytest.mark.parametrize("n_real", CASES)
def test_two_ranks_equal_one_process(two_ranks, corpus, n_real):
    crit, ranks = two_ranks
    want = _single(corpus, crit, n_real)
    got = ranks[0]["updates"][n_real]
    other = ranks[1]["updates"][n_real]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
    assert got["skipped"] == other["skipped"] == want["skipped"] == 0.0
    np.testing.assert_allclose(got["gnorm"], want["gnorm"], rtol=TOL)
    assert got["gnorm"] == other["gnorm"]
    assert set(got["grads"]) == set(want["grads"])
    for name, g in want["grads"].items():
        ref = (want["grads"][name[:-4] + "weight"]
               if name.endswith(KEY_BIASES) else g)
        bar = GRAD_TOL * float(ref.norm())
        err = float((got["grads"][name] - g).abs().max())
        assert err <= bar, (name, err, float(g.norm()))
        assert torch.equal(got["grads"][name], other["grads"][name]), name
    for name, s in want["stats"].items():
        torch.testing.assert_close(got["stats"][name], s, rtol=0, atol=TOL)
        assert torch.equal(got["stats"][name], other["stats"][name]), name
    n_sign, n_all = 0, 0
    steps = []
    for name, p in want["params"].items():
        g = want["grads"].get(name, torch.zeros_like(p))
        dg = (got["grads"].get(name, torch.zeros_like(p)) - g).abs()
        floor = ((g.abs() < SUB_FLOOR * max(float(g.abs().max()), 1e-30))
                 | (dg > ADAM_REL * g.abs())).numpy()
        if name.endswith(KEY_BIASES):                # exact gradient 0
            floor[:] = True
        err = (got["params"][name] - p).abs().numpy()
        nz = (g != 0).numpy()
        steps.append((p - want["before"][name]).abs().numpy()[nz])
        assert float(err[~floor].max(initial=0.0)) <= TOL, name
        assert float(err[floor].max(initial=0.0)) <= 2 * LR, name
        assert torch.equal(got["params"][name], other["params"][name]), name
        n_sign += int((floor & (g != 0).numpy()).sum())
        n_all += int((g != 0).sum())
    assert n_sign <= n_all // 100, (n_sign, n_all)
    # the bar is far below the update: a step in the wrong direction, of
    # another size, or left out would fail it
    assert float(np.median(np.concatenate(steps))) > 0.5 * LR


def test_the_ranks_reduced_through_the_group(two_ranks):
    _, ranks = two_ranks
    for r in ranks:
        c = r["counts"]
        assert c["grad_all_reduce"] >= len(CASES)
        assert c["bn_sync"] >= 2 * len(CASES)      # mean, then variance
        assert c["count_sum"] > 0


def test_host_collectives_across_ranks(two_ranks):
    _, ranks = two_ranks
    want = [{"rank": r, "payload": "x" * (1000 * r + 1)}
            for r in range(WORLD)]
    for r, saved in enumerate(ranks):
        assert saved["gathered"] == want
        assert saved["broadcast"] == "from rank 0"
        assert saved["shard"] == list(range(r, 7, WORLD))
        for g, n in zip(saved["bucketed"], (3, 5, 2, 4)):
            assert torch.equal(g, torch.full((n,), 3.0))


# ------------------------------------------------------ topology resolution

def test_single_process_resolves_to_none():
    assert mh.resolve_topology(env={}) is None
    assert mh.resolve_topology(env={"SLURM_JOB_ID": "1",
                                    "SLURM_NTASKS": "1"}) is None


def test_explicit_arguments():
    t = mh.resolve_topology("10.0.0.1:1234", 4, 2, env={"LOCAL_RANK": "1"})
    assert t == mh.Topology(2, 4, 1, "tcp://10.0.0.1:1234")


def test_env_fallback():
    t = mh.resolve_topology(env={mh.ENV_COORDINATOR: "head:9999",
                                 mh.ENV_NUM_PROCESSES: "2",
                                 mh.ENV_PROCESS_ID: "1"})
    assert t == mh.Topology(1, 2, 0, "tcp://head:9999")


def test_torchrun_env():
    t = mh.resolve_topology(env={"RANK": "3", "WORLD_SIZE": "8",
                                 "LOCAL_RANK": "3", "MASTER_ADDR": "h",
                                 "MASTER_PORT": "29500"})
    assert t == mh.Topology(3, 8, 3, "env://")


def test_slurm_env():
    env = {"SLURM_JOB_ID": "7", "SLURM_NTASKS": "4", "SLURM_PROCID": "2",
           "SLURM_LOCALID": "0", "MASTER_ADDR": "node0",
           "MASTER_PORT": "12345"}
    assert mh.resolve_topology(env=env) == mh.Topology(
        2, 4, 0, "tcp://node0:12345")
    del env["MASTER_ADDR"]
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        mh.resolve_topology(env=env)


@pytest.mark.parametrize("kw", [
    dict(coordinator="head:1"),
    dict(coordinator="head:1", num_processes=2),
    dict(num_processes=2, process_id=0),
    dict(process_id=1),
])
def test_partial_spec_raises(kw):
    with pytest.raises(ValueError):
        mh.resolve_topology(env={}, **kw)


def test_initialize_forwards_the_topology(monkeypatch):
    calls = []
    monkeypatch.setattr(mh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(mh.dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    for var in ("RANK", "WORLD_SIZE", mh.ENV_COORDINATOR,
                mh.ENV_NUM_PROCESSES, mh.ENV_PROCESS_ID, "SLURM_JOB_ID"):
        monkeypatch.delenv(var, raising=False)
    assert mh.initialize_distributed(device_type="cpu") is False
    assert calls == []
    assert mh.initialize_distributed("10.0.0.1:1234", 4, 2,
                                     device_type="cpu") is True
    assert calls == [dict(backend="gloo", init_method="tcp://10.0.0.1:1234",
                          rank=2, world_size=4)]
    # a CUDA run takes NCCL, and needs the card
    with pytest.raises(RuntimeError, match="CUDA"):
        mh.initialize_distributed("10.0.0.1:1234", 4, 2, device_type="cuda")


def test_single_process_degradation():
    assert not dist.is_initialized()
    assert (mh.process_index(), mh.process_count()) == (0, 1)
    assert mh.all_gather_host_objects({"a": 1}) == [{"a": 1}]
    assert mh.broadcast_host(5) == 5
    assert list(mh.shard_batches(range(5))) == [0, 1, 2, 3, 4]
    x = torch.ones(3)
    assert mh.global_sum(x) is x
    with mh.data_parallel(None):
        assert mh.step_group() is None


# ------------------------------------------------------------ shard by rank

def test_slices_partition_the_batch():
    rows = np.arange(32)
    parts = [rows[mh.process_batch_slice(32, pi, 4)] for pi in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts), rows)
    assert all(len(p) == 8 for p in parts)


def test_uneven_batch_raises():
    with pytest.raises(ValueError):
        mh.process_batch_slice(30, 0, 4)


def test_round_robin_partitions_exactly():
    got = [list(mh.shard_batches(range(10), pi, 3)) for pi in range(3)]
    assert sorted(x for g in got for x in g) == list(range(10))
    assert got[1] == [1, 4, 7]


def test_slice_batch_keeps_nested_rows():
    b = {"a": np.arange(8).reshape(4, 2), "m": {"t": np.arange(4)},
         "s": 3}
    got = mh.slice_batch(b, slice(2, 4))
    np.testing.assert_array_equal(got["a"], [[4, 5], [6, 7]])
    np.testing.assert_array_equal(got["m"]["t"], [2, 3])
    assert got["s"] == 3


# ----------------------------------------------------------------- watchdog

class TestHeartbeatWatchdog:
    def _wd(self, timeout):
        fired = threading.Event()
        wd = mh.HeartbeatWatchdog(timeout,
                                  on_timeout=lambda pid, t: fired.set())
        return wd, fired

    def test_fires_without_progress(self):
        wd, fired = self._wd(0.2)
        try:
            wd.ping()
            assert fired.wait(3.0)
        finally:
            wd.stop()

    def test_pings_keep_it_alive(self):
        wd, fired = self._wd(0.5)
        try:
            for _ in range(8):
                wd.ping()
                time.sleep(0.1)
            assert not fired.is_set()
        finally:
            wd.stop()

    def test_unarmed_until_first_ping(self):
        wd, fired = self._wd(0.1)
        try:
            time.sleep(0.4)
            assert not fired.is_set()
        finally:
            wd.stop()

    def test_disabled_when_nonpositive(self):
        for t in (0, -1):
            wd = mh.HeartbeatWatchdog(t)
            assert wd._thread is None
            wd.ping()
            wd.stop()
