"""The port's checkpoints (``daspeech_torch/train/checkpoint.py``): the
cases of ``tests/test_checkpoint.py`` on its manager (keep-N, best,
restore, non-blocking saves, uncommitted files, resume after an abandoned
save); ``average_checkpoints`` against the JAX package's on the same values
(bit for bit); the three transfers against JAX's transfer followed by
``daspeech_torch.convert`` (bit for bit); and resuming a training run at a
saved iterator position: the batch sequence and every update after it
equal the uninterrupted run's, bit for bit on the CPU, and no skipped
batch is collated."""

import csv
import json

import numpy as np
import pytest
import torch

from test_data import make_dataset
from test_s2s_import_structure import V, fabricate_sd
from test_torch_fairseq_import import port_cfg

from daspeech_torch import convert
from daspeech_torch.data.prefetch import prefetch_epoch, to_device
from daspeech_torch.losses import s2s_dag_fastspeech2_loss
from daspeech_torch.models import (
    FastSpeech2Encoder,
    S2SConformerDAGFastSpeech2,
    S2TConformerDAG,
)
from daspeech_torch.tasks import NATSpeechToSpeechTask, TaskConfig
from daspeech_torch.train import GuardedAdam, TrainState, make_train_step
from daspeech_torch.train import checkpoint as tck
from daspeech_tpu.train import checkpoint as jck
from daspeech_tpu.train import torch_import as ti
from torch_cli_corpus import one_torch_thread  # noqa: F401


def make_state(value):
    return {"model": {"w": torch.full((3,), float(value))},
            "step": torch.tensor(value, dtype=torch.int32)}


class TestManager:
    def test_keep_last_and_best(self, tmp_path):
        m = tck.CheckpointManager(tmp_path, keep_last=2, maximize_best=False)
        for step, metric in [(1, 5.0), (2, 2.0), (3, 4.0), (4, 3.0)]:
            m.save(make_state(step), step, metric=metric)
        steps = m.all_steps()
        assert 4 in steps and 3 in steps
        assert 2 in steps          # best (lowest metric) is never pruned
        assert 1 not in steps
        assert m._best_step() == 2
        assert not (tmp_path / "checkpoint_1.json").exists()

    def test_maximize_best(self, tmp_path):
        m = tck.CheckpointManager(tmp_path, keep_last=1, maximize_best=True)
        for step, metric in [(1, 5.0), (2, 9.0), (3, 4.0)]:
            m.save(make_state(step), step, metric=metric)
        assert m._best_step() == 2 and m.all_steps() == [2, 3]
        assert json.loads((tmp_path / "best.json").read_text()) == {
            "step": 2, "metric": 9.0}

    def test_restore_latest(self, tmp_path):
        m = tck.CheckpointManager(tmp_path)
        assert m.restore() is None
        m.save(make_state(7), 7)
        got = m.restore()
        assert float(got["model"]["w"][0]) == 7.0

    def test_async_save_then_restore_exact(self, tmp_path):
        """Non-blocking save: the state is copied before save returns (a
        later in-place update does not reach the file), and restore waits
        for the write."""
        m = tck.CheckpointManager(tmp_path)
        w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        m.save({"params": {"w": w}, "step": np.asarray(9, np.int32)}, 9,
               blocking=False)
        w.add_(100.0)
        got = m.restore()
        torch.testing.assert_close(got["params"]["w"], w - 100.0,
                                   rtol=0, atol=0)
        assert int(got["step"]) == 9

    def test_async_saves_serialize(self, tmp_path):
        m = tck.CheckpointManager(tmp_path, keep_last=5)
        for step in (1, 2, 3):
            m.save(make_state(step), step, blocking=False)
        m.wait_until_finished()
        assert m.all_steps() == [1, 2, 3]
        for step in (1, 2, 3):
            got = m.restore(step=step)
            assert float(got["model"]["w"][0]) == float(step)

    def test_async_save_error_surfaces(self, tmp_path):
        m = tck.CheckpointManager(tmp_path)
        m.save({"bad": lambda: 0}, 1, blocking=False)   # unpicklable
        with pytest.raises(Exception):
            m.wait_until_finished()
        assert m.all_steps() == []

    def test_all_steps_skips_uncommitted_files(self, tmp_path):
        m = tck.CheckpointManager(tmp_path)
        m.save(make_state(4), 4)
        (tmp_path / "checkpoint_7.pt.123.456.tmp").write_bytes(b"\x00" * 8)
        (tmp_path / "checkpoint_best.pt").write_bytes(b"\x00")
        assert m.all_steps() == [4]
        assert m.latest_step() == 4

    def test_resume_after_abandoned_async_save(self, tmp_path):
        """A process commits step 3, then dies writing step 5, leaving a
        partial temporary file: a restarted manager resumes from step 3 and
        its meta, and a later save of step 5 supersedes the wreckage."""
        m1 = tck.CheckpointManager(tmp_path)
        m1.save(make_state(3), 3, extra={"epoch": 1, "batch_idx": 2})
        (tmp_path / "checkpoint_5.pt.99.1.tmp").write_bytes(b"\x00" * 128)

        m2 = tck.CheckpointManager(tmp_path)
        assert m2.all_steps() == [3] and m2.latest_step() == 3
        assert float(m2.restore()["model"]["w"][0]) == 3.0
        assert tck.resume_position(m2) == (1, 2)
        assert m2.meta(3) == {"step": 3, "metric": None, "epoch": 1,
                              "batch_idx": 2}
        m2.save(make_state(5), 5)
        assert m2.latest_step() == 5
        assert float(m2.restore()["model"]["w"][0]) == 5.0
        assert tck.resume_position(tck.CheckpointManager(tmp_path / "e")) \
            == (0, 0)

    def test_average_checkpoints(self, tmp_path):
        m = tck.CheckpointManager(tmp_path, keep_last=10)
        with pytest.raises(ValueError):
            tck.average_checkpoints(m)
        for step in (1, 2, 3):
            m.save(make_state(step), step)
        avg = tck.average_checkpoints(m, last_n=3)
        np.testing.assert_allclose(avg["w"], 2.0)
        avg2 = tck.average_checkpoints(m, last_n=2)
        np.testing.assert_allclose(avg2["w"], 2.5)
        avg5 = tck.average_checkpoints(m, last_n=5)
        np.testing.assert_allclose(avg5["w"], 2.0)
        assert tck.average_checkpoints(m, keys=[]) == {}

    def test_resume_after_death_between_meta_and_commit(self, tmp_path):
        """A process commits step 3, then dies after writing step 5's meta
        but before committing its ``.pt``: step 5 is not listed, and the
        latest checkpoint's meta and resume position are step 3's."""
        m1 = tck.CheckpointManager(tmp_path)
        m1.save(make_state(3), 3, extra={"epoch": 1, "batch_idx": 2})
        (tmp_path / "checkpoint_5.json").write_text(json.dumps(
            {"step": 5, "metric": None, "epoch": 2, "batch_idx": 0}))
        (tmp_path / "checkpoint_5.pt.99.1.tmp").write_bytes(b"\x00" * 128)

        m2 = tck.CheckpointManager(tmp_path)
        assert m2.all_steps() == [3]
        assert tck.resume_position(m2) == (1, 2)
        m2.save(make_state(5), 5, extra={"epoch": 2, "batch_idx": 1})
        assert tck.resume_position(m2) == (2, 1)

    def test_every_listed_step_has_its_meta(self, tmp_path):
        """Each save writes the meta before it commits the checkpoint, so
        every step ``all_steps`` lists has a readable meta, also while
        non-blocking saves are being written."""
        m = tck.CheckpointManager(tmp_path, keep_last=10)
        for step in range(1, 7):
            m.save(make_state(step), step, extra={"epoch": step},
                   blocking=step % 2 == 0)
            for s in m.all_steps():
                assert m.meta(s)["step"] == s
        m.wait_until_finished()
        assert [m.meta(s)["epoch"] for s in m.all_steps()] == [1, 2, 3, 4,
                                                               5, 6]


def test_average_checkpoints_matches_jax(tmp_path):
    """The same values (sums that round) averaged by both packages: the
    same float32 bits."""
    rng = np.random.default_rng(0)
    trees = [{"a": (rng.normal(size=(7, 5)) * 10 ** rng.uniform(
                 -3, 3, size=(7, 5))).astype(np.float32),
              "b": rng.normal(size=(11,)).astype(np.float32)}
             for _ in range(4)]
    tm = tck.CheckpointManager(tmp_path / "t", keep_last=10)
    jm = jck.CheckpointManager(tmp_path / "j", keep_last=10)
    for step, tree in enumerate(trees, 1):
        tm.save({"model": tree}, step)
        jm.save({"params": tree}, step)
    want = jck.average_checkpoints(jm, {"params": trees[0]}, last_n=3)
    got = tck.average_checkpoints(tm, last_n=3)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k])


# ---------------------------------------------------------------- transfers

def _perturbed(sd, seed):
    rng = np.random.default_rng(seed)
    return {k: (v + rng.normal(0, 0.01, v.shape)).astype(np.float32)
            for k, v in sd.items()}


def _params(module):
    return dict(module.named_parameters())


def _assert_params_equal(got: dict, want_module):
    want = _params(want_module)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("source,reset_vocab", [
    ("s2t", False), ("s2t", True), ("s2s", True)])
def test_transfer_dag_params_matches_jax(source, reset_vocab):
    cfg = port_cfg()
    sd = fabricate_sd()
    target = ti.import_s2s_daspeech(sd, 1, 1, cfg.tts)
    src_sd = _perturbed(sd, 1)
    if source == "s2t":
        src_sd = {k: v for k, v in src_sd.items()
                  if k.startswith(("encoder.", "decoder."))}
        src = ti.import_s2t_conformer_dag(src_sd, 1, 1)
        src_port = convert.load_flax_(S2TConformerDAG(cfg.dag), src)
    else:
        src = ti.import_s2s_daspeech(src_sd, 1, 1, cfg.tts)
        src_port = convert.load_flax_(S2SConformerDAGFastSpeech2(cfg), src)
    want = convert.load_flax_(
        S2SConformerDAGFastSpeech2(cfg),
        {"params": jck.transfer_dag_params(target["params"], src["params"],
                                           reset_vocab=reset_vocab),
         "batch_stats": target["batch_stats"]})
    tgt_port = convert.load_flax_(S2SConformerDAGFastSpeech2(cfg), target)
    got = tck.transfer_dag_params(_params(tgt_port), _params(src_port),
                                  reset_vocab=reset_vocab)
    _assert_params_equal(got, want)
    emb = "dag.decoder.embed_tokens.weight"
    kept = (_params(tgt_port)[emb] if reset_vocab else
            _params(src_port)[emb if source == "s2s" else emb[4:]])
    assert torch.equal(got[emb], kept)


def test_transfer_dag_params_into_s2t_matches_jax():
    cfg = port_cfg().dag
    sd = {k: v for k, v in fabricate_sd().items()
          if k.startswith(("encoder.", "decoder."))}
    target = ti.import_s2t_conformer_dag(sd, 1, 1)
    src = ti.import_s2t_conformer_dag(_perturbed(sd, 2), 1, 1)
    want = convert.load_flax_(S2TConformerDAG(cfg), {
        "params": jck.transfer_dag_params(target["params"], src["params"]),
        "batch_stats": target["batch_stats"]})
    got = tck.transfer_dag_params(
        _params(convert.load_flax_(S2TConformerDAG(cfg), target)),
        _params(convert.load_flax_(S2TConformerDAG(cfg), src)))
    _assert_params_equal(got, want)


def test_transfer_tts_params_and_component_match_jax():
    cfg = port_cfg()
    sd = fabricate_sd()
    target = ti.import_s2s_daspeech(sd, 1, 1, cfg.tts)
    fs2_sd = {"encoder." + k[4:]: v for k, v in _perturbed(sd, 3).items()
              if k.startswith("tts.")}
    fs2_sd["encoder.embed_tokens.weight"] = np.ones((V, cfg.tts.
                                                     encoder_embed_dim),
                                                    np.float32)
    fs2 = ti.import_fastspeech2(fs2_sd, cfg.tts)
    want = convert.load_flax_(S2SConformerDAGFastSpeech2(cfg), {
        "params": jck.transfer_tts_params(target["params"], fs2["params"]),
        "batch_stats": target["batch_stats"]})
    tgt_port = convert.load_flax_(S2SConformerDAGFastSpeech2(cfg), target)
    fs2_port = convert.load_flax_(FastSpeech2Encoder(cfg.tts, V, 1), fs2)
    got = tck.transfer_tts_params(_params(tgt_port), _params(fs2_port))
    _assert_params_equal(got, want)

    other = ti.import_s2s_daspeech(_perturbed(sd, 4), 1, 1, cfg.tts)
    want = convert.load_flax_(S2SConformerDAGFastSpeech2(cfg), {
        "params": jck.load_pretrained_component(
            target["params"], other["params"], "adaptor"),
        "batch_stats": target["batch_stats"]})
    got = tck.load_pretrained_component(
        _params(tgt_port),
        _params(convert.load_flax_(S2SConformerDAGFastSpeech2(cfg), other)),
        "adaptor")
    _assert_params_equal(got, want)
    with pytest.raises(KeyError):
        tck.load_pretrained_component(_params(tgt_port), {}, "adaptor")


# ------------------------------------------------------------------ resume

def _data_dir(root):
    rng = np.random.default_rng(11)
    d, rows, _ = make_dataset(root, rng, n=12, s2s=True)
    while len(d) < V:
        d.add_symbol(f"PH{len(d)}")
    with open(root / "train.tsv", "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t")
        w.writeheader()
        w.writerows(rows)
    d.save(root / "vocab.txt")


def _fresh_state(seed=0):
    torch.manual_seed(seed)
    model = S2SConformerDAGFastSpeech2(port_cfg()).train()
    opt = GuardedAdam(lr=1e-3, warmup_updates=2)
    return TrainState.create(model, opt), opt


def _run(state, opt, batcher, manager, epoch, start, n_updates, losses,
         save_every=3):
    """The training loop: batches through ``prefetch_epoch`` (collated and
    moved on the producer thread), one update each (its dropout drawn from
    a generator seeded by the step), a checkpoint every ``save_every``
    updates with the iterator position of the next batch."""
    vocab = port_cfg().dag.vocab
    step = make_train_step(
        lambda m, b, g: s2s_dag_fastspeech2_loss(m, b, g, 0.5, vocab), opt)
    while len(losses) < n_updates:
        n_batches = len(batcher.batches_for_epoch(epoch))
        for i, (_, batch) in enumerate(prefetch_epoch(
                batcher, epoch, start=start,
                to_device=lambda b: to_device(b, "cpu")), start):
            m = step(state, batch, torch.Generator().manual_seed(
                1000 + state.step))
            losses.append(m["loss"].item())
            if state.step % save_every == 0:
                nxt = (epoch, i + 1) if i + 1 < n_batches else (epoch + 1, 0)
                manager.save(state, state.step, blocking=False,
                             extra={"epoch": nxt[0], "batch_idx": nxt[1]},
                             metric=losses[-1])
            if len(losses) == n_updates:
                manager.wait_until_finished()
                return
        epoch, start = epoch + 1, 0


def test_resume_matches_the_uninterrupted_run(tmp_path):
    """Eight updates over two epochs (4 batches an epoch) with a
    checkpoint every three; a fresh model and optimizer restored at update
    3's checkpoint (its saved position: epoch 0, batch 3) and resumed reach
    the same losses, parameters, moments and counts, bit for bit, across
    the epoch boundary, and the skipped batches are never collated."""
    _data_dir(tmp_path)
    task = NATSpeechToSpeechTask.setup_task(TaskConfig(
        data_dir=str(tmp_path), max_tokens=200))
    task.load_dataset("train")
    batcher = task.get_batch_iterator("train", max_tokens=200, seed=3,
                                      num_buckets=2)
    n_epoch = len(batcher.batches_for_epoch(0))
    assert n_epoch == 4
    n_updates = 8

    state, opt = _fresh_state()
    full = tck.CheckpointManager(tmp_path / "full", keep_last=10)
    losses = []
    _run(state, opt, batcher, full, 0, 0, n_updates, losses)
    restart = 3
    epoch, start = tck.resume_position(full, step=restart)
    assert (epoch, start) == (0, 3)

    resumed, opt2 = _fresh_state(seed=1)          # other initial weights
    full.restore(resumed, step=restart)
    assert resumed.step == restart
    collated = []
    orig = batcher.collate
    batcher.collate = lambda spec, idxs, **kw: (
        collated.append(list(idxs)), orig(spec, idxs, **kw))[1]
    again = losses[:restart]
    _run(resumed, opt2, batcher, tck.CheckpointManager(tmp_path / "resumed"),
         epoch, start, n_updates, again)
    assert again == losses
    order = [ix for e in range(3) for _, ix in batcher.batches_for_epoch(e)]
    assert collated == order[restart:n_updates]
    for (n, a), b in zip(state.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(state.opt_state.mu + state.opt_state.nu,
                    resumed.opt_state.mu + resumed.opt_state.nu):
        assert torch.equal(a, b)
    assert int(state.opt_state.count) == int(resumed.opt_state.count) == 8
    assert full.all_steps() == [3, 6]


def test_vocoder_train_state_roundtrip(tmp_path):
    """A ``VocoderTrainState`` (generator, discriminators, both AdamW
    states and their decay counts) saved and restored into a fresh one."""
    from daspeech_torch.config import HiFiGANConfig
    from daspeech_torch.models import HiFiGANGenerator
    from daspeech_torch.train.vocoder_train import (VocoderTrainState,
                                                    make_vocoder_optimizer)

    def state(seed):
        torch.manual_seed(seed)
        gen = HiFiGANGenerator(HiFiGANConfig(upsample_initial_channel=16))
        disc = {"mpd": torch.nn.Linear(4, 3), "msd": torch.nn.Linear(3, 2)}
        return VocoderTrainState(
            0, gen, disc, make_vocoder_optimizer(gen.parameters()),
            make_vocoder_optimizer([p for m in disc.values()
                                    for p in m.parameters()]))

    s = state(0)
    for opt in (s.gen_opt, s.disc_opt):
        for group in opt.param_groups:
            for p in group["params"]:
                p.grad = torch.randn_like(p)
        opt.step()
    s.step = 1
    m = tck.CheckpointManager(tmp_path)
    m.save(s, 1)
    r = m.restore(state(1))
    assert r.step == 1 and r.gen_opt.count == r.disc_opt.count == 1
    for a, b in ((s.gen, r.gen), (s.disc["mpd"], r.disc["mpd"]),
                 (s.disc["msd"], r.disc["msd"])):
        for x, y in zip(a.state_dict().values(), b.state_dict().values()):
            assert torch.equal(x, y)
    for a, b in ((s.gen_opt, r.gen_opt), (s.disc_opt, r.disc_opt)):
        sa, sb = a.state_dict()["state"], b.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for k in sa:
            for name in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(sa[k][name], sb[k][name])
    assert torch.equal(m.restore()["gen"]["conv_pre.weight"],
                       s.gen.conv_pre.weight.detach())
