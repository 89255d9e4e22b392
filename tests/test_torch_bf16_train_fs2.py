"""The port's bf16 FastSpeech 2 pretraining step (``fastspeech2_criterion``)
against the JAX package's, on the CPU at small widths: the third step of
``tests/test_torch_bf16_train.py``, whose module docstring gives the bars,
in a file of its own so that the tier-1 run's workers can run it beside
the other two."""

import jax
import jax.numpy as jnp
import torch

from daspeech_torch import convert
from daspeech_torch.losses import tts_loss as ttts
from daspeech_torch.models import fastspeech2 as tfs
from daspeech_tpu.losses import tts_loss as jtts
from daspeech_tpu.models import fastspeech2 as jfs
from test_torch_bf16_models import jax_kernel_route, one_thread  # noqa: F401
from test_torch_bf16_train import BF16, _assert_step, _jax_value_and_grad, _tb
from test_torch_fs2_train import V, VOCAB
from test_torch_fs2_train import _batch as fs2_batch
from test_torch_fs2_train import _cfg as fs2_cfg
from test_torch_models import random_variables


def test_fastspeech2_step():
    cfg = fs2_cfg()
    batch = fs2_batch(cfg, 9)
    v = random_variables(jfs.FastSpeech2Encoder(cfg, vocab_size=V,
                                                pad=VOCAB.pad), 10,
                         src_tokens=batch["src_tokens"],
                         max_out_len=batch["target_audio"].shape[1])
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_of(dt, params):
        return jtts.fastspeech2_criterion(
            jfs.FastSpeech2Encoder(cfg, vocab_size=V, pad=VOCAB.pad,
                                   dtype=dt), {"params": params}, jb,
            jax.random.key(0), VOCAB)

    want = _jax_value_and_grad(loss_of, v)
    tm = convert.load_flax_(
        tfs.FastSpeech2Encoder(cfg, V, VOCAB.pad, dtype=BF16), v).train()
    loss, _ = ttts.fastspeech2_criterion(tm, _tb(batch), torch.Generator(),
                                         VOCAB)
    loss.backward()
    _assert_step(tm, loss, want)
