"""The port's bf16 joint S2ST step (``s2s_dag_fastspeech2_loss``,
``expect``) against the JAX package's, on the CPU at small widths: the
second step of ``tests/test_torch_bf16_train.py``, whose module docstring
gives the bars, in a file of its own so that the tier-1 run's workers can
run it beside the others."""

import jax
import jax.numpy as jnp
import torch

from daspeech_torch import convert
from daspeech_torch.losses import s2s_loss as ts2s
from daspeech_torch.models import s2s_model as tmodel
from daspeech_tpu.losses import s2s_loss as js2s
from daspeech_tpu.models import s2s_model as jmodel
from test_torch_bf16_models import jax_kernel_route, one_thread  # noqa: F401
from test_torch_bf16_train import BF16, _assert_step, _jax_value_and_grad, _tb
from test_torch_joint import _joint_batch, _joint_variables
from test_torch_joint import _small_cfg as joint_cfg


def test_joint_step():
    cfg = joint_cfg()
    batch = _joint_batch(cfg, 0)
    v = _joint_variables(jmodel.S2SConformerDAGFastSpeech2(cfg), batch, 1)
    jb = {k: jnp.asarray(x) for k, x in batch.items()}

    def loss_of(dt, params):
        return js2s.s2s_dag_fastspeech2_loss(
            jmodel.S2SConformerDAGFastSpeech2(cfg, dtype=dt),
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            jax.random.key(3), jnp.float32(0.0), cfg.dag.vocab)

    want = _jax_value_and_grad(loss_of, v)
    tm = convert.load_flax_(
        tmodel.S2SConformerDAGFastSpeech2(cfg, dtype=BF16), v).train()
    loss, _ = ts2s.s2s_dag_fastspeech2_loss(tm, _tb(batch),
                                            torch.Generator(), 0.0,
                                            cfg.dag.vocab)
    loss.backward()
    _assert_step(tm, loss, want)
