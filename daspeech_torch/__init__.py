"""daspeech_torch: the PyTorch + CUDA port of ``daspeech_tpu``.

It serves two-pass S2ST (fbank -> Conformer -> DAG decoder + links ->
DAG decode -> FFN adaptor + FastSpeech 2 -> HiFi-GAN -> waveform) through
``decode.generator.S2SNATGenerator`` and S2TT through
``decode.generator.S2TNATGenerator``, with every decode strategy of the
JAX package (lookahead, greedy, viterbi, jointviterbi, beamsearch), the
length beam and iterative refinement. It trains through
``train.make_train_step`` over ``losses.nat_dag_loss`` (the S2TT DAG
model), ``losses.s2s_dag_fastspeech2_loss`` (the joint S2ST model) and
``losses.fastspeech2_criterion`` (FastSpeech 2 pretraining on phonemes),
and trains the HiFi-GAN vocoder against its MPD/MSD discriminators through
``train.vocoder_train.VocoderTrainer``. Around the models: the data
pipeline (``data``), the tasks (``tasks``), checkpoints
(``train.checkpoint``), metrics (``train.metrics``), released fairseq
``.pt`` loading (``train.fairseq_import``) and the generate CLI
(``python -m daspeech_torch.cli.generate``).
Hand-written CUDA kernels for sm_90a (``csrc/``) carry attention, packed
and head-major, and rel-pos attention (forward and backward, with
dropout), link extraction (forward and backward), the DAG alpha/beta
recursion and the Viterbi alignment on the card; CPU tensors take each
kernel's plain PyTorch version instead.

Serving and training run in float32, as the JAX default does; a model given
``dtype=torch.bfloat16`` (``cli.train --dtype bfloat16``) computes in bf16
on fp32 parameters, as JAX's ``--dtype bfloat16`` does, and the attention,
rel-pos and link kernels take bf16 operands. Importing this
package sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``: cuDNN convolutions otherwise
default to TF32, which holds only about three decimal digits.

The package imports torch and numpy, and nothing of jax or of the JAX
package; only its tests import both.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
