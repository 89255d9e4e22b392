"""daspeech_torch: the PyTorch + CUDA port of ``daspeech_tpu``.

This first slice serves two-pass S2ST (fbank -> Conformer -> DAG decoder +
links -> lookahead decode -> FFN adaptor + FastSpeech 2 -> HiFi-GAN ->
waveform) through ``decode.generator.S2SNATGenerator``. Three hand-written
CUDA kernels for sm_90a (``csrc/``) carry its attention, rel-pos attention
and link extraction on the card; CPU tensors take each kernel's plain
PyTorch version instead.

The serving path runs in float32, as the JAX default does. Importing this
package sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``: cuDNN convolutions otherwise
default to TF32, which holds only about three decimal digits.

The package imports torch and numpy, and nothing of jax or of the JAX
package; only its tests import both.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
