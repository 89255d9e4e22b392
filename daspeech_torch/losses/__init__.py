from daspeech_torch.losses.dag_loss import (
    GlanceDraws,
    GlatInfo,
    compute_dag_loss,
    conditional_stop_gradient,
    force_emit_match,
    glat_glance,
    nat_dag_loss,
)
from daspeech_torch.losses.fastspeech2_loss import (
    fastspeech2_losses,
    masked_mean,
)
from daspeech_torch.losses.s2s_loss import (
    argmax_path_features,
    dag_frozen,
    expected_features,
    s2s_dag_fastspeech2_loss,
)
from daspeech_torch.losses.tts_loss import (
    fastspeech2_criterion,
    fastspeech2_ctc_loss,
    multidecoder_criterion,
    sigmoid_bce,
    tts_transformer_criterion,
)

__all__ = [
    "GlanceDraws",
    "GlatInfo",
    "argmax_path_features",
    "compute_dag_loss",
    "conditional_stop_gradient",
    "dag_frozen",
    "expected_features",
    "fastspeech2_criterion",
    "fastspeech2_ctc_loss",
    "fastspeech2_losses",
    "force_emit_match",
    "glat_glance",
    "masked_mean",
    "multidecoder_criterion",
    "nat_dag_loss",
    "s2s_dag_fastspeech2_loss",
    "sigmoid_bce",
    "tts_transformer_criterion",
]
