from daspeech_torch.losses.dag_loss import (
    GlanceDraws,
    GlatInfo,
    compute_dag_loss,
    force_emit_match,
    glat_glance,
    nat_dag_loss,
)

__all__ = [
    "GlanceDraws",
    "GlatInfo",
    "compute_dag_loss",
    "force_emit_match",
    "glat_glance",
    "nat_dag_loss",
]
