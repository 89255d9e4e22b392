from daspeech_torch.models.conformer import ConformerEncoder
from daspeech_torch.models.dag_model import (
    GlatLinkDecoder,
    S2TConformerDAG,
    graph_lengths,
    initialize_output_tokens,
)
from daspeech_torch.models.fastspeech2 import (
    FastSpeech2Encoder,
    FFNAdapter,
    length_regulate,
)
from daspeech_torch.models.hifigan import (
    HiFiGANGenerator,
    fused_mrf_route,
    receptive_halo_mel,
    vocode_chunked,
    vocode_chunks,
)
from daspeech_torch.models.hifigan_discriminators import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
)
from daspeech_torch.models.s2s_model import S2SConformerDAGFastSpeech2

__all__ = [
    "ConformerEncoder",
    "FFNAdapter",
    "FastSpeech2Encoder",
    "GlatLinkDecoder",
    "HiFiGANGenerator",
    "MultiPeriodDiscriminator",
    "MultiScaleDiscriminator",
    "S2SConformerDAGFastSpeech2",
    "S2TConformerDAG",
    "fused_mrf_route",
    "graph_lengths",
    "initialize_output_tokens",
    "length_regulate",
    "receptive_halo_mel",
    "vocode_chunked",
    "vocode_chunks",
]
