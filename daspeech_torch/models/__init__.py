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
from daspeech_torch.models.griffin_lim import GriffinLimVocoder
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
from daspeech_torch.models.s2s_multidecoder import (
    CausalTextDecoder,
    S2SMultiDecoderModel,
)
from daspeech_torch.models.tts_transformer import TTSTransformer

__all__ = [
    "CausalTextDecoder",
    "ConformerEncoder",
    "FFNAdapter",
    "FastSpeech2Encoder",
    "GlatLinkDecoder",
    "GriffinLimVocoder",
    "HiFiGANGenerator",
    "MultiPeriodDiscriminator",
    "MultiScaleDiscriminator",
    "S2SConformerDAGFastSpeech2",
    "S2SMultiDecoderModel",
    "S2TConformerDAG",
    "TTSTransformer",
    "fused_mrf_route",
    "graph_lengths",
    "initialize_output_tokens",
    "length_regulate",
    "receptive_halo_mel",
    "vocode_chunked",
    "vocode_chunks",
]
