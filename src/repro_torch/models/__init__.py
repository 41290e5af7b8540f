"""Models: the quantized decoder served through the compiled stack, dense
layers through the program-level JIT, and the LM (dense, MoE, hybrid
Mamba2 and xLSTM families) with its serve-time PTQ."""
from . import (attention, layers, moe, quantized, ssm,  # noqa: F401
               transformer, vta_decoder, xlstm)
from .quantized import (VtaLinear, quantize_params,  # noqa: F401
                        vta_linear_from_params)
from .transformer import LMParams  # noqa: F401
from .vta_decoder import (DecoderConfig, DecoderReference,  # noqa: F401
                          QuantDecoder)
