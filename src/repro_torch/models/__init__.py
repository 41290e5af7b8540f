"""Models on the VTA datapath: the quantized decoder served through the
compiled stack, and dense layers through the program-level JIT."""
from . import quantized, vta_decoder  # noqa: F401
from .quantized import VtaLinear, vta_linear_from_params  # noqa: F401
from .vta_decoder import (DecoderConfig, DecoderReference,  # noqa: F401
                          QuantDecoder)
