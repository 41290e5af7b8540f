from .ops import quantized_linear, vta_gemm  # noqa: F401
from .ref import (quantize_activations, quantized_linear_ref,  # noqa: F401
                  vta_gemm_ref)
