from .ops import lut_gemm  # noqa: F401
from .ref import lut_gemm_ref, lut_gemm_table_ref  # noqa: F401
