from .ops import vta_gemm  # noqa: F401
from .ref import vta_gemm_ref  # noqa: F401
