from .ops import requantize, tensor_alu  # noqa: F401
from .ref import ALU_OPS, alu_apply, tensor_alu_ref  # noqa: F401
