from .block_map import BlockMap  # noqa: F401
from .ops import requantize, tensor_alu, tensor_alu_scatter  # noqa: F401
from .ref import (ALU_OPS, alu_apply, tensor_alu_ref,  # noqa: F401
                  tensor_alu_scatter_ref)
