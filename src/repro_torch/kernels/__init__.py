"""Hand-written Hopper kernels for the compute hot spots of the task-ISA
engine.

Each kernel ships kernel.py (the ctypes binding of its CUDA source under
csrc/, built by ``_build`` at first use), ref.py (the plain PyTorch
version of the same function) and ops.py (the public op).  The op picks
by the device of its tensors: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel, anything else raises.
"""
from . import tensor_alu, vta_gemm  # noqa: F401
