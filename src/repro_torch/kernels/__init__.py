"""Hand-written Hopper kernels for the compute hot spots of the task-ISA
engine, the quantized decoder and the LM serve path (attention, and the
chunked scan of Mamba2's prefill).

Each kernel ships kernel.py (the ctypes binding of its CUDA source under
csrc/, built by ``_build`` at first use), ref.py (the plain PyTorch
version of the same function) and ops.py (the public op).  The op picks
by the device of its tensors: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel, a ``meta`` tensor takes the LM path's ops'
card route with nothing launched (the dry run, ``_meta.py``; lut_gemm
and tensor_alu have none), anything else raises.
"""
from . import (decode_attention, flash_attention, gla_chunk,  # noqa: F401
               lut_gemm, tensor_alu, vta_gemm)
