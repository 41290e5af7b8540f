"""repro_torch: the VTA hardware-software stack on PyTorch and CUDA.

A port of the JAX package ``repro``, module for module, for an NVIDIA
Hopper card.  ``core`` holds the template, ISA, runtime, simulator,
compiler and the two execution engines; ``kernels`` holds the
hand-written CUDA kernels the fast engine resolves its tiles through.
Data lives in torch tensors on an explicit device, ``"cuda"`` by default.
"""
__version__ = "0.1.0"
