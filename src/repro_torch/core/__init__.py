"""VTA core: the paper's contribution (template, ISA, runtime, simulator,
scheduler, program-level JIT) as a composable package on PyTorch."""
from . import backend, compiler, conv, driver, hwspec, isa  # noqa: F401
from . import layout, microop, program, quantize, runtime  # noqa: F401
from . import scheduler, simulator, workloads  # noqa: F401
from .backend import (CrossBackendChecker, CudaBackend,  # noqa: F401
                      ExecutionBackend, SimulatorBackend, assert_fast_path,
                      decode_cache_info, resolve_backend,
                      set_decode_cache_cap)
from .conv import ConvShape, select_conv_lowering  # noqa: F401
from .driver import Device, resolve_torch_device  # noqa: F401
from .hwspec import HardwareSpec, pynq, pynq_batch2, tpu_like  # noqa: F401
from .program import (CompiledProgram, Program, TensorRef,  # noqa: F401
                      compile_multi)
from .runtime import Runtime  # noqa: F401
from .scheduler import Epilogue, SramPartition  # noqa: F401
from .simulator import RunStats  # noqa: F401
