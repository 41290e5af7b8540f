"""VTA core: the paper's contribution (template, ISA, runtime, simulator,
scheduler, program-level JIT, serving plane) as a composable package on
PyTorch."""
from . import autotune, backend, chaos, compiler, conv, driver  # noqa: F401
from . import hwspec, isa, layout, microop, pipeline_model  # noqa: F401
from . import program, quantize, runtime, sched, scheduler  # noqa: F401
from . import serve, simulator, workloads  # noqa: F401
from .autotune import TuningCache, TuningRecord  # noqa: F401
from .backend import (CrossBackendChecker, CudaBackend,  # noqa: F401
                      ExecutionBackend, SimulatorBackend, assert_fast_path,
                      decode_cache_info, resolve_backend,
                      set_decode_cache_cap)
from .chaos import Fault, FaultPlan  # noqa: F401
from .conv import ConvShape, select_conv_lowering  # noqa: F401
from .driver import Device, resolve_torch_device  # noqa: F401
from .hwspec import HardwareSpec, pynq, pynq_batch2, tpu_like  # noqa: F401
from .program import (CompiledProgram, Program, TensorRef,  # noqa: F401
                      compile_multi)
from .runtime import Runtime  # noqa: F401
from .sched import (DeadlineExpired, QueueFull, SchedConfig,  # noqa: F401
                    SchedFuture, Scheduler, Shed, auto_gang_width)
from .scheduler import Epilogue, SramPartition  # noqa: F401
from .serve import (BatchServer, DevicePool, IntegrityError,  # noqa: F401
                    PoolFuture, SessionStats, SlotDied, WaitTimeout,
                    WatchdogConfig, WatchdogTimeout, serve_batch)
from .simulator import RunStats  # noqa: F401
