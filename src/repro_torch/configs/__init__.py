"""Architecture registry: one module per assigned architecture (data
only; the port's copies of the reference's ``repro.configs``)."""
from typing import List

from .base import (SHAPES, ArchSpec, ShapeSpec, for_shape,  # noqa: F401
                   input_specs, reduced)

_ARCH_MODULES = {
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "kimi-k2-1t-a32b": "kimi_k2",
    "zamba2-1.2b": "zamba2",
    "olmo-1b": "olmo_1b",
    "minitron-8b": "minitron_8b",
    "llama3.2-3b": "llama32_3b",
    "starcoder2-7b": "starcoder2_7b",
    "xlstm-1.3b": "xlstm_1b",
    "phi-3-vision-4.2b": "phi3_vision",
    "whisper-large-v3": "whisper_large_v3",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_arch(name: str) -> ArchSpec:
    import importlib
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.ARCH


def cells(include_skipped: bool = False):
    """All (arch, shape) cells; skipped shapes only when asked."""
    out = []
    for a in list_archs():
        spec = get_arch(a)
        for s in SHAPES:
            if s in spec.shapes or include_skipped:
                out.append((a, s))
    return out
