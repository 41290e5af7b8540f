"""Carry the reference package's objects across into this package.

The parameters on the task-ISA path are already numpy arrays (int8
weights, int32 bias rows) plus the hardware spec, so the reference's
objects cross as plain fields: ``dataclasses.asdict`` of a spec or an
epilogue, and dicts of numpy arrays.  Nothing here imports the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .core.driver import TorchDeviceLike, resolve_torch_device
from .core.hwspec import HardwareSpec
from .core.scheduler import Epilogue


def spec_from_fields(fields: Mapping[str, Any]) -> HardwareSpec:
    """A HardwareSpec from the fields of a reference spec
    (``dataclasses.asdict(spec)``)."""
    return HardwareSpec(**dict(fields))


def epilogue_from_fields(fields: Mapping[str, Any]) -> Epilogue:
    """An Epilogue from the fields of a reference epilogue
    (``dataclasses.asdict(ep)``), including ``bias_blocked``."""
    f = dict(fields)
    if f.get("bias_blocked") is not None:
        f["bias_blocked"] = np.asarray(f["bias_blocked"], np.int32)
    return Epilogue(**f)


def constants_from_numpy(arrays: Mapping[str, np.ndarray],
                         torch_device: TorchDeviceLike = None
                         ) -> Dict[str, torch.Tensor]:
    """Tensors on `torch_device` (default the card) holding the same
    values and dtypes as `arrays`."""
    dev = resolve_torch_device(torch_device)
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
            for k, v in arrays.items()}
