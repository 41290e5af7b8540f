"""Carry the reference package's objects across into this package.

The parameters on the task-ISA path are already numpy arrays (int8
weights, int32 bias rows) plus the hardware spec, so the reference's
objects cross as plain fields: ``dataclasses.asdict`` of a spec, an
epilogue or a decoder config, and dicts of numpy arrays.  Nothing here
imports the reference.
"""
from __future__ import annotations

import dataclasses
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


def quant_decoder(ref_decoder: Any, torch_device: TorchDeviceLike = None,
                  dram_size: int = 1 << 28):
    """The port's ``QuantDecoder`` carrying a reference ``QuantDecoder``'s
    config, hardware spec and weight arrays (numpy, copied), compiled onto
    `torch_device` (default the card).  A reference session's persistent
    image (``CompiledProgram.persistent_image``: raw blocked bytes per
    buffer) loads into the port's program as it is, through
    ``CompiledProgram.load_persistent_image``: both programs put the same
    buffers in the same blocked layout."""
    from .models.vta_decoder import DecoderConfig, QuantDecoder
    cfg = DecoderConfig(**dataclasses.asdict(ref_decoder.cfg))
    dec = QuantDecoder(cfg, spec=spec_from_fields(
        dataclasses.asdict(ref_decoder.spec)), torch_device=torch_device,
        dram_size=dram_size)
    dec.weights = [{k: np.array(v, np.int8) for k, v in blk.items()}
                   for blk in ref_decoder.weights]
    return dec
