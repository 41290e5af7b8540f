"""Carry the reference package's objects across into this package.

The parameters on the task-ISA path are already numpy arrays (int8
weights, int32 bias rows) plus the hardware spec, so the reference's
objects cross as plain fields: ``dataclasses.asdict`` of a spec, an
epilogue, a decoder config or a model config, and nested dicts of numpy
arrays (an LM's weight tree, raw or quantized: a caller turns a JAX tree
into numpy first).  Nothing here imports the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .core.driver import TorchDeviceLike, resolve_torch_device
from .core.hwspec import HardwareSpec
from .core.scheduler import Epilogue
from .models.config import ModelConfig, ShardingConfig


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


def model_config_from_fields(fields: Mapping[str, Any]) -> ModelConfig:
    """A ModelConfig from the fields of a reference config
    (``dataclasses.asdict(cfg)``, the nested sharding config included)."""
    f = dict(fields)
    if isinstance(f.get("sharding"), Mapping):
        f["sharding"] = ShardingConfig(**f["sharding"])
    return ModelConfig(**f)


def _tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The same bytes as a tensor on `dev`; bfloat16 arrays (ml_dtypes)
    cross through their 16-bit patterns."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)) \
            .view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_numpy(tree: Mapping[str, Any],
                         torch_device: TorchDeviceLike = None):
    """An ``LMParams`` on `torch_device` (default the card) holding the
    values of a reference LM weight tree given as nested dicts of numpy
    arrays, raw or quantized.  Quantized weights cross as their int8
    bytes; each ``w_q`` (..., K, N) is stored as a transposed view of
    contiguous (..., N, K), as the port's own ``quantize_params`` stores
    it.  Every other leaf keeps its dtype, whatever the model's: the
    xlstm sLSTM's recurrent ``r`` and Mamba2's ``A_log``, ``D`` and
    ``dt_bias`` stay float32 in a bfloat16 tree."""
    from .models.transformer import LMParams
    dev = resolve_torch_device(torch_device)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = walk(v)
            elif k == "w_q":
                nk = np.ascontiguousarray(np.swapaxes(np.asarray(v), -1, -2))
                out[k] = _tensor(nk, dev).transpose(-1, -2)
            else:
                out[k] = _tensor(v, dev)
        return out
    return LMParams(walk(tree))
