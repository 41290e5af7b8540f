"""The LM for the dense family (olmo-1b, llama3.2-3b, minitron-8b,
starcoder2-7b), the moe family (phi3.5-moe, kimi-k2), the hybrid Mamba2
family (zamba2-1.2b) and xlstm-1.3b: parameters, caches, prefill and
decode.

The port of the serving half of the reference's ``models/transformer.py``
for the ``"attn"``, ``"moe"`` (attention, then the mixture of experts in
place of the MLP), ``"mamba2"``, ``"mamba2_sharedattn"`` (which applies
one globally shared attention block, with a KV cache of its own per
application), ``"mlstm"`` and ``"slstm"`` block types (each pre-norm with
a residual and no MLP; their caches are float32 whatever dtype the other
caches have).  Weights sit in an :class:`LMParams`
``nn.Module``, stacked over layers as in the reference, with state-dict
keys that are the reference's tree paths joined by ``.`` (for example
``layers.attn.attn.wq.w``); the math is plain functions on the nested
dict of tensors that :meth:`LMParams.tree` returns.  The reference scans
over the stacked layers; here a Python loop indexes them, and caches are
updated in place.

Not ported yet (``NotImplementedError`` names the ROADMAP item): the
vision and audio frontends, the whisper encoder and cross-attention, and
training (``forward_train``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import torch
from torch import nn

from repro_torch.core.driver import TorchDeviceLike, resolve_torch_device

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .config import ModelConfig
from .layers import (embed_apply, embed_init, linear_init, mlp_apply,
                     mlp_init, norm_apply, norm_init, torch_dtype)

Params = Dict[str, Any]

_NOT_PORTED = ("is not ported yet (ROADMAP Queue 1 item 4: the encoder, "
               "cross-attention and frontends)")


class LMParams(nn.Module):
    """A nested dict of tensors as a module: each dict a child module,
    each tensor a buffer, so ``state_dict()`` keys are the tree paths
    joined by ``.``."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, Mapping):
                self.add_module(k, LMParams(v))
            else:
                self.register_buffer(k, v)

    def tree(self) -> Params:
        """The nested dict of tensors (the buffers themselves, no copy)."""
        out: Params = {k: v for k, v in self._buffers.items()}
        for k, m in self._modules.items():
            out[k] = m.tree()
        return out


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.encoder_layers:
        raise NotImplementedError(f"the encoder of {cfg.name}: {_NOT_PORTED}")
    if cfg.frontend != "none":
        raise NotImplementedError(f"the {cfg.frontend} frontend of "
                                  f"{cfg.name}: {_NOT_PORTED}")


# ----------------------------------------------------------------------
# per-block init / cache / apply
# ----------------------------------------------------------------------
def _block_init(gen: torch.Generator, cfg: ModelConfig, btype: str, n: int,
                device: torch.device) -> Params:
    """A stack of n blocks of type `btype` with leading layer dim n."""
    d, lead = cfg.d_model, (n,)
    if btype in ("mamba2", "mamba2_sharedattn"):
        return {"ln1": norm_init(cfg, d, device, lead),
                "mamba": ssm_mod.mamba2_init(gen, cfg, device, lead)}
    if btype == "mlstm":
        return {"ln1": norm_init(cfg, d, device, lead),
                "mlstm": xlstm_mod.mlstm_init(gen, cfg, device, lead)}
    if btype == "slstm":
        return {"ln1": norm_init(cfg, d, device, lead),
                "slstm": xlstm_mod.slstm_init(gen, cfg, device, lead)}
    if btype == "moe":
        return {"ln1": norm_init(cfg, d, device, lead),
                "attn": attn.attn_init(gen, cfg, device, lead),
                "ln2": norm_init(cfg, d, device, lead),
                "moe": moe_mod.moe_init(gen, cfg, device, lead)}
    return {"ln1": norm_init(cfg, d, device, lead),
            "attn": attn.attn_init(gen, cfg, device, lead),
            "ln2": norm_init(cfg, d, device, lead),
            "mlp": mlp_init(gen, cfg, d, cfg.d_ff, device, lead)}


def _block_cache(cfg: ModelConfig, btype: str, batch: int, max_len: int,
                 dtype: torch.dtype, device: torch.device,
                 n: int) -> Params:
    if btype in ("attn", "moe"):
        return {"kv": attn.init_kv_cache(cfg, batch, max_len, dtype, device,
                                         (n,))}
    if btype == "mlstm":
        return xlstm_mod.init_mlstm_cache(cfg, batch, device, (n,))
    if btype == "slstm":
        return xlstm_mod.init_slstm_cache(cfg, batch, device, (n,))
    c = ssm_mod.init_ssm_cache(cfg, batch, dtype, device, (n,))
    if btype == "mamba2_sharedattn":
        # the shared block's weights are global, but each application
        # attends over its own history: a KV cache per layer
        c["shared_kv"] = attn.init_kv_cache(cfg, batch, max_len, dtype,
                                            device, (n,))
    return c


def _attn_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor, mode: str,
              kv: Params, pos: Optional[int]) -> torch.Tensor:
    """Pre-norm attention then the MLP (the mixture of experts where the
    block has one), each with its residual; `kv` is updated in place.  The
    moe layer's aux loss is a training term: serving drops it."""
    h = norm_apply(cfg, p["ln1"], x)
    if mode == "prefill":
        o, _ = attn.attn_prefill(p["attn"], cfg, h, kv)
    else:
        o, _ = attn.attn_decode(p["attn"], cfg, h, kv, pos)
    x = x + o
    h = norm_apply(cfg, p["ln2"], x)
    if "moe" in p:
        o, _ = moe_mod.moe_apply(p["moe"], cfg, h)
        return x + o
    return x + mlp_apply(p["mlp"], h, cfg)


def _block_apply(p: Params, cfg: ModelConfig, btype: str, x: torch.Tensor,
                 mode: str, cache: Params, pos: Optional[int],
                 shared_p: Optional[Params] = None) -> torch.Tensor:
    """One block on x in `mode` ("prefill" or "decode"); its cache is
    updated in place.  `shared_p` is zamba2's shared attention block."""
    if btype in ("attn", "moe"):
        return _attn_mlp(p, cfg, x, mode, cache["kv"], pos)
    h = norm_apply(cfg, p["ln1"], x)
    if btype in ("mlstm", "slstm"):
        fn = getattr(xlstm_mod, f"{btype}_{mode}")
        o, _ = fn(p[btype], cfg, h, cache)
        return x + o
    mamba = ssm_mod.mamba2_prefill if mode == "prefill" \
        else ssm_mod.mamba2_decode
    o, _ = mamba(p["mamba"], cfg, h, cache)
    x = x + o
    if btype == "mamba2_sharedattn" and shared_p is not None:
        x = _attn_mlp(shared_p, cfg, x, mode, cache["shared_kv"], pos)
    return x


# ----------------------------------------------------------------------
# model init
# ----------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: Union[int, torch.Generator] = 0,
                torch_device: TorchDeviceLike = None) -> LMParams:
    """Random weights with the reference's distributions, drawn from
    `generator` (a seeded ``torch.Generator`` on `torch_device`, or a
    seed), on `torch_device` (default the card)."""
    _check_supported(cfg)
    dev = resolve_torch_device(torch_device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator))
    p: Params = {"embed": embed_init(gen, cfg, dev),
                 "final_norm": norm_init(cfg, cfg.d_model, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab_size,
                                   torch_dtype(cfg), dev)
    pattern = cfg.block_pattern()
    p["layers"] = {b: _block_init(gen, cfg, b, pattern.count(b), dev)
                   for b in sorted(set(pattern))}
    if "mamba2_sharedattn" in pattern:
        d = cfg.d_model
        p["shared_attn"] = {"ln1": norm_init(cfg, d, dev),
                            "attn": attn.attn_init(gen, cfg, dev),
                            "ln2": norm_init(cfg, d, dev),
                            "mlp": mlp_init(gen, cfg, d, cfg.d_ff, dev)}
    return LMParams(p)


# ----------------------------------------------------------------------
# inputs -> first hidden states, hidden states -> logits
# ----------------------------------------------------------------------
def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """Token embedding (tokens only: the modality prefixes of the vision
    and audio frontends are not ported)."""
    if set(batch) - {"tokens"}:
        raise NotImplementedError(f"inputs {sorted(set(batch) - {'tokens'})}"
                                  f": {_NOT_PORTED}")
    return embed_apply(params["embed"], cfg, batch["tokens"])


def _head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tokens"].t()
    return params["lm_head"]["w"]


def logits_fn(params: Params, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    h = norm_apply(cfg, params["final_norm"], h)
    logits = h @ _head_weight(params, cfg).to(h.dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ----------------------------------------------------------------------
# serving: caches, prefill, decode
# ----------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16,
                torch_device: TorchDeviceLike = None) -> Params:
    """Per-layer caches stacked over each block type's layers, on
    `torch_device` (default the card): zeros (the sLSTM normalizer ones),
    in `dtype` (the xlstm caches float32)."""
    _check_supported(cfg)
    dev = resolve_torch_device(torch_device)
    pattern = cfg.block_pattern()
    return {"layers": {b: _block_cache(cfg, b, batch, max_len, dtype, dev,
                                       pattern.count(b))
                       for b in sorted(set(pattern))}}


def _index(tree: Params, i: int) -> Params:
    """Layer i of a stacked tree: views, so writes reach the stack."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _run_stack_cached(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      caches: Params, mode: str,
                      pos: Optional[int]) -> torch.Tensor:
    counters = {b: 0 for b in set(cfg.block_pattern())}
    shared_p = params.get("shared_attn")
    for btype in cfg.block_pattern():
        i = counters[btype]
        counters[btype] += 1
        x = _block_apply(_index(params["layers"][btype], i), cfg, btype, x,
                         mode, _index(caches["layers"][btype], i), pos,
                         shared_p)
    return x


def _tree(params: Union[LMParams, Params]) -> Params:
    return params.tree() if isinstance(params, LMParams) else params


def prefill(params: Union[LMParams, Params], cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor],
            caches: Params) -> tuple:
    """Run the prompt; returns (logits at the last position, caches), the
    caches updated in place."""
    _check_supported(cfg)
    params = _tree(params)
    x = embed_inputs(params, cfg, batch)
    x = _run_stack_cached(params, cfg, x, caches, "prefill", None)
    return logits_fn(params, cfg, x[:, -1:]), caches


def decode_step(params: Union[LMParams, Params], cfg: ModelConfig,
                caches: Params, token: torch.Tensor,
                pos: Union[int, torch.Tensor]) -> tuple:
    """token: (B, 1) integer; pos: the step's position (an int), the same
    for every row.  Returns (logits (B, 1, V), caches updated in place)."""
    _check_supported(cfg)
    params = _tree(params)
    pos = int(pos)
    x = embed_apply(params["embed"], cfg, token,
                    positions=torch.full(token.shape, pos,
                                         device=token.device))
    x = _run_stack_cached(params, cfg, x, caches, "decode", pos)
    return logits_fn(params, cfg, x), caches
