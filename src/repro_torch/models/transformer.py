"""The LM for all ten architecture configs: the dense family (olmo-1b,
llama3.2-3b, minitron-8b, starcoder2-7b), the moe family (phi3.5-moe,
kimi-k2), the hybrid Mamba2 family (zamba2-1.2b), xlstm-1.3b, the vision
model phi-3-vision-4.2b and the encoder-decoder whisper-large-v3:
parameters, caches, prefill and decode.

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

The modality frontends are stubs, as in the reference: phi-3-vision's
``patch_emb`` (B, n_patches, d) prefixes the text, so its rope positions
count the patches; whisper's ``frames`` (B, encoder_seq, d) run through
the non-causal encoder (``_encode``), and each decoder layer adds
cross-attention over them.  Prefill attends over the K/V it has just
computed from the encoder output, in the activation dtype, and writes a
copy in the cache dtype into ``cross_kv`` (never int8); a decode step
reads ``cross_kv``.  ``cross_kv`` is ``encoder_seq`` rows long and
written in place, so frames of another length raise ``ValueError``
(the reference swaps in whatever length it is given).

Training (``forward_hidden``, ``chunked_cross_entropy``,
``forward_train``, the reference's train mode) covers every block type:
``"attn"`` (whisper's encoder and cross-attention, phi-3-vision's patch
prefix included), ``"moe"``, ``"mamba2"`` and ``"mamba2_sharedattn"``
(zamba2's globally shared attention block applied after the Mamba2, its
gradients adding up over the applications), ``"mlstm"`` and
``"slstm"``.  The scans' gradient is the ``gla_chunk`` op's backward
(a kernel on the card), the attention's the flash op's, the sLSTM's
autograd's through its loop.  A stacked leaf is unbound into per-layer
views once per forward (so the backward stacks the layers' gradients
once), and with ``cfg.remat`` each layer runs under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of the
reference's ``jax.checkpoint(nothing_saveable)`` scan body (the
reference checkpoints a hybrid stack's repeating unit, 5 Mamba2 and the
shared block or 7 mLSTM and an sLSTM: the same values, more held); each
loss chunk is checkpointed, as the reference's, so the vocab-wide
float32 logits of one chunk at a time are live.

Under a mesh whose "model" axis computes split (the trainer's mesh path,
``meshctx.model_axis``), attention, the MLPs, the moe layer and the
vocab run split over it (``layers``, ``attention``, ``moe``): the logits
are vocab-sharded, and the loss is vocab-parallel (the max, the sum of
exponentials and the gold logit each all-reduced over the axis).  The
residual stream stays replicated over "model".  The reference's
``seq_parallel_residual`` only lets GSPMD keep the residual
sequence-sharded between layers; the values are the same, and a
sequence-parallel residual is later speed work (ROADMAP, item 6b).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.driver import TorchDeviceLike, resolve_torch_device
from repro_torch.distributed import meshctx
from repro_torch.distributed.sharding import vocab_split
from repro_torch.trace import BLOCK, EMBED, LOSS, span

from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from . import xlstm as xlstm_mod
from .config import ModelConfig
from .layers import (embed_apply, embed_init, linear_init, mlp_apply,
                     mlp_init, norm_apply, norm_init, torch_dtype)

Params = Dict[str, Any]


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
    p = {"ln1": norm_init(cfg, d, device, lead),
         "attn": attn.attn_init(gen, cfg, device, lead),
         "ln2": norm_init(cfg, d, device, lead),
         "mlp": mlp_init(gen, cfg, d, cfg.d_ff, device, lead)}
    if cfg.encoder_layers:      # whisper decoder layer: add cross-attn
        p["lnx"] = norm_init(cfg, d, device, lead)
        p["cross"] = attn.cross_attn_init(gen, cfg, device, lead)
    return p


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
              kv: Params, pos: Optional[int],
              cross_kv: Optional[Params] = None,
              enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm attention, cross-attention where the block has it
    (whisper's decoder), then the MLP (the mixture of experts where the
    block has one), each with its residual; `kv` and `cross_kv` are
    updated in place.  At prefill cross-attention attends over the K/V of
    `enc_out` just computed, in the activation dtype, and writes them into
    `cross_kv` in its dtype; a decode step reads `cross_kv`.  The moe
    layer's aux loss is a training term: serving drops it."""
    h = norm_apply(cfg, p["ln1"], x)
    if mode == "prefill":
        o, _ = attn.attn_prefill(p["attn"], cfg, h, kv)
    else:
        o, _ = attn.attn_decode(p["attn"], cfg, h, kv, pos)
    x = x + o
    if "cross" in p:
        h = norm_apply(cfg, p["lnx"], x)
        if mode == "prefill":
            enc_kv = attn.encode_cross_kv(p["cross"], cfg, enc_out)
            for name, t in enc_kv.items():
                cross_kv[name].copy_(t)
        else:
            enc_kv = cross_kv
        x = x + attn.cross_attn_apply(p["cross"], cfg, h, enc_kv)
    h = norm_apply(cfg, p["ln2"], x)
    if "moe" in p:
        o, _ = moe_mod.moe_apply(p["moe"], cfg, h)
        return x + o
    return x + mlp_apply(p["mlp"], h, cfg)


def _block_apply(p: Params, cfg: ModelConfig, btype: str, x: torch.Tensor,
                 mode: str, cache: Params, pos: Optional[int],
                 shared_p: Optional[Params] = None,
                 enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One block on x in `mode` ("prefill" or "decode"); its cache is
    updated in place.  `shared_p` is zamba2's shared attention block,
    `enc_out` whisper's encoder output (prefill only)."""
    if btype in ("attn", "moe"):
        return _attn_mlp(p, cfg, x, mode, cache["kv"], pos,
                         cache.get("cross_kv"), enc_out)
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
    seed), on `torch_device` (default the card).  On the meta device the
    leaves are shapes alone, drawn from no generator (the sharding rules
    read them)."""
    dev = resolve_torch_device(torch_device)
    gen = generator
    if dev.type == "meta":
        gen = None
    elif not isinstance(gen, torch.Generator):
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
    if cfg.encoder_layers:
        d, lead = cfg.d_model, (cfg.encoder_layers,)
        p["encoder"] = {
            "layers": {"ln1": norm_init(cfg, d, dev, lead),
                       "attn": attn.attn_init(gen, cfg, dev, lead),
                       "ln2": norm_init(cfg, d, dev, lead),
                       "mlp": mlp_init(gen, cfg, d, cfg.d_ff, dev, lead)},
            "norm": norm_init(cfg, d, dev)}
    return LMParams(p)


# ----------------------------------------------------------------------
# encoder (whisper): a non-causal attention stack over the frame stubs
# ----------------------------------------------------------------------
def _encode(params: Params, cfg: ModelConfig,
            frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d) -> the encoder output (B, T, d).  No position
    term is added to the frames, as in the reference."""
    enc = params["encoder"]
    x = frames
    for lp in _unstack(enc["layers"], cfg.encoder_layers):
        x = _remat(cfg.remat and _training(enc, x), _encoder_layer, lp,
                   cfg, x)
    return norm_apply(cfg, enc["norm"], x)


def _encoder_layer(lp: Params, cfg: ModelConfig,
                   x: torch.Tensor) -> torch.Tensor:
    h = norm_apply(cfg, lp["ln1"], x)
    x = x + attn.attn_train(lp["attn"], cfg, h, causal=False)
    h = norm_apply(cfg, lp["ln2"], x)
    return x + mlp_apply(lp["mlp"], h, cfg)


# ----------------------------------------------------------------------
# inputs -> first hidden states, hidden states -> logits
# ----------------------------------------------------------------------
def embed_inputs(params: Params, cfg: ModelConfig,
                 batch: Mapping[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Token embedding and the modality prefixes.  Returns (x, enc_out):
    phi-3-vision's ``patch_emb``, cast to x's dtype, ahead of the text;
    whisper's ``frames``, cast to x's dtype, through the encoder (enc_out
    None without them)."""
    with span(EMBED):
        x = embed_apply(params["embed"], cfg, batch["tokens"])
        enc_out = None
        if cfg.frontend == "vision_stub" and "patch_emb" in batch:
            x = torch.cat([batch["patch_emb"].to(x.dtype), x], dim=1)
        if cfg.encoder_layers and "frames" in batch:
            enc_out = _encode(params, cfg, batch["frames"].to(x.dtype))
        return x, enc_out


def _head_weight(params: Params, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tokens"].t()
    return params["lm_head"]["w"]


def _vocab_axis(cfg: ModelConfig) -> Optional[meshctx.Axis]:
    """The model axis where it splits the vocab, else None."""
    ax = meshctx.model_axis(cfg)
    return ax if ax is not None and vocab_split(cfg, ax.size) else None


def logits_fn(params: Params, cfg: ModelConfig,
              h: torch.Tensor) -> torch.Tensor:
    """The logits of h; where the model axis splits the vocab, this
    rank's V/tp columns of them (the head holds its slice)."""
    h = norm_apply(cfg, params["final_norm"], h)
    h = meshctx.copy_to_model(h, _vocab_axis(cfg))
    logits = h @ _head_weight(params, cfg).to(h.dtype)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# ----------------------------------------------------------------------
# training: the layer stack without caches, and the chunked loss
# ----------------------------------------------------------------------
def _unstack(tree: Params, n: int) -> list:
    """The n layers of a stacked tree, as views (``unbind``: the backward
    stacks the n gradients of a leaf once, where indexing each layer
    would add n leaf-sized tensors)."""
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _training(tree: Params, x: torch.Tensor) -> bool:
    """Grad mode is on and x or a leaf of `tree` requires grad."""
    if not torch.is_grad_enabled():
        return False
    if x.requires_grad:
        return True
    stack = [tree]
    while stack:
        node = stack.pop()
        for v in node.values():
            if isinstance(v, dict):
                stack.append(v)
            elif v.requires_grad:
                return True
    return False


def _remat(on: bool, fn, *args):
    """fn(*args), recomputed in the backward instead of saved when `on`."""
    if on:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _train_block(p: Params, cfg: ModelConfig, btype: str, x: torch.Tensor,
                 enc_out: Optional[torch.Tensor],
                 shared_p: Optional[Params]):
    """One block of type `btype` in train mode: (x, aux loss).
    `shared_p` is zamba2's shared attention block, `enc_out` whisper's
    encoder output."""
    with span(BLOCK):
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        h = norm_apply(cfg, p["ln1"], x)
        if btype in ("mlstm", "slstm"):
            fn = getattr(xlstm_mod, f"{btype}_train")
            return x + fn(p[btype], cfg, h), zero
        if btype in ("mamba2", "mamba2_sharedattn"):
            x = x + ssm_mod.mamba2_train(p["mamba"], cfg, h)
            if btype == "mamba2_sharedattn" and shared_p is not None:
                h = norm_apply(cfg, shared_p["ln1"], x)
                x = x + attn.attn_train(shared_p["attn"], cfg, h)
                h = norm_apply(cfg, shared_p["ln2"], x)
                x = x + mlp_apply(shared_p["mlp"], h, cfg)
            return x, zero
        x = x + attn.attn_train(p["attn"], cfg, h)
        if "cross" in p:
            h = norm_apply(cfg, p["lnx"], x)
            enc_kv = attn.encode_cross_kv(p["cross"], cfg, enc_out)
            x = x + attn.cross_attn_apply(p["cross"], cfg, h, enc_kv)
        h = norm_apply(cfg, p["ln2"], x)
        if "moe" in p:
            o, aux = moe_mod.moe_apply(p["moe"], cfg, h)
            return x + o, aux
        return x + mlp_apply(p["mlp"], h, cfg), zero


def forward_hidden(params: Union[LMParams, Params], cfg: ModelConfig,
                   x: torch.Tensor, enc_out: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the layer stack in train mode (no caches).  Returns (hidden,
    aux), aux the sum of the moe layers' aux losses."""
    params = _tree(params)
    pattern = cfg.block_pattern()
    layers = {b: _unstack(params["layers"][b], pattern.count(b))
              for b in set(pattern)}
    shared_p = params.get("shared_attn")
    remat = cfg.remat and (_training(params["layers"], x) or (
        shared_p is not None and _training(shared_p, x)))
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    counters = {b: 0 for b in layers}
    for btype in pattern:
        lp = layers[btype][counters[btype]]
        counters[btype] += 1
        x, aux = _remat(remat, _train_block, lp, cfg, btype, x, enc_out,
                        shared_p)
        aux_total = aux_total + aux
    return x, aux_total


def _chunk_loss(params: Params, cfg: ModelConfig, h: torch.Tensor,
                t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the chunk's token losses, its count of targets).  Over a
    vocab split on the model axis, each rank holds V/tp logits: the
    log-sum-exp takes the max over the axis (no gradient flows through
    it), then the sum of exponentials summed over the axis; the gold
    logit is taken on the rank whose rows hold it (zeros elsewhere) and
    summed over the axis."""
    logits = logits_fn(params, cfg, h).to(torch.float32)
    mask = (t >= 0).to(torch.float32)
    ax = _vocab_axis(cfg)
    if ax is None:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1,
                            t.clamp_min(0)[..., None].long())[..., 0]
        return torch.sum((lse - gold) * mask), torch.sum(mask)
    m = logits.detach().amax(dim=-1, keepdim=True)
    torch.distributed.all_reduce(m, op=torch.distributed.ReduceOp.MAX,
                                 group=ax.group)
    sumexp = meshctx.reduce_from_model(
        torch.exp(logits - m).sum(dim=-1), ax)
    lse = m[..., 0] + torch.log(sumexp)
    n = logits.shape[-1]
    local = t.long().clamp_min(0) - ax.rank * n
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, torch.where(mine, local, 0)[..., None]
                        )[..., 0] * mine.to(torch.float32)
    gold = meshctx.reduce_from_model(gold, ax)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def chunked_cross_entropy(params: Union[LMParams, Params], cfg: ModelConfig,
                          h: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Mean token loss of h (B, S, d) against targets (B, S) integer (-1:
    ignored), over ``cfg.chunked_loss_chunks`` sequence chunks (fewer
    where they do not divide S), each checkpointed when training, so one
    chunk's float32 logits (B, S / n, V) are live at a time."""
    with span(LOSS):
        params = _tree(params)
        B, S, _ = h.shape
        n = cfg.chunked_loss_chunks
        while S % n:
            n -= 1
        c = S // n
        remat = _training(params, h)
        tot = torch.zeros((), dtype=torch.float32, device=h.device)
        cnt = torch.zeros((), dtype=torch.float32, device=h.device)
        for j in range(0, S, c):
            part, m = _remat(remat, _chunk_loss, params, cfg, h[:, j:j + c],
                             targets[:, j:j + c])
            tot = tot + part
            cnt = cnt + m
        return tot / torch.clamp(cnt, min=1.0)


def forward_train(params: Union[LMParams, Params], cfg: ModelConfig,
                  batch: Mapping[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss of a batch {"tokens", "targets"} (B, S) integer,
    with phi-3-vision's ``patch_emb`` or whisper's ``frames``: returns
    (loss + 0.01 * aux, {"loss", "aux_loss"}).  The loss is over the text
    tokens only (the patch rows are dropped before it).  Raises
    ValueError, before any work, for whisper without frames."""
    params = _tree(params)
    if cfg.encoder_layers and "frames" not in batch:
        raise ValueError(f"{cfg.name} is an encoder-decoder: its training "
                         f"batch needs frames (B, {cfg.encoder_seq}, "
                         f"{cfg.d_model})")
    x, enc_out = embed_inputs(params, cfg, batch)
    h, aux = forward_hidden(params, cfg, x, enc_out)
    if cfg.frontend == "vision_stub" and "patch_emb" in batch:
        h = h[:, batch["patch_emb"].shape[1]:]   # loss over text tokens only
    loss = chunked_cross_entropy(params, cfg, h, batch["targets"])
    return loss + 0.01 * aux, {"loss": loss, "aux_loss": aux}


# ----------------------------------------------------------------------
# serving: caches, prefill, decode
# ----------------------------------------------------------------------
def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16,
                torch_device: TorchDeviceLike = None) -> Params:
    """Per-layer caches stacked over each block type's layers, on
    `torch_device` (default the card): zeros (the sLSTM normalizer ones),
    in `dtype` (the xlstm caches float32).  Whisper's decoder layers also
    hold ``cross_kv``: the encoder's K/V, (n_layers, batch, encoder_seq,
    KH, hd) in `dtype`, never int8, filled at prefill."""
    dev = resolve_torch_device(torch_device)
    pattern = cfg.block_pattern()
    caches = {"layers": {b: _block_cache(cfg, b, batch, max_len, dtype, dev,
                                         pattern.count(b))
                         for b in sorted(set(pattern))}}
    if cfg.encoder_layers:
        shape = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads,
                 cfg.hd)
        caches["layers"]["attn"]["cross_kv"] = {
            k: torch.zeros(shape, dtype=dtype, device=dev)
            for k in ("k", "v")}
    return caches


def _index(tree: Params, i: int) -> Params:
    """Layer i of a stacked tree: views, so writes reach the stack."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _run_stack_cached(params: Params, cfg: ModelConfig, x: torch.Tensor,
                      caches: Params, mode: str, pos: Optional[int],
                      enc_out: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    counters = {b: 0 for b in set(cfg.block_pattern())}
    shared_p = params.get("shared_attn")
    for btype in cfg.block_pattern():
        i = counters[btype]
        counters[btype] += 1
        x = _block_apply(_index(params["layers"][btype], i), cfg, btype, x,
                         mode, _index(caches["layers"][btype], i), pos,
                         shared_p, enc_out)
    return x


def _tree(params: Union[LMParams, Params]) -> Params:
    return params.tree() if isinstance(params, LMParams) else params


def prefill(params: Union[LMParams, Params], cfg: ModelConfig,
            batch: Mapping[str, torch.Tensor],
            caches: Params) -> tuple:
    """Run the prompt; returns (logits at the last position, caches), the
    caches updated in place.  Whisper needs ``frames`` of ``encoder_seq``
    rows: anything else raises ValueError, before any work."""
    params = _tree(params)
    if cfg.encoder_layers:
        frames = batch.get("frames")
        if frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its prefill "
                             f"needs frames (B, {cfg.encoder_seq}, "
                             f"{cfg.d_model})")
        rows = caches["layers"]["attn"]["cross_kv"]["k"].shape[2]
        if frames.shape[1] != rows:
            raise ValueError(f"{cfg.name}: {frames.shape[1]} frames, but "
                             f"the cross-attention cache holds {rows} "
                             f"(encoder_seq); frames are never truncated "
                             f"or padded")
    x, enc_out = embed_inputs(params, cfg, batch)
    x = _run_stack_cached(params, cfg, x, caches, "prefill", None, enc_out)
    return logits_fn(params, cfg, x[:, -1:]), caches


def decode_step(params: Union[LMParams, Params], cfg: ModelConfig,
                caches: Params, token: torch.Tensor,
                pos: Union[int, torch.Tensor]) -> tuple:
    """token: (B, 1) integer; pos: the step's position (an int), the same
    for every row.  Returns (logits (B, 1, V), caches updated in place)."""
    params = _tree(params)
    pos = int(pos)
    x = embed_apply(params["embed"], cfg, token,
                    positions=torch.full(token.shape, pos,
                                         device=token.device))
    x = _run_stack_cached(params, cfg, x, caches, "decode", pos)
    return logits_fn(params, cfg, x), caches
