"""Architecture registry plumbing: ArchSpec, the shape table, input
specs and the reduced (smoke-test) configs.

The port's copy of the reference's ``configs/base.py``.  ``input_specs``
returns tensors on the ``meta`` device, PyTorch's shape stand-ins, where
the reference returns ``jax.ShapeDtypeStruct``s: the same keys, shapes
and dtypes, and nothing is allocated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig, ShardingConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class ArchSpec:
    model: ModelConfig
    optimizer: str = "adamw"          # adamw | adafactor
    fsdp: bool = False                # ZeRO-3 over data axes
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skip_notes: str = ""              # why some shapes are skipped
    # SSM/recurrent archs have no tensor-parallel weights: the model axis
    # would idle, so data parallelism extends over it
    dp_over_model: bool = False

    @property
    def name(self) -> str:
        return self.model.name


def for_shape(spec: ArchSpec, shape: ShapeSpec,
              sharding: Optional[ShardingConfig] = None,
              quantized: bool = False) -> ModelConfig:
    """Model config specialized to one (shape, sharding) cell."""
    kw: Dict[str, Any] = {"max_seq": shape.seq_len}
    if sharding is not None:
        kw["sharding"] = sharding
    if quantized:
        kw["quantized_inference"] = True
    if shape.kind == "decode" and spec.model.moe_experts:
        # decode steps keep experts resident: per-step weight gathers
        # would move far more bytes than the step uses
        kw["moe_expert_2d"] = True
    return spec.model.replace(**kw)


# ----------------------------------------------------------------------
# input specs (meta tensors: shapes and dtypes, no allocation)
# ----------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Model inputs for the given shape, as tensors on the ``meta``
    device.

    Modality frontends are stubs: ``patch_emb`` (phi-3-vision) and
    ``frames`` (whisper) are precomputed embeddings in the model's dtype;
    the image's patches count against the shape's sequence length."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")
    if shape.kind == "decode":
        # one new token against a seq_len-deep cache
        return {"token": spec((B, 1)), "pos": spec(())}
    text = S
    batch: Dict[str, Any] = {}
    if cfg.frontend == "vision_stub":
        text = S - cfg.n_patches
        batch["patch_emb"] = spec((B, cfg.n_patches, cfg.d_model), dt)
    if cfg.frontend == "audio_stub":
        batch["frames"] = spec((B, cfg.encoder_seq, cfg.d_model), dt)
    batch["tokens"] = spec((B, text))
    if shape.kind == "train":
        batch["targets"] = spec((B, text))
    return batch


def reduced(cfg: ModelConfig) -> ModelConfig:
    """The same family at smoke-test size (the reference's reduction)."""
    kw: Dict[str, Any] = dict(
        d_model=64, n_heads=4, head_dim=16, d_ff=128 if cfg.d_ff else 0,
        vocab_size=512, max_seq=64, dtype="float32", remat=False,
        chunked_loss_chunks=2,
    )
    kw["n_kv_heads"] = min(cfg.n_kv_heads, 2) \
        if cfg.n_kv_heads < cfg.n_heads else 4
    if cfg.family == "hybrid":
        kw.update(n_layers=4, attn_every=2, ssm_state=16, ssm_head_dim=16,
                  d_ff=128)
    elif cfg.family == "ssm" and cfg.slstm_every:
        kw.update(n_layers=4, slstm_every=2)
    elif cfg.family == "ssm":
        kw.update(n_layers=3, ssm_state=16, ssm_head_dim=16)
    else:
        kw["n_layers"] = 2
    if cfg.moe_experts:
        kw.update(moe_experts=4, moe_top_k=min(cfg.moe_top_k, 2),
                  moe_d_ff=64,
                  n_shared_experts=min(cfg.n_shared_experts, 1))
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.frontend == "vision_stub":
        kw.update(n_patches=8)
    return cfg.replace(**kw)
