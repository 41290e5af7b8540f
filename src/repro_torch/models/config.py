"""Unified model configuration covering all assigned architecture families.

The port's own copy of the reference's ``models/config.py``: the same
fields and defaults, so ``ModelConfig(**dataclasses.asdict(ref_cfg))``
(``convert.model_config_from_fields``) rebuilds a reference config.
``use_pallas`` stays as a field and is ignored: the port's ops pick by the
device of their tensors.  The mesh path reads ``sharding``'s data and
model axes and the moe layer's distributed fields (``moe_combine``,
``moe_token_gather``, ``moe_fused_ep``, ``moe_expert_2d``);
``sharding.enabled``, ``fsdp_axes`` outside the sharding rules,
``seq_axis`` and ``seq_parallel_residual`` are carried and not read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ShardingConfig:
    """Logical-axis sharding knobs consumed by distributed/sharding.py and
    the in-model activation constraints."""
    enabled: bool = False
    data_axes: Tuple[str, ...] = ("data",)     # batch-sharding axes
    model_axis: Optional[str] = "model"        # TP/EP axis
    fsdp_axes: Tuple[str, ...] = ()            # param-sharding (ZeRO-3) axes
    seq_axis: Optional[str] = None             # sequence parallelism (decode SP)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    max_seq: int = 4096

    norm: str = "rmsnorm"          # rmsnorm | layernorm | nonparametric
    pos: str = "rope"              # rope | learned | sinusoidal | none
    rope_theta: float = 10_000.0
    mlp: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    n_shared_experts: int = 0      # always-on experts (kimi-style)

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    attn_every: int = 0            # hybrid: shared attn block every k layers

    # --- xLSTM ---
    slstm_every: int = 0           # sLSTM block every k layers (rest mLSTM)

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0           # frames after the (stubbed) conv frontend

    # --- modality frontend stubs ---
    frontend: str = "none"         # none | vision_stub | audio_stub
    n_patches: int = 0             # vision: image patch embeddings per sample

    dtype: str = "bfloat16"
    scan_layers: bool = True       # scan over stacked homogeneous layers
    remat: bool = True
    remat_policy: str = "nothing_saveable"  # nothing_saveable | dots | full
    chunked_loss_chunks: int = 8   # seq chunks for vocab-sharded CE

    # --- VTA quantized-inference path (the paper's technique) ---
    quantized_inference: bool = False   # int8 PTQ weights on serve path
    use_pallas: bool = False            # ignored: dispatch is by device

    # --- distributed perf levers (§Perf hillclimbing) ---
    seq_parallel_residual: bool = False  # shard residual stream S over model
    moe_combine: str = "psum"            # psum | psum_bf16 | reduce_scatter
    moe_token_gather: bool = False       # tokens enter EP model-sharded +
                                         # explicit bf16 all_gather (backward
                                         # becomes a bf16 reduce-scatter
                                         # instead of an f32 psum)
    moe_fused_ep: bool = False           # routing + shared expert computed
                                         # inside the EP shard_map: removes
                                         # the router-probs all-gather and
                                         # the unsharded shared-expert
                                         # activation
    kv_cache_quant: bool = False         # int8 KV cache (VTA-style PTQ)
    moe_expert_2d: bool = False          # serving: experts stay RESIDENT,
                                         # sharded (E:model, d:data); the
                                         # FFN contracts d-partially with a
                                         # (tiny at decode) activation psum
                                         # instead of gathering weights
                                         # every step

    sharding: ShardingConfig = field(default_factory=ShardingConfig)

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hd

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def block_pattern(self) -> Tuple[str, ...]:
        """Per-layer block types.  Homogeneous stacks return a uniform
        pattern and are scanned; heterogeneous (hybrid/xlstm) unroll."""
        if self.family == "moe":
            return tuple("moe" for _ in range(self.n_layers))
        if self.family == "hybrid":
            # zamba2: mamba2 backbone, a *shared* attention block applied
            # every `attn_every` layers (weights shared across applications)
            out = []
            for i in range(self.n_layers):
                out.append("mamba2_sharedattn"
                           if self.attn_every and (i + 1) % self.attn_every == 0
                           else "mamba2")
            return tuple(out)
        if self.family == "ssm" and self.slstm_every:
            return tuple("slstm" if (i % self.slstm_every) == self.slstm_every - 1
                         else "mlstm" for i in range(self.n_layers))
        if self.family == "ssm":
            return tuple("mamba2" for _ in range(self.n_layers))
        return tuple("attn" for _ in range(self.n_layers))

    @property
    def is_homogeneous(self) -> bool:
        return len(set(self.block_pattern())) == 1

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # parameter counting (for §Roofline MODEL_FLOPS = 6*N*D)
    # ------------------------------------------------------------------
    def param_counts(self) -> dict:
        d, hd = self.d_model, self.hd
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.mlp == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        moe = 0
        if self.moe_experts:
            e_ff = self.moe_d_ff or self.d_ff
            per_expert = 3 * d * e_ff if self.mlp == "swiglu" else 2 * d * e_ff
            moe = self.moe_experts * per_expert + d * self.moe_experts
            mlp = 0
        mamba = 0
        if self.family in ("hybrid", "ssm") and self.ssm_state:
            di = self.d_inner
            nh = self.ssm_heads
            mamba = (d * (2 * di + 2 * self.ssm_state + nh)   # in_proj (x,z,B,C,dt)
                     + di * d                                  # out_proj
                     + self.ssm_conv * (di + 2 * self.ssm_state)
                     + 2 * nh)                                 # A, D
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        counts = {"embed": emb}
        pattern = self.block_pattern()
        n_attn = sum(1 for b in pattern if "attn" in b and b != "mamba2_sharedattn")
        n_sharedattn = 1 if any(b == "mamba2_sharedattn" for b in pattern) else 0
        n_moe = sum(1 for b in pattern if b == "moe")
        n_mamba = sum(1 for b in pattern if b.startswith("mamba2"))
        n_xlstm = sum(1 for b in pattern if b in ("mlstm", "slstm"))
        counts["attn"] = n_attn * (attn + mlp)
        counts["shared_attn"] = n_sharedattn * (attn + mlp)
        counts["moe"] = n_moe * (attn + moe)
        counts["mamba"] = n_mamba * mamba
        # xlstm blocks: up/down proj + qkv-ish
        counts["xlstm"] = n_xlstm * (2 * d * 2 * d + 4 * d * d)
        if self.encoder_layers:
            counts["encoder"] = self.encoder_layers * (attn + mlp)
            counts["cross_attn"] = self.n_layers * attn
        return counts

    @property
    def n_params(self) -> int:
        return sum(self.param_counts().values())

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.moe_experts:
            return self.n_params
        d = self.d_model
        e_ff = self.moe_d_ff or self.d_ff
        per_expert = (3 if self.mlp == "swiglu" else 2) * d * e_ff
        total_expert = self.moe_experts * per_expert * self.n_layers
        active_expert = ((self.moe_top_k + self.n_shared_experts)
                         * per_expert * self.n_layers)
        return self.n_params - total_expert + active_expert
