"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=6400, vocab_size=32064,
        moe_experts=16, moe_top_k=2, moe_d_ff=6400,
        norm="layernorm", pos="rope", mlp="swiglu",
        moe_fused_ep=True),
    optimizer="adamw", fsdp=True,
)
